"""The MoE training step's share of the chip's peak.

The model work of every optimizer step completed in the window
(``cost_moe.moe_model_flops``: 6 times the parameters a token multiplies
by, the held experts at their expected share of a token's top-k picks, times
the step's tokens, plus causal attention forward and backward; no
recompute) over the window's seconds times the bf16 peak. Source: the host
clock over the window.
"""
from harness import cost_moe


def read(ctx):
    f = ctx.facts
    model, traffic = f["model"], f["traffic"]
    rows = traffic["micro_batch"] * traffic["accum_steps"]
    work = cost_moe.moe_model_flops(model, rows, traffic["seq"])
    return 100.0 * work * f["steps"] / f["window_s"] / ctx.peaks.PEAK_FLOPS[model["dtype"]]
