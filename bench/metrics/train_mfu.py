"""The whole training step's share of the chip's peak.

The model work of every optimizer step completed in the window (6 N T over
all parameters and the step's tokens, plus causal attention's products
forward and backward; no recompute) over the window's seconds times the
bf16 peak. Source: the host clock over the window.
"""


def read(ctx):
    f = ctx.facts
    model, traffic = f["model"], f["traffic"]
    rows = traffic["micro_batch"] * traffic["accum_steps"]
    work = ctx.cost.dense_lm_model_flops(model, rows, traffic["seq"])
    return 100.0 * work * f["steps"] / f["window_s"] / ctx.peaks.PEAK_FLOPS[model["dtype"]]
