"""The held experts' products' share of their roofline.

The gate, up and down products of the rows the program's expert products
computed in the traced step (its ``moe.assignments_held`` counter, which
counts each pass that runs the layer's forward: the forward and
rematerialization's recompute), at the bf16 peak, over the device time of
the ops launched inside the program's ``moe.experts`` spans (the same
passes). Source: the device trace and the program's counter. None when the
trace holds no such op or the program counted nothing.
"""
from harness import cost_moe


def read(ctx):
    f = ctx.facts
    rows = f.get("moe_counts", {}).get("moe.assignments_held")
    took = ctx.digest.time_s(lambda op: "moe.experts" in op.spans)
    if not rows or took <= 0:
        return None
    model = f["model"]
    least = cost_moe.expert_flops(model, rows) / ctx.peaks.PEAK_FLOPS[model["dtype"]]
    return 100.0 * least / took
