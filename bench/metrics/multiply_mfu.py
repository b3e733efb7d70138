"""The whole multiply's share of the chip's peak.

The leaf FLOPs (rank^d products of the quadrant blocks) of every multiply
completed in the window, over the window's seconds times the operands'
dtype peak. Source: the host clock over the window.
"""


def read(ctx):
    cfg, f = ctx.cell.config, ctx.facts
    leaf = ctx.cost.strassen_leaf(cfg["m"], cfg["k"], cfg["n"], cfg["backend"]["depth"],
                                  cfg["scheme"], f["dtype"])
    return 100.0 * leaf.ops * f["multiplies"] / f["window_s"] / ctx.peaks.PEAK_FLOPS[f["dtype"]]
