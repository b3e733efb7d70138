"""The leaf products' share of their roofline, read under the program's span.

The least time of the traced multiplies' leaves (rank^d products of the
(M/2^d, K/2^d) x (K/2^d, N/2^d) blocks at the operands' dtype peak, or
their bytes at HBM bandwidth where that is longer) over the device time of
the ops launched inside the program's ``strassen.leaf`` spans, whatever
kernel implements the leaf. Source: the device trace. None when the trace
holds no such op.
"""


def read(ctx):
    cfg, f = ctx.cell.config, ctx.facts
    took = ctx.digest.time_s(lambda op: "strassen.leaf" in op.spans)
    if took <= 0:
        return None
    leaf = ctx.cost.strassen_leaf(cfg["m"], cfg["k"], cfg["n"], cfg["backend"]["depth"],
                                  cfg["scheme"], f["dtype"])
    least = ctx.peaks.least_seconds(leaf.ops, f["dtype"], leaf.bytes) * f["traced_multiplies"]
    return 100.0 * least / took
