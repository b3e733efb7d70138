"""The leaf products' share of their roofline.

The least time of the traced multiplies' leaves (rank^d products of the
(M/2^d, K/2^d) x (K/2^d, N/2^d) blocks at the operands' dtype peak, or
their bytes at HBM bandwidth where that is longer) over the device time of
the ops whose launching CPU op took the leaf's two operand shapes. Source:
the device trace. None when no op took them (a route with no such leaf).
"""


def read(ctx):
    cfg, f = ctx.cell.config, ctx.facts
    m, k, n, d = cfg["m"], cfg["k"], cfg["n"], cfg["backend"]["depth"]
    rank, s = ctx.cost.SCHEME_RANK[cfg["scheme"]] ** d, 2**d
    shapes = ((rank, m // s, k // s), (rank, k // s, n // s))
    took = ctx.digest.time_s(lambda op: op.shapes[:2] == shapes)
    if took <= 0:
        return None
    leaf = ctx.cost.strassen_leaf(m, k, n, d, cfg["scheme"], f["dtype"])
    least = ctx.peaks.least_seconds(leaf.ops, f["dtype"], leaf.bytes) * f["traced_multiplies"]
    return 100.0 * least / took
