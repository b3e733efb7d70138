"""The Strassen divide and combine levels' share of their roofline.

The bytes every level must move, each input read once and each output
written once (``cost.strassen_level_bytes`` for M, K, N, the depth, the
scheme and the dtype), at HBM bandwidth, over the device time of every op
inside the program's ``backend.matmul`` spans that is not on the leaf's
operand shapes. Source: the device trace. None when the trace holds no
such op.
"""


def read(ctx):
    cfg, f = ctx.cell.config, ctx.facts
    m, k, n, d = cfg["m"], cfg["k"], cfg["n"], cfg["backend"]["depth"]
    rank, s = ctx.cost.SCHEME_RANK[cfg["scheme"]] ** d, 2**d
    leaf = ((rank, m // s, k // s), (rank, k // s, n // s))
    took = ctx.digest.time_s(lambda op: "backend.matmul" in op.spans and op.shapes[:2] != leaf)
    if took <= 0:
        return None
    moved = ctx.cost.strassen_level_bytes(m, k, n, d, cfg["scheme"], f["dtype"])
    return 100.0 * moved * f["traced_multiplies"] / ctx.peaks.HBM_BYTES_PER_S / took
