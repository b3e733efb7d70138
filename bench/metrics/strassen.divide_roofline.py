"""The Strassen divide levels' share of their roofline.

The bytes every divide level of A (M, K) and of B (K, N) must move, each
input read once and each output written once (level l takes rank^l blocks
of 4 quadrants and gives rank^(l+1) blocks: ``cost.signed_sum_bytes``), for
the traced multiplies, at HBM bandwidth, over the device time of the ops
launched inside the program's ``strassen.divide`` spans, the quadrant
split copies among them. Source: the device trace. None when the trace
holds no such op.
"""


def read(ctx):
    cfg, f = ctx.cell.config, ctx.facts
    took = ctx.digest.time_s(lambda op: "strassen.divide" in op.spans)
    if took <= 0:
        return None
    m, k, n, d = cfg["m"], cfg["k"], cfg["n"], cfg["backend"]["depth"]
    rank = ctx.cost.SCHEME_RANK[cfg["scheme"]]
    moved = sum(ctx.cost.signed_sum_bytes(rank, 4, rank**level,
                                          (rows // 2 ** (level + 1)) * (cols // 2 ** (level + 1)),
                                          f["dtype"])
                for level in range(d) for rows, cols in ((m, k), (k, n)))
    return 100.0 * moved * f["traced_multiplies"] / ctx.peaks.HBM_BYTES_PER_S / took
