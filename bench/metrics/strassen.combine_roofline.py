"""The Strassen combine levels' share of their roofline.

The bytes every combine level of C (M, N) must move, each input read once
and each output written once (level l takes rank^(l+1) product blocks and
gives rank^l blocks of 4 quadrants: ``cost.signed_sum_bytes``), for the
traced multiplies, at HBM bandwidth, over the device time of the ops
launched inside the program's ``strassen.combine`` spans, the quadrant
merge copies among them. Source: the device trace. None when the trace
holds no such op.
"""


def read(ctx):
    cfg, f = ctx.cell.config, ctx.facts
    took = ctx.digest.time_s(lambda op: "strassen.combine" in op.spans)
    if took <= 0:
        return None
    m, n, d = cfg["m"], cfg["n"], cfg["backend"]["depth"]
    rank = ctx.cost.SCHEME_RANK[cfg["scheme"]]
    moved = sum(ctx.cost.signed_sum_bytes(rank, 4, rank**level,
                                          (m // 2 ** (level + 1)) * (n // 2 ** (level + 1)),
                                          f["dtype"])
                for level in range(d))
    return 100.0 * moved * f["traced_multiplies"] / ctx.peaks.HBM_BYTES_PER_S / took
