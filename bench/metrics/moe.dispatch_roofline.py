"""Routing, dispatch and combine's share of their roofline.

Their least bytes (``cost_moe.dispatch_bytes``) for the tokens the
program routed and the assignments to held experts in the traced step (its
``moe.tokens_routed`` and ``moe.assignments_held`` counters, over every pass
that runs the layer's forward), at HBM bandwidth, over the device time of
the ops launched inside the program's ``moe.route``, ``moe.dispatch`` and
``moe.combine`` spans. Source: the device trace and the program's counters.
None when the trace holds no such op or the program counted nothing.
"""
from harness import cost_moe

SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def read(ctx):
    f = ctx.facts
    counts = f.get("moe_counts", {})
    tokens, rows = counts.get("moe.tokens_routed"), counts.get("moe.assignments_held")
    took = ctx.digest.time_s(lambda op: any(s in op.spans for s in SPANS))
    if not tokens or took <= 0:
        return None
    moved = cost_moe.dispatch_bytes(f["model"], tokens, rows)
    return 100.0 * moved / ctx.peaks.HBM_BYTES_PER_S / took
