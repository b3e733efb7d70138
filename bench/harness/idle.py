"""The device's idle time ahead of the ops of one phase of a traced pass.

Read by the ``train.*_idle`` metrics. Over the pass's device ops sorted by
start, an op that starts after every earlier op has ended takes the gap
before it: the device waited for that op's launch. A phase's idle time is
the sum of the gaps taken by ops launched under its span. It is given as a
share of the pass's op extent, from its first op's start to its last op's
end, since the digest's ``window_s`` is measured on the other pass.
"""
from __future__ import annotations

from typing import Optional


def idle_share(digest, span: str) -> Optional[float]:
    """The idle time taken by ops launched under ``span``, as % of the pass's
    op extent; None when no op ran under ``span``."""
    ops = sorted(digest.ops, key=lambda op: op.start_ns)
    if not any(span in op.spans for op in ops):
        return None
    idle, end = 0, ops[0].start_ns
    for op in ops:
        if op.start_ns > end and span in op.spans:
            idle += op.start_ns - end
        end = max(end, op.start_ns + op.dur_ns)
    extent = end - ops[0].start_ns
    return 100.0 * idle / extent if extent > 0 else None
