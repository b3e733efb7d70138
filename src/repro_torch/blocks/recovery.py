"""Fault types of the runtime, copied from ``repro.blocks.recovery``.

The serving engine evicts the request a :class:`FaultError` is attributed to
and keeps serving. Lineage-based block recovery comes with the out-of-core
runtime (ROADMAP.md queue 1 item 6).
"""
from __future__ import annotations

__all__ = ["FaultError", "InjectedFault"]


class FaultError(RuntimeError):
    """Base of the runtime's recoverable fault family.

    The scheduler's degradation ladder steps down on this (and on
    device-OOM); anything else propagates as a plain bug.
    """


class InjectedFault(FaultError):
    """Raised by the chaos harness (FlakyLeaf / poisoned requests)."""
