"""Observability of the port: tag-addressed spans and process metrics.

Copies of :mod:`repro.obs.tracer` and :mod:`repro.obs.metrics`. Tracing is
disabled by default: ``get_tracer().span(...)`` returns a shared no-op
context manager until ``obs.configure(enabled=True)``. With
``configure(profiler_annotations=True)`` each span also opens a
``torch.profiler.record_function`` range. The Perfetto exporter
(``repro.obs.export``) is not ported yet.
"""
from __future__ import annotations

from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Metrics,
    get_metrics,
    reset_metrics,
)
from repro_torch.obs.tracer import (  # noqa: F401
    Span,
    Tracer,
    configure,
    get_tracer,
    reset_tracing,
)

__all__ = [
    "Span",
    "Tracer",
    "configure",
    "get_tracer",
    "reset_tracing",
    "Counter",
    "Gauge",
    "Histogram",
    "Metrics",
    "get_metrics",
    "reset_metrics",
]
