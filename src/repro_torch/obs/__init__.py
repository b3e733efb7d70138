"""Observability of the port: tag-addressed spans and process metrics.

Copies of :mod:`repro.obs.tracer` and :mod:`repro.obs.metrics`. Tracing is
disabled by default: ``get_tracer().span(...)`` returns a shared no-op
context manager until ``obs.configure(enabled=True)``. With
``configure(profiler_annotations=True)`` each span also opens a
``torch.profiler.record_function`` range. :mod:`repro_torch.obs.export`
(a port of ``repro.obs.export``) writes the spans as a Chrome/Perfetto
trace or JSONL, checks a trace with ``validate_trace``, and starts and stops
a ``torch.profiler`` trace beside them.
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
