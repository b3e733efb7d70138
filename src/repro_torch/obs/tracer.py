"""Nestable, tag-addressed spans with a thread-local context stack.

A copy of :mod:`repro.obs.tracer` whose profiler passthrough opens
``torch.profiler.record_function`` ranges in place of
``jax.profiler.TraceAnnotation``, so spans line up with the card's kernels
in a ``torch.profiler`` trace.

Design constraints, in order:

1. **Disabled mode is free.** ``Tracer.span()`` on a disabled tracer
   returns one shared no-op context manager — no ``Span`` object, no
   dict, no perf_counter call. Hot paths (the jitted matmul entry, the
   decode loop) can be instrumented unconditionally.
2. **The tag is the span identity.** Block-scheduler spans carry the
   paper's base-7 / base-4 tag (``tags.to_string``) in ``Span.tag``;
   the exporter renders it into the event name so a trace of an
   out-of-core run reads as the recursion tree itself.
3. **Explicit-time spans.** Subsystems that already own precise
   timestamps (the async wave pipeline, the request lifecycle) record
   completed spans via :meth:`Tracer.add_span` instead of wrapping
   code in context managers — overlap between waves then shows up as
   genuinely concurrent tracks, not nested blocks.

Timestamps are raw ``time.perf_counter()`` seconds; the exporter
rebases them against :attr:`Tracer.epoch`. ``begin()``/``end()``
always produce a timed :class:`Span` (callers may need the duration
even when tracing is off — e.g. the straggler watchdog); the span is
only *retained* when the tracer is enabled.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "Span",
    "Tracer",
    "get_tracer",
    "configure",
    "reset_tracing",
]


@dataclasses.dataclass
class Span:
    """One timed region. ``t0``/``t1`` are perf_counter seconds."""

    name: str
    t0: float
    t1: Optional[float] = None
    cat: str = "span"
    tag: Optional[str] = None
    track: Optional[str] = None  # exporter lane (tid); None = per-thread lane
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    span_id: int = 0
    parent_id: Optional[int] = None
    thread: int = 0

    @property
    def duration(self) -> float:
        """Seconds; 0.0 while the span is still open."""
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self


class _NullSpan:
    """Shared no-op stand-in when tracing is disabled.

    One module-level instance serves every ``span()`` call on a
    disabled tracer: ``with tracer.span(...)`` allocates nothing.
    """

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    @property
    def duration(self) -> float:
        return 0.0


NULL_SPAN = _NullSpan()


class _SpanContext:
    """Context manager wrapping begin/end on an enabled tracer."""

    __slots__ = ("_tracer", "_span", "_profiler_ctx")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span
        self._profiler_ctx = None

    def __enter__(self) -> Span:
        if self._tracer.profiler_annotations:
            from torch.profiler import record_function

            self._profiler_ctx = record_function(self._span.name)
            self._profiler_ctx.__enter__()
        return self._span

    def __exit__(self, *exc: Any) -> bool:
        if self._profiler_ctx is not None:
            self._profiler_ctx.__exit__(*exc)
        self._tracer.end(self._span)
        return False


class Tracer:
    """Span recorder with per-thread nesting and a bounded span list."""

    def __init__(
        self,
        enabled: bool = False,
        max_spans: int = 200_000,
        profiler_annotations: bool = False,
    ):
        self.enabled = enabled
        self.max_spans = max_spans
        self.profiler_annotations = profiler_annotations
        self.epoch = time.perf_counter()
        self.spans: List[Span] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._tls = threading.local()

    # -- nesting ----------------------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[Span]:
        """Innermost open span on this thread (None at top level)."""
        st = self._stack()
        return st[-1] if st else None

    # -- recording --------------------------------------------------------
    def begin(
        self,
        name: str,
        *,
        cat: str = "span",
        tag: Optional[str] = None,
        track: Optional[str] = None,
        **attrs: Any,
    ) -> Span:
        """Open a span. Always returns a timed Span (duration is valid
        even when disabled); it is only retained when enabled."""
        sp = Span(
            name=name,
            t0=time.perf_counter(),
            cat=cat,
            tag=tag,
            track=track,
            attrs=dict(attrs),
            thread=threading.get_ident(),
        )
        if self.enabled:
            sp.span_id = next(self._ids)
            st = self._stack()
            if st:
                sp.parent_id = st[-1].span_id
            st.append(sp)
        return sp

    def end(self, span: Optional[Span], **attrs: Any) -> Optional[Span]:
        """Close ``span``. Tolerates exception unwinding: pops the
        thread stack down through ``span`` if children were left open."""
        if span is None or isinstance(span, _NullSpan):
            return None
        span.t1 = time.perf_counter()
        if attrs:
            span.attrs.update(attrs)
        if self.enabled and span.span_id:
            st = self._stack()
            while st:
                top = st.pop()
                if top is span:
                    break
            self._retain(span)
        return span

    def span(
        self,
        name: str,
        *,
        cat: str = "span",
        tag: Optional[str] = None,
        track: Optional[str] = None,
        **attrs: Any,
    ):
        """``with tracer.span("name"): ...`` — no-op singleton when
        disabled (the zero-allocation fast path)."""
        if not self.enabled:
            return NULL_SPAN
        return _SpanContext(
            self, self.begin(name, cat=cat, tag=tag, track=track, **attrs)
        )

    def add_span(
        self,
        name: str,
        t0: float,
        t1: float,
        *,
        cat: str = "span",
        tag: Optional[str] = None,
        track: Optional[str] = None,
        parent: Optional[Span] = None,
        **attrs: Any,
    ) -> Optional[Span]:
        """Record a completed span from caller-owned perf_counter
        timestamps (async pipeline phases, request lifecycles)."""
        if not self.enabled:
            return None
        sp = Span(
            name=name,
            t0=t0,
            t1=t1,
            cat=cat,
            tag=tag,
            track=track,
            attrs=dict(attrs),
            span_id=next(self._ids),
            parent_id=parent.span_id if parent is not None else None,
            thread=threading.get_ident(),
        )
        self._retain(sp)
        return sp

    def event(self, name: str, *, cat: str = "instant",
              tag: Optional[str] = None, track: Optional[str] = None,
              **attrs: Any) -> Optional[Span]:
        """Instant event (zero-duration span, cat='instant' by default)."""
        if not self.enabled:
            return None
        now = time.perf_counter()
        return self.add_span(
            name, now, now, cat=cat, tag=tag, track=track,
            parent=self.current(), **attrs,
        )

    def _retain(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.dropped += 1
            else:
                self.spans.append(span)

    # -- inspection -------------------------------------------------------
    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self.spans)

    def find(self, name: Optional[str] = None, *, cat: Optional[str] = None,
             tag: Optional[str] = None) -> List[Span]:
        """Completed spans filtered by name/cat/tag (tests, derivations)."""
        out = []
        for sp in self.snapshot():
            if name is not None and sp.name != name:
                continue
            if cat is not None and sp.cat != cat:
                continue
            if tag is not None and sp.tag != tag:
                continue
            out.append(sp)
        return out

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.dropped = 0
        self.epoch = time.perf_counter()


_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The process-global tracer (disabled until :func:`configure`)."""
    return _GLOBAL


def configure(
    enabled: Optional[bool] = None,
    *,
    profiler_annotations: Optional[bool] = None,
    max_spans: Optional[int] = None,
) -> Tracer:
    """Reconfigure the global tracer in place (identity is stable so
    modules may cache ``get_tracer()`` safely)."""
    if enabled is not None:
        _GLOBAL.enabled = enabled
    if profiler_annotations is not None:
        _GLOBAL.profiler_annotations = profiler_annotations
    if max_spans is not None:
        _GLOBAL.max_spans = max_spans
    return _GLOBAL


def reset_tracing() -> None:
    """Drop recorded spans and rebase the epoch (test isolation)."""
    _GLOBAL.clear()
