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

**One clock with the profiler.** ``perf_counter`` stays the clock of
durations, but ``torch.profiler`` stamps its events in Unix-epoch
nanoseconds (``time.time_ns()``'s clock). Beside :attr:`Tracer.epoch` the
tracer keeps :attr:`Tracer.profiler_epoch_ns`, the Unix clock's reading at
the same instant: of several back-to-back (perf_counter, time_ns,
perf_counter) samples, the one whose two perf_counter reads lie closest
together, with the epoch at their midpoint. :meth:`Tracer.to_profiler_ns`
maps any span time onto a device trace's timeline, spans recorded with
:meth:`Tracer.add_span` included, which open no profiler range.

**Spans across threads.** Nesting is per thread: a span's parent is the
innermost span open on the thread that opens it, unless ``parent=`` names
another, as a span opened on autograd's device thread names the training
step's span on the caller's. A span may be closed on another thread than
its own; :meth:`Tracer.end` pops it from the stack of the thread that
opened it.
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

            t = time.perf_counter()
            self._profiler_ctx = record_function(self._span.name)
            self._profiler_ctx.__enter__()
            # The range is stamped partway through its enter, which takes
            # tens of µs on a busy host (and near the end of its exit, after
            # which ``end`` stamps t1): the midpoint lays the span over it.
            self._span.t0 = (t + time.perf_counter()) / 2
        return self._span

    def __exit__(self, *exc: Any) -> bool:
        if self._profiler_ctx is not None:
            self._profiler_ctx.__exit__(*exc)
        self._tracer.end(self._span)
        return False


def _clock_pair(samples: int = 8) -> "tuple[float, int]":
    """(perf_counter seconds, Unix ns) read at one instant: the tightest of
    ``samples`` (perf_counter, time_ns, perf_counter) reads, at the
    midpoint of its two perf_counter reads."""
    best = None
    for _ in range(samples):
        a = time.perf_counter()
        unix_ns = time.time_ns()
        b = time.perf_counter()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) / 2, unix_ns)
    return best[1], best[2]


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
        self.epoch, self.profiler_epoch_ns = _clock_pair()
        self.spans: List[Span] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._stacks: Dict[int, List[Span]] = {}  # thread ident -> open spans

    # -- clock ------------------------------------------------------------
    def to_profiler_ns(self, t: float) -> int:
        """A perf_counter time (a span's ``t0`` or ``t1``) on the clock of
        ``torch.profiler``'s events: Unix-epoch nanoseconds."""
        return self.profiler_epoch_ns + round((t - self.epoch) * 1e9)

    # -- nesting ----------------------------------------------------------
    def _stack(self) -> List[Span]:
        return self._stacks.setdefault(threading.get_ident(), [])

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
        parent: Optional[Span] = None,
        **attrs: Any,
    ) -> Span:
        """Open a span. Always returns a timed Span (duration is valid
        even when disabled); it is only retained when enabled. Its parent
        is ``parent`` when given, else the innermost span open on this
        thread."""
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
            if parent is not None:
                sp.parent_id = parent.span_id or None
            elif st:
                sp.parent_id = st[-1].span_id
            st.append(sp)
        return sp

    def end(self, span: Optional[Span], **attrs: Any) -> Optional[Span]:
        """Close ``span``, on any thread. Tolerates exception unwinding:
        pops the opening thread's stack down through ``span`` if children
        were left open."""
        if span is None or isinstance(span, _NullSpan):
            return None
        span.t1 = time.perf_counter()
        if attrs:
            span.attrs.update(attrs)
        if self.enabled and span.span_id:
            st = self._stacks.get(span.thread, [])
            for i in range(len(st) - 1, -1, -1):
                if st[i] is span:
                    del st[i:]
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
        parent: Optional[Span] = None,
        **attrs: Any,
    ):
        """``with tracer.span("name"): ...`` — no-op singleton when
        disabled (the zero-allocation fast path)."""
        if not self.enabled:
            return NULL_SPAN
        return _SpanContext(
            self, self.begin(name, cat=cat, tag=tag, track=track, parent=parent, **attrs)
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
        self.epoch, self.profiler_epoch_ns = _clock_pair()


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
    """Drop recorded spans and rebase the epoch and its profiler-clock
    reading (test isolation)."""
    _GLOBAL.clear()
