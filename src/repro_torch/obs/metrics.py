"""Process-local counters, gauges, and fixed-bucket histograms.

A copy of :mod:`repro.obs.metrics`; nothing in it depends on the framework.

The registry is deliberately small: named instruments created on first
use, a ``snapshot()`` that returns plain dicts (JSON-able, embeddable
in ``Engine.stats()["obs"]`` and benchmark reports), and a lock per
instrument so concurrent engines / scheduler threads can record safely.

Histograms use Prometheus ``le`` semantics — a value lands in the
first bucket whose upper bound is **>= v** (boundary values belong to
the bucket they bound). Alongside the fixed buckets each histogram
keeps a bounded reservoir of raw samples; while the reservoir has not
overflowed, ``percentile()`` is exact and matches
``numpy.percentile(..., interpolation="linear")`` bit-for-bit — that
is what lets ``benchmarks/serve_load.py`` gate its obs-derived
TTFT/TPOT percentiles against per-request ``latency_stats()``.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Metrics",
    "get_metrics",
    "reset_metrics",
    "TIME_BUCKETS_S",
    "BYTES_BUCKETS",
]

# Exponential upper bounds covering 10 µs .. 100 s — wide enough for
# TTFT on CPU smoke runs and for full out-of-core wave times.
TIME_BUCKETS_S: Tuple[float, ...] = tuple(
    round(10.0 ** (e / 2.0), 10) for e in range(-10, 5)
)

# Power-of-4 byte buckets: 1 KiB .. 16 GiB.
BYTES_BUCKETS: Tuple[float, ...] = tuple(float(1 << s) for s in range(10, 35, 2))


class Counter:
    """Monotonic accumulator."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge:
    """Last-write value, plus the high-water mark since reset."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0
        self._max = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            if v > self._max:
                self._max = float(v)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"value": self._value, "max": self._max}

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0
            self._max = 0.0


class Histogram:
    """Fixed-bucket histogram with an exact-percentile reservoir.

    ``bounds`` are the buckets' inclusive upper edges; an implicit
    +inf bucket catches the overflow. The raw-sample reservoir (capped
    at ``max_samples``) keeps percentiles exact for bounded runs; once
    it overflows, ``percentile()`` degrades to linear interpolation
    inside the matched bucket and ``snapshot()["exact"]`` flips False.
    """

    def __init__(
        self,
        name: str,
        bounds: Sequence[float] = TIME_BUCKETS_S,
        max_samples: int = 4096,
    ):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"histogram {name!r}: bounds must be sorted, non-empty")
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        self.max_samples = max_samples
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._samples: List[float] = []
        self._overflowed = False

    def record(self, v: float) -> None:
        v = float(v)
        with self._lock:
            # le semantics: first bound >= v gets the observation, so a
            # value sitting exactly on a boundary lands in the bucket it
            # bounds (bisect_left, not bisect_right).
            self._counts[bisect.bisect_left(self.bounds, v)] += 1
            self._sum += v
            self._count += 1
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            if len(self._samples) < self.max_samples:
                self._samples.append(v)
            else:
                self._overflowed = True

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100]. Exact (numpy 'linear' method) while the
        reservoir holds every observation; bucket-interpolated after."""
        with self._lock:
            if self._count == 0:
                return None
            if not self._overflowed:
                xs = sorted(self._samples)
                rank = (q / 100.0) * (len(xs) - 1)
                lo = int(math.floor(rank))
                hi = min(lo + 1, len(xs) - 1)
                frac = rank - lo
                return xs[lo] + (xs[hi] - xs[lo]) * frac
            return self._bucket_percentile(q)

    def _bucket_percentile(self, q: float) -> float:
        target = (q / 100.0) * self._count
        cum = 0
        for i, c in enumerate(self._counts):
            if cum + c >= target and c > 0:
                lo = self.bounds[i - 1] if i > 0 else (self._min or 0.0)
                hi = self.bounds[i] if i < len(self.bounds) else (self._max or lo)
                frac = (target - cum) / c
                return lo + (hi - lo) * frac
            cum += c
        return self._max or 0.0

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
            lo, hi = self._min, self._max
            exact = not self._overflowed
        out: Dict[str, Any] = {
            "count": count,
            "sum": total,
            "mean": (total / count) if count else None,
            "min": lo,
            "max": hi,
            "buckets": [
                {"le": b, "count": c} for b, c in zip(self.bounds, counts)
            ]
            + [{"le": "inf", "count": counts[-1]}],
            "exact": exact,
        }
        for q in (50, 90, 99):
            out[f"p{q}"] = self.percentile(q)
        return out

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._count = 0
            self._min = self._max = None
            self._samples = []
            self._overflowed = False


class Metrics:
    """Named-instrument registry. Engines own a private instance for
    per-engine series; module-level code shares :func:`get_metrics`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(
        self,
        name: str,
        bounds: Sequence[float] = TIME_BUCKETS_S,
        max_samples: int = 4096,
    ) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, bounds, max_samples)
            return h

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.snapshot() for k, c in counters.items()},
            "gauges": {k: g.snapshot() for k, g in gauges.items()},
            "histograms": {k: h.snapshot() for k, h in histograms.items()},
        }

    def reset(self) -> None:
        with self._lock:
            instruments = (
                list(self._counters.values())
                + list(self._gauges.values())
                + list(self._histograms.values())
            )
        for inst in instruments:
            inst.reset()


_GLOBAL = Metrics()


def get_metrics() -> Metrics:
    """The process-global registry (scheduler / autotune series)."""
    return _GLOBAL


def reset_metrics() -> None:
    _GLOBAL.reset()
