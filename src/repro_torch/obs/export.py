"""Trace exporters: Chrome/Perfetto ``trace_event`` JSON and JSONL.

The port of :mod:`repro.obs.export` over the port's tracer and metrics; the
``jax.profiler`` passthrough becomes :func:`start_profiler_trace` /
:func:`stop_profiler_trace` on ``torch.profiler``.

The Chrome writer emits complete (``ph: "X"``) events with
microsecond ``ts``/``dur`` rebased to the tracer epoch. Lanes: spans
with an explicit ``track`` share a synthetic tid per track name (this
is how the async wave pipeline's stage / compute / fetch phases render
as concurrent tracks); untracked spans get a lane per OS thread.
``thread_name`` metadata events label every lane, and span tags (the
paper's base-7 / base-4 addresses) are folded into the event name so
Perfetto's flame view reads as the recursion tree.

``validate_trace`` is the schema checker the tests share;
``python -m repro_torch.obs.export trace.json ...`` runs it from the
command line (non-zero exit if any file is bad).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Union

import torch

from repro_torch.obs.metrics import Metrics
from repro_torch.obs.tracer import Tracer, get_tracer

__all__ = [
    "trace_events",
    "to_chrome_trace",
    "write_trace",
    "write_jsonl",
    "validate_trace",
    "start_profiler_trace",
    "stop_profiler_trace",
]

PID = 1  # single-process repro: one constant Chrome pid


def _lanes(tracer: Tracer) -> Dict[Any, int]:
    """Stable lane (tid) assignment: named tracks first, then threads."""
    lanes: Dict[Any, int] = {}
    for sp in tracer.snapshot():
        key = sp.track if sp.track is not None else ("thread", sp.thread)
        if key not in lanes:
            lanes[key] = len(lanes) + 1
    return lanes


def trace_events(tracer: Optional[Tracer] = None) -> List[Dict[str, Any]]:
    """Tracer spans as a Chrome ``traceEvents`` list."""
    tracer = tracer or get_tracer()
    lanes = _lanes(tracer)
    events: List[Dict[str, Any]] = []
    for key, tid in lanes.items():
        label = key if isinstance(key, str) else f"thread-{key[1]}"
        events.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": PID,
                "tid": tid,
                "ts": 0,
                "args": {"name": label},
            }
        )
    for sp in tracer.snapshot():
        if sp.t1 is None:
            continue
        key = sp.track if sp.track is not None else ("thread", sp.thread)
        args: Dict[str, Any] = dict(sp.attrs)
        if sp.tag is not None:
            args["tag"] = sp.tag
        ev = {
            "name": f"{sp.name} [{sp.tag}]" if sp.tag is not None else sp.name,
            "cat": sp.cat,
            "ph": "X",
            "ts": max(0.0, (sp.t0 - tracer.epoch) * 1e6),
            "dur": max(0.0, (sp.t1 - sp.t0) * 1e6),
            "pid": PID,
            "tid": lanes[key],
            "args": args,
        }
        events.append(ev)
    return events


def to_chrome_trace(
    tracer: Optional[Tracer] = None, metrics: Optional[Metrics] = None
) -> Dict[str, Any]:
    """Full Chrome/Perfetto JSON object; metrics ride in ``otherData``, and
    so does ``clock``: ``ts`` 0 (the tracer's epoch) read on the
    ``torch.profiler`` clock, in Unix-epoch nanoseconds, so that an event's
    ``ts`` in µs maps to ``profiler_ns_at_ts_0 + 1000 * ts`` there."""
    tracer = tracer or get_tracer()
    doc: Dict[str, Any] = {
        "traceEvents": trace_events(tracer),
        "displayTimeUnit": "ms",
    }
    other: Dict[str, Any] = {
        "dropped_spans": tracer.dropped,
        # ts 0 on torch.profiler's clock, so the spans lay over a device trace
        "clock": {"profiler_ns_at_ts_0": tracer.profiler_epoch_ns},
    }
    if metrics is not None:
        other["metrics"] = metrics.snapshot()
    doc["otherData"] = other
    return doc


def write_trace(
    path: str,
    tracer: Optional[Tracer] = None,
    metrics: Optional[Metrics] = None,
) -> str:
    """Write the Chrome/Perfetto JSON trace to ``path``."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tracer, metrics), f)
    return path


def write_jsonl(path: str, tracer: Optional[Tracer] = None) -> str:
    """One JSON object per span (append-friendly event log)."""
    tracer = tracer or get_tracer()
    with open(path, "w") as f:
        for sp in tracer.snapshot():
            if sp.t1 is None:
                continue
            f.write(
                json.dumps(
                    {
                        "name": sp.name,
                        "cat": sp.cat,
                        "tag": sp.tag,
                        "track": sp.track,
                        "t0": sp.t0 - tracer.epoch,
                        "dur": sp.t1 - sp.t0,
                        "span_id": sp.span_id,
                        "parent_id": sp.parent_id,
                        "attrs": sp.attrs,
                    }
                )
                + "\n"
            )
    return path


def validate_trace(source: Union[str, Dict[str, Any]]) -> List[str]:
    """Perfetto-loadability check; returns a list of problems (empty =
    valid). ``source`` is a path or an already-loaded trace object."""
    errors: List[str] = []
    if isinstance(source, str):
        try:
            with open(source) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return [f"unreadable trace: {e}"]
    else:
        doc = source
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        return ["no traceEvents array"]
    if not events:
        errors.append("empty traceEvents")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        for field in ("ph", "name", "pid", "tid"):
            if field not in ev:
                errors.append(f"event {i} ({ev.get('name', '?')}): missing {field!r}")
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "M", "i", "I", "C", "b", "e"):
            errors.append(f"event {i}: unknown ph {ph!r}")
        if ph != "M" and "ts" not in ev:
            errors.append(f"event {i} ({ev.get('name', '?')}): missing 'ts'")
        if ph == "X":
            if "dur" not in ev:
                errors.append(f"event {i} ({ev.get('name', '?')}): X without 'dur'")
            elif not (
                isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0
            ):
                errors.append(f"event {i}: bad dur {ev['dur']!r}")
        ts = ev.get("ts")
        if ts is not None and not isinstance(ts, (int, float)):
            errors.append(f"event {i}: non-numeric ts {ts!r}")
    return errors


# -- torch.profiler passthrough -------------------------------------------

_PROFILER = None  # the running torch.profiler, if any


def start_profiler_trace(logdir: str) -> bool:
    """Start a ``torch.profiler`` trace (host ops, and CUDA kernels where a
    card is present) alongside obs spans; :func:`stop_profiler_trace` writes
    it into ``logdir`` as a Chrome trace. Best-effort: returns False when a
    profiler is already running or cannot start."""
    global _PROFILER
    if _PROFILER is not None:
        return False
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    )
    try:
        prof.start()
    except RuntimeError:
        return False
    _PROFILER = prof
    return True


def stop_profiler_trace() -> bool:
    """Stop the profiler :func:`start_profiler_trace` started and write its
    trace; False when none is running."""
    global _PROFILER
    if _PROFILER is None:
        return False
    prof, _PROFILER = _PROFILER, None
    prof.stop()
    return True


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Validate Chrome/Perfetto trace JSON files"
    )
    ap.add_argument("paths", nargs="+", help="trace JSON files to check")
    args = ap.parse_args(argv)
    rc = 0
    for path in args.paths:
        errs = validate_trace(path)
        if errs:
            rc = 1
            print(f"{path}: INVALID")
            for e in errs[:20]:
                print(f"  - {e}")
        else:
            with open(path) as f:
                n = len(json.load(f).get("traceEvents", []))
            print(f"{path}: ok ({n} events)")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
