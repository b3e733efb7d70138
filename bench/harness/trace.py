"""The traced part of a run: a device trace and what the metric readers read.

:class:`Profile` records a short steady part of a run with the PyTorch
profiler's low-level interface (CPU ops with their input shapes, the CUDA
kernels, copies and sets). Its raw events are read directly: no
``FunctionEvent`` tree is built, which for a training step took minutes.
:func:`digest` turns them into :class:`Digest`:

- each device op, with the innermost CPU op that launched it (its name and
  input shapes) and the names of the annotated ranges around that launch
  (the benchmark's own ``bench.*`` ranges and the program's tracer spans,
  which open ``record_function`` ranges while profiling);
- the device's busy seconds (the union of its ops' intervals) and the
  traced window's length, from a pass that profiles the device alone
  (:func:`traced`), since recording every host op slows the host;
- the breakdown: the device ops that took most time, and the longest idle
  gaps named by the CPU op the host was in.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_RUNTIME_PREFIXES = ("cuda", "cu", "nccl")


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    cpu_op: str  # the innermost CPU op that launched it, "" when unknown
    shapes: Tuple[Tuple[int, ...], ...]  # that op's input shapes
    spans: frozenset  # the annotated ranges around the launch


@dataclasses.dataclass
class Digest:
    ops: List[DeviceOp]
    window_s: float
    busy_s: float
    breakdown: dict

    def time_s(self, pred) -> float:
        """The summed device seconds of the ops for which ``pred(op)`` holds."""
        return sum(op.dur_ns for op in self.ops if pred(op)) / 1e9


class Profile:
    """A context that profiles its body: CPU ops (with their input shapes
    when ``shapes``) when ``cpu``, the device's ops when ``cuda``;
    ``events`` and ``window_s`` are set when it closes."""

    def __init__(self, cuda: bool, cpu: bool = True, shapes: bool = False):
        self.cuda, self.cpu, self.shapes = cuda, cpu, shapes
        self.events: list = []
        self.window_s = 0.0

    def __enter__(self):
        from torch.autograd import (ProfilerActivity, ProfilerConfig, ProfilerState,
                                    _disable_profiler, _enable_profiler, _prepare_profiler)
        from torch._C._profiler import _ExperimentalConfig

        self._disable = _disable_profiler
        self._acts = (({ProfilerActivity.CPU} if self.cpu else set())
                      | ({ProfilerActivity.CUDA} if self.cuda else set()))
        if self._acts:
            cfg = ProfilerConfig(ProfilerState.KINETO, self.shapes, False, False, False, False,
                                 _ExperimentalConfig())
            _prepare_profiler(cfg, self._acts)
        self._sync()
        if self._acts:
            _enable_profiler(cfg, self._acts)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        if self._acts:
            self.events = list(self._disable().events())
        return False

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()


def traced(body, cuda: bool, shapes: bool) -> "Digest":
    """Run ``body()`` twice, first under a profile of the device alone, whose
    light touch leaves the host's pace as it is (the busy and window
    seconds and the device ops by time), then under a full profile of the
    host's ops too (each device op's launching op and spans, and the idle
    gaps named by the host's op)."""
    with Profile(cuda, cpu=False) as timeline:
        body()
    with Profile(cuda, cpu=True, shapes=shapes) as full:
        body()
    t, f = digest(timeline), digest(full)
    return Digest(ops=f.ops, window_s=t.window_s, busy_s=t.busy_s,
                  breakdown={"device_ops": t.breakdown["device_ops"],
                             "idle_gaps": f.breakdown["idle_gaps"]})


def _is_device(evt) -> bool:
    return evt.device_type() != torch.autograd.DeviceType.CPU


def _is_annotation(evt) -> bool:
    return bool(getattr(evt, "is_user_annotation", lambda: False)())


def _short(name: str, width: int = 96) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."


def _union_ns(intervals: Sequence[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """The covered length of ``intervals`` and the gaps between them."""
    total, gaps, end = 0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total, gaps


def _stab(ranges: Dict[int, List[Tuple[int, int, str]]],
          points: List[Optional[Tuple[int, int]]]) -> List[frozenset]:
    """For each (thread, time) point, the names of that thread's ranges that
    hold it: one sweep over the sorted range ends and points."""
    out: List[frozenset] = [frozenset()] * len(points)
    by_thread: Dict[int, list] = {}
    for tid, rs in ranges.items():
        by_thread.setdefault(tid, []).extend(
            [(s, 0, n) for s, _, n in rs] + [(e, 2, n) for _, e, n in rs])
    for i, p in enumerate(points):
        if p is not None and p[0] in by_thread:
            by_thread[p[0]].append((p[1], 1, i))
    for items in by_thread.values():
        active: Dict[str, int] = {}
        for _, kind, what in sorted(items, key=lambda x: (x[0], x[1])):
            if kind == 0:
                active[what] = active.get(what, 0) + 1
            elif kind == 2:
                active[what] -= 1
            else:
                out[what] = frozenset(n for n, c in active.items() if c > 0)
    return out


def digest(prof: Profile, top: int = 10) -> Digest:
    """The device ops of a :class:`Profile` with their launching CPU ops,
    busy and window seconds, and the breakdown."""
    cpu_by_id: Dict[int, object] = {}
    runtime: Dict[int, Tuple[int, int]] = {}  # correlation id -> (thread, start)
    ranges: Dict[int, List[Tuple[int, int, str]]] = {}  # thread -> annotated ranges
    host: List[Tuple[int, int, str]] = []  # (start, end, name) of CPU ops
    device = []
    for e in prof.events:
        name, annotation = e.name(), _is_annotation(e)
        if _is_device(e):
            if not annotation and e.duration_ns() > 0:
                device.append((name, e.start_ns(), e.duration_ns(), e.correlation_id(),
                               e.linked_correlation_id()))
            continue
        tid, start, end = e.start_thread_id(), e.start_ns(), e.end_ns()
        cpu_by_id[e.correlation_id()] = e
        if annotation:
            ranges.setdefault(tid, []).append((start, end, name))
        elif name.startswith(_RUNTIME_PREFIXES):
            runtime[e.correlation_id()] = (tid, start)
        else:
            host.append((start, end, name))

    parents, anchors = [], []
    for name, start, dur, corr, linked in device:
        parent = cpu_by_id.get(linked)
        anchors.append(runtime.get(corr) or (
            (parent.start_thread_id(), parent.start_ns()) if parent is not None else None))
        parents.append(parent)
    spans = _stab(ranges, anchors)

    ops: List[DeviceOp] = []
    for (name, start, dur, _, _), parent, held in zip(device, parents, spans):
        if parent is not None and _is_annotation(parent):
            held |= {parent.name()}
            parent = None
        ops.append(DeviceOp(
            name=name, start_ns=start, dur_ns=dur,
            cpu_op=parent.name() if parent is not None else "",
            shapes=tuple(tuple(s) for s in parent.shapes()) if parent is not None else (),
            spans=held))

    busy_ns, gaps = _union_ns([(o.start_ns, o.start_ns + o.dur_ns) for o in ops])
    per_name: Dict[str, float] = {}
    for o in ops:
        per_name[_short(o.name)] = per_name.get(_short(o.name), 0.0) + o.dur_ns / 1e9
    # Name each idle gap by the innermost host op running at its middle: going
    # back from the last op to start before it, the first that still runs.
    host.sort()
    starts = [h[0] for h in host]
    per_gap: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid, name = (g0 + g1) // 2, "host outside any op"
        hi = bisect.bisect_right(starts, mid)
        for i in range(hi - 1, max(hi - 256, 0) - 1, -1):
            if host[i][1] >= mid:
                name = host[i][2]
                break
        per_gap[name] = per_gap.get(name, 0.0) + (g1 - g0) / 1e9
    breakdown = {
        "device_ops": [[n, s] for n, s in sorted(per_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, s] for n, s in sorted(per_gap.items(), key=lambda kv: -kv[1])[:top]],
    }
    return Digest(ops=ops, window_s=prof.window_s, busy_s=busy_ns / 1e9, breakdown=breakdown)
