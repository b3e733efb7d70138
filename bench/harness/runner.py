"""One run of one cell: set-up, window, trace, comparison and the result line.

:func:`run_cell` looks the cell up, hands it to its traffic's driver
(``harness/<kind>.py``, whose ``run(run)`` returns an :class:`Outcome`),
reads the per-layer metrics from the trace when ``trace`` is set, checks
that no JAX module was loaded, and returns the result object whose JSON is
the run's last line. The driver marks the end of set-up with
:meth:`Run.window_opens`; ``setup_s`` runs from the process's start
(``t_start``) to that mark.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch

from harness import cost, peaks, spec
from harness.trace import Digest

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    setup_s: Optional[float] = None

    def window_opens(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start
        self.mallocs = self.device_mallocs()

    def device_mallocs(self) -> int:
        """The caching allocator's cudaMalloc calls so far."""
        return torch.cuda.memory_stats(self.device).get("num_device_alloc", 0) if self.cuda else 0

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]  # name -> (value, limit)
    memory_peak_bytes: int
    digest: Optional[Digest] = None
    facts: dict = dataclasses.field(default_factory=dict)  # counts the readers use


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def passes(value: float, limit: float) -> bool:
    return math.isfinite(value) and value <= limit


def print_attribution(dg: Digest, top: int = 16) -> None:
    """Device seconds by launching CPU op, its first two input shapes and the
    annotated ranges around the launch, on standard error."""
    groups: Dict[tuple, list] = {}
    for op in dg.ops:
        key = (op.cpu_op or op.name[:60], op.shapes[:2], tuple(sorted(op.spans)))
        g = groups.setdefault(key, [0.0, 0])
        g[0] += op.dur_ns / 1e9
        g[1] += 1
    print(f"trace: {len(dg.ops)} device ops, busy {dg.busy_s!r} s of {dg.window_s!r} s",
          file=sys.stderr)
    for (name, shapes, spans), (secs, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"trace: {secs!r} s in {n} ops under {name} {list(shapes)} {list(spans)}",
              file=sys.stderr)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, bench: Path = spec.BENCH) -> Optional[dict]:
    """The result object of one run, or None when a forbidden module was loaded."""
    cell = spec.cell(root, workload, bench)
    run = Run(cell, seed, seconds, trace, torch.device(device), t_start)
    driver = importlib.import_module(f"harness.{cell.traffic['kind']}")
    out: Outcome = driver.run(run)
    facts = out.facts
    print(f"setup {run.setup_s!r} s, window {facts.get('window_s')!r} s, reference "
          f"{facts.get('reference_s')!r} s, peak {out.memory_peak_bytes} bytes", file=sys.stderr)
    if "setup_phases" in facts:
        phases = ", ".join(f"{k} {v:.3f}" for k, v in facts["setup_phases"].items())
        print(f"setup phases (s): {phases}", file=sys.stderr)
    if "step_s" in facts:
        print("window steps (s): " + " ".join(f"{s:.4f}" for s in facts["step_s"]), file=sys.stderr)
    if run.cuda:
        stats = torch.cuda.memory_stats(run.device)
        print(f"allocator: {stats.get('num_alloc_retries', 0)} alloc retries, "
              f"{stats.get('num_device_alloc', 0)} cudaMalloc calls, "
              f"{facts.get('window_mallocs')} of them in the window", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in the measuring process: {found}", file=sys.stderr)
        return None

    if trace and out.digest is not None:
        print_attribution(out.digest)
    if trace:
        ctx = SimpleNamespace(cell=cell, digest=out.digest, facts=out.facts, cost=cost, peaks=peaks)
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(bench, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**out.end_to_end, "setup_s": run.setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {
        "platform": "gpu" if run.cuda else device,
        "kind": torch.cuda.get_device_name(run.device) if run.cuda else device,
        "count": cell.chips,
        "memory_peak_bytes": out.memory_peak_bytes,
    }
    if trace and out.digest is not None:
        dev["busy_s"] = out.digest.busy_s
        dev["window_s"] = out.digest.window_s
    if run.cuda:
        dev["power"] = peaks.power_limit()
    correct = out.failed == 0 and all(passes(v, lim) for v, lim in out.checks.values())
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace and out.digest is not None:
        result["breakdown"] = out.digest.breakdown
    result["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in out.checks.items()}
    return result
