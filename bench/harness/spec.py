"""``BENCHMARK.json`` and the files each of its names points to.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one ``configs`` gives it; the traffic mix
is ``bench/traffic/<traffic>.json``, whose ``kind`` names the driver
(``bench/harness/<kind>.py``); the limits of the comparison that decides
``correct`` are ``bench/limits/<workload>.json``; a per-layer metric is
read by ``bench/metrics/<metric>.py``. So a cell or a metric is added as
files and entries, with no edit to any file here.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports when traced
    bench: Path


def load(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def cell(root: Path, name: str, bench: Path = BENCH) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its files read."""
    spec = load(root)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r}; have {sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
        end_to_end=e2e, per_layer=layer, bench=bench)


def reader(bench: Path, metric: str) -> Callable:
    """The ``read(ctx)`` function of ``bench/metrics/<metric>.py``."""
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def derive(seed: int, *labels) -> int:
    """A 63-bit seed for one stream of a run, from ``--seed`` and labels."""
    text = ":".join(str(x) for x in (seed, *labels)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") & (2**63 - 1)
