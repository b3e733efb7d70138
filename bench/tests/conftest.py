"""Tiny cells on the CPU: a BENCHMARK.json and the files it names, in a
temporary root, run through the harness with its look for a chip skipped."""
import json
import shutil
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

MM = {"name": "mm-64", "m": 64, "k": 64, "n": 64, "scheme": "strassen",
      "backend": {"kind": "strassen", "depth": 2, "min_dim": 8, "precision": None}}
LM = {"name": "lm-tiny", "model": {
    "name": "lm-tiny", "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
    "d_ff": 128, "vocab": 128, "act": "silu", "glu": True, "rope_theta": 10000.0, "norm_eps": 1e-6,
    "tie_embeddings": True, "dtype": "float32", "remat": True, "remat_every": 2}}
OPT = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0,
       "warmup_steps": 2, "total_steps": 1000, "min_lr_ratio": 0.1, "moment_dtype": "float32"}
TRAFFIC = {
    "mm.fp32": {"kind": "multiply", "dtype": "float32", "pool": 2, "samples": 3,
                "trace_multiplies": 2},
    "mm.bf16": {"kind": "multiply", "dtype": "bfloat16", "pool": 2, "samples": 3,
                "trace_multiplies": 2},
    "tr.acc2": {"kind": "train", "seq": 16, "micro_batch": 2, "accum_steps": 2, "first_steps": 3,
                "trace_steps": 1, "optimizer": OPT},
    "tr.b2": {"kind": "train", "seq": 16, "micro_batch": 2, "accum_steps": 1, "first_steps": 3,
              "trace_steps": 1, "optimizer": OPT},
}
# The real cells' multiply limits; the fp32 tiny LM's own, far below the
# bf16 cells' since both sides compute in fp32 here.
LIMITS = {
    "t.mm.fp32": json.loads((BENCH / "limits" / "stark16k.fp32.json").read_text()),
    "t.mm.bf16": json.loads((BENCH / "limits" / "stark16k.bf16.json").read_text()),
    "t.tr.acc2": {"loss": 1e-5, "grad1": 1e-4, "change": 1e-3},
    "t.tr.b2": {"loss": 1e-5, "grad1": 1e-4, "change": 1e-3},
}
CELLS = [("t.mm.fp32", "mm-64", "mm.fp32"), ("t.mm.bf16", "mm-64", "mm.bf16"),
         ("t.tr.acc2", "lm-tiny", "tr.acc2"), ("t.tr.b2", "lm-tiny", "tr.b2")]


def make_root(tmp: Path) -> Path:
    """A checkout-like root whose BENCHMARK.json holds the tiny cells with the
    real file's metrics, and whose bench/ holds their files and the real
    metric readers."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp / "bench"
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    for cfg in (MM, LM):
        (bench / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    for name, traffic in TRAFFIC.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for name, lim in LIMITS.items():
        (bench / "limits" / f"{name}.json").write_text(json.dumps(lim))
    spec["configs"] = [{"name": c["name"], "source": "test", "reduced": [], "why": "test",
                        "file": f"bench/configs/{c['name']}.json"} for c in (MM, LM)]
    spec["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
                         for n, c, t in CELLS]
    kinds = {n: TRAFFIC[t]["kind"] for n, _, t in CELLS}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            want = {spec_kind(real, w) for w in m["workloads"]}
            m["workloads"] = [n for n, k in kinds.items() if k in want]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp


def spec_kind(spec: dict, workload: str) -> str:
    traffic = {w["name"]: w["traffic"] for w in spec["workloads"]}[workload]
    return json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())["kind"]


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def run_tiny(tiny_root):
    from harness import runner

    def run(workload: str, trace: bool = False, seed: int = 2**31 + 77, seconds: float = 0.3):
        return runner.run_cell(tiny_root, workload, seed, seconds, trace, "cpu",
                               time.perf_counter(), bench=tiny_root / "bench")
    return run
