"""The harness end to end on the CPU at a tiny size, on the program's plain
path: the last line's keys, the metrics each cell reports, a cell and a
metric added only as files and entries, and the command's refusal without
a card."""
import json
import os
import subprocess
import sys
import time

import pytest

from conftest import BENCH, CELLS, ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", [c[0] for c in CELLS])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(run_tiny, workload, trace):
    out = run_tiny(workload, trace)
    keys = list(out)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"], name
    json.dumps(out)
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
        # On the CPU only the host clock's per-layer metrics have something to read.
        mfu = "multiply_mfu" if workload.startswith("t.mm") else "train_mfu"
        assert set(out["metrics"]) == {mfu}
    else:
        e2e = "multiply_tflops" if workload.startswith("t.mm") else "train_tokens_per_s"
        assert set(out["metrics"]) == {e2e, "setup_s"}
        assert all(m["value"] > 0 for m in out["metrics"].values())


def test_same_seed_same_inputs():
    import torch

    from harness import multiply, train
    from conftest import LM, MM, TRAFFIC

    a1, b1 = multiply.operands(MM, TRAFFIC["mm.fp32"], 2**31 + 5, "cpu")
    a2, b2 = multiply.operands(MM, TRAFFIC["mm.fp32"], 2**31 + 5, "cpu")
    a3, _ = multiply.operands(MM, TRAFFIC["mm.fp32"], 2**31 + 6, "cpu")
    assert torch.equal(a1, a2) and torch.equal(b1, b2) and not torch.equal(a1, a3)
    w1 = train.weights(LM["model"], 2**33, "cpu")
    w2 = train.weights(LM["model"], 2**33, "cpu")
    assert all(torch.equal(w1[n], w2[n]) for n in w1)
    f = [train.feed(TRAFFIC["tr.acc2"], 128, 2**33, s, "cpu")["tokens"] for s in (1, 1, 2)]
    assert torch.equal(f[0], f[1]) and not torch.equal(f[0], f[2])
    assert len({tuple(r.tolist()) for r in torch.cat([f[0], f[2]])}) == 8  # every row differs


def test_added_cell_and_metric_are_picked_up(tiny_root):
    """A new traffic mix, limits, cell and per-layer metric, added as files and
    BENCHMARK.json entries only."""
    from harness import runner

    bench = tiny_root / "bench"
    (bench / "traffic" / "mm.fp32.pool3.json").write_text(json.dumps(
        {"kind": "multiply", "dtype": "float32", "pool": 3, "samples": 2, "trace_multiplies": 1}))
    (bench / "limits" / "t.mm.new.json").write_text(json.dumps({"rel_fro": 5e-5}))
    (bench / "metrics" / "multiplies_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.facts['traced_multiplies'])\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "t.mm.new", "config": "mm-64", "traffic": "mm.fp32.pool3",
                              "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append("t.mm.new")
    spec["per_layer"].append({"name": "multiplies_traced", "unit": "count", "better": "higher",
                              "source": "program_counter", "layer": "whole multiply",
                              "moves": "multiply_tflops", "workloads": ["t.mm.new"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = runner.run_cell(tiny_root, "t.mm.new", 9, 0.2, True, "cpu", time.perf_counter(),
                          bench=bench)
    assert out["correct"] and out["metrics"]["multiplies_traced"]["value"] == 1.0
    assert "multiply.leaf_roofline" not in out["metrics"]  # that metric lists its cells
    out = runner.run_cell(tiny_root, "t.mm.new", 9, 0.2, False, "cpu", time.perf_counter(),
                          bench=bench)
    assert set(out["metrics"]) == {"multiply_tflops", "setup_s"}


def test_command_refuses_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "stark16k.fp32",
                           "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""


def test_forbidden_module_refuses(run_tiny, monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run_tiny("t.mm.fp32") is None
