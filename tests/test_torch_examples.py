"""The port's examples (``repro_torch.examples``) and ``repro_torch.configs.stark``, on the CPU.

Each example runs through its ``main`` with ``--device cpu`` at the JAX
example's settings or smaller ones, and holds what the JAX example holds:
quickstart's four routes within 2e-2 of the plain product, train_e2e's
falling loss, the distributed strategies' errors, and serve's requests
ending by length or eviction. Without a GPU and without ``--device cpu``
each refuses (exit 2). The Stark tables equal ``repro.configs.stark``'s.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import stark as jstark
from repro_torch.configs import stark as tstark
from repro_torch.examples import quickstart, serve, strassen_distributed, train_e2e

EXAMPLES = {"quickstart": quickstart, "serve": serve, "strassen_distributed": strassen_distributed,
            "train_e2e": train_e2e}


def test_stark_tables_equal_the_reference():
    assert tstark.PAPER_SIZES == jstark.PAPER_SIZES
    assert tstark.BENCH_SIZES == jstark.BENCH_SIZES
    assert tstark.PARTITIONS == jstark.PARTITIONS
    assert dataclasses.asdict(tstark.DEFAULT) == dataclasses.asdict(jstark.DEFAULT)
    assert tstark.DEFAULT.partitions == jstark.DEFAULT.partitions == 4
    assert set(tstark.BACKENDS) == set(jstark.BACKENDS)
    for name, want in jstark.BACKENDS.items():
        got = tstark.BACKENDS[name]
        assert (got.kind, got.depth, got.min_dim) == (want.kind, want.depth, want.min_dim), name


@pytest.mark.parametrize("n,depth,scheme", [(4096, 1, "strassen"), (16384, 5, "winograd")])
def test_stark_workload_matches_the_reference(n, depth, scheme):
    got, want = tstark.StarkWorkload(n, depth, scheme), jstark.StarkWorkload(n, depth, scheme)
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and got.partitions == want.partitions


def test_quickstart_routes_on_cpu(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert all(f"{name:9s} max|err|" in out for name in ("serial", "bfs", "backend", "winograd"))
    errs = quickstart.routes(256, "cpu")
    assert set(errs) == {"serial", "bfs", "backend", "winograd"}
    assert max(errs.values()) < quickstart.LIMIT


def test_strassen_distributed_example_on_cpu(capsys):
    assert strassen_distributed.main(["--device", "cpu", "--n", "256"]) == 0
    out = capsys.readouterr().out
    for name in ("bfs_sharded", "strassen_2d", "shardmap(7)"):
        line = next(ln for ln in out.splitlines() if ln.startswith(name))
        assert float(line.split("=")[1]) < 1e-3, line
    assert "psum          over mult" in out  # the 7-way level's one collective
    assert "collective bytes (bfs_sharded): logical" in out


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "phi4_mini_3_8b", "xlstm_1_3b", "whisper_tiny"])
def test_serve_example_on_cpu(arch, capsys):
    assert serve.main(["--device", "cpu", "--arch", arch, "--new-tokens", "8"]) == 0
    out = capsys.readouterr().out
    if arch == "whisper_tiny":
        assert "generated (4, 8)" in out
        return
    reasons = [ln.split("reason=")[1].split()[0] for ln in out.splitlines() if ln.startswith("req ")]
    assert len(reasons) == 5 and set(reasons) <= {"length", "evicted"}
    assert "pool: 0 pages in use" in out


@pytest.mark.parametrize("backend", ["naive", "strassen"])
def test_train_e2e_ci_loss_falls_on_cpu(backend, tmp_path):
    out = tmp_path / "run.json"
    assert train_e2e.main(["--ci", "--steps", "12", "--batch", "2", "--seq", "32", "--device", "cpu",
                           "--backend", backend, "--out", str(out)]) == 0
    summary = json.loads(out.read_text())
    assert summary["config"] == "repro-8m" and summary["backend"] == backend
    assert len(summary["loss"]) == 12 and summary["loss"][-1] < summary["loss"][0]


def test_train_e2e_configs_match_the_reference():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "train_e2e.py"
    spec = importlib.util.spec_from_file_location("jax_train_e2e", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for name in ("FULL_100M", "CI_8M"):
        got, want = getattr(train_e2e, name), getattr(ref, name)
        fields = {f.name for f in dataclasses.fields(got)} & {f.name for f in dataclasses.fields(want)}
        assert {f: getattr(got, f) for f in fields if f != "matmul_backend"} == \
            {f: getattr(want, f) for f in fields if f != "matmul_backend"}, name
        assert got.param_count() == want.param_count()


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_examples_refuse_without_a_gpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert EXAMPLES[name].main([]) == 2
