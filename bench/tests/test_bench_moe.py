"""Traffic kind ``train_moe`` on the CPU at a tiny size: the driver end to
end through the harness, the half-batch and drop-past-capacity faults
failing the limits, the fp8 control moving the readings, ``cost_moe``'s
counts against hand-worked shapes, and the ``moe.*`` readers on hand-built
digests."""
import json
from types import SimpleNamespace

import pytest
import torch

from conftest import BENCH, OPT, ROOT, make_root
from harness import cost, cost_moe, peaks, spec
from harness.trace import Digest, DeviceOp

REAL = "olmoe.train.s4096b4acc2"
OLMOE = json.loads((BENCH / "configs" / "olmoe-1b-7b.json").read_text())["model"]
# OLMoE's shape at a test size: QK-norm, top-4 of 16 experts unnormalised,
# EP rank 1 of 4 (experts 4-7), fp32 so that both sides agree to round-off.
MOE = {"name": "moe-tiny", "model": {
    **OLMOE, "name": "moe-tiny", "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
    "head_dim": 16, "vocab": 128, "n_experts": 16, "experts_held": 4, "expert_first": 4,
    "top_k": 4, "d_expert": 32, "dtype": "float32", "remat_every": 2}}
TRAFFIC = {"kind": "train_moe", "seq": 16, "micro_batch": 2, "accum_steps": 2, "first_steps": 3,
           "trace_steps": 1, "optimizer": OPT}
# Both sides compute in fp32 here: the tiny dense cells' limits.
LIMITS = {"loss": 1e-5, "grad1": 1e-4, "change": 1e-3}
CELL = "t.moe.acc2"


@pytest.fixture
def moe_root(tmp_path):
    root = make_root(tmp_path)
    bench = root / "bench"
    (bench / "configs" / "moe-tiny.json").write_text(json.dumps(MOE))
    (bench / "traffic" / "trm.acc2.json").write_text(json.dumps(TRAFFIC))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    tiny, real = json.loads((root / "BENCHMARK.json").read_text()), spec.load(ROOT)
    tiny["configs"].append({"name": "moe-tiny", "source": "test", "reduced": [], "why": "test",
                            "file": "bench/configs/moe-tiny.json"})
    tiny["workloads"].append({"name": CELL, "config": "moe-tiny", "traffic": "trm.acc2",
                              "chips": 1, "why": "test"})
    lists = {m["name"]: m.get("workloads", []) for m in real["end_to_end"] + real["per_layer"]}
    for m in tiny["end_to_end"] + tiny["per_layer"]:
        if REAL in lists[m["name"]]:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(tiny))
    return root


def run_moe(root, trace=False, seed=2**31 + 91):
    import time

    from harness import runner

    return runner.run_cell(root, CELL, seed, 0.3, trace, "cpu", time.perf_counter(),
                           bench=root / "bench")


@pytest.mark.parametrize("trace", [False, True])
def test_driver_end_to_end(moe_root, trace):
    out = run_moe(moe_root, trace)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name
    if trace:
        # On the CPU only the host clock's per-layer metrics have something to read.
        assert set(out["metrics"]) == {"moe.train_mfu"}
        assert 0 < out["metrics"]["moe.train_mfu"]["value"] < 100
    else:
        assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_traced_counts_are_the_program_counters(moe_root, monkeypatch):
    """The facts the readers see: the last traced pass's moe.* counters,
    with held + elsewhere = tokens x top_k."""
    from harness import train_moe

    seen = {}
    orig = train_moe.run

    def spy(run):
        out = orig(run)
        seen.update(out.facts)
        return out

    monkeypatch.setattr(train_moe, "run", spy)
    run_moe(moe_root, trace=True)
    counts, m = seen["moe_counts"], MOE["model"]
    # One traced step: 2 micro-batches of 2 x 16 tokens, each layer's forward
    # and (remat) its recompute.
    tokens = TRAFFIC["micro_batch"] * TRAFFIC["seq"] * TRAFFIC["accum_steps"] * m["n_layers"] * 2
    assert counts["moe.tokens_routed"] == tokens
    assert counts["moe.assignments_held"] + counts["moe.assignments_elsewhere"] == tokens * m["top_k"]
    loads = [counts.get(f"moe.expert_load.{e}", 0) for e in range(4, 8)]
    assert sum(loads) == counts["moe.assignments_held"] > 0
    assert not any(n.startswith("moe.expert_load.") and int(n.rsplit(".", 1)[1]) not in range(4, 8)
                   for n in counts)


def test_half_the_batch_left_out_fails(moe_root, monkeypatch):
    import repro_torch.training.train_step as ts

    orig = ts.M.loss_fn

    def half(params, batch, cfg):
        mask = torch.ones(batch["tokens"].shape)
        mask[: max(mask.shape[0] // 2, 1), mask.shape[1] // 2:] = 0.0
        return orig(params, {**batch, "mask": mask}, cfg)

    monkeypatch.setattr(ts.M, "loss_fn", half)
    assert run_moe(moe_root)["correct"] is False


def test_dropping_past_capacity_fails(moe_root, monkeypatch):
    """The program's picks past a capacity factor of 1.25 sent to an expert
    held elsewhere, which drops them from this share: ``correct`` is false."""
    import repro_torch.models.moe as moe
    from reference import moe_lm

    orig, dropped = moe._route, []

    def capped(params, xt, cfg):
        gates, idx, aux = orig(params, xt, cfg)
        keep = moe_lm.keep_within_capacity(idx, cfg.n_experts, 1.25)
        elsewhere = (cfg.expert_first + cfg.held_experts) % cfg.n_experts
        dropped.append(int((~keep & (idx >= 4) & (idx < 8)).sum()))
        return gates, torch.where(keep, idx, elsewhere), aux

    monkeypatch.setattr(moe, "_route", capped)
    assert run_moe(moe_root)["correct"] is False
    assert sum(dropped) > 0


def test_reference_faults_and_control_fail_the_tiny_limits():
    from harness import train_moe

    model, seed = MOE["model"], 2**31 + 17
    want = train_moe.reference_readings(model, TRAFFIC, seed, "cpu")
    same = train_moe.reference_readings(model, TRAFFIC, seed, "cpu")
    assert train_moe.compare(same, want) == {"loss": 0.0, "grad1": 0.0, "change": 0.0}
    drop = train_moe.reference_readings(model, TRAFFIC, seed, "cpu", capacity=1.25)
    assert drop["drop_share"] > 0
    half = train_moe.reference_readings(model, TRAFFIC, seed, "cpu", half_batch=True)
    for low in (drop, half):
        gaps = train_moe.compare(low, want)
        assert any(gaps[n] > LIMITS[n] for n in LIMITS), gaps
    bf16 = {**model, "dtype": "bfloat16"}
    want16 = train_moe.reference_readings(bf16, TRAFFIC, seed, "cpu")
    low = train_moe.reference_readings(bf16, TRAFFIC, seed, "cpu", fp8=True)
    assert train_moe.compare(low, want16)["loss"] > 0.0


def test_model_config_is_the_published_training_variants_share():
    """The driver's ModelConfig of the real cell is the port's published
    training configuration, as EP rank 0 of 4."""
    from harness import train_moe
    from repro_torch.configs import olmoe_1b_7b

    want = olmoe_1b_7b.share(olmoe_1b_7b.TRAIN_CONFIG, 0, 4)
    got = train_moe.model_config(OLMOE)
    skip = {"name", "block_pattern"}  # the cell's name; remat groups of 4 either way
    assert {k: v for k, v in vars(got).items() if k not in skip} == {
        k: v for k, v in vars(want).items() if k not in skip}
    assert got.block_pattern == want.block_pattern


def test_olmoe_parameters_by_hand():
    attn = 4 * 2048 * 2048 + 2 * 2048  # q, k, v, o and the q and k norms
    per_layer = attn + 2 * 2048 + 2048 * 64  # the two layer norms and the router
    assert cost_moe.non_expert_params(OLMOE) == 16 * per_layer + 50304 * 2048 + 2048 == 373_688_320
    # 8 picks of 64 experts, 16 held: 2 experts a token here, 3 x 2048 x 1024 each.
    assert cost_moe.active_expert_params(OLMOE) == 16 * 2 * 3 * 2048 * 1024 == 201_326_592


def test_olmoe_step_work_by_hand():
    pairs = 4096 * 4097 // 2
    attn_fwd = 16 * 4 * 8 * 16 * 128 * pairs  # 8 rows of 4096, 16 heads of 128, 16 layers
    want = 6 * (373_688_320 + 201_326_592) * 8 * 4096 + 3.5 * attn_fwd
    assert cost_moe.moe_model_flops(OLMOE, 8, 4096) == pytest.approx(want, rel=1e-12)
    assert 1.4e14 < want < 1.5e14


def test_expert_and_dispatch_counts_by_hand():
    assert cost_moe.expert_flops(OLMOE, 100) == 3 * 2 * 2048 * 1024 * 100
    # 10 tokens, 30 held rows, bf16 rows of 4096 bytes, 8 picks of 8 bytes
    want = 10 * (4096 + 64) + 2 * 30 * 4096 + 30 * 4096 + 10 * 4096
    assert cost_moe.dispatch_bytes(OLMOE, 10, 30) == want


def op(start, dur, *spans):
    return DeviceOp(name="k", start_ns=start, dur_ns=dur, cpu_op="", shapes=(),
                    spans=frozenset(spans))


def ctx_of(ops, counts):
    digest = Digest(ops=ops, window_s=1.0, busy_s=1.0, breakdown={})
    facts = {"model": OLMOE, "moe_counts": counts}
    return SimpleNamespace(cell=None, digest=digest, facts=facts, cost=cost, peaks=peaks)


def read(name, ctx):
    return spec.reader(BENCH, name)(ctx)


def test_experts_roofline_reads_its_span_and_counter():
    rows = 65536
    ops = [op(0, 2_000_000, "moe.experts"), op(2_000_000, 5_000_000, "moe.dispatch"),
           op(7_000_000, 1_000_000, "moe.experts", "train.backward")]
    got = read("moe.experts_roofline", ctx_of(ops, {"moe.assignments_held": rows}))
    least = 3 * 2 * 2048 * 1024 * rows / 989e12
    assert got == pytest.approx(100 * least / 3e-3)
    assert read("moe.experts_roofline", ctx_of(ops[1:2], {"moe.assignments_held": rows})) is None
    assert read("moe.experts_roofline", ctx_of(ops, {})) is None


def test_dispatch_roofline_reads_its_three_spans():
    counts = {"moe.tokens_routed": 16384, "moe.assignments_held": 32768}
    ops = [op(0, 1_000_000, "moe.route"), op(1_000_000, 2_000_000, "moe.dispatch"),
           op(3_000_000, 3_000_000, "moe.combine"), op(6_000_000, 9_000_000, "moe.experts")]
    got = read("moe.dispatch_roofline", ctx_of(ops, counts))
    moved = cost_moe.dispatch_bytes(OLMOE, 16384, 32768)
    assert got == pytest.approx(100 * moved / 3.35e12 / 6e-3)
    assert read("moe.dispatch_roofline", ctx_of(ops[3:], counts)) is None


def test_new_entries_list_the_cell():
    s = spec.load(ROOT)
    metrics = {m["name"]: m for m in s["end_to_end"] + s["per_layer"]}
    for name in ("moe.train_mfu", "moe.experts_roofline", "moe.dispatch_roofline"):
        assert metrics[name]["workloads"] == [REAL] and metrics[name]["moves"] == "train_tokens_per_s"
        assert (BENCH / "metrics" / f"{name}.py").exists()
    for name in ("train_tokens_per_s", "device_idle.train", "train.forward_idle",
                 "train.backward_idle", "train.optimizer_idle", "train.attn_roofline"):
        assert REAL in metrics[name]["workloads"]
    for name in ("train_mfu", "train.optimizer_roofline", "train.accumulate_roofline"):
        assert REAL not in metrics[name]["workloads"]
    cell = spec.cell(ROOT, REAL)
    assert cell.traffic["kind"] == "train_moe" and set(cell.limits) == {"loss", "grad1", "change"}
