"""The training substrate of repro_torch: tests/test_substrate.py and the
checkpoint and straggler tests of tests/test_recovery.py, mirrored on the
port, on the CPU.

The optimizer, the train step, the data pipeline, the checkpoints and the
elastic policy of the port are held to what the JAX package's own tests
hold its modules to. The data pipeline's tokens are also compared with the
JAX package's, bit for bit. A checkpoint of the port stores one ``.npy``
file per leaf, with each file's digest in the manifest (the JAX package
stores one ``arrays.npz``), so the corruption tests damage a leaf's file or
its manifest entry where the JAX tests damage the archive.
"""
import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # fall back to the vendored grid shim
    from _propshim import given, settings, strategies as st

from repro import configs as jconfigs
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_for_host
from repro_torch.launch import train as train_mod
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim.adamw import AdamWConfig, cosine_schedule
from repro_torch.runtime.checkpoint import (
    CheckpointError,
    CheckpointManager,
    load_pytree,
    save_pytree,
)
from repro_torch.runtime.elastic import (
    ElasticError,
    StragglerMonitor,
    plan_mesh,
    rebalance_accum,
)
from repro_torch.training.train_step import init_train_state, make_train_step


def _tiny_setup(accum=1, seed=0):
    cfg = get_smoke_config("phi4_mini_3_8b")
    opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50)
    state = init_train_state(cfg, opt_cfg, torch.Generator().manual_seed(seed))
    data = SyntheticLM(cfg, DataConfig(batch=4, seq_len=16, seed=1), device="cpu")
    return cfg, state, data, make_train_step(cfg, opt_cfg, accum_steps=accum)


def _leaves(state):
    return [t.detach().clone() for t in
            [*state.params.state_dict().values(), state.opt.step,
             *state.opt.m.values(), *state.opt.v.values()]]


def test_train_step_decreases_loss():
    cfg, state, data, step_fn = _tiny_setup()
    losses = []
    for i in range(10):
        state, metrics = step_fn(state, data(i % 2))  # repeat 2 batches -> memorize
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    assert int(state.opt.step) == 10


def test_grad_accumulation_matches_full_batch():
    _, s1, data, step1 = _tiny_setup(accum=1)
    _, s4, _, step4 = _tiny_setup(accum=4)
    batch = data(0)
    s1, _ = step1(s1, batch)
    s4, _ = step4(s4, batch)
    # same initial params -> near-identical updated params
    diff = max((a.detach() - b.detach()).abs().max().item()
               for a, b in zip(s1.params.parameters(), s4.params.parameters()))
    assert diff < 5e-3, diff


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(cosine_schedule(torch.tensor(s), cfg)) for s in (0, 5, 10, 55, 100, 200)]
    assert lrs[1] == pytest.approx(0.5, rel=1e-3)  # mid-warmup
    assert lrs[2] == pytest.approx(1.0, rel=1e-3)  # peak
    assert lrs[4] == pytest.approx(0.1, rel=1e-2)  # min ratio
    assert lrs[5] == pytest.approx(0.1, rel=1e-2)  # clamped past end


def test_data_pipeline_deterministic_and_shifted():
    cfg = get_smoke_config("phi4_mini_3_8b")
    pipe = SyntheticLM(cfg, DataConfig(batch=2, seq_len=32, seed=7), device="cpu")
    b1, b2 = pipe(3), pipe(3)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(pipe(4)["tokens"], b1["tokens"])
    # labels are tokens shifted by one
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "qwen2_vl_72b"])
def test_data_pipeline_tokens_are_the_jax_packages_bit_for_bit(arch):
    for batch, seq, seed, step in ((2, 32, 7, 3), (4, 16, 1, 0), (3, 64, 0, 11)):
        got = SyntheticLM(get_smoke_config(arch), DataConfig(batch, seq, seed), device="cpu")(step)
        want = JSyntheticLM(jconfigs.get_smoke_config(arch), JDataConfig(batch, seq, seed))(step)
        for key in ("tokens", "labels"):
            w = np.asarray(want[key])
            assert got[key].dtype == torch.int32 and w.dtype == np.int32
            assert np.array_equal(got[key].numpy(), w)
        if "positions" in want:
            assert np.array_equal(got["positions"].numpy(), np.asarray(want["positions"]))


def test_data_pipeline_stub_frames_are_seeded_by_the_step():
    pipe = SyntheticLM(get_smoke_config("whisper_tiny"), DataConfig(batch=2, seq_len=8), device="cpu")
    a, b, c = pipe(5)["frames"], pipe(5)["frames"], pipe(6)["frames"]
    assert a.shape == (2, pipe.cfg.enc_seq, pipe.cfg.d_model)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_shard_for_host_partitions_exactly():
    for gb, hosts in [(256, 32), (100, 8), (7, 3)]:
        total = sum(shard_for_host(gb, i, hosts) for i in range(hosts))
        assert total == gb
    assert shard_for_host(10) == 10  # no process group: one host


def test_checkpoint_roundtrip(tmp_path):
    _, state, data, step_fn = _tiny_setup()
    state, _ = step_fn(state, data(0))
    path = save_pytree(state, str(tmp_path), step=1)
    _, fresh, _, _ = _tiny_setup(seed=1)
    restored = load_pytree(fresh, path)
    assert restored is fresh  # loaded in place
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert torch.equal(a, b)


def test_checkpoint_roundtrip_bf16_bits(tmp_path):
    tree = {"w": torch.randn(5, 3).bfloat16(), "step": torch.tensor(3, dtype=torch.int32)}
    path = save_pytree(tree, str(tmp_path), step=1)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["leaves"]["w"]["dtype"] == "bfloat16"
    assert np.load(os.path.join(path, manifest["leaves"]["w"]["file"])).dtype == np.uint16
    out = load_pytree({"w": torch.zeros(5, 3, dtype=torch.bfloat16),
                       "step": torch.tensor(0, dtype=torch.int32)}, path)
    assert torch.equal(out["w"], tree["w"]) and int(out["step"]) == 3


def test_checkpoint_manager_resume_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.maybe_save({"w": torch.arange(4.0) * s}, s)
    assert mgr.latest_step() == 4
    step, restored = mgr.restore_latest({"w": torch.zeros(4)})
    assert step == 4
    assert torch.equal(restored["w"], torch.arange(4.0) * 4)
    # gc kept only last 2
    assert len(mgr._steps()) == 2


def test_checkpoint_atomicity_torn_write(tmp_path):
    """A directory without a complete manifest must be ignored on restore."""
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep_last=5)
    mgr.maybe_save({"w": torch.ones(3)}, 1)
    # simulate a torn write: step dir exists but manifest is junk
    os.makedirs(tmp_path / "step_00000002", exist_ok=True)
    with open(tmp_path / "step_00000002" / "manifest.json", "w") as f:
        f.write("{")  # truncated
    assert mgr.latest_step() == 1


def test_plan_mesh_elasticity():
    assert plan_mesh(512, model_parallel=16, pods=2) == ((2, 16, 16), ("pod", "data", "model"))
    assert plan_mesh(256, model_parallel=16) == ((16, 16), ("data", "model"))
    # lose a host (8 devices): data axis absorbs it if divisible
    assert plan_mesh(496, model_parallel=16) == ((31, 16), ("data", "model"))
    with pytest.raises(ElasticError):
        plan_mesh(500, model_parallel=16)


@settings(max_examples=30, deadline=None)
@given(
    gb=st.sampled_from([64, 128, 256]),
    shards=st.integers(min_value=1, max_value=32),
)
def test_property_rebalance_preserves_global_batch(gb, shards):
    accum = rebalance_accum(gb, 128, shards, per_shard_tokens_budget=4096)
    assert accum >= 1
    assert gb % (accum * shards) == 0 or accum == gb


def test_straggler_monitor_flags_sustained_slowdown():
    mon = StragglerMonitor(window=16, threshold=2.0, patience=3)
    flagged = False
    for i in range(20):
        mon.start_step()
        time.sleep(0.001 if i < 12 else 0.02)  # 12 fast steps then sustained slow
        flagged = mon.end_step() or flagged
    assert flagged


# ------------------------------------------- tests/test_recovery.py mirrors
def test_checkpoint_digest_mismatch_raises(tmp_path):
    tree = {"w": torch.arange(6.0), "b": torch.ones((2, 2))}
    path = save_pytree(tree, str(tmp_path), step=1)
    leaf = os.path.join(path, json.load(open(os.path.join(path, "manifest.json")))["leaves"]["w"]["file"])
    with open(leaf, "rb") as f:
        raw = bytearray(f.read())
    raw[-1] ^= 0xFF
    with open(leaf, "wb") as f:
        f.write(bytes(raw))
    template = {"w": torch.zeros(6), "b": torch.zeros((2, 2))}
    with pytest.raises(CheckpointError, match="digest mismatch"):
        load_pytree(template, path)
    assert not template["b"].any()  # verified before anything is written


def test_checkpoint_partial_and_torn_writes_raise(tmp_path):
    tree = {"w": torch.ones(3)}
    path = save_pytree(tree, str(tmp_path), step=1)
    os.remove(os.path.join(path, "00000.npy"))
    with pytest.raises(CheckpointError, match="missing 00000.npy"):
        load_pytree(tree, path)

    path2 = save_pytree(tree, str(tmp_path), step=2)
    with open(os.path.join(path2, "manifest.json"), "w") as f:
        f.write("{")  # torn mid-write
    with pytest.raises(CheckpointError, match="torn manifest"):
        load_pytree(tree, path2)

    path3 = save_pytree(tree, str(tmp_path), step=3)
    with open(os.path.join(path3, "manifest.json"), "w") as f:
        json.dump({"complete": False}, f)
    with pytest.raises(CheckpointError, match="not marked complete"):
        load_pytree(tree, path3)

    path4 = save_pytree(tree, str(tmp_path), step=4)
    os.remove(os.path.join(path4, "manifest.json"))
    with pytest.raises(CheckpointError, match="missing manifest"):
        load_pytree(tree, path4)


def test_checkpoint_save_is_atomic_on_failure(tmp_path, monkeypatch):
    """A save that dies mid-write must leave neither a step dir nor a tmp
    dir behind: the atomic-replace contract load verification rests on."""

    def boom(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(np, "save", boom)
    with pytest.raises(OSError, match="disk full"):
        save_pytree({"w": torch.ones(3)}, str(tmp_path), step=1)
    assert os.listdir(tmp_path) == []


def test_checkpoint_missing_key_and_digestless_back_compat(tmp_path):
    tree = {"w": torch.arange(4.0), "b": torch.zeros(2)}
    path = save_pytree(tree, str(tmp_path), step=1)
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    # checkpoints written without digests still load (no verification)
    for entry in manifest["leaves"].values():
        del entry["digest"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    restored = load_pytree({"w": torch.zeros(4), "b": torch.ones(2)}, path)
    assert torch.equal(restored["w"], torch.arange(4.0))
    # a payload missing one array is a partial checkpoint, not a default
    manifest["leaves"].pop(sorted(manifest["leaves"])[0])
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CheckpointError, match="payload missing"):
        load_pytree(tree, path)


def test_straggler_monitor_gauges_reason_and_counter():
    mon = StragglerMonitor(window=8, threshold=2.0, patience=2)
    flagged = False
    for i in range(12):
        mon.start_step()
        time.sleep(0.001 if i < 8 else 0.02)
        flagged = mon.end_step() or flagged
    assert flagged
    reason = mon.flag_reason()
    assert reason["median"] > 2.0 and reason["streak"] >= 2
    snap = obs_metrics.get_metrics().snapshot()
    assert snap["gauges"]["elastic.step_over_median"]["max"] > 2.0
    assert snap["gauges"]["elastic.slow_streak"]["max"] >= 2
    assert snap["counters"]["elastic.straggler_flags"] >= 1.0


def test_train_loop_stop_on_straggler_checkpoints_and_stops(tmp_path, monkeypatch):
    class FlagAtThree:
        def __init__(self):
            self._steps = 0

        def start_step(self):
            pass

        def end_step(self):
            self._steps += 1
            return self._steps >= 3

        def flag_reason(self):
            return {"median": 9.9, "streak": 3}

        @property
        def median_step_time(self):
            return 0.001

    monkeypatch.setattr(train_mod, "StragglerMonitor", FlagAtThree)
    cfg = get_smoke_config("phi4_mini_3_8b")
    opt = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50)
    stats = {}
    _, history = train_mod.train_loop(
        cfg, opt, steps=10, batch=2, seq=8, ckpt_dir=str(tmp_path),
        save_every=1000, log_every=1000, stats_out=stats,
        stop_on_straggler=True, device="cpu",
    )
    assert stats["straggler"] == {"median": 9.9, "streak": 3}
    assert len(history) == 3  # stopped at the flag, not at steps
    # force-saved despite save_every never aligning, evidence in the manifest
    assert os.path.isdir(tmp_path / "step_00000003")
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["extra"]["straggler"] == {"median": 9.9, "streak": 3}
    assert train_mod.STRAGGLER_EXIT_CODE == 75

    # library default: the flag logs and training continues to completion
    stats2 = {}
    _, history2 = train_mod.train_loop(
        cfg, opt, steps=5, batch=2, seq=8, ckpt_dir=None,
        log_every=1000, stats_out=stats2, device="cpu",
    )
    assert len(history2) == 5 and "straggler" not in stats2
    assert len(stats2["grad_norm"]) == 5
