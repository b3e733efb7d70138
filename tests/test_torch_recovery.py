"""Port parity: repro_torch.blocks.recovery against repro.blocks.recovery.

The chaos harness draws from the same seeded numpy generators as the
reference, so under one seed it injects the same faults at the same reads;
the recovering store detects and heals them, and a chaos run's product is
bit-identical to the fault-free run's. Lineage recompute rebuilds every
block of a run — divided operands, leaf products, combine partials — to
its stored bits.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.blocks import blockmatrix as jbm
from repro.blocks import recovery as jr
from repro.blocks import scheduler as js
from repro.core import backend as jb
from repro_torch.blocks import blockmatrix as tbm
from repro_torch.blocks import recovery as tr
from repro_torch.blocks import scheduler as ts
from repro_torch.blocks import tags
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import backend as tb
from repro_torch.core.coefficients import get_scheme
from repro_torch.obs import metrics as obs_metrics

RNG = np.random.default_rng(31)
CPU = dict(device="cpu")
J_NAIVE = jb.MatmulBackend(kind="naive")
T_NAIVE = tb.MatmulBackend(kind="naive")


@pytest.fixture(autouse=True)
def _fresh_metrics():
    obs_metrics.reset_metrics()


def _counters():
    return obs_metrics.get_metrics().snapshot()["counters"]


def _int_operands(shape):
    """Integer-valued fp32 operands: every product the run forms is exact,
    so the port's and the reference's runs agree bit for bit."""
    x = RNG.integers(-3, 4, size=shape).astype(np.float32)
    return x, torch.from_numpy(x.copy())


def test_chaos_config_validation_and_flags():
    with pytest.raises(ValueError, match="drop"):
        tr.ChaosConfig(drop=1.5)
    with pytest.raises(ValueError, match="corrupt"):
        tr.ChaosConfig(corrupt=-0.1)
    quiet = tr.ChaosConfig()
    assert not quiet.injects_store_faults and not quiet.injects_leaf_faults
    assert tr.ChaosConfig(drop=0.1).injects_store_faults
    assert tr.ChaosConfig(corrupt=0.1).injects_store_faults
    assert tr.ChaosConfig(leaf_fail_rate=0.1).injects_leaf_faults
    assert tr.ChaosConfig(fail_leaf_calls=(3,)).injects_leaf_faults


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_block_checksum_equals_reference(dtype_name):
    x = RNG.standard_normal((16, 12)).astype(np.float32)
    if dtype_name == "bfloat16":
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16))
    t = tensor_from_numpy(x, "cpu")
    assert tr.block_checksum(t) == jr.block_checksum(x)
    assert tr.block_checksum(t.t().contiguous().t()) == jr.block_checksum(x)  # layout-agnostic
    bad = t.clone()
    bad.reshape(-1).view(torch.uint8)[5] ^= 0x01
    assert tr.block_checksum(bad) != jr.block_checksum(x)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_chaos_store_schedule_equals_reference(seed):
    """Same seed, same reads: the same drops and corruptions, at the same
    reads, flipping the same byte."""
    def run(mod, store_mod, to_block, seed):
        rng = np.random.default_rng(0)
        inner = store_mod.DictStore()
        keys = [(0, i, "A:0") for i in range(8)]
        for k in keys:
            inner.put(k, to_block(rng.standard_normal((4, 4)).astype(np.float32)))
        chaos = mod.ChaosStore(inner, drop=0.25, corrupt=0.25, seed=seed)
        schedule = []
        for t in range(60):
            k = keys[t % 8]
            try:
                got = chaos.get(k)
                digest = bytes(np.asarray(got).view(np.uint8).reshape(-1))
            except KeyError:
                inner.put(k, to_block(rng.standard_normal((4, 4)).astype(np.float32)))
                digest = b"lost"
            schedule.append((chaos.injected_drops, chaos.injected_corruptions, digest))
        return schedule

    got = run(tr, tbm, torch.from_numpy, seed)
    want = run(jr, jbm, lambda a: a, seed)
    assert got == want
    assert got[-1][0] > 0 and got[-1][1] > 0


def test_chaos_store_counts_and_copies():
    inner = tbm.DictStore()
    key = (0, 0, "A:0")
    stored = torch.zeros((4, 4))
    inner.put(key, stored)
    chaos = tr.ChaosStore(inner, corrupt=1.0, seed=0)
    got = chaos.get(key)
    assert chaos.injected_corruptions == 1
    assert got.view(torch.uint8).max() > 0  # one byte flipped in the store...
    assert not stored.any()  # ...of a copy: the caller's tensor is untouched
    chaos2 = tr.ChaosStore(inner, drop=1.0, seed=0)
    with pytest.raises(KeyError):
        chaos2.get(key)
    assert chaos2.injected_drops == 1 and key not in inner
    snap = _counters()
    assert snap["fault.injected_corruptions"] == 1.0 and snap["fault.injected_drops"] == 1.0


@pytest.mark.parametrize("seed", [1, 2])
def test_flaky_leaf_pattern_equals_reference(seed):
    def pattern(mod):
        fl = mod.FlakyLeaf(fail_calls=(0, 7), fail_rate=0.3, seed=seed)
        out = []
        for _ in range(40):
            try:
                fl.check()
                out.append(False)
            except mod.InjectedFault:
                out.append(True)
        return out, fl.calls, fl.injected

    assert pattern(tr) == pattern(jr)
    assert issubclass(tr.InjectedFault, tr.FaultError) and issubclass(tr.BlockLossError, tr.FaultError)


def _root_lineage(a, b):
    return tr.Lineage(
        scheme=get_scheme("strassen"), depth=1, a=a, b=b,
        pm=a.shape[0], pk=a.shape[1], pn=b.shape[1], bam=4, bak=4, bbn=4,
        acc_dtype=torch.float32, stage_dtype=torch.float32,
        leaf_matmul=lambda x, y: x @ y,
    )


def test_recovering_store_heals_lost_and_corrupt_blocks():
    a, b = torch.randn(8, 8), torch.randn(8, 8)
    inner = tbm.DictStore()
    store = tr.RecoveringStore(inner, _root_lineage(a, b))
    tag = "A:"
    blocks = {}
    for i in range(2):
        for j in range(2):
            blk = a[i * 4:(i + 1) * 4, j * 4:(j + 1) * 4].contiguous()
            blocks[(i, j, tag)] = blk
            store.put((i, j, tag), blk)
    inner.delete((0, 1, tag))
    assert torch.equal(store.get((0, 1, tag)), blocks[(0, 1, tag)])
    assert store.lost_blocks == 1 and store.recovered_blocks == 1 and (0, 1, tag) in inner
    bad = inner.get((1, 0, tag)).clone()
    bad.reshape(-1).view(torch.uint8)[0] ^= 0xFF
    inner.put((1, 0, tag), bad)
    assert torch.equal(store.get((1, 0, tag)), blocks[(1, 0, tag)])
    assert store.corrupt_blocks == 1 and store.recovered_blocks == 2
    assert store.recompute_mismatches == 0
    snap = _counters()
    assert (snap["fault.lost_blocks"], snap["fault.corrupt_blocks"],
            snap["fault.recomputed_blocks"]) == (1.0, 1.0, 2.0)


def test_recovering_store_unrecoverable_paths_are_loud():
    bare = tr.RecoveringStore(tbm.DictStore())
    bare.put((0, 0, "A:"), torch.ones(2, 2))
    bare.inner.delete((0, 0, "A:"))
    with pytest.raises(tr.BlockLossError, match="no lineage"):
        bare.get((0, 0, "A:"))
    store = tr.RecoveringStore(tbm.DictStore(), _root_lineage(torch.randn(8, 8), torch.randn(8, 8)))
    store.put((0, 0, "X:junk"), torch.ones(2, 2))
    store.inner.delete((0, 0, "X:junk"))
    with pytest.raises(tr.BlockLossError):
        store.get((0, 0, "X:junk"))
    assert _counters()["fault.unrecoverable"] == 2.0


@pytest.mark.parametrize("scheme", ["strassen", "winograd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lineage_recomputes_every_block_of_a_run_bit_exactly(scheme, dtype, monkeypatch):
    """Snapshot the store at the end of each stage of a depth-2 run with a
    block grain, then recompute every block of every snapshot from lineage
    alone: each matches the stored bits."""
    m = k = n = 64
    a, b = torch.randn(m, k).to(dtype), torch.randn(k, n).to(dtype)
    seen = {}
    real_put = tbm.DictStore.put

    def recording_put(self, key, block):
        real_put(self, key, block)
        seen[key] = block.clone()

    monkeypatch.setattr(tbm.DictStore, "put", recording_put)
    ts.strassen_oot_matmul(a, b, depth=2, budget_bytes=1 << 20, scheme=scheme, block=8,
                           backend=T_NAIVE, **CPU)
    acc = torch.float32
    lineage = tr.Lineage(scheme=get_scheme(scheme), depth=2, a=a, b=b, pm=m, pk=k, pn=n,
                         bam=8, bak=8, bbn=8, acc_dtype=acc, stage_dtype=acc,
                         leaf_matmul=lambda x, y: x @ y)

    def fetch(key):
        return seen[key] if key in seen else tr.recompute_block(key, lineage, fetch)

    assert {key[2].split(":")[0] for key in seen} == {"A", "B", "C"}
    for key, want in seen.items():
        got = tr.recompute_block(key, lineage, fetch)
        assert got.dtype == want.dtype and torch.equal(got, want), key


@pytest.mark.parametrize("store_kind", ["dict", "arena", "memmap"])
@pytest.mark.parametrize("chaos_kw", [dict(drop=0.06, corrupt=0.04, seed=0),
                                      dict(drop=0.05, corrupt=0.02, leaf_fail_rate=0.05, seed=3)])
def test_chaos_run_bit_identical_to_clean_and_to_reference(store_kind, chaos_kw):
    """Seeded drops, corruptions and leaf failures across the whole tree heal
    to the byte; on integer operands the port's healed product is the
    reference's, and the fault bookkeeping is the reference's."""
    (ja_, ta_), (jb_, tb_) = _int_operands((64, 64)), _int_operands((64, 64))
    budget = 4 * ts.leaf_bytes(64, 64, 64, 2, "float32")
    kw = dict(depth=2, budget_bytes=budget, store=store_kind, retry_backoff_s=0.0)
    clean, _ = ts.strassen_oot_matmul(ta_, tb_, backend=T_NAIVE, **kw, **CPU)
    out, st = ts.strassen_oot_matmul(ta_, tb_, backend=T_NAIVE, chaos=tr.ChaosConfig(**chaos_kw),
                                     **kw, **CPU)
    want, jst = js.strassen_oot_matmul(ja_, jb_, backend=J_NAIVE, chaos=jr.ChaosConfig(**chaos_kw),
                                       **kw)
    assert torch.equal(out, clean)
    assert out.numpy().tobytes() == np.ascontiguousarray(want).tobytes()
    assert st.recovered_blocks > 0 and st.unrecovered_faults == 0
    assert st.recovered_blocks == st.lost_blocks + st.corrupt_blocks
    for field in ("recovered_blocks", "lost_blocks", "corrupt_blocks", "injected_faults",
                  "leaf_retries", "unrecovered_faults", "rung", "degrades"):
        assert getattr(st, field) == getattr(jst, field), field
    st.assert_within_budget()


def test_transient_leaf_fault_is_retried_in_place():
    t = torch.randn(64, 64)
    budget = 4 * ts.leaf_bytes(64, 64, 64, 1, "float32")
    clean, _ = ts.strassen_oot_matmul(t, t, depth=1, budget_bytes=budget, backend=T_NAIVE, **CPU)
    out, st = ts.strassen_oot_matmul(t, t, depth=1, budget_bytes=budget, backend=T_NAIVE,
                                     chaos=tr.ChaosConfig(fail_leaf_calls=(1,)), retries=2,
                                     retry_backoff_s=0.0, **CPU)
    assert torch.equal(out, clean)
    assert st.leaf_retries >= 1 and st.injected_faults == 1 and st.degrades == 0
    assert _counters()["fault.retries"] >= 1.0


def test_exhausted_retries_walk_the_degradation_ladder():
    t = torch.randn(64, 64)
    budget = 4 * ts.leaf_bytes(64, 64, 64, 1, "float32")
    clean, clean_st = ts.strassen_oot_matmul(t, t, depth=1, budget_bytes=budget, backend=T_NAIVE,
                                             **CPU)
    assert clean_st.rung == "pipeline"
    out, st = ts.strassen_oot_matmul(t, t, depth=1, budget_bytes=budget, backend=T_NAIVE,
                                     chaos=tr.ChaosConfig(fail_leaf_calls=(0,)), retries=0, **CPU)
    assert torch.equal(out, clean)
    assert st.rung == "sync" and st.degrades == 1
    (ev,) = st.degrade_events
    assert ev["from"] == "pipeline" and ev["to"] == "sync" and "InjectedFault" in ev["cause"]
    assert _counters()["fault.degrade"] == 1.0


@pytest.mark.parametrize("store_kind", ["dict", "arena", "memmap"])
def test_unrecovered_chaos_fault_cleans_caller_store(store_kind, tmp_path):
    t = torch.randn(96, 96)
    if store_kind == "dict":
        store = tbm.DictStore()
    elif store_kind == "memmap":
        store = tbm.MemmapStore(str(tmp_path / "spill"))
    else:
        store = tbm.ArenaStore(slot_bytes=64 * 1024, capacity=64)
    keep, foreign = torch.ones(2, 2), torch.full((2, 2), 7.0)
    store.put((0, 0, "keep"), keep)
    store.put((99, 99, "A:0"), foreign)
    with pytest.raises(tr.InjectedFault):
        ts.strassen_oot_matmul(t, t, depth=2, budget_bytes=4 * ts.leaf_bytes(96, 96, 96, 2, "float32"),
                               backend=T_NAIVE, store=store,
                               chaos=tr.ChaosConfig(fail_leaf_calls=(4,)), retries=0,
                               degrade=False, **CPU)
    leftover = [kk for kk in store.keys() if kk[2][:2] in ("A:", "B:", "C:")]
    assert leftover == [(99, 99, "A:0")]
    assert torch.equal(store.get((0, 0, "keep")), keep)
    assert torch.equal(store.get((99, 99, "A:0")), foreign)
    if store_kind == "memmap":
        assert len(os.listdir(store.root)) == 2
    store.close()


def test_tag_parsing_rejects_foreign_tags():
    lineage = _root_lineage(torch.randn(8, 8), torch.randn(8, 8))
    for tag in ("X:0", "A", "A:9,x"):
        with pytest.raises(tr.BlockLossError):
            tr.recompute_block((0, 0, tag), lineage, lambda k: None)
    with pytest.raises(tr.BlockLossError, match="outside"):
        tr.recompute_block((5, 5, "A:"), lineage, lambda k: None)
    assert tags.to_string((1, 2)) == "1,2"
