"""Port parity: repro_torch.blocks (stores, BlockMatrix, the wave scheduler)
against repro.blocks, on the CPU.

The same seeded numpy operands go through both packages. What runs on the
host is held bit for bit: the stores' round trips, ``signed_block_sum``, and
every leaf operand the divide stages hand to the leaf multiply. The leaf
products differ only in BLAS summation order, so the results are held to
the reference's own tolerances (2e-4 fp32 and 1e-2 bf16, relative to the
largest entry), and bit for bit on integer-valued operands, whose every
partial sum is exact in fp32. Wave sizing, the budget helpers and the
degradation ladder's bookkeeping equal the reference's exactly.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.blocks import blockmatrix as jbm
from repro.blocks import scheduler as js
from repro.blocks.recovery import ChaosConfig as JChaos
from repro.core import autotune as ja
from repro.core import backend as jb
from repro_torch.blocks import blockmatrix as tbm
from repro_torch.blocks import scheduler as ts
from repro_torch.blocks.recovery import ChaosConfig, InjectedFault
from repro_torch.convert import tensor_from_numpy, tensor_to_numpy
from repro_torch.core import autotune as ta
from repro_torch.core import backend as tb

RNG = np.random.default_rng(23)
CPU = dict(device="cpu")
J_NAIVE = jb.MatmulBackend(kind="naive")
T_NAIVE = tb.MatmulBackend(kind="naive")
CALIB = dict(t_flop=1e-11, t_elem=1e-9, t_coll=4e-9, t_h2d=2e-9, device_kind="cpu",
             device_count=1)
# Port against reference, relative to the largest entry of the reference.
PARITY = {"float32": 2e-4, "bfloat16": 1e-2}
STORES = ["dict", "arena", "memmap"]


@pytest.fixture(autouse=True)
def _pinned_calibration(monkeypatch):
    """No micro-benchmarks, no process-cache leakage, in either package."""
    monkeypatch.setattr(ja, "_CALIBRATION", ja.Calibration(**CALIB))
    monkeypatch.setattr(ja, "_PROCESS_CACHES", {})
    monkeypatch.setattr(ta, "_CALIBRATIONS", {"cpu": ta.Calibration(**CALIB)})
    monkeypatch.setattr(ta, "_PROCESS_CACHES", {})
    jb.resolve_auto.cache_clear()
    tb.resolve_auto.cache_clear()
    yield
    jb.resolve_auto.cache_clear()
    tb.resolve_auto.cache_clear()


def _operands(shape, dtype_name="float32", integer=False):
    """(numpy operand for the reference, CPU tensor for the port), same bits."""
    if integer:
        x = RNG.integers(-3, 4, size=shape).astype(np.float32)
    else:
        x = RNG.standard_normal(shape).astype(np.float32)
    if dtype_name == "bfloat16":
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16))
    return x, tensor_from_numpy(x, "cpu")


def _rel(got_t, want_np):
    got = tensor_to_numpy(got_t).astype(np.float32)
    want = np.asarray(want_np).astype(np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def _same_bits(got_t, want_np) -> bool:
    got = tensor_to_numpy(got_t)
    want = np.ascontiguousarray(np.asarray(want_np))
    return got.shape == want.shape and got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _stores(kind, slot_bytes, tmp_path):
    if kind == "dict":
        return jbm.DictStore(), tbm.DictStore()
    if kind == "arena":
        return jbm.ArenaStore(slot_bytes, capacity=8), tbm.ArenaStore(slot_bytes, capacity=8)
    return jbm.MemmapStore(str(tmp_path / "j")), tbm.MemmapStore(str(tmp_path / "t"))


# ------------------------------------------------------------------ stores
@pytest.mark.parametrize("store_kind", STORES)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 64), (65, 33), (100, 7), (30, 50)])
def test_blockmatrix_round_trip_equals_reference(store_kind, dtype_name, shape, tmp_path):
    """from_dense / to_dense / block are the reference's bits, edge blocks
    zero-padded, metadata equal, across every store."""
    x, t = _operands(shape, dtype_name)
    js_, ts_ = _stores(store_kind, 16 * 16 * 4, tmp_path)
    jm = jbm.BlockMatrix.from_dense(x, (16, 16), js_, tag="A:")
    tm = tbm.BlockMatrix.from_dense(t, (16, 16), ts_, tag="A:")
    assert _same_bits(tm.to_dense(), jm.to_dense())
    assert tm.meta() == jm.meta()
    assert tm.nbytes == jm.nbytes and tm.grid == jm.grid
    for key in tm.block_keys():
        assert _same_bits(ts_.get(key), js_.get(key))
    assert tuple(tm.block(0, 0).shape) == (16, 16)
    if store_kind != "memmap":  # .npy headers differ; the payloads do not
        assert ts_.nbytes() == js_.nbytes()
    tm.free()
    assert ts_.keys() == []
    js_.close()
    ts_.close()


def test_blockmatrix_shape_extension_and_zeros():
    x, t = _operands((40, 24))
    tm = tbm.BlockMatrix.from_dense(t, (16, 16), tbm.DictStore(), tag="A:", shape=(64, 32))
    jm = jbm.BlockMatrix.from_dense(x, (16, 16), jbm.DictStore(), tag="A:", shape=(64, 32))
    assert _same_bits(tm.to_dense(), jm.to_dense())
    z = tbm.BlockMatrix.zeros((20, 20), (8, 8), tbm.DictStore(), torch.float32, tag="C:")
    assert not z.to_dense().any() and tuple(z.to_dense().shape) == (20, 20)
    with pytest.raises(ValueError, match="smaller than data"):
        tbm.BlockMatrix.from_dense(t, (16, 16), shape=(8, 8))
    with pytest.raises(ValueError, match="store padded"):
        tm.put_block(0, 0, torch.zeros(4, 4))


def test_arena_store_reuses_slots_and_reports_footprint():
    store = tbm.ArenaStore(slot_bytes=256, capacity=2)
    blk = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    for i in range(10):  # 10 puts through 2-slot segments with deletes
        store.put((i, 0, "A:"), blk)
        store.delete((i, 0, "A:"))
    store.put((0, 0, "B:"), blk[:4])
    assert torch.equal(store.get((0, 0, "B:")), blk[:4])
    assert store.arena_bytes() == 2 * 256  # deletes recycled one segment
    with pytest.raises(ValueError):
        store.put((1, 0, "B:"), torch.zeros((9, 9)))
    # raw byte slots: bf16 blocks and fp32 accumulators share one arena
    x16 = torch.randn(8, 8).bfloat16()
    store.put((0, 0, "A:"), x16)
    assert torch.equal(store.get((0, 0, "A:")), x16) and store.get((0, 0, "A:")).dtype == torch.bfloat16


def test_memmap_store_spills_npy_files_and_cleans_up(tmp_path):
    root = str(tmp_path / "spill")
    store = tbm.MemmapStore(root)
    blk = torch.randn(8, 8)
    store.put((0, 1, "C:2,3"), blk)
    files = os.listdir(root)
    assert len(files) == 1 and files[0].endswith(".npy")
    assert np.array_equal(np.load(os.path.join(root, files[0])), blk.numpy())
    got = store.get((0, 1, "C:2,3"))
    assert torch.equal(got, blk)
    got.zero_()  # copy-on-write: the spilled file keeps its bytes
    assert torch.equal(store.get((0, 1, "C:2,3")), blk)
    # bf16 spills as its int16 bits; the index restores the dtype
    x16 = torch.randn(4, 4).bfloat16()
    store.put((0, 0, "A:"), x16)
    assert store.get((0, 0, "A:")).dtype == torch.bfloat16
    assert torch.equal(store.get((0, 0, "A:")), x16)
    store.delete((0, 1, "C:2,3"))
    store.delete((0, 0, "A:"))
    assert os.listdir(root) == []
    owned = tbm.MemmapStore()
    owned.put((0, 0, "A:"), blk)
    root2 = owned.root
    owned.close()
    assert not os.path.isdir(root2)


def test_make_store_specs():
    assert isinstance(tbm.make_store("dict"), tbm.DictStore)
    assert isinstance(tbm.make_store("arena", slot_bytes=64), tbm.ArenaStore)
    mm = tbm.make_store("memmap")
    assert isinstance(mm, tbm.MemmapStore)
    mm.close()
    with pytest.raises(ValueError):
        tbm.make_store("s3")
    with pytest.raises(ValueError):
        tbm.make_store("arena")


# --------------------------------------------------------- signed_block_sum
COEF_ROWS = [[1, 0, 0, 1], [0, 1, 0, -1], [-1, 0, 1, 0], [1, 1, 1, 1], [0.5, -2.0, 0, 1],
             [0, 0, -1, 0], [1, -1, -1, 1, 0, 1, -1]]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("row", COEF_ROWS, ids=lambda r: ",".join(str(c) for c in r))
def test_signed_block_sum_equals_reference_bit_for_bit(dtype_name, row):
    blocks = [_operands((24, 40), dtype_name) for _ in row]
    coefs = np.asarray(row, np.float64)
    got = tbm.signed_block_sum(lambda i: blocks[i][1], coefs, torch.float32)
    want = jbm.signed_block_sum(lambda i: blocks[i][0], coefs, np.float32)
    assert _same_bits(got, want)


def test_signed_block_sum_is_out_of_place():
    """The first term may BE the stored block (the cast is a no-op), so the
    sum must never accumulate into it."""
    a, b = torch.randn(8, 8), torch.randn(8, 8)
    a0 = a.clone()
    assert tbm.signed_block_sum(lambda i: a, np.array([1.0]), torch.float32) is a
    tbm.signed_block_sum(lambda i: (a, b)[i], np.array([1.0, 1.0]), torch.float32)
    tbm.signed_block_sum(lambda i: (a, b)[i], np.array([1.0, -1.0]), torch.float32)
    assert torch.equal(a, a0)
    with pytest.raises(ValueError, match="all zero"):
        tbm.signed_block_sum(lambda i: a, np.zeros(3), torch.float32)


# -------------------------------------------------- the out-of-core multiply
@pytest.mark.parametrize("scheme", ["strassen", "winograd", "naive8"])
@pytest.mark.parametrize("store_kind", STORES)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_oot_matches_reference(scheme, store_kind, dtype_name):
    """Depth 2 with a budget below either operand: the port's product agrees
    with the reference's, and every run statistic that is not a time is the
    reference's."""
    m, k, n = 96, 72, 80
    (ja_, ta_), (jb_, tb_) = _operands((m, k), dtype_name), _operands((k, n), dtype_name)
    budget = js.pipelined_leaf_bytes(m, k, n, 2, np.float32) * 2
    kw = dict(depth=2, budget_bytes=budget, scheme=scheme, store=store_kind)
    want, jst = js.strassen_oot_matmul(ja_, jb_, backend=J_NAIVE, **kw)
    got, tst = ts.strassen_oot_matmul(ta_, tb_, backend=T_NAIVE, **kw, **CPU)
    assert got.dtype == getattr(torch, dtype_name) and tuple(got.shape) == (m, n)
    assert _rel(got, want) < PARITY[dtype_name]
    for field in ("m", "k", "n", "depth", "scheme", "leaves", "waves", "wave_size", "prefetch",
                  "stage_dtype", "budget_bytes", "per_leaf_bytes", "peak_device_bytes",
                  "h2d_bytes", "d2h_bytes", "host_store_peak_bytes", "rung", "degrades",
                  "op"):
        assert getattr(tst, field) == getattr(jst, field), field
    assert tst.waves >= 2 and tst.peak_device_bytes <= budget


@pytest.mark.parametrize("scheme", ["strassen", "winograd", "naive8"])
@pytest.mark.parametrize("depth,block", [(1, None), (2, None), (2, 8), (3, None)])
def test_oot_integer_operands_bit_equal_reference(scheme, depth, block):
    """On small integers every partial sum is exact in fp32, so whatever
    order BLAS sums in, the port's product is the reference's bit for bit
    (odd shapes exercise the zero padding)."""
    m, k, n = 70, 45, 52
    (ja_, ta_), (jb_, tb_) = _operands((m, k), integer=True), _operands((k, n), integer=True)
    kw = dict(depth=depth, budget_bytes=1 << 20, scheme=scheme, block=block)
    want, _ = js.strassen_oot_matmul(ja_, jb_, backend=J_NAIVE, **kw)
    got, _ = ts.strassen_oot_matmul(ta_, tb_, backend=T_NAIVE, **kw, **CPU)
    assert _same_bits(got, want)
    assert _same_bits(got, ja_ @ jb_)


def _record_leaves(monkeypatch, sched_cls, sink):
    real = sched_cls._leaf_matmul

    def spy(self, a_dev, b_dev):
        sink.append((np.asarray(a_dev) if not isinstance(a_dev, torch.Tensor)
                     else tensor_to_numpy(a_dev),
                     np.asarray(b_dev) if not isinstance(b_dev, torch.Tensor)
                     else tensor_to_numpy(b_dev)))
        return real(self, a_dev, b_dev)

    monkeypatch.setattr(sched_cls, "_leaf_matmul", spy)


@pytest.mark.parametrize("dtype_name,stage", [("float32", None), ("bfloat16", None),
                                              ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("scheme", ["strassen", "winograd"])
def test_staged_leaf_operands_bit_equal_reference(dtype_name, stage, scheme, monkeypatch):
    """The host divide stages hand every leaf the reference's operands, bit
    for bit, in the reference's order — staged in the accumulation dtype by
    default, rounded once at the H2D boundary when stage_dtype narrows."""
    m, k, n = 64, 48, 40
    (ja_, ta_), (jb_, tb_) = _operands((m, k), dtype_name), _operands((k, n), dtype_name)
    j_seen, t_seen = [], []
    _record_leaves(monkeypatch, js.PlanScheduler, j_seen)
    _record_leaves(monkeypatch, ts.PlanScheduler, t_seen)
    kw = dict(depth=2, budget_bytes=1 << 20, scheme=scheme)
    j_stage = None if stage is None else jnp.bfloat16
    js.strassen_oot_matmul(ja_, jb_, backend=J_NAIVE, stage_dtype=j_stage, **kw)
    ts.strassen_oot_matmul(ta_, tb_, backend=T_NAIVE, stage_dtype=stage, **kw, **CPU)
    assert len(t_seen) == len(j_seen) == 49
    for (ga, gb), (wa, wb) in zip(t_seen, j_seen):
        assert ga.dtype == wa.dtype and ga.tobytes() == wa.tobytes()
        assert gb.dtype == wb.dtype and gb.tobytes() == wb.tobytes()


# ------------------------------------------------------------ budget sizing
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_budget_helpers_equal_reference(dtype_name):
    jdt = np.float32 if dtype_name == "float32" else jnp.bfloat16
    shapes = [(256, 256, 256), (200, 136, 168), (16384, 16384, 16384), (1, 3072, 8192),
              (8192, 8192, 8192), (999, 17, 4099)]
    for m, k, n in shapes:
        for depth in range(1, 6):
            assert ts.leaf_bytes(m, k, n, depth, dtype_name) == js.leaf_bytes(m, k, n, depth, jdt)
            assert (ts.pipelined_leaf_bytes(m, k, n, depth, getattr(torch, dtype_name))
                    == js.pipelined_leaf_bytes(m, k, n, depth, jdt))
        for budget in (1 << 10, 3 * 64 * 64 * 4, 1 << 20, 64 << 20, 1 << 30, 1 << 34):
            for pipelined in (False, True):
                try:
                    want = js.min_depth_for_budget(m, k, n, budget, jdt, pipelined=pipelined)
                except ValueError:
                    with pytest.raises(ValueError, match="no depth"):
                        ts.min_depth_for_budget(m, k, n, budget, dtype_name, pipelined=pipelined)
                    continue
                assert ts.min_depth_for_budget(m, k, n, budget, dtype_name,
                                               pipelined=pipelined) == want


def test_chip_cell_sizing():
    """16384^2 fp32 under a 1 GiB budget: depth 2, 4096^2 leaves with 128 MiB
    in and 64 MiB out, a 512 MiB pipelined slot, waves of 2 — 25 waves over
    49 leaves."""
    n, budget = 16384, 1 << 30
    assert ts.min_depth_for_budget(n, n, n, budget, torch.float32, pipelined=True) == 2
    assert ts._leaf_inout_bytes(n, n, n, 2, torch.float32) == (128 << 20, 64 << 20)
    assert ts.pipelined_leaf_bytes(n, n, n, 2, torch.float32) == 512 << 20
    assert budget // ts.pipelined_leaf_bytes(n, n, n, 2, torch.float32) == 2


@pytest.mark.parametrize("factor", [0.5, 1, 2, 3, 8])
def test_wave_sizing_equals_reference(factor):
    """Waves, wave size, pipeline on/off and the modeled peak at budgets
    around one pipelined slot are the reference's."""
    m, k, n = 96, 64, 80
    (ja_, ta_), (jb_, tb_) = _operands((m, k)), _operands((k, n))
    budget = int(js.pipelined_leaf_bytes(m, k, n, 2, np.float32) * factor)
    want, jst = js.strassen_oot_matmul(ja_, jb_, depth=2, budget_bytes=budget, backend=J_NAIVE)
    got, tst = ts.strassen_oot_matmul(ta_, tb_, depth=2, budget_bytes=budget, backend=T_NAIVE,
                                      **CPU)
    for field in ("waves", "wave_size", "prefetch", "peak_device_bytes", "per_leaf_bytes"):
        assert getattr(tst, field) == getattr(jst, field), field
    tst.assert_within_budget()
    assert (tst.overlap_efficiency > 0.0) == (tst.prefetch and tst.waves >= 2)


def test_budget_too_small_raises_with_min_depth():
    t = torch.randn(256, 256)
    with pytest.raises(ValueError, match="use depth >= 2"):
        ts.strassen_oot_matmul(t, t, depth=1, budget_bytes=3 * 64 * 64 * 4, backend=T_NAIVE,
                               **CPU)
    with pytest.raises(ValueError):
        ts.PlanScheduler(depth=0, budget_bytes=1 << 20, **CPU)
    with pytest.raises(ValueError):
        ts.PlanScheduler(depth=1, budget_bytes=0, **CPU)
    with pytest.raises(ValueError, match="not wave-schedulable"):
        ts.PlanScheduler(depth=1, budget_bytes=1 << 20, plan="spin_inverse", **CPU)


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.PlanScheduler(depth=1, budget_bytes=1 << 20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.strassen_oot_matmul(torch.eye(4), torch.eye(4), depth=1, budget_bytes=1 << 20)


# ----------------------------------------------------------- the pipeline
@pytest.mark.parametrize("store_kind", STORES)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_pipelined_matches_sync_bit_for_bit(store_kind, dtype_name):
    m, k, n = 200, 136, 168
    _, ta_ = _operands((m, k), dtype_name)
    _, tb_ = _operands((k, n), dtype_name)
    budget = ts.pipelined_leaf_bytes(m, k, n, 2, torch.float32)
    kw = dict(depth=2, budget_bytes=budget, backend=T_NAIVE, store=store_kind, **CPU)
    pipe, st_pipe = ts.strassen_oot_matmul(ta_, tb_, **kw)
    sync, st_sync = ts.strassen_oot_matmul(ta_, tb_, prefetch=False, **kw)
    assert st_pipe.prefetch and st_pipe.waves >= 2 and not st_sync.prefetch
    assert torch.equal(pipe, sync)
    st_pipe.assert_within_budget()
    st_sync.assert_within_budget()
    assert st_sync.overlap_efficiency == 0.0


def test_overlap_telemetry_and_stats_ring():
    """A forced multi-wave pipelined run reports a strictly positive overlap
    efficiency, ordered per-wave timestamps that show the interleave, and
    lands in the default ring and in an attached consumer ring."""
    ts.reset_oot_stats()
    ring = ts.attach_stats_ring()
    t = torch.randn(192, 192)
    budget = ts.pipelined_leaf_bytes(192, 192, 192, 2, torch.float32)
    _, st = ts.strassen_oot_matmul(t, t, depth=2, budget_bytes=budget, backend=T_NAIVE, **CPU)
    assert st.prefetch and st.wave_size == 1 and st.waves == 49
    assert st.peak_device_bytes == budget
    assert 0.0 < st.overlap_efficiency <= 1.0
    assert len(st.wave_events) == st.waves
    for e in st.wave_events:
        assert (e["issue_start"] <= e["issue_end"] <= e["dispatch_end"]
                <= e["fetch_start"] <= e["fetch_end"])
    assert st.wave_events[1]["issue_start"] < st.wave_events[0]["fetch_start"]
    assert ts.recent_oot_stats()[-1]["overlap_efficiency"] == st.overlap_efficiency
    assert ring.snapshot()[-1]["wave_events"] == st.wave_events
    ts.reset_oot_stats()
    assert ts.recent_oot_stats() == [] and len(ring) == 1


# ------------------------------------------------- retries and the ladder
def test_retries_and_ladder_equal_reference():
    """Under the same FlakyLeaf schedule the port retries, degrades and
    counts exactly as the reference does."""
    (ja_, ta_), (jb_, tb_) = _operands((64, 64)), _operands((64, 64))
    budget = 4 * js.leaf_bytes(64, 64, 64, 1, np.float32)
    cases = [dict(fail_leaf_calls=(1,)), dict(fail_leaf_calls=(0,)),
             dict(fail_leaf_calls=(0, 1, 2, 3)), dict(leaf_fail_rate=0.3, seed=5)]
    for chaos_kw in cases:
        for retries in (0, 2):
            kw = dict(depth=1, budget_bytes=budget, retries=retries, retry_backoff_s=0.0)
            try:
                _, jst = js.strassen_oot_matmul(ja_, jb_, backend=J_NAIVE,
                                                chaos=JChaos(**chaos_kw), **kw)
            except Exception as e:  # every rung failed: the port must fail alike
                with pytest.raises(InjectedFault, match=str(e)):
                    ts.strassen_oot_matmul(ta_, tb_, backend=T_NAIVE,
                                           chaos=ChaosConfig(**chaos_kw), **kw, **CPU)
                continue
            got, tst = ts.strassen_oot_matmul(ta_, tb_, backend=T_NAIVE,
                                              chaos=ChaosConfig(**chaos_kw), **kw, **CPU)
            for field in ("rung", "degrades", "leaf_retries", "injected_faults"):
                assert getattr(tst, field) == getattr(jst, field), (chaos_kw, retries, field)
            assert [e["from"] + ">" + e["to"] for e in tst.degrade_events] == [
                e["from"] + ">" + e["to"] for e in jst.degrade_events]


def test_ladder_degrades_on_oom_and_propagates_unknown_errors(monkeypatch):
    t = torch.randn(64, 64)
    budget = 4 * ts.leaf_bytes(64, 64, 64, 1, torch.float32)
    clean, _ = ts.strassen_oot_matmul(t, t, depth=1, budget_bytes=budget, backend=T_NAIVE, **CPU)
    real = ts.PlanScheduler._attempt
    calls = {"n": 0}

    def oom_once(self, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return real(self, *args, **kwargs)

    monkeypatch.setattr(ts.PlanScheduler, "_attempt", oom_once)
    out, st = ts.strassen_oot_matmul(t, t, depth=1, budget_bytes=budget, backend=T_NAIVE, **CPU)
    assert torch.equal(out, clean)  # the sync rung gives the pipeline's bits
    assert st.rung == "sync" and st.degrades == 1
    assert st.degrade_events[0]["cause"].startswith("OutOfMemoryError")

    boom = {"n": 0}

    def always_boom(self, *args, **kwargs):
        boom["n"] += 1
        raise RuntimeError("not a fault, a bug")

    monkeypatch.setattr(ts.PlanScheduler, "_attempt", always_boom)
    with pytest.raises(RuntimeError, match="not a fault"):
        ts.strassen_oot_matmul(t, t, depth=1, budget_bytes=budget, backend=T_NAIVE, **CPU)
    assert boom["n"] == 1


def test_fault_at_the_fence_is_redone_bit_identically(monkeypatch):
    """A fault-typed failure at a product's D2H fence replays that one leaf
    synchronously, counted as a retry, and the product keeps its bits."""
    t = torch.randn(96, 96)
    kw = dict(depth=2, budget_bytes=1 << 20, backend=T_NAIVE, **CPU)
    clean, _ = ts.strassen_oot_matmul(t, t, **kw)
    real = ts.PlanScheduler._fetch
    calls = {"n": 0}

    def flaky_fence(self, link, handle, acc_dtype):
        calls["n"] += 1
        if calls["n"] in (3, 17):
            raise InjectedFault("lost at the fence")
        return real(self, link, handle, acc_dtype)

    monkeypatch.setattr(ts.PlanScheduler, "_fetch", flaky_fence)
    out, st = ts.strassen_oot_matmul(t, t, **kw)
    assert torch.equal(out, clean)
    assert st.leaf_retries == 2 and st.degrades == 0


def _inject_failing_leaf(monkeypatch, fail_at: int) -> None:
    calls = {"n": 0}
    real = ts.PlanScheduler._leaf_matmul

    def boom(self, a_dev, b_dev):
        calls["n"] += 1
        if calls["n"] == fail_at:
            raise RuntimeError("injected leaf failure")
        return real(self, a_dev, b_dev)

    monkeypatch.setattr(ts.PlanScheduler, "_leaf_matmul", boom)


@pytest.mark.parametrize("store_kind", ["dict", "memmap"])
def test_failing_leaf_cleans_caller_store(store_kind, tmp_path, monkeypatch):
    """A leaf failure mid-pipeline drops every block the run created from a
    caller-provided store (spilled files included); unrelated keys and other
    runs' blocks under the same tag space survive."""
    t = torch.randn(96, 96)
    store = tbm.DictStore() if store_kind == "dict" else tbm.MemmapStore(str(tmp_path / "s"))
    keep, foreign = torch.ones(2, 2), torch.full((2, 2), 7.0)
    store.put((0, 0, "keep"), keep)
    store.put((99, 99, "A:0"), foreign)
    _inject_failing_leaf(monkeypatch, fail_at=5)
    with pytest.raises(RuntimeError, match="injected leaf failure"):
        ts.strassen_oot_matmul(t, t, depth=2, budget_bytes=4 * ts.leaf_bytes(96, 96, 96, 2, "float32"),
                               backend=T_NAIVE, store=store, **CPU)
    leftover = [kk for kk in store.keys() if kk[2][:2] in ("A:", "B:", "C:")]
    assert leftover == [(99, 99, "A:0")]
    assert torch.equal(store.get((0, 0, "keep")), keep)
    assert torch.equal(store.get((99, 99, "A:0")), foreign)
    if store_kind == "memmap":
        assert len(os.listdir(store.root)) == 2
    store.close()


def test_failing_leaf_removes_owned_memmap_spill_dir(monkeypatch):
    roots = []
    real_init = tbm.MemmapStore.__init__

    def spying_init(self, root=None):
        real_init(self, root)
        roots.append(self.root)

    monkeypatch.setattr(tbm.MemmapStore, "__init__", spying_init)
    _inject_failing_leaf(monkeypatch, fail_at=3)
    t = torch.randn(96, 96)
    with pytest.raises(RuntimeError, match="injected leaf failure"):
        ts.strassen_oot_matmul(t, t, depth=1, budget_bytes=1 << 20, backend=T_NAIVE,
                               store="memmap", **CPU)
    assert roots and not os.path.isdir(roots[0])


def test_auto_leaf_resolves_before_the_first_wave(monkeypatch):
    """A kind-auto leaf backend is resolved (calibrating on first use) before
    the run's root span opens, never inside a wave."""
    events = []
    real_resolve = tb.resolve_auto

    def spy_resolve(*args, **kwargs):
        events.append(("resolve", args[:3], args[5] if len(args) > 5 else kwargs.get("site")))
        return real_resolve(*args, **kwargs)

    real_leaf = ts.PlanScheduler._leaf_matmul

    def spy_leaf(self, a, b):
        events.append(("leaf",))
        return real_leaf(self, a, b)

    spy_resolve.cache_clear = real_resolve.cache_clear
    monkeypatch.setattr(tb, "resolve_auto", spy_resolve)
    monkeypatch.setattr(ts.PlanScheduler, "_leaf_matmul", spy_leaf)
    t = torch.randn(128, 128)
    ts.strassen_oot_matmul(t, t, depth=1, budget_bytes=1 << 20, **CPU)  # default auto leaves
    assert events[0] == ("resolve", (64, 64, 64), "blocks.leaf")
    assert ("leaf",) in events


def test_scheduler_accepts_a_plan_and_matches_the_scheme_path():
    from repro_torch.blocks.plan import get_plan

    t = torch.randn(64, 64)
    by_scheme, _ = ts.strassen_oot_matmul(t, t, depth=2, budget_bytes=1 << 20, scheme="winograd",
                                          backend=T_NAIVE, **CPU)
    by_plan, st = ts.strassen_oot_matmul(t, t, depth=2, budget_bytes=1 << 20,
                                         plan=get_plan("winograd"), backend=T_NAIVE, **CPU)
    assert torch.equal(by_scheme, by_plan) and st.scheme == "winograd"


def test_numpy_operands_are_accepted():
    x, t = _operands((48, 40))
    y, u = _operands((40, 24))
    got, _ = ts.strassen_oot_matmul(x, y, depth=1, budget_bytes=1 << 20, backend=T_NAIVE, **CPU)
    want, _ = ts.strassen_oot_matmul(t, u, depth=1, budget_bytes=1 << 20, backend=T_NAIVE, **CPU)
    assert torch.equal(got, want)
