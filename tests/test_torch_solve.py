"""Port parity: repro_torch.blocks.solve and the solver ops of
repro_torch.core.backend against the JAX package's, on the CPU.

The same seeded SPD and triangular inputs go through SPIN inversion and the
triangular solves of both packages, held to ``tests/test_solve.py``'s atol
1e-4 (and to the dense library solver at 1e-5 relative to the largest entry,
as the reference is). The recursion's bookkeeping (depths, nested
out-of-core runs, waves, staged bytes) is the reference's exactly, chaos
heals bit-identically, and the backend routes each solver kind as the JAX
package does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import jax.scipy.linalg as jsl

from repro.blocks import solve as jsolve
from repro.core import autotune as ja
from repro.core import backend as jb
from repro_torch import obs
from repro_torch.blocks import solve as tsolve
from repro_torch.blocks.recovery import ChaosConfig
from repro_torch.blocks.scheduler import recent_oot_stats, reset_oot_stats
from repro_torch.convert import tensor_from_numpy, tensor_to_numpy
from repro_torch.core import autotune as ta
from repro_torch.core import backend as tb

RNG = np.random.default_rng(0)
CPU = dict(device="cpu")
# A 256^2 fp32 dense inverse (2 x 256 KiB) does not fit: every sized test
# goes out of core, and its nested multiplies run multi-wave staging.
BUDGET = 96 << 10
CALIB = dict(t_flop=1e-11, t_elem=1e-9, device_kind="cpu", device_count=1)
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _pinned_calibration(monkeypatch):
    monkeypatch.setattr(ja, "_CALIBRATION", ja.Calibration(**CALIB))
    monkeypatch.setattr(ja, "_PROCESS_CACHES", {})
    monkeypatch.setattr(ta, "_CALIBRATIONS", {"cpu": ta.Calibration(**CALIB)})
    monkeypatch.setattr(ta, "_PROCESS_CACHES", {})
    jb.resolve_auto.cache_clear()
    tb.resolve_auto.cache_clear()
    yield
    jb.resolve_auto.cache_clear()
    tb.resolve_auto.cache_clear()


def _spd(n):
    g = RNG.standard_normal((n, n)).astype(np.float32)
    return (g @ g.T / n + 2.0 * np.eye(n, dtype=np.float32)).astype(np.float32)


def _tri(n, lower=True):
    g = RNG.standard_normal((n, n)).astype(np.float32)
    t = np.tril(g) if lower else np.triu(g)
    return (t / np.sqrt(n) + 2.0 * np.eye(n, dtype=np.float32)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_err(got, want):
    got = tensor_to_numpy(got).astype(np.float32) if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / (np.abs(want).max() or 1.0))


STAT_FIELDS = ("m", "k", "n", "depth", "scheme", "op", "leaves", "waves", "wave_size",
               "h2d_bytes", "d2h_bytes", "peak_device_bytes", "oot_runs", "per_leaf_bytes",
               "stage_dtype", "budget_bytes", "rung", "degrades")


def _same_stats(got, want):
    for field in STAT_FIELDS:
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("store", ["dict", "arena", "memmap"])
def test_spin_inverse_matches_reference_across_stores(store):
    a = _spd(256)
    want, jst = jsolve.spin_inverse_oot(a, budget_bytes=BUDGET, store=store)
    got, tst = tsolve.spin_inverse_oot(_t(a), budget_bytes=BUDGET, store=store, **CPU)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert _rel_err(got, np.linalg.inv(a.astype(np.float64))) <= 1e-5
    _same_stats(tst, jst)
    assert tst.oot_runs > 0 and tst.peak_device_bytes <= BUDGET


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("nrhs", [64, 256])
def test_triangular_solve_matches_reference(lower, nrhs):
    t = _tri(256, lower)
    b = RNG.standard_normal((256, nrhs)).astype(np.float32)
    want, jst = jsolve.triangular_solve_oot(t, b, lower=lower, budget_bytes=BUDGET)
    got, tst = tsolve.triangular_solve_oot(_t(t), _t(b), lower=lower, budget_bytes=BUDGET, **CPU)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    dense = np.asarray(jsl.solve_triangular(jnp.asarray(t), jnp.asarray(b), lower=lower))
    assert _rel_err(got, dense) <= 1e-5
    _same_stats(tst, jst)


def test_bf16_inverse_matches_reference():
    a = np.array(jnp.asarray(_spd(128)).astype(jnp.bfloat16))
    want, _ = jsolve.spin_inverse_oot(a, budget_bytes=BUDGET // 4)
    got, st = tsolve.spin_inverse_oot(tensor_from_numpy(a, "cpu"), budget_bytes=BUDGET // 4,
                                      **CPU)
    assert got.dtype == torch.bfloat16 and st.stage_dtype == "float32"
    assert _rel_err(got, np.asarray(want).astype(np.float32)) < 1e-2


def test_non_power_of_two_size_pads_with_identity():
    a = _spd(200)
    want, _ = jsolve.spin_inverse_oot(a, depth=3, budget_bytes=BUDGET)
    got, st = tsolve.spin_inverse_oot(_t(a), depth=3, budget_bytes=BUDGET, **CPU)
    assert tuple(got.shape) == (200, 200) and st.depth == 3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_solver_min_depth_equals_reference():
    for n in (100, 256, 1000, 8192):
        for budget in (1 << 12, BUDGET, 1 << 20, 128 << 20):
            for nrhs, leaf in ((None, "inv"), (64, "trsm_lower"), (1024, "trsm_upper")):
                try:
                    want = jsolve.solver_min_depth_for_budget(n, budget, np.float32,
                                                              nrhs=nrhs, leaf_kind=leaf)
                except ValueError:
                    with pytest.raises(ValueError, match="no depth"):
                        tsolve.solver_min_depth_for_budget(n, budget, torch.float32,
                                                           nrhs=nrhs, leaf_kind=leaf)
                    continue
                assert tsolve.solver_min_depth_for_budget(
                    n, budget, torch.float32, nrhs=nrhs, leaf_kind=leaf) == want
    # the chip cell: an 8192^2 fp32 inverse under 128 MiB recurses once
    assert tsolve.solver_min_depth_for_budget(8192, 128 << 20, torch.float32) == 1


def test_leaf_too_big_and_bilinear_plans_are_refused():
    with pytest.raises(ValueError, match="use depth >="):
        tsolve.spin_inverse_oot(_t(_spd(128)), depth=0, budget_bytes=BUDGET // 2, **CPU)
    with pytest.raises(ValueError, match="not a dataflow plan"):
        tsolve.SolveScheduler(plan="strassen", depth=1, budget_bytes=BUDGET, **CPU)
    with pytest.raises(ValueError, match="takes operands"):
        tsolve.SolveScheduler(plan="spin_inverse", depth=1, budget_bytes=BUDGET, **CPU).run(
            _t(_spd(8)), _t(_spd(8)))


def test_chaos_heals_bit_identically():
    a = _t(_spd(256))
    clean, _ = tsolve.spin_inverse_oot(a, budget_bytes=BUDGET, **CPU)
    chaos = ChaosConfig(drop=0.05, corrupt=0.02, leaf_fail_rate=0.02, seed=0)
    healed, st = tsolve.spin_inverse_oot(a, budget_bytes=BUDGET, chaos=chaos,
                                         retry_backoff_s=0.0, **CPU)
    assert st.injected_faults > 0 and st.recovered_blocks > 0
    assert st.unrecovered_faults == 0 and st.peak_device_bytes <= BUDGET
    assert torch.equal(clean, healed)


def test_chaos_schedule_equals_reference():
    """The per-multiply seeds (seed + 7919 * call) give the reference's fault
    schedule, so the healed run's fault tallies are the reference's."""
    from repro.blocks.recovery import ChaosConfig as JChaos

    a = _spd(192)
    kw = dict(drop=0.05, corrupt=0.02, seed=7)
    _, jst = jsolve.spin_inverse_oot(a, budget_bytes=BUDGET, chaos=JChaos(**kw))
    _, tst = tsolve.spin_inverse_oot(_t(a), budget_bytes=BUDGET, chaos=ChaosConfig(**kw), **CPU)
    for field in ("injected_faults", "recovered_blocks", "lost_blocks", "corrupt_blocks",
                  "unrecovered_faults"):
        assert getattr(tst, field) == getattr(jst, field), field


@pytest.fixture
def global_tracing():
    obs.reset_tracing()
    obs.configure(enabled=True)
    yield obs.get_tracer()
    obs.configure(enabled=False)
    obs.reset_tracing()


def test_inverse_root_span_and_nested_matmul_spans(global_tracing):
    _, st = tsolve.spin_inverse_oot(_t(_spd(256)), budget_bytes=BUDGET, **CPU)
    spans = obs.get_tracer().snapshot()
    roots = [s for s in spans if s.name == "oot.inverse"]
    assert len(roots) == 1 and roots[0].attrs["op"] == "inverse"
    assert roots[0].attrs["oot_runs"] == st.oot_runs
    assert len([s for s in spans if s.name == "oot.matmul"]) == st.oot_runs
    assert any(s.name == "leaf.inv" for s in spans)
    assert any(s.name == "solve.node" for s in spans)


def test_solve_root_span_and_stats_ring(global_tracing):
    reset_oot_stats()
    t = _t(_tri(192))
    b = torch.randn(192, 64)
    tsolve.triangular_solve_oot(t, b, budget_bytes=BUDGET, **CPU)
    roots = [s for s in obs.get_tracer().snapshot() if s.name == "oot.solve"]
    assert len(roots) == 1 and roots[0].attrs["plan"] == "spin_trsm_lower"
    tsolve.spin_inverse_oot(_t(_spd(192)), budget_bytes=BUDGET, **CPU)
    ops = {row["op"] for row in recent_oot_stats()}
    assert {"solve", "inverse", "matmul"} <= ops


# ----------------------------------------------------- backend-level ops
@pytest.mark.parametrize("kind", ["dense", "spin_oot", "auto"])
def test_backend_inverse_kinds_match_reference(kind):
    a = _spd(256)
    jbk = jb.MatmulBackend(kind="auto", depth=2, device_budget=BUDGET)
    tbk = tb.MatmulBackend(kind="auto", depth=2, device_budget=BUDGET)
    want = np.asarray(jb.inverse(jnp.asarray(a), jbk, kind=kind))
    got = tb.inverse(_t(a), tbk, kind=kind)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert _rel_err(got, np.asarray(jnp.linalg.inv(jnp.asarray(a)))) <= 1e-5


@pytest.mark.parametrize("kind", ["dense", "spin_oot", "auto"])
@pytest.mark.parametrize("lower", [True, False])
def test_backend_solve_triangular_kinds_match_reference(kind, lower):
    t = _tri(256, lower)
    b = RNG.standard_normal((256, 64)).astype(np.float32)
    jbk = jb.MatmulBackend(kind="auto", depth=2, device_budget=BUDGET)
    tbk = tb.MatmulBackend(kind="auto", depth=2, device_budget=BUDGET)
    want = np.asarray(jb.solve_triangular(jnp.asarray(t), jnp.asarray(b), jbk, lower=lower,
                                          kind=kind))
    got = tb.solve_triangular(_t(t), _t(b), tbk, lower=lower, kind=kind)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_backend_spin_oot_without_budget_uses_one_leaf():
    """Forced out of core with no device_budget: the budget is one depth-1
    dense leaf, as in the reference."""
    a = _spd(128)
    got = tb.inverse(_t(a), tb.MatmulBackend(kind="naive"), kind="spin_oot")
    want = np.asarray(jb.inverse(jnp.asarray(a), jb.MatmulBackend(kind="naive"), kind="spin_oot"))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert tb._leaf_budget_fallback(128, 32, torch.float32) == jb._leaf_budget_fallback(
        128, 32, np.float32)


def test_solver_kind_errors_enumerate_valid_kinds():
    a = _t(_spd(16))
    with pytest.raises(ValueError) as ei:
        tb.inverse(a, kind="cholesky")
    assert all(k in str(ei.value) for k in tb.SOLVER_KINDS)
    with pytest.raises(ValueError) as ei:
        tb.solve_triangular(a, a, kind="gauss")
    assert all(k in str(ei.value) for k in tb.SOLVER_KINDS)
    with pytest.raises(ValueError, match="square"):
        tb.inverse(torch.zeros(3, 4))
    assert (tb.SOLVER_KINDS, tb.SOLVER_EAGER_ONLY_KINDS, tb.SOLVER_JIT_SAFE_KINDS) == (
        jb.SOLVER_KINDS, jb.SOLVER_EAGER_ONLY_KINDS, jb.SOLVER_JIT_SAFE_KINDS)


def test_spin_oot_refuses_a_compiling_caller(monkeypatch):
    """The host-resident pipeline cannot run inside a torch.compile trace:
    kind 'spin_oot' says so, and kind 'auto' picks the dense op."""
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    bk = tb.MatmulBackend(kind="auto", depth=2, device_budget=BUDGET)
    a = _t(_spd(256))
    with pytest.raises(ValueError) as ei:
        tb.inverse(a, bk, kind="spin_oot")
    assert all(k in str(ei.value) for k in tb.SOLVER_JIT_SAFE_KINDS)
    assert _rel_err(tb.inverse(a, bk, kind="auto"), np.linalg.inv(a.double().numpy())) <= 1e-5
