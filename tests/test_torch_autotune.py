"""Port parity: repro_torch.core.autotune and kind 'auto' against repro.core.autotune.

Two parts, on the CPU:

* Parity. With one pinned ``Calibration`` given to both packages (live
  timings differ), the candidate lists, cost terms, cache keys, decisions
  and ``resolve_auto`` backends are equal with ``==`` (the arithmetic is
  copied operation for operation), tuning-cache JSON written by either
  package answers the other's lookups, and ``kind='auto'`` products agree
  within ``tests/test_autotune.py``'s tolerances (3e-3 fp32, 1.5e-1 bf16).
* The reference's own tests (``tests/test_autotune.py``) mirrored on the
  port, except those that need a mesh (``test_mesh_*``,
  ``test_fused_sharded_*``, ``test_calibrate_collective_*``): the mesh
  strategies are not ported and must raise.
* The out-of-core ``strassen_oot`` family and the solver families: under a
  pinned calibration their candidates, cost terms (``t_h2d`` with and
  without the pipeline's overlap discount), decisions and cache keys equal
  the reference's with ``==``, and their products agree.
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # fall back to the vendored grid shim
    from _propshim import given, settings, strategies as st

from repro.core import autotune as ja
from repro.core import backend as jb
from repro_torch.configs import get_smoke_config
from repro_torch.core import autotune, compat
from repro_torch.core.autotune import (
    Calibration,
    Candidate,
    Decision,
    TuningCache,
    cache_key,
    enumerate_candidates,
    predict_seconds,
)
from repro_torch.core.backend import MatmulBackend, matmul, resolve_auto
from repro_torch.core.cost_model import paper_stage_count, total_cost

RNG = np.random.default_rng(17)
CPU = dict(device="cpu")

# Fixed synthetic constants: decisions in these tests must never depend on
# the machine the suite happens to run on.
CALIB = Calibration(t_flop=1e-11, t_elem=1e-9, device_kind="test", device_count=1)
# Constants under which Strassen wins at the small shapes of the product tests.
CALIB_CHEAP_ELEM = Calibration(t_flop=1e-9, t_elem=1e-12, device_kind="test", device_count=1)
JDTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jcal(calib: Calibration) -> "ja.Calibration":
    return ja.Calibration(**calib.to_dict())


def _rand(shape, dtype=torch.float32):
    return torch.from_numpy(RNG.standard_normal(shape).astype(np.float32)).to(dtype)


def _auto_backend(**kw):
    kw.setdefault("kind", "auto")
    kw.setdefault("depth", 2)
    return MatmulBackend(**kw)


def _fields(c):
    return (c.kind, c.scheme, c.depth)


@pytest.fixture(autouse=True)
def _synthetic_calibration(monkeypatch):
    """No micro-benchmarks and no cross-test lru_cache leakage, in either package."""
    monkeypatch.setattr(autotune, "_CALIBRATIONS", {"cpu": CALIB})
    monkeypatch.setattr(autotune, "_PROCESS_CACHES", {})
    monkeypatch.setattr(ja, "_CALIBRATION", _jcal(CALIB))
    monkeypatch.setattr(ja, "_PROCESS_CACHES", {})
    resolve_auto.cache_clear()
    jb.resolve_auto.cache_clear()
    yield
    resolve_auto.cache_clear()
    jb.resolve_auto.cache_clear()


# ------------------------------------------------------ parity with repro
SHAPES = [(512, 512, 512), (1024, 1024, 1024), (2048, 1024, 4096), (1028, 1028, 1028),
          (96, 96, 96), (100, 60, 36), (33, 65, 17), (640, 640, 640), (1536, 3072, 8192),
          (16384, 16384, 16384), (1, 3072, 8192), (6, 4096, 4096)]


@pytest.mark.parametrize("max_depth", [1, 2, 3])
@pytest.mark.parametrize("min_dim", [1, 64, 256, 1024])
def test_enumerate_candidates_equal_reference(min_dim, max_depth):
    for schemes in (("strassen", "winograd"), ("winograd",), ("strassen",)):
        for m, k, n in SHAPES:
            kw = dict(min_dim=min_dim, max_depth=max_depth, schemes=schemes)
            got = enumerate_candidates(m, k, n, **kw, **CPU)
            want = ja.enumerate_candidates(m, k, n, **kw)
            assert [_fields(c) for c in got] == [_fields(c) for c in want], (m, k, n, kw)


@pytest.mark.parametrize("calib", [
    CALIB, CALIB_CHEAP_ELEM,
    Calibration(t_flop=3.1e-14, t_elem=7.7e-12, device_kind="gpu", t_coll=2.5e-11, t_h2d=4.4e-11),
], ids=["default", "cheap_elem", "all_constants"])
def test_predict_cost_terms_equal_reference(calib):
    """The terms of every candidate the port enumerates are equal with ==
    to the reference's on one device: the arithmetic is the reference's, in
    its order."""
    jcal = _jcal(calib)
    for m, k, n in SHAPES:
        for c in enumerate_candidates(m, k, n, min_dim=1, max_depth=3, **CPU):
            jc = ja.Candidate(*_fields(c))
            got = autotune.predict_cost_terms(c, m, k, n, calib)
            assert got == ja.predict_cost_terms(jc, m, k, n, jcal, device_count=1), (c, m, k, n)
            assert predict_seconds(c, m, k, n, calib) == ja.predict_seconds(jc, m, k, n, jcal)


def test_cache_key_equals_reference():
    for dt in (torch.float32, torch.bfloat16):
        for site in (None, "attn.wq", "mlp.down"):
            for oot in (None, 1 << 30):
                for topo in ("local", "mesh2x4"):
                    kw = dict(device_kind="cpu", device_count=1, schemes=("strassen", "winograd"),
                              min_dim=1024, max_depth=3, topo=topo, site=site, oot_budget=oot)
                    got = cache_key(1024, 3072, 8192, dt, **kw)
                    assert got == ja.cache_key(1024, 3072, 8192, JDTYPES[dt], **kw)
                    assert cache_key(1024, 3072, 8192, str(dt).split(".")[1], **kw) == got
                    assert got.split("|")[1] == str(dt).split(".")[1]
    assert autotune.device_platform("cuda") == "gpu" and autotune.device_platform("cpu") == "cpu"


@pytest.mark.parametrize("calib", [CALIB, CALIB_CHEAP_ELEM], ids=["default", "cheap_elem"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autotune_predicted_decision_equals_reference(calib, dtype):
    for m, k, n in SHAPES:
        for min_dim, max_depth in ((1024, 3), (64, 2), (1, 1)):
            kw = dict(min_dim=min_dim, max_depth=max_depth, site="mlp.up")
            got = autotune.autotune(m, k, n, dtype, calibration=calib, **kw, **CPU)
            want = ja.autotune(m, k, n, JDTYPES[dtype], calibration=_jcal(calib), **kw)
            assert got.to_dict() == want.to_dict(), (m, k, n, kw)


def test_resolve_auto_equals_reference(monkeypatch):
    monkeypatch.setattr(autotune, "_CALIBRATIONS", {"cpu": CALIB_CHEAP_ELEM})
    monkeypatch.setattr(ja, "_CALIBRATION", _jcal(CALIB_CHEAP_ELEM))
    kinds = set()
    for fields in (dict(depth=2, min_dim=32), dict(depth=3, min_dim=64, schemes=("winograd",)),
                   dict(depth=1, min_dim=1024, precision="highest"), dict(depth=2, min_dim=4096)):
        for m, k, n in SHAPES:
            for dt in ("float32", "bfloat16"):
                got = resolve_auto(m, k, n, dt, _auto_backend(**fields), "attn.wq", "cpu")
                want = jb.resolve_auto(m, k, n, dt, jb.MatmulBackend(kind="auto", **fields), "attn.wq")
                assert dataclasses.asdict(got) == dataclasses.asdict(want), (m, k, n, dt, fields)
                kinds.add(got.kind)
    assert kinds == {"naive", "winograd", "strassen_fused"}


def _resolve_grid(tune, cache, dtypes):
    """Resolve a grid of shapes (some site-tagged) into ``cache`` with ``tune``."""
    for m, k, n in SHAPES[:8]:
        for dt in dtypes:
            tune(m, k, n, dt, calibration=CALIB, cache=cache, min_dim=64, max_depth=2)
            tune(m, k, n, dt, calibration=CALIB, cache=cache, min_dim=64, max_depth=2,
                 site="attn.wq")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tuning_cache_json_loads_both_ways(writer, tmp_path, monkeypatch):
    """A cache file written by one package loads in the other and answers
    every key from the cache, with the writer's decision."""
    path = str(tmp_path / "tuning.json")
    port_tune = lambda *a, **k: autotune.autotune(*a, **k, **CPU)  # noqa: E731
    if writer == "jax":
        _resolve_grid(ja.autotune, ja.TuningCache(path), [jnp.float32, jnp.bfloat16])
        reader, tune, dtypes = TuningCache(path), port_tune, [torch.float32, torch.bfloat16]
        monkeypatch.setattr(autotune, "calibrate", None)  # a cache hit must not calibrate
    else:
        _resolve_grid(port_tune, TuningCache(path), [torch.float32, torch.bfloat16])
        reader, tune, dtypes = ja.TuningCache(path), ja.autotune, [jnp.float32, jnp.bfloat16]
        monkeypatch.setattr(ja, "calibrate", None)
    with open(path) as f:
        raw = json.load(f)
    assert raw["calibration"] == CALIB.to_dict() and len(raw["decisions"]) == 16
    assert reader.calibration.to_dict() == CALIB.to_dict()
    assert set(reader.entries) == set(raw["decisions"])
    for m, k, n in SHAPES[:8]:
        for dt, name in zip(dtypes, ("float32", "bfloat16")):
            stored = raw["decisions"][cache_key(
                m, k, n, name, device_kind="cpu", device_count=1,
                schemes=("strassen", "winograd"), min_dim=64, max_depth=2)]
            for site in (None, "attn.wq"):
                got = tune(m, k, n, dt, cache=reader, min_dim=64, max_depth=2, site=site)
                assert got.source == "cache"
                assert {f: getattr(got, f) for f in stored if f != "source"} == {
                    f: v for f, v in stored.items() if f != "source"}


@pytest.mark.parametrize("calib", [CALIB, CALIB_CHEAP_ELEM], ids=["default", "cheap_elem"])
@pytest.mark.parametrize("schemes", [("strassen", "winograd"), ("winograd",)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-3), (torch.bfloat16, 1.5e-1)])
def test_auto_products_match_reference(calib, schemes, dtype, tol, monkeypatch):
    monkeypatch.setattr(autotune, "_CALIBRATIONS", {"cpu": calib})
    monkeypatch.setattr(ja, "_CALIBRATION", _jcal(calib))
    for (m, k, n), min_dim in (((64, 64, 64), 32), ((128, 64, 256), 32), ((96, 128, 128), 64),
                               ((2, 64, 128), 64)):
        x = RNG.standard_normal((m, k)).astype(np.float32)
        w = RNG.standard_normal((k, n)).astype(np.float32)
        be = dict(kind="auto", depth=2, min_dim=min_dim, schemes=schemes)
        got = matmul(torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype), MatmulBackend(**be))
        want = jb.matmul(jnp.asarray(x, JDTYPES[dtype]), jnp.asarray(w, JDTYPES[dtype]),
                         jb.MatmulBackend(**be))
        assert got.dtype == dtype and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("n", [512, 4096])
def test_winograd_depth2_bf16_error_is_the_references(n):
    """Winograd at depth 2 in bf16 (every einsum level rounded to bf16) lies
    2.10e-2 to 2.12e-2 from fp32 in the JAX package from 512^2 to 4096^2,
    with no trend in the size, over the 2e-2 the other bf16 routes meet. The
    port's route lies within 1% of the reference's; chip_smoke.py holds it
    on the card to the largest of these errors plus 5%."""
    from repro.core.strassen import strassen_matmul as jax_strassen
    from repro_torch.core.strassen import strassen_matmul

    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n), dtype=np.float32)
    b = rng.standard_normal((n, n), dtype=np.float32)
    ja16, jb16 = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    ref = np.asarray(ja16, np.float32) @ np.asarray(jb16, np.float32)

    def err(out):
        return float(np.linalg.norm(np.asarray(out, np.float32) - ref) / np.linalg.norm(ref))

    want = err(jax_strassen(ja16, jb16, depth=2, scheme="winograd"))
    got = err(strassen_matmul(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(),
                              depth=2, scheme="winograd").float().numpy())
    print(f"winograd depth 2 bf16 at {n}^2: reference {want:.4e}, port {got:.4e}")
    assert 2e-2 < want < 2.2e-2
    assert abs(got - want) <= 0.01 * want


# ------------------------------------- tests/test_autotune.py, mirrored
@settings(max_examples=20, deadline=None)
@given(
    logm=st.integers(min_value=5, max_value=8),
    logk=st.integers(min_value=5, max_value=8),
    logn=st.integers(min_value=5, max_value=8),
    min_dim=st.sampled_from([1, 64, 4096]),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
)
def test_property_auto_matches_matmul(logm, logk, logn, min_dim, seed):
    rng = np.random.default_rng(seed)
    m, k, n = 2**logm, 2**logk, 2**logn
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    got = matmul(x, w, _auto_backend(min_dim=min_dim))
    np.testing.assert_allclose(got.numpy(), (x @ w).numpy(), atol=3e-3, rtol=3e-3)


@pytest.mark.parametrize("shape", [(96, 96, 96), (100, 60, 36), (33, 65, 17)])
def test_auto_odd_and_non_pow2_shapes(shape):
    """Divisibility guard: odd dims route to shallower depth or naive."""
    m, k, n = shape
    x, w = _rand((m, k)), _rand((k, n))
    got = matmul(x, w, _auto_backend(min_dim=1))
    np.testing.assert_allclose(got.numpy(), (x @ w).numpy(), atol=3e-3, rtol=3e-3)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-3), (torch.bfloat16, 1.5e-1)])
def test_auto_dtypes(dtype, tol):
    x, w = _rand((128, 128), dtype), _rand((128, 128), dtype)
    got = matmul(x, w, _auto_backend(min_dim=1))
    want = torch.matmul(x, w)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=tol, rtol=tol)


def test_auto_under_inference_mode_and_batched_lead_dims():
    x, w = _rand((4, 32, 128)), _rand((128, 64))
    with torch.inference_mode():
        got = matmul(x, w, _auto_backend(min_dim=1))
    np.testing.assert_allclose(got.numpy(), (x @ w).numpy(), atol=3e-3, rtol=3e-3)


def test_never_selects_strassen_below_min_dim():
    for m, k, n in [(512, 512, 512), (1023, 1024, 1024), (64, 4096, 4096)]:
        cands = enumerate_candidates(m, k, n, min_dim=1024, **CPU)
        assert cands == [Candidate(kind="naive")], (m, k, n, cands)
        d = autotune.autotune(m, k, n, min_dim=1024, calibration=CALIB, **CPU)
        assert d.kind == "naive" and d.depth == 0


def test_depth_respects_divisibility_per_level():
    # 1028 = 4 * 257: two halvings possible, not three.
    cands = enumerate_candidates(1028, 1028, 1028, min_dim=1, max_depth=3, **CPU)
    depths = {c.depth for c in cands if c.kind == "strassen"}
    assert depths == {1, 2}


def test_enumeration_matches_backend_effective_depth():
    be = MatmulBackend(kind="strassen", depth=3, min_dim=256)
    for dims in [(1024, 1024, 1024), (512, 2048, 1024), (640, 640, 640)]:
        cands = enumerate_candidates(*dims, min_dim=256, max_depth=3, **CPU)
        max_enum = max((c.depth for c in cands if c.kind == "strassen"), default=0)
        assert max_enum == be.effective_depth(*dims), dims


def test_larger_shapes_prefer_strassen_smaller_prefer_naive():
    """The §V-C crossover under fixed constants: selection flips with n."""
    small = autotune.autotune(256, 256, 256, calibration=CALIB, min_dim=1024, **CPU)
    large = autotune.autotune(8192, 8192, 8192, calibration=CALIB, min_dim=1024, **CPU)
    assert small.kind == "naive"
    assert large.kind in ("strassen", "winograd", "strassen_fused")
    assert large.depth >= 1


def test_cache_round_trip_no_remeasure(tmp_path, monkeypatch):
    path = os.path.join(tmp_path, "tuning.json")
    cache = TuningCache(path)
    # 2048 at min_dim 1024: one level, so measuring stays quick on the CPU.
    d1 = autotune.autotune(
        2048, 2048, 2048, calibration=CALIB, cache=cache, measure=True, top_k=1, **CPU
    )
    assert d1.source == "measured" and d1.measured_s is not None
    assert os.path.exists(path)

    # Fresh load: identical decision, and neither measurement nor
    # calibration may run again.
    def boom(*a, **k):
        raise AssertionError("re-measured on a warm cache")

    monkeypatch.setattr(autotune, "measure_seconds", boom)
    monkeypatch.setattr(autotune, "calibrate", boom)
    cache2 = TuningCache(path)
    assert cache2.calibration == CALIB  # calibration persists alongside
    d2 = autotune.autotune(2048, 2048, 2048, cache=cache2, measure=True, top_k=1, **CPU)
    assert d2.source == "cache"
    assert (d2.kind, d2.scheme, d2.depth) == (d1.kind, d1.scheme, d1.depth)
    assert d2.measured_s == d1.measured_s


def test_cache_key_separates_dtype_and_shape():
    kw = dict(device_kind="cpu", device_count=1, schemes=("strassen",),
              min_dim=1024, max_depth=2)
    k1 = cache_key(512, 512, 512, torch.float32, **kw)
    k2 = cache_key(512, 512, 512, torch.bfloat16, **kw)
    k3 = cache_key(512, 512, 1024, torch.float32, **kw)
    assert len({k1, k2, k3}) == 3


def test_backend_resolution_is_cached_per_shape(monkeypatch):
    be = _auto_backend(min_dim=1)
    calls = []
    real = autotune.autotune

    def counting(*a, **k):
        calls.append(a[:3])
        return real(*a, **k)

    monkeypatch.setattr(autotune, "autotune", counting)
    x, w = _rand((64, 64)), _rand((64, 64))
    matmul(x, w, be)
    matmul(x, w, be)  # same shape: lru-cached, no second decision
    assert len(calls) == 1


def test_paper_stage_count_matches_eq25():
    """Stark's Spark-stage count is 2(p-q)+2, pinned against eq. 25."""
    for p, q in [(10, 8), (12, 8), (14, 10), (14, 4)]:
        n, b = 2**p, 2 ** (p - q)
        assert paper_stage_count(n, b) == 2 * (p - q) + 2


def test_stark_vs_mllib_advantage_monotone_in_n():
    """Predicted stark/mllib ratio decreases monotonically with n (§V-C)."""
    ratios = [
        total_cost("stark", n, 16, cores=25) / total_cost("mllib", n, 16, cores=25)
        for n in (2048, 4096, 8192, 16384, 32768)
    ]
    assert all(a > b for a, b in zip(ratios, ratios[1:])), ratios


def test_crossover_monotone_in_n():
    """Auto model: strassen-vs-naive predicted ratio falls monotonically."""
    c = Candidate(kind="strassen", scheme="strassen", depth=1)
    naive = Candidate(kind="naive")
    ratios = [
        predict_seconds(c, n, n, n, CALIB) / predict_seconds(naive, n, n, n, CALIB)
        for n in (512, 1024, 2048, 4096, 8192, 16384)
    ]
    assert all(a > b for a, b in zip(ratios, ratios[1:])), ratios


def test_calibrated_constants_positive():
    """The live calibration on the CPU; on one device t_coll is 0.0 and the
    device count 1, as the reference's calibrate_collective gives them."""
    calib = autotune.calibrate(sample_dim=64, repeats=1, device="cpu")
    assert calib.t_flop > 0.0 and calib.t_elem > 0.0 and calib.t_h2d > 0.0
    assert calib.device_kind == "cpu" and calib.device_count == 1 and calib.t_coll == 0.0
    assert autotune.calibration_snapshot("cpu") == CALIB.to_dict()  # the pinned one, untouched


def test_predictions_positive_and_naive_flops_exact():
    assert predict_seconds(Candidate(kind="naive"), 100, 200, 300, CALIB) == (
        pytest.approx(2.0 * 100 * 200 * 300 * CALIB.t_flop)
    )
    for c in enumerate_candidates(2048, 2048, 2048, min_dim=1, max_depth=3, **CPU):
        assert predict_seconds(c, 2048, 2048, 2048, CALIB) > 0.0


def test_fused_enumerates_when_leaf_runs():
    """strassen_fused appears at every usable depth on devices where the
    fused kernel runs (its plain version, on this CPU suite)."""
    assert compat.fused_leaf_mode("cpu") == "plain"
    cands = enumerate_candidates(4096, 4096, 4096, min_dim=1, max_depth=2, **CPU)
    fused = {c.depth for c in cands if c.kind == "strassen_fused"}
    assert fused == {1, 2}
    assert all(c.scheme == "strassen" for c in cands if c.kind == "strassen_fused")


def test_fused_not_enumerated_without_pallas(monkeypatch):
    monkeypatch.setattr(compat, "fused_leaf_mode", lambda device: "none")
    cands = enumerate_candidates(4096, 4096, 4096, min_dim=1, max_depth=2, **CPU)
    assert not any(c.kind == "strassen_fused" for c in cands)


def test_fused_cache_hit_revalidated_without_the_kernel(monkeypatch):
    """A cached fused decision is dropped where the kernel does not run, as
    the reference drops it where its Pallas leaf does not."""
    cache = TuningCache()
    d1 = autotune.autotune(8192, 8192, 8192, calibration=CALIB, cache=cache, **CPU)
    assert d1.kind == "strassen_fused"
    monkeypatch.setattr(compat, "fused_leaf_mode", lambda device: "none")
    d2 = autotune.autotune(8192, 8192, 8192, calibration=CALIB, cache=cache, **CPU)
    assert d2.source == "predicted" and d2.kind in ("strassen", "winograd")


def test_fused_gate_raises_when_the_kernel_cannot_run():
    """On a CUDA device the gate builds and launches strassen1; a failure
    raises instead of quietly dropping the fused candidates."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        compat.fused_leaf_mode("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        enumerate_candidates(4096, 4096, 4096, min_dim=1, max_depth=1, device="cuda")
    with pytest.raises(ValueError, match="no fused Strassen kernel"):
        compat.fused_leaf_mode("meta")


def test_fused_selected_at_scale_and_executes():
    """Under the fixed constants the fused pipeline wins once dims clear the
    crossover; the candidate executes exactly (checked at a small shape)."""
    d = autotune.autotune(8192, 8192, 8192, calibration=CALIB, min_dim=1024, **CPU)
    assert d.kind == "strassen_fused" and d.depth >= 1
    small = Candidate(kind="strassen_fused", scheme="strassen", depth=d.depth)
    x, w = _rand((256, 256)), _rand((256, 256))
    got = autotune.execute(small, x, w)
    np.testing.assert_allclose(got.numpy(), (x @ w).numpy(), atol=3e-3, rtol=3e-3)


def test_resolve_auto_routes_through_fused_backend(monkeypatch):
    """A fused decision resolves to a kind='strassen_fused' backend and the
    matmul wrapper routes through the fused pipeline."""
    from repro_torch.core import backend

    be = _auto_backend(min_dim=1)
    decision = Decision(kind="strassen_fused", scheme="strassen", depth=1, predicted_s=1e-3)
    monkeypatch.setattr(autotune, "autotune", lambda *a, **k: decision)
    resolved = resolve_auto(256, 256, 256, "float32", be, None, "cpu")
    assert resolved.kind == "strassen_fused" and resolved.depth == 1
    calls = []
    real = backend.strassen_matmul_fused
    monkeypatch.setattr(backend, "strassen_matmul_fused",
                        lambda *a, **k: calls.append(k["depth"]) or real(*a, **k))
    x, w = _rand((256, 256)), _rand((256, 256))
    got = matmul(x, w, be)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), (x @ w).numpy(), atol=3e-3, rtol=3e-3)


def test_fused_predicted_cheaper_than_unfused_strassen():
    """The fused leaf skips the last level's materialized M-terms, so at
    equal depth its predicted cost must be strictly below plain BFS."""
    for depth in (1, 2, 3):
        fused = Candidate(kind="strassen_fused", scheme="strassen", depth=depth)
        plain = Candidate(kind="strassen", scheme="strassen", depth=depth)
        n = 8192
        assert predict_seconds(fused, n, n, n, CALIB) < predict_seconds(plain, n, n, n, CALIB)


def test_t_coll_monotonicity():
    """The candidates the port prices are the local ones of one device: none
    touches the interconnect constant, so their predictions stay constant in
    t_coll, as the reference's local predictions do. The mesh strategies,
    whose predictions grow with t_coll, are refused (queue 1 item 8)."""
    n = 4096
    t_colls = [0.0, 1e-9, 4e-9, 1.6e-8, 6.4e-8]
    for cand in enumerate_candidates(n, n, n, min_dim=1, max_depth=2, **CPU):
        costs = {predict_seconds(cand, n, n, n, dataclasses.replace(CALIB, t_coll=tc))
                 for tc in t_colls}
        want = {ja.predict_seconds(ja.Candidate(*_fields(cand)), n, n, n,
                                   dataclasses.replace(_jcal(CALIB), t_coll=tc)) for tc in t_colls}
        assert costs == want and len(costs) == 1, (cand, costs, want)
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        predict_seconds(Candidate(kind="strassen_2d", depth=2), n, n, n, CALIB)


def test_t_coll_zero_falls_back_to_t_elem():
    """A calibration without t_coll (t_coll=0, what calibrate() gives on one
    device) prices every candidate as one with t_coll = t_elem does, in the
    port and in the reference alike."""
    explicit = dataclasses.replace(CALIB, t_coll=CALIB.t_elem)
    for cand in enumerate_candidates(2048, 2048, 2048, min_dim=1, max_depth=3, **CPU):
        base = predict_seconds(cand, 2048, 2048, 2048, CALIB)
        assert base == predict_seconds(cand, 2048, 2048, 2048, explicit)
        assert base == ja.predict_seconds(ja.Candidate(*_fields(cand)), 2048, 2048, 2048,
                                          _jcal(explicit))


def test_mesh_and_oot_raise_not_implemented():
    """In place of the mesh tests: a mesh names the ROADMAP item that ports
    it, and no other candidate is picked instead. The out-of-core family
    once raised here too (queue 1 item 6); it is ported now, and its
    decision and product under a budget are the reference's."""
    for fn in (autotune.autotune, enumerate_candidates):
        with pytest.raises(NotImplementedError, match="queue 1 item 8"):
            fn(512, 512, 512, mesh=object(), **CPU)
    x = _rand((64, 64))
    for kind in ("strassen_bfs_sharded", "strassen_fused_sharded"):
        for fn in (lambda c: autotune.execute(c, x, x),
                   lambda c: autotune.predict_cost_terms(c, 512, 512, 512, CALIB)):
            with pytest.raises(NotImplementedError, match="queue 1 item 8"):
                fn(Candidate(kind=kind, depth=1))
    budget = 3 * 128 * 128 * 4  # the dense 512^2 working set does not fit
    got = autotune.autotune(512, 512, 512, oot_budget=budget, calibration=CALIB, **CPU)
    want = ja.autotune(512, 512, 512, oot_budget=budget, calibration=_jcal(CALIB))
    assert got.to_dict() == want.to_dict() and got.kind == "strassen_oot"
    a, b = _rand((512, 512)), _rand((512, 512))
    out = matmul(a, b, _auto_backend(min_dim=1, device_budget=budget))
    ref = jb.matmul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                    jb.MatmulBackend(kind="auto", depth=2, min_dim=1, device_budget=budget))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-3, rtol=3e-3)


@pytest.mark.parametrize("first", ["cpu", "cuda"])
def test_cache_calibration_costs_only_its_own_platform(first, monkeypatch):
    """One anonymous process cache serves the CPU and the card: each miss is
    costed with its own device's constants, whichever device resolved first,
    and autotune_stats' calibration is the one that costed the device's misses."""
    gpu_calib = dataclasses.replace(CALIB_CHEAP_ELEM, device_kind="gpu")
    cpu_calib = dataclasses.replace(CALIB, device_kind="cpu")
    monkeypatch.setattr(autotune, "_CALIBRATIONS", {"cpu": cpu_calib, "cuda": gpu_calib})
    monkeypatch.setattr(compat, "fused_leaf_mode", lambda device: "plain")
    own = {"cpu": cpu_calib, "cuda": gpu_calib}
    shape = (4096, 4096, 4096)
    want = {d: autotune.autotune(*shape, calibration=own[d], device=d).to_dict() for d in own}
    assert want["cpu"] != want["cuda"]  # the constants lead to different decisions
    cache = autotune.process_cache(None)
    for device in (first, "cuda" if first == "cpu" else "cpu"):
        got = autotune.autotune(*shape, cache=cache, device=device)
        assert got.to_dict() == want[device], device
        assert autotune.costing_calibration(cache, device) == own[device].to_dict()
    assert cache.calibration == own[first]  # the file keeps the first fit, as the reference's does


def test_jax_written_cpu_cache_does_not_cost_the_card(tmp_path, monkeypatch):
    """A cache the JAX package wrote on the CPU answers the CPU's keys, but
    its CPU constants never cost a decision on the card."""
    path = str(tmp_path / "tuning.json")
    jax_cpu = dataclasses.replace(CALIB, device_kind="cpu")
    ja.autotune(4096, 4096, 4096, calibration=_jcal(jax_cpu), cache=ja.TuningCache(path))
    gpu_calib = dataclasses.replace(CALIB_CHEAP_ELEM, device_kind="gpu")
    monkeypatch.setattr(autotune, "_CALIBRATIONS", {"cuda": gpu_calib})
    monkeypatch.setattr(compat, "fused_leaf_mode", lambda device: "plain")
    cache = TuningCache(path)
    assert cache.calibration == jax_cpu
    assert autotune.autotune(4096, 4096, 4096, cache=cache, **CPU).source == "cache"
    got = autotune.autotune(4096, 4096, 4096, cache=cache, device="cuda")
    assert got.to_dict() == autotune.autotune(
        4096, 4096, 4096, calibration=gpu_calib, device="cuda").to_dict()
    assert got.to_dict() != autotune.autotune(
        4096, 4096, 4096, calibration=jax_cpu, device="cuda").to_dict()
    assert autotune.costing_calibration(cache, "cuda") == gpu_calib.to_dict()
    assert autotune.costing_calibration(cache, "cpu") == jax_cpu.to_dict()


def test_cache_key_site_tag_separates_and_composes():
    kw = dict(device_kind="cpu", device_count=1, schemes=("strassen",),
              min_dim=1024, max_depth=2)
    k_plain = cache_key(512, 512, 512, torch.float32, **kw)
    k_q = cache_key(512, 512, 512, torch.float32, site="attn.wq", **kw)
    k_up = cache_key(512, 512, 512, torch.float32, site="mlp.up", **kw)
    assert len({k_plain, k_q, k_up}) == 3
    assert k_q.startswith(k_plain)


def test_site_lookup_falls_back_to_generic_in_predicted_mode():
    cache = TuningCache()
    d1 = autotune.autotune(4096, 4096, 4096, calibration=CALIB, cache=cache, **CPU)
    # the generic entry answers a tagged lookup without a new resolution
    d2 = autotune.autotune(4096, 4096, 4096, calibration=CALIB, cache=cache, site="attn.wq", **CPU)
    assert d2.source == "cache"
    assert (d2.kind, d2.depth) == (d1.kind, d1.depth)
    assert len(cache.entries) == 1


def test_measured_site_decisions_diverge(monkeypatch):
    """Under measure mode, two sites of the same shape hold separate
    entries: the point of call-site keys."""
    cache = TuningCache()
    times = iter([3.0, 1.0, 2.0, 1.0, 2.0, 3.0])  # distinct winners per site
    monkeypatch.setattr(autotune, "measure_seconds", lambda *a, **k: next(times))
    d_q = autotune.autotune(
        4096, 4096, 4096, calibration=CALIB, cache=cache,
        measure=True, top_k=3, site="attn.wq", **CPU,
    )
    d_up = autotune.autotune(
        4096, 4096, 4096, calibration=CALIB, cache=cache,
        measure=True, top_k=3, site="mlp.up", **CPU,
    )
    assert len(cache.entries) == 2
    assert (d_q.kind, d_q.depth) != (d_up.kind, d_up.depth)


def test_resolve_auto_site_is_part_of_memo_key(monkeypatch):
    be = _auto_backend(min_dim=1)
    calls = []
    real = autotune.autotune

    def counting(*a, **k):
        calls.append(k.get("site"))
        return real(*a, **k)

    monkeypatch.setattr(autotune, "autotune", counting)
    x, w = _rand((64, 64)), _rand((64, 64))
    matmul(x, w, be, site="attn.wq")
    matmul(x, w, be, site="attn.wq")  # lru hit
    matmul(x, w, be, site="mlp.up")  # new site: new resolution
    assert calls == ["attn.wq", "mlp.up"]


def test_telemetry_records_hits_misses_and_kinds():
    tel = autotune.get_telemetry()
    tel.reset()
    cache = TuningCache()
    autotune.autotune(4096, 4096, 4096, calibration=CALIB, cache=cache, **CPU)
    autotune.autotune(4096, 4096, 4096, calibration=CALIB, cache=cache, **CPU)
    snap = tel.snapshot()
    assert snap["cache_misses"] == 1 and snap["cache_hits"] == 1
    assert sum(snap["kinds"].values()) == 2
    first, second = snap["decisions"]
    assert first["cache_hit"] is False and second["cache_hit"] is True
    assert first["kind"] == second["kind"]
    assert first["predicted_s"] > 0.0
    tel.reset()
    assert tel.snapshot()["cache_hits"] == 0 and not tel.snapshot()["decisions"]


def test_warm_for_model_emits_site_tagged_telemetry():
    tel = autotune.get_telemetry()
    tel.reset()
    cfg = dataclasses.replace(get_smoke_config("phi4_mini_3_8b"), matmul_autotune=True)
    n = autotune.warm_for_model(cfg, tokens=(1, 64), **CPU)
    assert n > 0
    sites = {e.site for e in tel.events}
    assert {"attn.wq", "mlp.up"} <= sites
    assert None not in sites
    # predicted-mode decisions dedupe to shape-only entries: equal-shape
    # sites share one cache row instead of storing identical copies
    cache = autotune.process_cache(cfg.matmul_backend.tuning_cache)
    assert cache.entries and not any("|site:" in k for k in cache.entries)


def test_model_config_autotune_flag_rewrites_backend():
    cfg = get_smoke_config("phi4_mini_3_8b")
    assert cfg.matmul_backend.kind != "auto"
    cfg_auto = dataclasses.replace(cfg, matmul_autotune=True)
    assert cfg_auto.matmul_backend.kind == "auto"
    assert hash(cfg_auto) is not None  # stays usable as an lru_cache key


def test_warm_for_model_counts_resolutions():
    cfg = dataclasses.replace(get_smoke_config("phi4_mini_3_8b"), matmul_autotune=True)
    n = autotune.warm_for_model(cfg, tokens=(1, 64), **CPU)
    assert n > 0
    # every warmed shape now resolves from the lru cache: no new decisions
    info_before = resolve_auto.cache_info().currsize
    autotune.warm_for_model(cfg, tokens=(1, 64), **CPU)
    assert resolve_auto.cache_info().currsize == info_before


def test_reset_telemetry_and_caller_owned_log():
    """reset_telemetry() zeroes the process log (how Engine scopes its stats
    per instance), and autotune(telemetry=...) records to a caller-owned
    Telemetry, leaving the process log untouched."""
    tel = autotune.get_telemetry()
    tel.reset()
    autotune.autotune(4096, 4096, 4096, calibration=CALIB, cache=TuningCache(), **CPU)
    assert tel.snapshot()["cache_misses"] == 1
    assert autotune.reset_telemetry() is tel
    snap = tel.snapshot()
    assert snap["cache_hits"] == 0 and snap["cache_misses"] == 0
    assert not snap["decisions"]
    own = autotune.Telemetry()
    autotune.autotune(
        4096, 4096, 4096, calibration=CALIB, cache=TuningCache(), telemetry=own, **CPU
    )
    assert own.cache_misses == 1 and len(own.events) == 1
    assert tel.snapshot()["cache_misses"] == 0  # process log untouched


# ------------------------------------------------- the out-of-core family
OOT_BUDGETS = [1 << 20, 3 * 256 * 256 * 4, 16 << 20, 64 << 20, 1 << 30]


@pytest.mark.parametrize("budget", OOT_BUDGETS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_oot_candidates_equal_reference(budget, dtype):
    for m, k, n in SHAPES:
        for min_dim, max_depth in ((1024, 2), (64, 2), (1, 3), (192, 2)):
            kw = dict(min_dim=min_dim, max_depth=max_depth, oot_budget=budget)
            got = enumerate_candidates(m, k, n, dtype=dtype, **kw, **CPU)
            want = ja.enumerate_candidates(m, k, n, dtype=JDTYPES[dtype], **kw)
            assert [_fields(c) for c in got] == [_fields(c) for c in want], (m, k, n, kw)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("calib", [
    CALIB, Calibration(t_flop=3.1e-14, t_elem=7.7e-12, device_kind="gpu", t_h2d=4.4e-11),
    Calibration(t_flop=1e-11, t_elem=1e-9, device_kind="gpu", t_h2d=2e-7),
], ids=["default", "gpu_like", "transfer_bound"])
def test_oot_cost_terms_equal_reference(overlap, calib):
    jcal = _jcal(calib)
    for m, k, n in SHAPES:
        for scheme in ("strassen", "winograd"):
            for depth in (1, 2, 3, 5):
                c = Candidate(kind="strassen_oot", scheme=scheme, depth=depth)
                got = autotune.predict_cost_terms(c, m, k, n, calib, oot_overlap=overlap)
                want = ja.predict_cost_terms(ja.Candidate(*_fields(c)), m, k, n, jcal,
                                             device_count=1, oot_overlap=overlap)
                assert got == want, (c, m, k, n)
                assert got["t_h2d"] > 0.0 and got["t_coll"] == 0.0
                assert predict_seconds(c, m, k, n, calib, oot_overlap=overlap) == ja.predict_seconds(
                    ja.Candidate(*_fields(c)), m, k, n, jcal, oot_overlap=overlap)
    assert autotune.OOT_OVERLAP_EXPOSED_FRACTION == ja.OOT_OVERLAP_EXPOSED_FRACTION


def test_oot_overlap_discount_hides_staged_transfer_cost():
    cand = Candidate(kind="strassen_oot", scheme="strassen", depth=2)
    calib = dataclasses.replace(CALIB, t_h2d=2e-9)
    raw = autotune.predict_cost_terms(cand, 4096, 4096, 4096, calib, oot_overlap=False)
    dft = autotune.predict_cost_terms(cand, 4096, 4096, 4096, calib)
    assert dft["t_flop"] == raw["t_flop"] and 0.0 < dft["t_h2d"] < raw["t_h2d"]
    hidden = min(raw["t_h2d"], raw["t_flop"])
    assert dft["t_h2d"] == pytest.approx(
        max(raw["t_h2d"] - raw["t_flop"], 0.0)
        + autotune.OOT_OVERLAP_EXPOSED_FRACTION * hidden)
    for other in (Candidate(kind="naive"), Candidate(kind="strassen", depth=2)):
        assert autotune.predict_cost_terms(other, 4096, 4096, 4096, calib)["t_h2d"] == 0.0


@pytest.mark.parametrize("budget", OOT_BUDGETS)
def test_oot_decisions_equal_reference(budget):
    """Decisions under a budget (the overlap discount priced only where the
    pipelined slot fits) are the reference's, key and telemetry terms too."""
    calib = dataclasses.replace(CALIB, t_h2d=2e-9)
    tel = autotune.Telemetry()
    jtel = ja.Telemetry()
    for m, k, n in SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            kw = dict(min_dim=64, max_depth=2, oot_budget=budget)
            got = autotune.autotune(m, k, n, dt, calibration=calib, telemetry=tel, **kw, **CPU)
            want = ja.autotune(m, k, n, JDTYPES[dt], calibration=_jcal(calib), telemetry=jtel,
                               **kw)
            assert got.to_dict() == want.to_dict(), (m, k, n, dt)
    assert [e.to_dict() for e in tel.events] == [
        {**e.to_dict(), "key": e.key} for e in jtel.events]


def test_oot_pipeline_fits_equals_reference():
    for n in (512, 4096, 16384):
        for depth in (1, 2, 3):
            for budget in (None, 0, 1 << 20, 64 << 20, 1 << 30):
                assert autotune._oot_pipeline_fits(n, n, n, depth, "float32", budget) == (
                    ja._oot_pipeline_fits(n, n, n, depth, jnp.float32, budget))


def test_oot_execute_and_measure_on_the_cpu():
    cand = Candidate(kind="strassen_oot", scheme="winograd", depth=1)
    a, b = _rand((96, 80)), _rand((80, 72))
    got = autotune.execute(cand, a, b, oot_budget=1 << 20)
    want = ja.execute(ja.Candidate(*_fields(cand)), jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                      oot_budget=1 << 20)
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    assert autotune.measure_seconds(cand, 96, 80, 72, repeats=1, oot_budget=1 << 20, **CPU) > 0


def test_resolve_auto_routes_oot_decision_and_keeps_its_scheme(monkeypatch):
    decision = Decision(kind="strassen_oot", scheme="winograd", depth=1, predicted_s=1e-3)
    real = autotune.autotune

    def fake(m, *args, **kwargs):  # only the outer shape resolves out of core
        return decision if m == 2048 else real(m, *args, **kwargs)

    monkeypatch.setattr(autotune, "autotune", fake)
    be = _auto_backend(min_dim=1, device_budget=1 << 20)
    resolved = resolve_auto(2048, 2048, 2048, "float32", be, None, "cpu")
    assert resolved.kind == "strassen_oot" and resolved.scheme_name == "winograd"
    assert resolved.depth == 1 and resolved.device_budget == 1 << 20
    a, b = _rand((96, 96)), _rand((96, 96))
    np.testing.assert_allclose(matmul(a, b, resolved).numpy(), (a @ b).numpy(), atol=2e-3,
                               rtol=2e-3)


def test_auto_with_budget_under_compile_never_picks_oot(monkeypatch):
    """A compiling caller cannot run the host-resident family: kind 'auto'
    resolves it without the budget, even where the eager resolution picks
    strassen_oot."""
    budget = 3 * 32 * 32 * 4
    d = autotune.autotune(256, 256, 256, min_dim=1, max_depth=3, calibration=CALIB,
                          oot_budget=budget, **CPU)
    assert d.kind == "strassen_oot"
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    a, b = _rand((256, 256)), _rand((256, 256))
    out = matmul(a, b, _auto_backend(depth=3, min_dim=1, device_budget=budget))
    np.testing.assert_allclose(out.numpy(), (a @ b).numpy(), atol=3e-3, rtol=3e-3)
    with pytest.raises(ValueError, match="torch.compile"):
        matmul(a, b, MatmulBackend(kind="strassen_oot", depth=1, min_dim=1))


# ------------------------------------------------------ the solver families
@pytest.mark.parametrize("op,nrhs", [("inverse", None), ("solve", 128), ("solve", None)])
def test_solver_terms_equal_reference(op, nrhs):
    calib = dataclasses.replace(CALIB, t_h2d=2e-9)
    for n in (256, 1000, 8192):
        for depth in range(0, 5):
            for overlap in (True, False):
                got = autotune.predict_solver_terms(op, n, depth, calib, nrhs=nrhs,
                                                    oot_overlap=overlap)
                want = ja.predict_solver_terms(op, n, depth, _jcal(calib), nrhs=nrhs,
                                               oot_overlap=overlap)
                assert got == want, (n, depth, overlap)
                assert autotune.predict_solver_seconds(op, n, depth, calib, nrhs=nrhs) == (
                    ja.predict_solver_seconds(op, n, depth, _jcal(calib), nrhs=nrhs))


@pytest.mark.parametrize("budget", [96 << 10, 1 << 20, 128 << 20, None])
def test_autotune_solver_equals_reference_and_caches(budget):
    cache, jcache = TuningCache(), ja.TuningCache()
    for op, n, nrhs in (("inverse", 512, None), ("solve", 512, 128), ("inverse", 8192, None)):
        kw = dict(nrhs=nrhs, oot_budget=budget, max_depth=10)
        got = autotune.autotune_solver(op, n, torch.float32, cache=cache, calibration=CALIB,
                                       **kw, **CPU)
        want = ja.autotune_solver(op, n, jnp.float32, cache=jcache, calibration=_jcal(CALIB),
                                  **kw)
        assert got.to_dict() == want.to_dict()
        assert autotune.autotune_solver(op, n, torch.float32, cache=cache, **kw,
                                        **CPU).source == "cache"
    assert set(cache.entries) == set(jcache.entries) and len(cache.entries) == 3
    with pytest.raises(ValueError, match="unknown solver op"):
        autotune.autotune_solver("lu", 256, **CPU)
