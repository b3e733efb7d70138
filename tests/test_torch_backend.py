"""Port parity: repro_torch.core.backend against repro.core.backend.

``matmul`` of the four kinds the port runs is held against the JAX backend on
the same numpy inputs (fp32 to 2e-4, the JAX matmul kernels' tolerance; bf16
to 1e-2 normwise; fp32 against bf16 promoted to fp32, as jnp promotes), with
a small ``min_dim`` so Strassen levels really run.
"""
import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import backend as jb
from repro.obs import tracer as jtracer
from repro_torch import obs
from repro_torch.core import backend as tb

RNG = np.random.default_rng(3)
RUNNABLE = ["naive", "strassen", "winograd", "strassen_fused"]


def _np(shape):
    return RNG.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kind", RUNNABLE)
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("x_shape", [(64, 48), (2, 32, 48)])
def test_matmul_matches_reference(kind, depth, x_shape):
    x, w = _np(x_shape), _np((48, 32))
    got = tb.matmul(torch.from_numpy(x), torch.from_numpy(w),
                    tb.MatmulBackend(kind=kind, depth=depth, min_dim=16))
    want = jb.matmul(jnp.asarray(x), jnp.asarray(w),
                     jb.MatmulBackend(kind=kind, depth=depth, min_dim=16))
    assert tuple(got.shape) == want.shape == (*x_shape[:-1], 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("kind", RUNNABLE)
def test_matmul_bf16_matches_reference(kind):
    x, w = _np((64, 64)), _np((64, 64))
    got = tb.matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                    tb.MatmulBackend(kind=kind, depth=2, min_dim=16))
    want = jb.matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                     jb.MatmulBackend(kind=kind, depth=2, min_dim=16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    err = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert err < 1e-2


@pytest.mark.parametrize("kind", ["naive", "strassen"])
def test_matmul_promotes_mixed_fp32_bf16_as_reference(kind):
    """fp32 x against bf16 w (the sLSTM's input projection): jnp promotes to an
    fp32 product; torch.matmul refuses mixed inputs, so the port promotes first.

    Every kind then equals the fp32 product of the promoted operands (2e-4).
    The JAX strassen kind divides w in bf16 before its fp32 leaf, rounding
    the operand sums to bf16, so there the two backends agree to the bf16
    tolerance of ``test_matmul_bf16_matches_reference`` (1e-2 normwise).
    """
    x, w = _np((2, 32, 64)), _np((64, 32))
    w16 = torch.from_numpy(w).bfloat16()
    backend = dict(kind=kind, depth=2, min_dim=16)
    got = tb.matmul(torch.from_numpy(x), w16, tb.MatmulBackend(**backend))
    want = jb.matmul(jnp.asarray(x), jnp.asarray(w, jnp.bfloat16), jb.MatmulBackend(**backend))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), torch.from_numpy(x) @ w16.float(), atol=2e-4, rtol=2e-4)
    want = np.asarray(want)
    if kind == "naive":
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    else:
        assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) < 1e-2


def test_effective_depth_matches_reference():
    for kind, depth, min_dim, (m, k, n) in itertools.product(
        RUNNABLE, [0, 1, 2, 3], [1, 16, 64],
        [(64, 64, 64), (64, 48, 32), (96, 64, 30), (7, 64, 64), (128, 128, 256)],
    ):
        got = tb.MatmulBackend(kind=kind, depth=depth, min_dim=min_dim)
        want = jb.MatmulBackend(kind=kind, depth=depth, min_dim=min_dim)
        assert got.effective_depth(m, k, n) == want.effective_depth(m, k, n)


def test_kind_registries_match_reference():
    assert tb.VALID_KINDS == jb.VALID_KINDS
    assert tb.EAGER_ONLY_KINDS == jb.EAGER_ONLY_KINDS
    assert tb.JIT_SAFE_KINDS == jb.JIT_SAFE_KINDS
    for kind in tb.VALID_KINDS:
        for schemes in (("strassen", "winograd"), ("winograd",), ()):
            got = tb.MatmulBackend(kind=kind, schemes=schemes)
            want = jb.MatmulBackend(kind=kind, schemes=schemes)
            try:
                expected = want.scheme_name
            except ValueError:
                with pytest.raises(ValueError, match="no scheme"):
                    got.scheme_name
            else:
                assert got.scheme_name == expected
    assert [f.name for f in dataclasses.fields(tb.MatmulBackend)] == [
        f.name for f in dataclasses.fields(jb.MatmulBackend)
    ]


def test_unknown_kind_and_bad_shapes_raise_value_error():
    with pytest.raises(ValueError, match="valid kinds: naive, strassen"):
        tb.MatmulBackend(kind="fast")
    with pytest.raises(ValueError, match="bad shapes"):
        tb.matmul(torch.zeros(4, 3), torch.zeros(4, 3))
    with pytest.raises(ValueError, match="bad shapes"):
        tb.matmul(torch.zeros(4, 3), torch.zeros(3))


@pytest.mark.parametrize("kind,item", [("auto", "item 5"), ("strassen_oot", "item 6")])
def test_unported_kinds_raise_not_implemented(kind, item, monkeypatch):
    """Kind 'auto' (queue 1 item 5) and kind 'strassen_oot' (item 6) once
    raised here. Both are ported: under one pinned calibration 'auto' resolves
    to the JAX package's backend, with or without a device_budget, and
    'strassen_oot' runs the out-of-core runtime; each product is within 3e-3
    of the JAX package's, and the out-of-core result comes back on the
    operands' device with the operands' leading dims."""
    from repro.core import autotune as ja
    from repro_torch.core import autotune as ta

    # Constants under which Strassen wins at 128 (cheap element traffic).
    calib = dict(t_flop=1e-9, t_elem=1e-12, device_kind="cpu", device_count=1)
    monkeypatch.setattr(ja, "_CALIBRATION", ja.Calibration(**calib))
    monkeypatch.setattr(ta, "_CALIBRATIONS", {"cpu": ta.Calibration(**calib)})
    monkeypatch.setattr(ja, "_PROCESS_CACHES", {})
    monkeypatch.setattr(ta, "_PROCESS_CACHES", {})
    jb.resolve_auto.cache_clear()
    tb.resolve_auto.cache_clear()
    x, w = _np((128, 128)), _np((128, 128))
    if kind == "auto":
        be = dict(kind="auto", depth=2, min_dim=32)
        t_res = tb.resolve_auto(128, 128, 128, "float32", tb.MatmulBackend(**be), None, "cpu")
        j_res = jb.resolve_auto(128, 128, 128, "float32", jb.MatmulBackend(**be))
        assert t_res.kind != "naive"
        assert dataclasses.asdict(t_res) == dataclasses.asdict(j_res)
        configs = [be, dict(be, device_budget=3 * 32 * 32 * 4)]
    else:
        configs = [dict(kind="strassen_oot", depth=2, min_dim=1, device_budget=x.nbytes),
                   dict(kind="strassen_oot", depth=1, min_dim=1, device_budget=3 * 32 * 32 * 4 + 1)]
    for be in configs:
        got = tb.matmul(torch.from_numpy(x), torch.from_numpy(w), tb.MatmulBackend(**be))
        want = jb.matmul(jnp.asarray(x), jnp.asarray(w), jb.MatmulBackend(**be))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-3, rtol=3e-3)
        tb.resolve_auto.cache_clear()
        jb.resolve_auto.cache_clear()
    if kind == "strassen_oot":
        x3 = _np((2, 4, 128))
        got = tb.matmul(torch.from_numpy(x3), torch.from_numpy(w), tb.MatmulBackend(**configs[0]))
        assert tuple(got.shape) == (2, 4, 128) and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), x3 @ w, atol=3e-3, rtol=3e-3)


def test_is_oom_error_classifies_allocator_failures():
    """The ladder's OOM test: the caching allocator's error and MemoryError
    by type, allocator messages on a RuntimeError; nothing else."""
    assert tb.is_oom_error(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"))
    assert tb.is_oom_error(MemoryError("host allocator exhausted"))
    assert tb.is_oom_error(RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate"))
    assert tb.is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: out of memory"))
    assert not tb.is_oom_error(RuntimeError("not a fault, a bug"))
    assert not tb.is_oom_error(ValueError("out of memory"))


@pytest.mark.parametrize("kind", RUNNABLE)
def test_w_logical_raises_not_implemented(kind):
    """``w_logical`` once raised here; with no sharding context it is the
    identity in both packages, so the products agree with it set."""
    x, w = _np((2, 32, 48)), _np((48, 32))
    be = dict(kind=kind, depth=1, min_dim=16)
    got = tb.matmul(torch.from_numpy(x), torch.from_numpy(w), tb.MatmulBackend(**be),
                    w_logical=("fsdp", "d_ff"))
    want = jb.matmul(jnp.asarray(x), jnp.asarray(w), jb.MatmulBackend(**be),
                     w_logical=("fsdp", "d_ff"))
    plain = tb.matmul(torch.from_numpy(x), torch.from_numpy(w), tb.MatmulBackend(**be))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("kind", RUNNABLE)
def test_w_logical_under_a_sharding_context_matches_reference(kind):
    """Under a (data 4, model 2) context the port runs the product per
    position, the JAX package under GSPMD on conftest's 8 host devices."""
    import jax

    from repro.launch.mesh import make_mesh_for as jmake_mesh_for
    from repro.models.sharding import use_sharding as juse_sharding
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.sharding import use_sharding

    if jax.device_count() < 8:
        pytest.skip("needs the conftest multi-device host platform")
    x, w = _np((2, 32, 48)), _np((48, 32))
    be = dict(kind=kind, depth=1, min_dim=16)
    mesh = make_mesh_for(8, model_parallel=2, device="cpu")
    with use_sharding(mesh):
        got = tb.matmul(torch.from_numpy(x), torch.from_numpy(w), tb.MatmulBackend(**be),
                        w_logical=("d_ff", "fsdp"))
    with juse_sharding(jmake_mesh_for(8, model_parallel=2)):
        want = jb.matmul(jnp.asarray(x), jnp.asarray(w), jb.MatmulBackend(**be),
                         w_logical=("d_ff", "fsdp"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    assert mesh.count("psum", "model") == 1 and mesh.count("all_gather", "data") == 1


def test_default_precision_matches_reference():
    try:
        for name in (None, "high", "highest", "tensorfloat32", "default"):
            assert tb.set_default_matmul_precision(name) == jb.set_default_matmul_precision(name)
            assert tb.default_matmul_precision() == jb.default_matmul_precision() == name
            for own in (None, "fastest"):
                assert tb.resolve_precision(tb.MatmulBackend(precision=own)) == (
                    jb.resolve_precision(jb.MatmulBackend(precision=own))
                )
        with pytest.raises(ValueError, match="unknown matmul precision"):
            tb.set_default_matmul_precision("half")
    finally:
        tb.set_default_matmul_precision(None)
        jb.set_default_matmul_precision(None)


@pytest.mark.parametrize("precision", [None, "high", "highest"])
def test_matmul_restores_the_tf32_switch(precision):
    before = torch.backends.cuda.matmul.allow_tf32
    x = torch.from_numpy(_np((32, 32)))
    for kind in RUNNABLE:
        tb.matmul(x, x, tb.MatmulBackend(kind=kind, min_dim=8, precision=precision))
        assert torch.backends.cuda.matmul.allow_tf32 == before


def test_span_name_and_attributes_match_reference():
    x, w = _np((2, 32, 48)), _np((48, 16))
    be = dict(kind="strassen", depth=1, min_dim=16)
    obs.reset_tracing()
    obs.configure(enabled=True)
    jtracer.reset_tracing()
    jtracer.configure(enabled=True)
    try:
        tb.matmul(torch.from_numpy(x), torch.from_numpy(w), tb.MatmulBackend(**be), site="mlp.up")
        jb.matmul(jnp.asarray(x), jnp.asarray(w), jb.MatmulBackend(**be), site="mlp.up")
        (got,) = obs.get_tracer().find("backend.matmul")
        (want,) = jtracer.get_tracer().find("backend.matmul")
    finally:
        obs.configure(enabled=False)
        obs.reset_tracing()
        jtracer.configure(enabled=False)
        jtracer.reset_tracing()
    assert (got.name, got.cat) == (want.name, want.cat) == ("backend.matmul", "matmul")
    assert got.attrs == want.attrs == dict(
        m=64, k=48, n=16, kind="strassen", site="mlp.up", traced=False
    )
    assert got.t1 >= got.t0
