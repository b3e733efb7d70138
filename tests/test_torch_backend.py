"""Port parity: repro_torch.core.backend against repro.core.backend.

``matmul`` of the four kinds the port runs is held against the JAX backend on
the same numpy inputs (fp32 to 2e-4, the JAX matmul kernels' tolerance; bf16
to 1e-2 normwise), with a small ``min_dim`` so Strassen levels really run.
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
def test_unported_kinds_raise_not_implemented(kind, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1 {item}"):
        tb.matmul(torch.zeros(4, 4), torch.zeros(4, 4), tb.MatmulBackend(kind=kind))


def test_w_logical_raises_not_implemented():
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 8"):
        tb.matmul(torch.zeros(4, 4), torch.zeros(4, 4), tb.MatmulBackend(kind="strassen"),
                  w_logical=("fsdp", "d_ff"))


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
