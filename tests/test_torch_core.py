"""Port parity: repro_torch.core (coefficients, strassen) against repro.core.

The same numpy inputs, made from a seeded generator, go through the JAX
function and its PyTorch counterpart on the CPU. Tolerances: the coefficient
tables and quadrant reshapes must match exactly; fp32 divide/combine levels
(sums of +/-1 terms) to 1e-6; whole fp32 multiplies to 2e-4, the JAX matmul
kernels' own fp32 tolerance; bf16 levels to one bf16 ulp (2^-7 relative).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import coefficients as jc
from repro.core import strassen as js
from repro_torch.core import coefficients as tc
from repro_torch.core import strassen as ts
from repro_torch.core.precision import matmul_precision

SCHEMES = ["strassen", "winograd", "naive8"]
RNG = np.random.default_rng(11)


def _np(shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------- schemes
@pytest.mark.parametrize("name", SCHEMES)
def test_scheme_tables_equal_reference(name):
    got, want = tc.get_scheme(name), jc.get_scheme(name)
    assert got.name == want.name and got.rank == want.rank
    assert (got.n_mults, got.n_adds) == (want.n_mults, want.n_adds)
    for field in ("a_coef", "b_coef", "c_coef"):
        assert np.array_equal(getattr(got, field), getattr(want, field))
        assert getattr(got, field).dtype == getattr(want, field).dtype
    got.validate()
    assert got.exponent() == want.exponent()


def test_scheme_constants_and_unknown_name():
    assert [tc.STRASSEN.name, tc.WINOGRAD.name, tc.NAIVE8.name] == SCHEMES
    with pytest.raises(ValueError, match="unknown scheme"):
        tc.get_scheme("nope")


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_leaf_tag_path_round_trip(depth):
    for index in range(7**depth):
        path = tc.leaf_tag_path(index, depth)
        assert path == jc.leaf_tag_path(index, depth)
        assert tc.leaf_index_from_path(path) == index
    with pytest.raises(ValueError):
        tc.leaf_tag_path(7**depth, depth)
    with pytest.raises(ValueError):
        tc.leaf_index_from_path((7,))


@pytest.mark.parametrize("name", SCHEMES)
@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_leaf_count(name, depth):
    assert ts.leaf_count(tc.get_scheme(name), depth) == js.leaf_count(jc.get_scheme(name), depth)


# ---------------------------------------------------------------- levels
@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 48), (2, 5, 8, 6)])
def test_split_merge_match_reference(shape):
    x = _np(shape)
    got = ts.split_quadrants(_t(x))
    want = np.asarray(js.split_quadrants(jnp.asarray(x)))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ts.merge_quadrants(got).numpy(), x)


def test_split_merge_reject_bad_shapes():
    with pytest.raises(ValueError):
        ts.split_quadrants(torch.zeros(3, 4))
    with pytest.raises(ValueError):
        ts.merge_quadrants(torch.zeros(3, 4, 4))


@pytest.mark.parametrize("name", SCHEMES)
@pytest.mark.parametrize("m,r,c", [(1, 64, 64), (7, 32, 48)])
def test_divide_level_matches_reference(name, m, r, c):
    s = jc.get_scheme(name)
    x = _np((m, r, c))
    for coef in (s.a_coef, s.b_coef):
        got = ts.divide_level(_t(x), coef).numpy()
        want = np.asarray(js.divide_level(jnp.asarray(x), jnp.asarray(coef)))
        assert got.shape == want.shape == (m * s.rank, r // 2, c // 2)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", SCHEMES)
def test_combine_level_matches_reference(name):
    s = jc.get_scheme(name)
    p = _np((3 * s.rank, 16, 24))
    got = ts.combine_level(_t(p), s.c_coef).numpy()
    want = np.asarray(js.combine_level(jnp.asarray(p), jnp.asarray(s.c_coef)))
    assert got.shape == want.shape == (3, 32, 48)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        ts.combine_level(_t(p[:-1]), s.c_coef)


def test_levels_in_bf16_match_reference_to_one_ulp():
    s = jc.STRASSEN
    x = _np((2, 32, 32))
    got = ts.divide_level(_t(x).bfloat16(), s.a_coef)
    want = js.divide_level(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s.a_coef))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=2**-7, atol=2**-7
    )
    p = _np((14, 16, 16))
    got = ts.combine_level(_t(p).bfloat16(), s.c_coef)
    want = js.combine_level(jnp.asarray(p, jnp.bfloat16), jnp.asarray(s.c_coef))
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=2**-7, atol=2**-6
    )


# ---------------------------------------------------------------- pipelines
@pytest.mark.parametrize("name", SCHEMES)
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_strassen_matmul_matches_reference(name, depth):
    a, b = _np((64, 48)), _np((48, 32))
    got = ts.strassen_matmul(_t(a), _t(b), depth=depth, scheme=name).numpy()
    want = np.asarray(js.strassen_matmul(jnp.asarray(a), jnp.asarray(b), depth=depth, scheme=name))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got, a @ b, atol=2e-4, rtol=2e-4)


def test_strassen_matmul_leaf_and_constrain_hooks():
    a, b = _np((32, 32)), _np((32, 16))
    seen = []

    def leaf(x, y):
        seen.append(("leaf", tuple(x.shape), tuple(y.shape)))
        return torch.bmm(x, y)

    def hook(tag):
        def f(t):
            seen.append((tag, tuple(t.shape)))
            return t
        return f

    out = ts.strassen_matmul(
        _t(a), _t(b), depth=2, leaf_fn=leaf,
        constrain_a=hook("a"), constrain_b=hook("b"), constrain_out=hook("out"),
    )
    np.testing.assert_allclose(out.numpy(), a @ b, atol=2e-4, rtol=2e-4)
    assert seen == [
        ("a", (7, 16, 16)), ("b", (7, 16, 8)),
        ("a", (49, 8, 8)), ("b", (49, 8, 4)),
        ("leaf", (49, 8, 8), (49, 8, 4)),
        ("out", (49, 8, 4)), ("out", (7, 16, 8)), ("out", (1, 32, 16)),
    ]


def test_strassen_matmul_rejects_bad_input():
    a = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="bad matmul shapes"):
        ts.strassen_matmul(a, torch.zeros(4, 8), depth=1)
    with pytest.raises(ValueError, match="depth"):
        ts.strassen_matmul(a, a, depth=-1)
    with pytest.raises(ValueError, match="not divisible"):
        ts.strassen_matmul(torch.zeros(6, 8), a, depth=2)


def _tf32() -> bool:
    return torch.backends.cuda.matmul.allow_tf32


def test_strassen_matmul_precision_applies_to_leaf_only(monkeypatch):
    """The default leaf runs at the caller's precision, the divide/combine
    einsums at full fp32, and the process switch is restored afterwards."""
    seen = []
    bmm, einsum = torch.bmm, torch.einsum
    monkeypatch.setattr(torch, "bmm", lambda x, y: (seen.append(("leaf", _tf32())), bmm(x, y))[1])
    monkeypatch.setattr(
        torch, "einsum", lambda *args: (seen.append(("level", _tf32())), einsum(*args))[1]
    )
    before = _tf32()
    a = torch.ones(8, 8)
    ts.strassen_matmul(a, a, depth=1, precision="high")
    assert seen == [("level", False), ("level", False), ("leaf", True), ("level", False)]
    assert _tf32() == before


def test_matmul_precision_scopes_tf32():
    prev = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with matmul_precision("highest"):
            assert not _tf32()
            with matmul_precision("tensorfloat32"):
                assert _tf32()
            assert not _tf32()
        for name in (None, "default", "fastest", "bfloat16", "float32"):
            with matmul_precision(name):
                assert not _tf32()
        assert _tf32()
        with pytest.raises(ValueError, match="unknown matmul precision"):
            with matmul_precision("bogus"):
                pass
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("name", SCHEMES)
def test_strassen_recursive_matches_reference(name):
    a, b = _np((128, 128)), _np((128, 64))
    got = ts.strassen_recursive(_t(a), _t(b), threshold=16, scheme=name).numpy()
    want = np.asarray(
        js.strassen_recursive(jnp.asarray(a), jnp.asarray(b), threshold=16, scheme=name)
    )
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got, a @ b, atol=2e-3, rtol=2e-3)
