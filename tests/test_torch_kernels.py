"""Port parity: repro_torch.kernels against the Pallas kernels of repro.kernels.

On the CPU every wrapper computes its kernel's plain version, so these tests
hold the plain versions and the pipelines built on them against the Pallas
functions, run in interpret mode as their own tests run them. Tolerances are
the JAX tests' own (tests/test_kernels_matmul.py, test_kernels_strassen.py):
divide/combine 1e-6, matmul 2e-4 (bf16 2e-1), strassen1 and the pipelines
5e-4 (bf16 5e-1). tests/test_torch_cuda.py holds the CUDA kernels
themselves against these plain versions on the card.
"""
import pytest

torch = pytest.importorskip("torch")

import ast
import inspect

import jax.numpy as jnp
import numpy as np

from repro.core.coefficients import get_scheme
from repro.kernels import common as jcommon
from repro.kernels.matmul import ops as jmm
from repro.kernels.strassen import ops as jops
from repro.kernels.strassen import strassen as jst
from repro_torch.kernels import _build, common
from repro_torch.kernels.matmul import matmul as tmm_kernel
from repro_torch.kernels.matmul import ops as tmm
from repro_torch.kernels.matmul import ref as tmm_ref
from repro_torch.kernels.strassen import ops as tops
from repro_torch.kernels.strassen import ref as tref
from repro_torch.kernels.strassen import strassen as tst

RNG = np.random.default_rng(5)
SCHEMES = ["strassen", "winograd", "naive8"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL_MM = {"float32": 2e-4, "bfloat16": 2e-1}
TOL_STRASSEN = {"float32": 5e-4, "bfloat16": 5e-1}


def _pair(shape, dtype="float32"):
    """The same seeded values as a JAX array and a torch tensor of ``dtype``."""
    x = RNG.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


# ------------------------------------------------- plain versions vs Pallas
@pytest.mark.parametrize("scheme_name", SCHEMES)
@pytest.mark.parametrize("m,h,w", [(1, 64, 64), (7, 32, 64), (4, 128, 128)])
def test_divide_matches_pallas(scheme_name, m, h, w):
    s = get_scheme(scheme_name)
    jx, tx = _pair((m, 4, h, w))
    for coef in (s.a_coef, s.b_coef):
        got = tst.divide_cuda(tx, coef)
        assert got.shape == (m, s.rank, h, w) and got.dtype == torch.float32
        _close(got, jst.divide_pallas(jx, coef, block=64), 1e-6)


@pytest.mark.parametrize("scheme_name", SCHEMES)
@pytest.mark.parametrize("m,h,w", [(1, 64, 64), (7, 32, 32)])
def test_combine_matches_pallas(scheme_name, m, h, w):
    s = get_scheme(scheme_name)
    jx, tx = _pair((m, s.rank, h, w))
    got = tst.combine_cuda(tx, s.c_coef)
    assert got.shape == (m, 4, h, w)
    _close(got, jst.combine_pallas(jx, s.c_coef, block=32), 1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mb,m2,k2,n2", [(1, 64, 64, 64), (7, 32, 64, 32), (2, 128, 128, 128)])
def test_strassen1_matches_pallas(mb, m2, k2, n2, dtype):
    jaq, taq = _pair((mb, 4, m2, k2), dtype)
    jbq, tbq = _pair((mb, 4, k2, n2), dtype)
    got = tst.strassen1_matmul_cuda(taq, tbq)
    assert got.shape == (mb, 4, m2, n2) and got.dtype == DTYPES[dtype][1]
    want = jst.strassen1_matmul_pallas(jaq, jbq, block_m=32, block_n=32, block_k=32)
    _close(got, want, TOL_STRASSEN[dtype])


@pytest.mark.parametrize("scheme_name", ["winograd", "naive8"])
def test_strassen1_other_schemes_match_pallas(scheme_name):
    jaq, taq = _pair((2, 4, 32, 64))
    jbq, tbq = _pair((2, 4, 64, 32))
    got = tst.strassen1_matmul_cuda(taq, tbq, scheme=scheme_name)
    want = jst.strassen1_matmul_pallas(
        jaq, jbq, scheme=scheme_name, block_m=32, block_n=32, block_k=32
    )
    _close(got, want, TOL_STRASSEN["float32"])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mb,m,k,n", [(7, 64, 64, 64), (49, 32, 32, 32), (1, 128, 64, 128)])
def test_batched_matmul_matches_pallas(mb, m, k, n, dtype):
    ja, ta = _pair((mb, m, k), dtype)
    jb, tb = _pair((mb, k, n), dtype)
    got = tmm.batched_matmul(ta, tb)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, jmm.batched_matmul(ja, jb, block_m=64, block_n=64, block_k=64), TOL_MM[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "m,k,n,bm,bn,bk",
    [
        (128, 128, 128, 128, 128, 128),
        (256, 128, 64, 128, 64, 64),
        (64, 192, 128, 32, 128, 64),
        (8, 16, 8, 8, 8, 16),
        (96, 80, 112, 128, 128, 128),
    ],
)
def test_matmul_matches_pallas(m, k, n, bm, bn, bk, dtype):
    ja, ta = _pair((m, k), dtype)
    jb, tb = _pair((k, n), dtype)
    got = tmm.matmul(ta, tb)
    assert got.shape == (m, n) and got.dtype == DTYPES[dtype][1]
    _close(got, jmm.matmul(ja, jb, block_m=bm, block_n=bn, block_k=bk), TOL_MM[dtype])


def test_plain_divide_matches_the_einsum():
    """The plain divide is the JAX oracle's einsum (divide_ref), and the
    wrapper on a CPU tensor returns exactly the plain version."""
    s = get_scheme("winograd")
    _, x = _pair((3, 4, 8, 8))
    want = torch.einsum("pq,mqij->mpij", torch.as_tensor(s.a_coef, dtype=torch.float32), x)
    got = tref.divide_ref(x, s.a_coef)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
    assert torch.equal(tst.divide_cuda(x, s.a_coef), got)


# ------------------------------------------------- pipelines vs Pallas
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("pipeline", ["strassen_matmul_stages", "strassen_matmul_fused"])
def test_pipelines_match_pallas(depth, pipeline):
    ja, ta = _pair((128, 128))
    jb, tb = _pair((128, 128))
    got = getattr(tops, pipeline)(ta, tb, depth=depth)
    _close(got, getattr(jops, pipeline)(ja, jb, depth=depth), 5e-4)
    _close(got, ta.double() @ tb.double(), 5e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("depth", [1, 2])
def test_fused_matches_pallas_dtypes(depth, dtype):
    ja, ta = _pair((128, 96), dtype)
    jb, tb = _pair((96, 64), dtype)
    got = tops.strassen_matmul_fused(ta, tb, depth=depth)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, jops.strassen_matmul_fused(ja, jb, depth=depth), TOL_STRASSEN[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n", [(33, 65, 17), (100, 60, 36), (127, 129, 64)])
def test_fused_padded_odd_shapes_match_pallas(m, k, n, dtype):
    ja, ta = _pair((m, k), dtype)
    jb, tb = _pair((k, n), dtype)
    for depth in (1, 2):
        got = tops.strassen_matmul_fused_padded(ta, tb, depth=depth)
        assert got.shape == (m, n) and got.dtype == DTYPES[dtype][1]
        want = jops.strassen_matmul_fused_padded(ja, jb, depth=depth)
        _close(got, want, TOL_STRASSEN[dtype])


def test_fused_padded_is_fused_on_divisible_shapes():
    _, ta = _pair((64, 64))
    _, tb = _pair((64, 64))
    assert torch.equal(
        tops.strassen_matmul_fused_padded(ta, tb, depth=2),
        tops.strassen_matmul_fused(ta, tb, depth=2),
    )
    with pytest.raises(ValueError, match="depth >= 1"):
        tops.strassen_matmul_fused(ta, tb, depth=0)


@pytest.mark.parametrize("scheme_name", ["winograd", "naive8"])
def test_pipelines_other_schemes_match_pallas(scheme_name):
    ja, ta = _pair((64, 64))
    jb, tb = _pair((64, 64))
    for pipeline in ("strassen_matmul_stages", "strassen_matmul_fused"):
        got = getattr(tops, pipeline)(ta, tb, depth=1, scheme_name=scheme_name)
        want = getattr(jops, pipeline)(ja, jb, depth=1, scheme_name=scheme_name)
        _close(got, want, 5e-4)


# ------------------------------------------------- wrappers and helpers
def test_common_helpers_match_reference():
    for dim in (1, 7, 96, 128, 256, 384, 1000, 4096):
        for pref in (8, 64, 256):
            assert common.pick_block(dim, pref) == jcommon.pick_block(dim, pref)
    for a, b in ((0, 4), (1, 4), (8, 4), (9, 4)):
        assert common.cdiv(a, b) == jcommon.cdiv(a, b)
    assert common.on_cuda(torch.zeros(1)) is False
    with pytest.raises(ValueError, match="no kernel for device"):
        common.on_cuda(torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="different devices"):
        common.on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))


def test_wrappers_reject_bad_input():
    s = get_scheme("strassen")
    x = torch.zeros(1, 4, 8, 8)
    with pytest.raises(ValueError):
        tst.divide_cuda(torch.zeros(1, 3, 8, 8), s.a_coef)
    with pytest.raises(ValueError):
        tst.combine_cuda(torch.zeros(1, 6, 8, 8), s.c_coef)
    with pytest.raises(TypeError):
        tst.divide_cuda(x.half(), s.a_coef)
    with pytest.raises(TypeError):
        tst.strassen1_matmul_cuda(x, x.bfloat16())
    with pytest.raises(ValueError):
        tst.strassen1_matmul_cuda(x, torch.zeros(1, 4, 4, 8))
    with pytest.raises(ValueError):
        tmm_kernel.batched_matmul_cuda(torch.zeros(2, 3, 4), torch.zeros(2, 5, 6))
    with pytest.raises(TypeError):
        tmm_kernel.batched_matmul_cuda(torch.zeros(1, 3, 4), torch.zeros(1, 4, 6).double())
    with pytest.raises(ValueError):
        tmm_kernel.matmul_cuda(torch.zeros(3), torch.zeros(3, 4))


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    s = get_scheme("strassen")
    _, x = _pair((2, 4, 8, 8))
    _, y = _pair((2, 4, 8, 8))
    before = [f.launches for f in (tst.divide_cuda, tst.combine_cuda,
                                   tst.strassen1_matmul_cuda, tmm_kernel.batched_matmul_cuda)]
    assert torch.equal(tst.divide_cuda(x, s.a_coef), tref.divide_ref(x, s.a_coef))
    assert torch.equal(tst.strassen1_matmul_cuda(x, y), tref.strassen1_matmul_ref(x, y))
    assert torch.equal(tmm.batched_matmul(x[0], y[0]), tmm_ref.batched_matmul_ref(x[0], y[0]))
    after = [f.launches for f in (tst.divide_cuda, tst.combine_cuda,
                                  tst.strassen1_matmul_cuda, tmm_kernel.batched_matmul_cuda)]
    assert before == after


def test_wrappers_compute_nothing_with_torch_matmul():
    """The kernel wrappers leave the work of the Pallas body to the CUDA
    kernel: no torch.matmul/bmm/mm/einsum/compile in their modules."""
    banned = {"matmul", "bmm", "mm", "einsum", "compile"}
    for module in (tst, tmm_kernel):
        tree = ast.parse(inspect.getsource(module))
        used = {
            node.attr for node in ast.walk(tree)
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "torch"
        }
        assert not used & banned, (module.__name__, used & banned)


def test_build_locates_library_and_refuses_without_nvcc(monkeypatch, tmp_path):
    path = _build.library_path()
    assert path == _build.library_path()  # content hash is stable
    assert path.parent.parent == _build.BUILD_ROOT and path.name == "librepro_torch.so"
    assert {p.name for p in _build.CSRC.glob("*.cu")} >= {
        "matmul.cu", "signed_sum.cu", "strassen1.cu",
    }
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
