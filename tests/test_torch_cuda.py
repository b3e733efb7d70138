"""The CUDA kernels of repro_torch against their plain versions, on the card.

These tests need an NVIDIA Hopper GPU and the CUDA toolkit, and skip with a
reason elsewhere; they import no JAX, so they run where the port runs.
Tolerances, as in chip_smoke.py: max|kernel - plain| <= tol * max(1,
max|plain|); divide/combine are bit-exact (the same fp32 sums in the same
order, one rounding); the products accumulate in another order than cuBLAS,
hence 2e-5 in fp32 and 8e-3 (about two bf16 ulps) in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.coefficients import get_scheme
from repro_torch.kernels.matmul import ops as tmm
from repro_torch.kernels.matmul import ref as tmm_ref
from repro_torch.kernels.strassen import ref as tref
from repro_torch.kernels.strassen import strassen as tst

SCHEMES = ["strassen", "winograd", "naive8"]
RNG = np.random.default_rng(17)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(device, shape, dtype):
    x = RNG.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme_name", SCHEMES)
def test_cuda_signed_sum_kernels_are_bit_exact(cuda, scheme_name, dtype):
    s = get_scheme(scheme_name)
    for shape in [(1, 4, 64, 64), (3, 4, 5, 7), (2, 4, 16, 24)]:
        x = _on(cuda, shape, dtype)
        n = tst.divide_cuda.launches
        assert torch.equal(tst.divide_cuda(x, s.a_coef), tref.divide_ref(x, s.a_coef))
        assert tst.divide_cuda.launches == n + 1
        p = _on(cuda, (shape[0], s.rank, *shape[2:]), dtype)
        assert torch.equal(tst.combine_cuda(p, s.c_coef), tref.combine_ref(p, s.c_coef))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("scheme_name", SCHEMES)
def test_cuda_strassen1_matches_plain(cuda, scheme_name, dtype, tol):
    for mb, m2, k2, n2 in [(1, 64, 64, 64), (3, 33, 65, 17), (2, 128, 256, 128)]:
        aq, bq = _on(cuda, (mb, 4, m2, k2), dtype), _on(cuda, (mb, 4, k2, n2), dtype)
        got = tst.strassen1_matmul_cuda(aq, bq, scheme=scheme_name)
        want = tref.strassen1_matmul_ref(aq, bq, scheme_name)
        scale = max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 8e-3)])
def test_cuda_matmul_kernels_match_plain(cuda, dtype, tol):
    for mb, m, k, n in [(7, 64, 64, 64), (3, 100, 70, 130), (1, 8, 192, 8)]:
        a, b = _on(cuda, (mb, m, k), dtype), _on(cuda, (mb, k, n), dtype)
        for got, want in (
            (tmm.batched_matmul(a, b), tmm_ref.batched_matmul_ref(a, b)),
            (tmm.matmul(a[0], b[0]), tmm_ref.matmul_ref(a[0], b[0])),
        ):
            scale = max(1.0, want.float().abs().max().item())
            assert (got.float() - want.float()).abs().max().item() <= tol * scale
    with pytest.raises(ValueError, match="contiguous"):
        tmm.batched_matmul(a.transpose(1, 2), b.transpose(1, 2))
