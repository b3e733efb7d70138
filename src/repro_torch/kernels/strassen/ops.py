"""Public Strassen pipelines composed from the kernels (``repro.kernels.strassen.ops``).

* :func:`strassen_matmul_stages` follows the paper stage by stage: every
  divide and combine level is materialized, as Stark's shuffles are, but
  each level's additions run in one divide/combine kernel and the leaves in
  the batched matmul kernel.
* :func:`strassen_matmul_fused` unrolls einsum levels down to the last,
  which runs whole inside the fused kernel. Backend kind ``strassen_fused``
  uses it.
* :func:`strassen_matmul_fused_padded` zero-pads odd dims for it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.coefficients import get_scheme
from repro_torch.core.strassen import (
    combine_level,
    divide_level,
    merge_quadrants,
    split_quadrants,
)
from repro_torch.kernels.matmul.matmul import batched_matmul_cuda
from repro_torch.kernels.strassen.strassen import (
    combine_cuda,
    divide_cuda,
    strassen1_matmul_cuda,
)

__all__ = [
    "strassen_matmul_stages",
    "strassen_matmul_fused",
    "strassen_matmul_fused_padded",
]


def strassen_matmul_stages(
    a: torch.Tensor, b: torch.Tensor, *, depth: int = 1, scheme_name: str = "strassen"
) -> torch.Tensor:
    """Stage-by-stage Stark pipeline with one kernel per stage."""
    scheme = get_scheme(scheme_name)
    ta, tb = a[None], b[None]
    for _ in range(depth):
        ta = divide_cuda(split_quadrants(ta), scheme.a_coef).flatten(0, 1)
        tb = divide_cuda(split_quadrants(tb), scheme.b_coef).flatten(0, 1)
    prod = batched_matmul_cuda(ta, tb)
    for _ in range(depth):
        grouped = prod.reshape(-1, scheme.n_mults, *prod.shape[1:])
        prod = merge_quadrants(combine_cuda(grouped, scheme.c_coef))
    return prod[0]


def strassen_matmul_fused(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    depth: int = 1,
    scheme_name: str = "strassen",
    precision: Optional[str] = None,
) -> torch.Tensor:
    """Fused pipeline: the last level runs whole inside the kernel.

    The depth-1 outer levels are unrolled einsums at the caller's
    ``precision``; the last level never materializes its 7/4x
    intermediates and always accumulates in fp32 with fp32 products.
    """
    if depth < 1:
        raise ValueError("fused pipeline needs depth >= 1")
    scheme = get_scheme(scheme_name)
    ta, tb = a[None], b[None]
    for _ in range(depth - 1):
        ta = divide_level(ta, scheme.a_coef, precision=precision)
        tb = divide_level(tb, scheme.b_coef, precision=precision)
    cq = strassen1_matmul_cuda(split_quadrants(ta), split_quadrants(tb), scheme=scheme)
    prod = merge_quadrants(cq)
    for _ in range(depth - 1):
        prod = combine_level(prod, scheme.c_coef, precision=precision)
    return prod[0]


def strassen_matmul_fused_padded(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    depth: int = 1,
    scheme_name: str = "strassen",
    precision: Optional[str] = None,
) -> torch.Tensor:
    """Fused pipeline for any (M, K) @ (K, N), odd dims included.

    Zero-pads each dim up to the next multiple of 2**depth, runs
    :func:`strassen_matmul_fused`, and slices back. Padding contributes
    exactly zero to every M-term (the scheme is bilinear), so the unpadded
    block of C is exact.
    """
    m, k = a.shape
    n = b.shape[1]
    step = 2**depth
    mp, kp, np_ = (-(-d // step) * step for d in (m, k, n))
    if (mp, kp, np_) == (m, k, n):
        return strassen_matmul_fused(
            a, b, depth=depth, scheme_name=scheme_name, precision=precision
        )
    a_p = F.pad(a, (0, kp - k, 0, mp - m))
    b_p = F.pad(b, (0, np_ - n, 0, kp - k))
    out = strassen_matmul_fused(
        a_p, b_p, depth=depth, scheme_name=scheme_name, precision=precision
    )
    return out[:m, :n]
