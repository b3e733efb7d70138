"""Wrappers of the fused Strassen kernels (``csrc/signed_sum.cu``, ``csrc/strassen1.cu``).

Stark materializes every divide and combine level through a Spark shuffle.
On the card those levels are memory-bound signed sums, so:

* :func:`divide_cuda` / :func:`combine_cuda` (``divide_pallas`` /
  ``combine_pallas``) run one level's additions in a single pass over
  device memory: read 4 quadrant planes and write r operand planes, or read
  r product planes and write 4 C planes. The coefficients are passed in at
  launch from the :class:`Scheme`.
* :func:`strassen1_matmul_cuda` (``strassen1_matmul_pallas``) runs the last
  recursion level whole inside the kernel: per output tile it forms the r
  operand sums, accumulates the r products in fp32 registers and combines
  them into the 4 C quadrants, so none of the level's 7/4x intermediates
  reach device memory. Backend kind ``strassen_fused`` runs through it.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it computes the plain version in ``ref.py``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.coefficients import STRASSEN, Scheme, get_scheme
from repro_torch.kernels import _build
from repro_torch.kernels.common import on_cuda
from repro_torch.kernels.strassen.ref import combine_ref, divide_ref, strassen1_matmul_ref

__all__ = ["divide_cuda", "combine_cuda", "strassen1_matmul_cuda"]


def _floats(*arrays: np.ndarray) -> ctypes.Array:
    """Row-major float32 copy of the arrays, one after the other, for the C side."""
    flat = np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays])
    return (ctypes.c_float * flat.size)(*flat.tolist())


def _signed_sum(x: torch.Tensor, coef: np.ndarray, code: int) -> torch.Tensor:
    """Launch the signed-sum kernel: (m, q, h, w) -> (m, p, h, w)."""
    if not x.is_contiguous():
        raise ValueError("the signed-sum kernel needs a contiguous input")
    m, q, h, w = x.shape
    p = coef.shape[0]
    out = torch.empty((m, p, h, w), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    c = _floats(coef)
    _build.launch(
        "repro_signed_sum", x.device, x.data_ptr(), out.data_ptr(),
        code, m, q, p, h * w, ctypes.addressof(c),
    )
    return out


def divide_cuda(x: torch.Tensor, coef: np.ndarray) -> torch.Tensor:
    """One divide level on quadrant layout: (m, 4, h, w) -> (m, r, h, w)."""
    coef = np.asarray(coef)
    if x.ndim != 4 or x.shape[1] != 4 or coef.ndim != 2 or coef.shape[1] != 4:
        raise ValueError(f"need (m, 4, h, w) and (r, 4), got {tuple(x.shape)}, {coef.shape}")
    code = _build.dtype_code(x)
    if not on_cuda(x):
        return divide_ref(x, coef)
    out = _signed_sum(x, coef, code)
    divide_cuda.launches += 1
    return out


def combine_cuda(products: torch.Tensor, c_coef: np.ndarray) -> torch.Tensor:
    """One combine level on quadrant layout: (m, r, h, w) -> (m, 4, h, w)."""
    c_coef = np.asarray(c_coef)
    if products.ndim != 4 or c_coef.ndim != 2 or c_coef.shape != (4, products.shape[1]):
        raise ValueError(
            f"need (m, r, h, w) and (4, r), got {tuple(products.shape)}, {c_coef.shape}"
        )
    code = _build.dtype_code(products)
    if not on_cuda(products):
        return combine_ref(products, c_coef)
    out = _signed_sum(products, c_coef, code)
    combine_cuda.launches += 1
    return out


divide_cuda.launches = 0
combine_cuda.launches = 0


def strassen1_matmul_cuda(
    aq: torch.Tensor, bq: torch.Tensor, *, scheme: Scheme | str = STRASSEN
) -> torch.Tensor:
    """Fused one-level Strassen on quadrant layout.

    Args:
      aq: (mb, 4, M2, K2) A-quadrants (batched over mb leaves).
      bq: (mb, 4, K2, N2) B-quadrants.

    Returns:
      (mb, 4, M2, N2) C-quadrants in the operands' dtype.
    """
    if isinstance(scheme, str):
        scheme = get_scheme(scheme)
    if (
        aq.ndim != 4 or bq.ndim != 4 or aq.shape[1] != 4 or bq.shape[:2] != aq.shape[:2]
        or bq.shape[2] != aq.shape[3]
    ):
        raise ValueError(f"bad quadrant shapes {tuple(aq.shape)} x {tuple(bq.shape)}")
    code = _build.dtype_code(aq, bq)
    if not on_cuda(aq, bq):
        return strassen1_matmul_ref(aq, bq, scheme)
    if not (aq.is_contiguous() and bq.is_contiguous()):
        raise ValueError("strassen1_matmul_cuda needs contiguous quadrant operands")
    mb, _, m2, k2 = aq.shape
    n2 = bq.shape[3]
    out = torch.empty((mb, 4, m2, n2), dtype=aq.dtype, device=aq.device)
    if out.numel() == 0:
        return out
    c = _floats(scheme.a_coef, scheme.b_coef, scheme.c_coef)
    _build.launch(
        "repro_strassen1", aq.device, aq.data_ptr(), bq.data_ptr(), out.data_ptr(),
        code, scheme.n_mults, mb, m2, k2, n2, ctypes.addressof(c),
    )
    strassen1_matmul_cuda.launches += 1
    return out


strassen1_matmul_cuda.launches = 0
