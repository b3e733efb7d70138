"""Wrappers of the Strassen kernels (``csrc/signed_sum.cu``, ``csrc/strassen_level.cu``,
``csrc/strassen1.cu``).

Stark materializes every divide and combine level through a Spark shuffle.
On the card those levels are memory-bound signed sums, so:

* :func:`divide_cuda` / :func:`combine_cuda` (``divide_pallas`` /
  ``combine_pallas``) run one level's additions in a single pass over
  device memory: read 4 quadrant planes and write r operand planes, or read
  r product planes and write 4 C planes. The coefficients are passed in at
  launch from the :class:`Scheme`.
* :func:`divide_level_cuda` / :func:`combine_level_cuda` (``csrc/strassen_level.cu``)
  are the same levels as ``core/strassen.py`` lays them out, (m, r, c) ->
  (m*rank, r/2, c/2) and back: they read or write each block's quadrants
  where they lie, so no split or merge copy is made, and sum in fp32,
  rounded once, as the einsum levels they replace on backend kind
  ``strassen``'s path do.
* :func:`strassen1_matmul_cuda` (``strassen1_matmul_pallas``) runs the last
  recursion level whole inside the kernel: per output tile it forms the r
  operand sums, accumulates the r products in fp32 registers and combines
  them into the 4 C quadrants, so none of the level's 7/4x intermediates
  reach device memory. Backend kind ``strassen_fused`` runs through it.
  It takes the reference's ``out_dtype`` (fp32 or bf16, the operands'
  dtype by default): the fp32 combine is stored as it is or rounded once.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it computes the plain version in ``ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.core.coefficients import STRASSEN, Scheme, get_scheme
from repro_torch.kernels import _build, cost
from repro_torch.kernels.common import on_cuda, out_dtype_of, traced
from repro_torch.kernels.strassen.ref import (
    combine_level_ref,
    combine_ref,
    divide_level_ref,
    divide_ref,
    strassen1_matmul_ref,
)

__all__ = [
    "divide_cuda",
    "combine_cuda",
    "divide_level_cuda",
    "combine_level_cuda",
    "strassen1_matmul_cuda",
]


def _floats(*arrays: np.ndarray) -> ctypes.Array:
    """Row-major float32 copy of the arrays, one after the other, for the C side."""
    flat = np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays])
    return (ctypes.c_float * flat.size)(*flat.tolist())


def _signed_sum(fn, x: torch.Tensor, coef: np.ndarray, code: int) -> torch.Tensor:
    """Launch the signed-sum kernel for wrapper ``fn``: (m, q, h, w) -> (m, p, h, w)."""
    if not x.is_contiguous():
        raise ValueError("the signed-sum kernel needs a contiguous input")
    m, q, h, w = x.shape
    p = coef.shape[0]
    out = torch.empty((m, p, h, w), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or traced(fn, cost.signed_sum(coef, m, h * w, x.dtype), x):
        return out
    c = _floats(coef)
    _build.launch(
        "repro_signed_sum", x.device, x.data_ptr(), out.data_ptr(),
        code, m, q, p, h * w, ctypes.addressof(c),
    )
    fn.launches += 1
    return out


def divide_cuda(x: torch.Tensor, coef: np.ndarray) -> torch.Tensor:
    """One divide level on quadrant layout: (m, 4, h, w) -> (m, r, h, w)."""
    coef = np.asarray(coef)
    if x.ndim != 4 or x.shape[1] != 4 or coef.ndim != 2 or coef.shape[1] != 4:
        raise ValueError(f"need (m, 4, h, w) and (r, 4), got {tuple(x.shape)}, {coef.shape}")
    code = _build.dtype_code(x)
    if not on_cuda(x):
        return divide_ref(x, coef)
    return _signed_sum(divide_cuda, x, coef, code)


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
    return _signed_sum(combine_cuda, products, c_coef, code)


divide_cuda.launches = 0
combine_cuda.launches = 0


def _level(fn, x: torch.Tensor, out: torch.Tensor, coef: np.ndarray, divide: bool) -> torch.Tensor:
    """Launch the level kernel for wrapper ``fn`` on contiguous ``x`` into
    ``out``: quadrants into planes when ``divide``, else planes into quadrants."""
    quads, planes = (x, out) if divide else (out, x)
    m, (hr, hc) = quads.shape[0], planes.shape[1:]
    p, q = coef.shape
    if out.numel() == 0 or traced(fn, cost.signed_sum(coef, m, hr * hc, x.dtype), x):
        return out
    c = _floats(coef)
    _build.launch(
        "repro_strassen_level", x.device, x.data_ptr(), out.data_ptr(),
        _build.dtype_code(x), int(divide), m, q, p, hr, hc, ctypes.addressof(c),
    )
    fn.launches += 1
    return out


def divide_level_cuda(x: torch.Tensor, coef: np.ndarray) -> torch.Tensor:
    """One divide level on the quadrants in place: (m, r, c) -> (m*p, r/2, c/2).

    ``coef`` is a (p, 4) table over the quadrants [11, 12, 21, 22] of each
    (r, c) block: out[b*p + i] = sum_k coef[i, k] * quadrant k of x[b]. A
    non-contiguous ``x`` is made contiguous first (one copy)."""
    coef = np.asarray(coef)
    if x.ndim != 3 or x.shape[1] % 2 or x.shape[2] % 2 or coef.ndim != 2 or coef.shape[1] != 4:
        raise ValueError(
            f"need (m, r, c) with even r, c and (p, 4), got {tuple(x.shape)}, {coef.shape}"
        )
    _build.dtype_code(x)
    if not on_cuda(x):
        return divide_level_ref(x, coef)
    x = x.contiguous()
    m, r, c = x.shape
    out = torch.empty((m * coef.shape[0], r // 2, c // 2), dtype=x.dtype, device=x.device)
    return _level(divide_level_cuda, x, out, coef, True)


def combine_level_cuda(products: torch.Tensor, c_coef: np.ndarray) -> torch.Tensor:
    """One combine level into the quadrants in place: (m*q, hr, hc) -> (m, 2hr, 2hc).

    ``c_coef`` is a (4, q) table: quadrant i of out[b] = sum_k c_coef[i, k] *
    products[b*q + k]. A non-contiguous ``products`` is made contiguous
    first (one copy)."""
    c_coef = np.asarray(c_coef)
    if (c_coef.ndim != 2 or c_coef.shape[0] != 4 or products.ndim != 3
            or products.shape[0] % c_coef.shape[1]):
        raise ValueError(
            f"need (m*q, hr, hc) and (4, q), got {tuple(products.shape)}, {c_coef.shape}"
        )
    _build.dtype_code(products)
    if not on_cuda(products):
        return combine_level_ref(products, c_coef)
    x = products.contiguous()
    mq, hr, hc = x.shape
    out = torch.empty((mq // c_coef.shape[1], 2 * hr, 2 * hc), dtype=x.dtype, device=x.device)
    return _level(combine_level_cuda, x, out, c_coef, False)


divide_level_cuda.launches = 0
combine_level_cuda.launches = 0


def strassen1_matmul_cuda(
    aq: torch.Tensor,
    bq: torch.Tensor,
    *,
    scheme: Scheme | str = STRASSEN,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Fused one-level Strassen on quadrant layout.

    Args:
      aq: (mb, 4, M2, K2) A-quadrants (batched over mb leaves).
      bq: (mb, 4, K2, N2) B-quadrants.

    Returns:
      (mb, 4, M2, N2) C-quadrants in ``out_dtype`` (the operands' dtype by default).
    """
    if isinstance(scheme, str):
        scheme = get_scheme(scheme)
    if (
        aq.ndim != 4 or bq.ndim != 4 or aq.shape[1] != 4 or bq.shape[:2] != aq.shape[:2]
        or bq.shape[2] != aq.shape[3]
    ):
        raise ValueError(f"bad quadrant shapes {tuple(aq.shape)} x {tuple(bq.shape)}")
    code = _build.dtype_code(aq, bq)
    dtype = out_dtype_of(out_dtype, aq)
    if not on_cuda(aq, bq):
        return strassen1_matmul_ref(aq, bq, scheme, dtype)
    if not (aq.is_contiguous() and bq.is_contiguous()):
        raise ValueError("strassen1_matmul_cuda needs contiguous quadrant operands")
    mb, _, m2, k2 = aq.shape
    n2 = bq.shape[3]
    out = torch.empty((mb, 4, m2, n2), dtype=dtype, device=aq.device)
    if out.numel() == 0 or traced(strassen1_matmul_cuda,
                                  cost.strassen1(mb, m2, k2, n2, scheme.n_mults, aq.dtype, dtype), aq, bq):
        return out
    c = _floats(scheme.a_coef, scheme.b_coef, scheme.c_coef)
    _build.launch(
        "repro_strassen1", aq.device, aq.data_ptr(), bq.data_ptr(), out.data_ptr(),
        code, _build.dtype_code(out), scheme.n_mults, mb, m2, k2, n2, ctypes.addressof(c),
    )
    strassen1_matmul_cuda.launches += 1
    return out


strassen1_matmul_cuda.launches = 0
