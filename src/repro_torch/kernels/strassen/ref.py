"""Plain PyTorch versions of the fused Strassen kernels.

They repeat the kernels' arithmetic: each signed sum runs over q in
ascending order, skips zero coefficients, and is formed as the Pallas
kernels' ``_signed_sum`` forms it, in the input dtype with one rounding per
term and per add (no rounding in fp32), so the divide and combine kernels
match them bit for bit; products are fp32 with TF32 off, and the fused
kernel's fp32 combine is rounded once (to ``out_dtype``, the input dtype by
default). The level kernel's versions (:func:`divide_level_ref`,
:func:`combine_level_ref`) read and write the quadrants in place and sum in
fp32, rounded once, as the einsum levels of ``core/strassen.py`` do. The
wrappers use them for CPU tensors; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the kernels against them on the card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.coefficients import STRASSEN, Scheme, get_scheme
from repro_torch.core.precision import matmul_precision
from repro_torch.kernels.common import out_dtype_of


def signed_sum_ref(x: torch.Tensor, coef: np.ndarray) -> torch.Tensor:
    """(m, q, h, w) -> (m, p, h, w) in fp32: out[:, i] = sum_j coef[i, j] * x[:, j].

    Over j in ascending order, zeros skipped, each term and each partial sum
    rounded to x's dtype (no rounding in fp32), as ``_signed_sum`` in
    ``repro/kernels/strassen/strassen.py`` adds in the input dtype."""
    rows = []
    for row in np.asarray(coef):
        acc = None
        for j, c in enumerate(row):
            if c == 0:
                continue
            term = (x[:, j].float() * float(c)).to(x.dtype).float()
            acc = term if acc is None else (acc + term).to(x.dtype).float()
        assert acc is not None, "coefficient row is all zero"
        rows.append(acc)
    return torch.stack(rows, dim=1)


def divide_ref(x: torch.Tensor, coef: np.ndarray) -> torch.Tensor:
    """(m, 4, h, w) -> (m, r, h, w), the einsum 'pq,mqij->mpij'."""
    return signed_sum_ref(x, coef).to(x.dtype)


def combine_ref(products: torch.Tensor, c_coef: np.ndarray) -> torch.Tensor:
    """(m, r, h, w) -> (m, 4, h, w), the einsum 'kp,mpij->mkij'."""
    return signed_sum_ref(products, c_coef).to(products.dtype)


def _quadrant(x: torch.Tensor, k: int) -> torch.Tensor:
    """Quadrant ``k`` (row-major [11, 12, 21, 22]) of each (2hr, 2hc) block
    of ``x``, as a view: rows (k // 2) * hr.., columns (k % 2) * hc.."""
    hr, hc = x.shape[-2] // 2, x.shape[-1] // 2
    r, c = divmod(k, 2)
    return x[..., r * hr:(r + 1) * hr, c * hc:(c + 1) * hc]


def _fp32_sum(terms, row) -> torch.Tensor:
    """sum_j row[j] * terms[j] in fp32, over j in ascending order, zeros
    skipped (zeros when every coefficient is 0)."""
    acc = None
    for t, c in zip(terms, row):
        if c == 0:
            continue
        term = t.float() * float(c)
        acc = term if acc is None else acc + term
    return acc if acc is not None else torch.zeros_like(terms[0], dtype=torch.float32)


def divide_level_ref(x: torch.Tensor, coef: np.ndarray) -> torch.Tensor:
    """(m, r, c) -> (m*p, r/2, c/2) for a (p, 4) ``coef``: the level kernel's
    divide on the quadrants where they lie, each sum in fp32 rounded once to
    x's dtype; out[b*p + i] = sum_k coef[i, k] * quadrant k of x[b]."""
    _, r, c = x.shape
    quads = [_quadrant(x, k) for k in range(4)]
    out = torch.stack([_fp32_sum(quads, row) for row in np.asarray(coef)], dim=1)
    return out.to(x.dtype).reshape(-1, r // 2, c // 2)


def combine_level_ref(products: torch.Tensor, c_coef: np.ndarray) -> torch.Tensor:
    """(m*q, hr, hc) -> (m, 2hr, 2hc) for a (4, q) ``c_coef``: the level
    kernel's combine, each quadrant's sum in fp32 rounded once as it is
    written in place; quadrant i of out[b] = sum_k c_coef[i, k] * products[b*q + k]."""
    c_coef = np.asarray(c_coef)
    q = c_coef.shape[1]
    mq, hr, hc = products.shape
    prods = products.reshape(mq // q, q, hr, hc)
    out = products.new_empty((mq // q, 2 * hr, 2 * hc))
    for k, row in enumerate(c_coef):
        _quadrant(out, k).copy_(_fp32_sum([prods[:, j] for j in range(q)], row))
    return out


def strassen1_matmul_ref(
    aq: torch.Tensor,
    bq: torch.Tensor,
    scheme: Scheme | str = STRASSEN,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """(mb,4,M2,K2) x (mb,4,K2,N2) -> (mb,4,M2,N2), unfused fp32 pipeline."""
    if isinstance(scheme, str):
        scheme = get_scheme(scheme)
    dtype = out_dtype_of(out_dtype, aq)
    left = signed_sum_ref(aq, scheme.a_coef)
    right = signed_sum_ref(bq, scheme.b_coef)
    with matmul_precision("highest"):
        prods = torch.matmul(left, right)
    return signed_sum_ref(prods, scheme.c_coef).to(dtype)


def strassen1_full_ref(
    a: torch.Tensor, b: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Direct (M,K)@(K,N) oracle for the whole fused op."""
    dtype = out_dtype_of(out_dtype, a)
    with matmul_precision("highest"):
        return torch.matmul(a.float(), b.float()).to(dtype)
