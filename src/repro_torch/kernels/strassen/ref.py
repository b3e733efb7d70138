"""Plain PyTorch versions of the fused Strassen kernels.

They repeat the kernels' arithmetic: each signed sum runs in fp32 over q in
ascending order and skips zero coefficients (so the divide and combine
kernels match them bit for bit), operand sums are rounded to the input
dtype before the products, products are fp32 with TF32 off, and each output
is rounded once. The wrappers use them for CPU tensors; ``chip_smoke.py``
holds the kernels against them on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.coefficients import STRASSEN, Scheme, get_scheme
from repro_torch.core.precision import matmul_precision


def signed_sum_ref(x: torch.Tensor, coef: np.ndarray) -> torch.Tensor:
    """(m, q, h, w) -> (m, p, h, w): out[:, i] = sum_j coef[i, j] * x[:, j] in fp32."""
    coef = np.asarray(coef)
    x32 = x.float()
    rows = []
    for row in coef:
        acc = None
        for j, c in enumerate(row):
            if c == 0:
                continue
            term = x32[:, j] * float(c)
            acc = term if acc is None else acc + term
        assert acc is not None, "coefficient row is all zero"
        rows.append(acc)
    return torch.stack(rows, dim=1)


def divide_ref(x: torch.Tensor, coef: np.ndarray) -> torch.Tensor:
    """(m, 4, h, w) -> (m, r, h, w), the einsum 'pq,mqij->mpij'."""
    return signed_sum_ref(x, coef).to(x.dtype)


def combine_ref(products: torch.Tensor, c_coef: np.ndarray) -> torch.Tensor:
    """(m, r, h, w) -> (m, 4, h, w), the einsum 'kp,mpij->mkij'."""
    return signed_sum_ref(products, c_coef).to(products.dtype)


def strassen1_matmul_ref(
    aq: torch.Tensor, bq: torch.Tensor, scheme: Scheme | str = STRASSEN
) -> torch.Tensor:
    """(mb,4,M2,K2) x (mb,4,K2,N2) -> (mb,4,M2,N2), unfused fp32 pipeline."""
    if isinstance(scheme, str):
        scheme = get_scheme(scheme)
    left = divide_ref(aq, scheme.a_coef).float()
    right = divide_ref(bq, scheme.b_coef).float()
    with matmul_precision("highest"):
        prods = torch.matmul(left, right)
    return signed_sum_ref(prods, scheme.c_coef).to(aq.dtype)


def strassen1_full_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Direct (M,K)@(K,N) oracle for the whole fused op."""
    with matmul_precision("highest"):
        return torch.matmul(a.float(), b.float()).to(a.dtype)
