"""The work of one call of each hand-written kernel, from its shapes.

Each function returns a :class:`Cost`: the operations the call does, the
dtype whose peak rate they run at (``launch/roofline.py``'s
``Hardware.peak_flops``), and the bytes it must move, each input read once
and each output written once. ``chip_smoke.py`` turns these into the bound
beside each kernel's time, and the dry-run's analysis
(``launch/op_analysis.py``) records them where a wrapper meets a fake
tensor, so the two cannot disagree.

Operations count what the call's inputs need: a product 2 per
multiply-add, a signed sum one per addition, RMSNorm 3 per element (10
backward), attention 4 * D per live (query, key) pair and head (QK^T and
PV; the backward's five products 2.5 times that), the sLSTM 2 * 4 * dh^2
per row, step and head (its recurrent mat-vecs; the backward's twice that
with the dr product). Element-wise maths beside these is not counted.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "Cost",
    "matmul",
    "signed_sum",
    "strassen1",
    "rmsnorm",
    "rmsnorm_bwd",
    "live_pairs",
    "flash",
    "flash_bwd",
    "slstm",
    "slstm_bwd",
]


class Cost(NamedTuple):
    ops: float
    dtype: torch.dtype
    bytes: int


def _size(dtype: torch.dtype) -> int:
    return dtype.itemsize


def matmul(mb: int, m: int, k: int, n: int, dtype: torch.dtype,
           out_dtype: Optional[torch.dtype] = None) -> Cost:
    """The tiled matmul: (mb, m, k) x (mb, k, n) -> (mb, m, n) in ``out_dtype``."""
    out = out_dtype or dtype
    moved = mb * (m * k + k * n) * _size(dtype) + mb * m * n * _size(out)
    return Cost(2 * mb * m * k * n, dtype, moved)


def signed_sum(coef, m: int, plane: int, dtype: torch.dtype) -> Cost:
    """One divide or combine level: (m, q, plane) in, (m, p, plane) out for a
    (p, q) coefficient matrix; (nonzeros - 1) additions per output row and
    element."""
    coef = np.asarray(coef)
    p, q = coef.shape
    adds = sum(max(int(np.count_nonzero(row)) - 1, 0) for row in coef)
    return Cost(adds * m * plane, dtype, (p + q) * m * plane * _size(dtype))


def strassen1(mb: int, m2: int, k2: int, n2: int, n_mults: int, dtype: torch.dtype,
              out_dtype: Optional[torch.dtype] = None) -> Cost:
    """The fused one-level Strassen on quadrants (mb, 4, m2, k2) x (mb, 4, k2, n2):
    ``n_mults`` products of the quadrant size."""
    out = out_dtype or dtype
    moved = mb * 4 * (m2 * k2 + k2 * n2) * _size(dtype) + mb * 4 * m2 * n2 * _size(out)
    return Cost(2 * n_mults * mb * m2 * k2 * n2, dtype, moved)


def rmsnorm(rows: int, d: int, dtype: torch.dtype, w_dtype: torch.dtype) -> Cost:
    """(rows, d) in and out in ``dtype``, the scale in ``w_dtype``; fp32 maths."""
    return Cost(3 * rows * d, torch.float32, 2 * rows * d * _size(dtype) + d * _size(w_dtype))


def rmsnorm_bwd(rows: int, d: int, dtype: torch.dtype, w_dtype: torch.dtype) -> Cost:
    """x and dy in, dx out in ``dtype``; w in and dw out in ``w_dtype``."""
    return Cost(10 * rows * d, torch.float32, 3 * rows * d * _size(dtype) + 2 * d * _size(w_dtype))


def live_pairs(sq: int, sk: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs the mask keeps: query i sees key j when j <= i
    (causal) and i - j < window, as the kernels' mask is laid (top-left)."""
    if not causal and window is None:
        return sq * sk
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i + 1, sk) if causal else np.full(sq, sk, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window is not None else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash(b: int, hq: int, hkv: int, sq: int, sk: int, d: int, causal: bool,
          window: Optional[int], dtype: torch.dtype, lse: bool = False) -> Cost:
    """Flash attention: q (b, hq, sq, d) and out in, k and v (b, hkv, sk, d),
    and with ``lse`` the fp32 (b, hq, sq) row statistics out."""
    ops = 4 * b * hq * d * live_pairs(sq, sk, causal, window)
    moved = (2 * b * hq * sq * d + 2 * b * hkv * sk * d) * _size(dtype)
    return Cost(ops, dtype, moved + (4 * b * hq * sq if lse else 0))


def flash_bwd(b: int, hq: int, hkv: int, sq: int, sk: int, d: int, causal: bool,
              window: Optional[int], dtype: torch.dtype) -> Cost:
    """The flash backward: q, k, v, o, dO and the fp32 lse in; dq, dk, dv out."""
    ops = 2.5 * (4 * b * hq * d * live_pairs(sq, sk, causal, window))
    q, kv = b * hq * sq * d, b * hkv * sk * d
    moved = (3 * q + 2 * kv) * _size(dtype) + 4 * b * hq * sq + (q + 2 * kv) * _size(dtype)
    return Cost(ops, dtype, moved)


def slstm(b: int, s: int, h: int, dh: int, save: bool = False) -> Cost:
    """The sLSTM sequence in fp32: wx (b, s, 4, h, dh) and r (4, h, dh, dh)
    in, the state {c, n, m, h} (b, h, dh) in and out, hs (b, s, h, dh) out;
    with ``save`` also each step's pre-activations and c, n, m out."""
    wx, r, state, seq = 4 * b * s * 4 * h * dh, 4 * 4 * h * dh * dh, 4 * b * h * dh, 4 * b * s * h * dh
    moved = wx + r + 2 * 4 * state + seq + ((wx + 3 * seq) if save else 0)
    return Cost(2 * b * s * 4 * h * dh * dh, torch.float32, moved)


def slstm_bwd(b: int, s: int, h: int, dh: int, dr: bool = True) -> Cost:
    """The sLSTM backward in fp32: r, hs, dhs, the saved pre-activations and
    c, n, m, the initial state and the final state's gradients in; dwx, dr
    and the initial state's gradients out. ``dr`` False leaves out the dr
    product, which the wrapper runs after the kernel as a plain ``bmm``
    (its operations, hs's read and dr's write)."""
    wx, r, state, seq = 4 * b * s * 4 * h * dh, 4 * 4 * h * dh * dh, 4 * b * h * dh, 4 * b * s * h * dh
    moved = (r + 2 * seq + wx + 3 * seq + 4 * state + 4 * state) + (wx + r + 4 * state)
    ops = 2 * 2 * 4 * b * s * h * dh * dh
    if not dr:
        ops, moved = ops // 2, moved - seq - r
    return Cost(ops, torch.float32, moved)
