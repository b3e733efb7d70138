"""The work each measured piece must do, from the cell's shapes: the yardstick.

A frozen copy of the counts in ``src/repro_torch/kernels/cost.py`` (the
``matmul``, ``signed_sum`` (its bytes), ``live_pairs``, ``flash`` and
``flash_bwd`` functions, as of the port's dry-run slice), so that a change to the port
cannot move the numbers its shares are held to, and the counts that the
benchmark adds: the standard multiply's 2N^3, the leaf of a depth-d
Strassen, the bytes of its divide and combine levels, a decoder LM's
model work (6NT plus attention, without rematerialization's recompute)
and AdamW's least bytes.

Operations count what the inputs need: 2 per multiply-add, attention 4 * D
per live (query, key) pair and head (QK^T and PV; the backward's five
products 2.5 times that). Bytes count each input read once and each output
written once.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

# Multiplications per 2x2 level of each scheme the port names
# (src/repro_torch/core/coefficients.py): Strassen's and Winograd's 7, the
# naive 8. The coefficient matrices are (rank, 4) and (4, rank).
SCHEME_RANK = {"strassen": 7, "winograd": 7, "naive8": 8}

ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}


class Cost(NamedTuple):
    ops: float
    dtype: str
    bytes: int


def matmul(mb: int, m: int, k: int, n: int, dtype: str) -> Cost:
    """(mb, m, k) x (mb, k, n) -> (mb, m, n)."""
    moved = mb * (m * k + k * n + m * n) * ITEMSIZE[dtype]
    return Cost(2 * mb * m * k * n, dtype, moved)


def signed_sum_bytes(p: int, q: int, m: int, plane: int, dtype: str) -> int:
    """One divide or combine level: (m, q, plane) in, (m, p, plane) out for a
    (p, q) coefficient matrix."""
    return (p + q) * m * plane * ITEMSIZE[dtype]


def standard_multiply_flops(m: int, k: int, n: int) -> float:
    """The standard algorithm's count, 2MKN: the figure cuBLAS is compared by."""
    return 2.0 * m * k * n


def strassen_leaf(m: int, k: int, n: int, depth: int, scheme: str, dtype: str) -> Cost:
    """The leaf of a depth-``depth`` recursion: rank^depth products of
    (m/2^d, k/2^d) x (k/2^d, n/2^d)."""
    s = 2**depth
    return matmul(SCHEME_RANK[scheme] ** depth, m // s, k // s, n // s, dtype)


def strassen_level_bytes(m: int, k: int, n: int, depth: int, scheme: str, dtype: str) -> int:
    """Bytes every divide level of A and of B and every combine level of C
    must move: level l reads rank^l (4 quadrants) and writes rank^(l+1)
    blocks of the level's quadrant plane (a combine level the reverse)."""
    r = SCHEME_RANK[scheme]
    total = 0
    for level in range(depth):
        half = 2 ** (level + 1)
        for rows, cols in ((m, k), (k, n), (m, n)):
            total += signed_sum_bytes(r, 4, r**level, (rows // half) * (cols // half), dtype)
    return total


def live_pairs(sq: int, sk: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs the mask keeps: query i sees key j when j <= i
    (causal) and i - j < window."""
    if not causal and window is None:
        return sq * sk
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i + 1, sk) if causal else np.full(sq, sk, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window is not None else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash(b: int, hq: int, hkv: int, sq: int, sk: int, d: int, causal: bool,
          window: Optional[int], dtype: str, lse: bool = False) -> Cost:
    """Flash attention: q (b, hq, sq, d) and out, k and v (b, hkv, sk, d),
    with ``lse`` the fp32 (b, hq, sq) row statistics out."""
    ops = 4 * b * hq * d * live_pairs(sq, sk, causal, window)
    moved = (2 * b * hq * sq * d + 2 * b * hkv * sk * d) * ITEMSIZE[dtype]
    return Cost(ops, dtype, moved + (4 * b * hq * sq if lse else 0))


def flash_bwd(b: int, hq: int, hkv: int, sq: int, sk: int, d: int, causal: bool,
              window: Optional[int], dtype: str) -> Cost:
    """The flash backward: q, k, v, o, dO and the fp32 lse in; dq, dk, dv out."""
    ops = 2.5 * (4 * b * hq * d * live_pairs(sq, sk, causal, window))
    q, kv = b * hq * sq * d, b * hkv * sk * d
    moved = (3 * q + 2 * kv) * ITEMSIZE[dtype] + 4 * b * hq * sq + (q + 2 * kv) * ITEMSIZE[dtype]
    return Cost(ops, dtype, moved)


def dense_lm_params(model: dict) -> int:
    """Parameters of a dense decoder LM with a (gated) MLP, RMSNorm and a
    tied or untied embedding, from the configuration's sizes."""
    d, v, hd = model["d_model"], model["vocab"], model["head_dim"]
    h, hkv, f = model["n_heads"], model["n_kv_heads"], model["d_ff"]
    mlp = (3 if model["glu"] else 2) * d * f
    per_layer = d * h * hd + 2 * d * hkv * hd + h * hd * d + mlp + 2 * d
    emb = v * d * (1 if model["tie_embeddings"] else 2)
    return model["n_layers"] * per_layer + emb + d


def dense_lm_model_flops(model: dict, batch: int, seq: int) -> float:
    """One optimizer step's model work over ``batch`` x ``seq`` tokens: 6NT
    (forward and backward of every parameter) plus causal attention's score
    and PV products forward and backward (3.5 times the forward's), with no
    rematerialization's recompute."""
    attn = model["n_layers"] * flash(batch, model["n_heads"], model["n_kv_heads"], seq, seq,
                                     model["head_dim"], True, None, model["dtype"]).ops
    return 6.0 * dense_lm_params(model) * batch * seq + 3.5 * attn


def adamw_bytes(n_params: int, param_dtype: str, moment_dtype: str) -> int:
    """AdamW's least bytes a step: read the parameters, their gradients (in
    the parameters' dtype) and both moments; write the parameters and both
    moments."""
    p, mom = ITEMSIZE[param_dtype], ITEMSIZE[moment_dtype]
    return n_params * (3 * p + 4 * mom)
