"""Plain PyTorch flash attention, the counterpart of ``repro.kernels.flash_attention.ref``.

It materializes the (Sq, Sk) scores in fp32 with TF32 off. Masked scores are
-1e30 and their probabilities are set to 0 before the row sum, and a row
sum of 0 divides as 1: the TPU kernel's rule, which the CUDA kernel keeps.
Rows with a live key get the softmax of ``repro``'s ``attention_ref``; a row
with none gets 0 (``attention_ref`` gives the mean of v there, the kernels 0).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.precision import matmul_precision

_NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked attention with GQA kv-head broadcast; fp32 math, q's dtype out."""
    _, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else d**-0.5
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows >= cols
    if window is not None:
        mask &= rows - cols < window
    with matmul_precision("highest"):
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        s = torch.where(mask, s, _NEG_INF)
        p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        out = torch.matmul(p, v.float()) / torch.where(l == 0.0, 1.0, l)
    return out.to(q.dtype)
