"""Plain PyTorch flash attention, the counterpart of ``repro.kernels.flash_attention.ref``.

It materializes the (Sq, Sk) scores in fp32 with TF32 off. Masked scores are
-1e30 and their probabilities are set to 0 before the row sum, and a row
sum of 0 divides as 1: the TPU kernel's rule, which the CUDA kernel keeps.
Rows with a live key get the softmax of ``repro``'s ``attention_ref``; a row
with none gets 0 (``attention_ref`` gives the mean of v there, the kernels 0).

:func:`attention_bwd_ref` is the plain version of the backward kernel
(``csrc/flash_attention_bwd.cu``), by the same formulas: from the forward's
output ``o`` and row log-sum-exp ``lse`` it recomputes P and forms
dS = P o (dP - rowsum(dO o O)).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.precision import matmul_precision

_NEG_INF = -1e30


def _mask(sq: int, sk: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= rows >= cols
    if window is not None:
        mask &= rows - cols < window
    return mask


def _expand(t: torch.Tensor, group: int) -> torch.Tensor:
    return t.repeat_interleave(group, dim=1) if group > 1 else t


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Masked attention with GQA kv-head broadcast; fp32 math, q's dtype out.

    With ``return_lse`` it returns (out, lse): lse (B, Hq, Sq) fp32 is the
    row log-sum-exp of the scaled, masked scores, +inf for a row with no
    live key.
    """
    _, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else d**-0.5
    k, v = _expand(k, group), _expand(v, group)
    mask = _mask(sq, sk, causal, window, q.device)
    with matmul_precision("highest"):
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        s = torch.where(mask, s, _NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        out = (torch.matmul(p, v.float()) / torch.where(l == 0.0, 1.0, l)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0.0, torch.inf, m + torch.log(l))[..., 0]
    return out, lse


def attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`attention_ref` in fp32 maths, each in its input's dtype.

    P = exp(S * scale - lse) on live entries (0 elsewhere), dV = P^T dO,
    dP = dO V^T, delta = rowsum(dO o O), dS = P o (dP - delta) * scale,
    dQ = dS K, dK = dS^T Q; a GQA group's dK, dV are summed over its query
    heads. A row with no live key has P = 0 and so contributes nothing.
    """
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = scale if scale is not None else d**-0.5
    ke, ve = _expand(k, group).float(), _expand(v, group).float()
    qf, dof = q.float(), do.float()
    mask = _mask(sq, sk, causal, window, q.device)
    with matmul_precision("highest"):
        s = torch.matmul(qf, ke.transpose(-1, -2)) * scale
        p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
        dv = torch.matmul(p.transpose(-1, -2), dof)
        dp = torch.matmul(dof, ve.transpose(-1, -2))
        delta = (dof * o.float()).sum(dim=-1, keepdim=True)
        ds = p * (dp - delta) * scale
        dq = torch.matmul(ds, ke)
        dk = torch.matmul(ds.transpose(-1, -2), qf)
    dk = dk.reshape(b, hkv, group, sk, d).sum(dim=2)
    dv = dv.reshape(b, hkv, group, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
