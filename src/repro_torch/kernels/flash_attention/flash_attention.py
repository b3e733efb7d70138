"""Wrappers of the flash-attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``).

:func:`flash_attention_cuda` is the counterpart of ``flash_attention_pallas``:
online-softmax attention of q (B, Hq, Sq, D) against k, v (B, Hkv, Sk, D),
Hq % Hkv == 0, with the causal and sliding-window masks of the TPU kernel.
The CUDA kernel takes D in (16, 32, 64, 128, 256) and any Sq, Sk; asked for
``return_lse`` it also writes the row log-sum-exp that the backward reads.
:func:`flash_attention_bwd_cuda` is its gradient, which the JAX package
leaves to XLA (it has no Pallas backward): D in (16, 32, 64, 128) for bf16,
all five for fp32. Its dQ sums each key tile's term in a fixed order, so it
gives the same bits on every run, from an fp32 scratch of Sk / 64 (fp32:
Sk / 32) times dQ's size. On a CUDA tensor each wrapper launches its kernel
or raises; on a CPU tensor it computes the plain version in ``ref.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import cdiv, on_cuda
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda", "HEAD_DIMS", "BWD_HEAD_DIMS"]

# Head dims the kernel is instantiated for: every dense config in configs/.
HEAD_DIMS = (16, 32, 64, 128, 256)
# Head dims of the backward kernel by dtype. bf16 stops at 128: a warp's two
# 16 x 256 fp32 accumulators (dK, dV) would need 256 registers a thread.
BWD_HEAD_DIMS = {torch.float32: HEAD_DIMS, torch.bfloat16: (16, 32, 64, 128)}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window) -> None:
    if window is not None and not causal:
        raise ValueError("sliding window requires causal=True (backward window)")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad attention shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """softmax(q k^T * scale + mask) v in q's dtype; scale defaults to D**-0.5.

    With ``return_lse``: (out, lse), lse (B, Hq, Sq) fp32 the row
    log-sum-exp of the scaled, masked scores (+inf for a row with no live
    key). ``out`` is the same either way.
    """
    _check(q, k, v, causal, window)
    b, hq, sq, d = q.shape
    code = _build.dtype_code(q, k, v)
    if not on_cuda(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale, return_lse=return_lse)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda takes head dims {HEAD_DIMS}, got {d}")
    if not _aligned(q, k, v):
        raise ValueError("flash_attention_cuda needs contiguous, 16-byte aligned q, k, v")
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    hkv, sk = k.shape[1], k.shape[2]
    _build.launch(
        "repro_flash_attention", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), code, b, hq, hkv, sq, sk, d,
        int(causal), -1 if window is None else int(window), d**-0.5 if scale is None else float(scale),
    )
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(
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
    """(dq, dk, dv) of :func:`flash_attention_cuda` given its output ``o``, its
    ``lse`` and the output's gradient ``do``; each in its input's dtype."""
    _check(q, k, v, causal, window)
    b, hq, sq, d = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, hq, sq):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"do not match q {tuple(q.shape)}")
    code = _build.dtype_code(q, k, v, o, do)
    if lse.dtype != torch.float32:
        raise TypeError(f"lse must be float32, got {lse.dtype}")
    if not on_cuda(q, k, v, o, lse, do):
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window, scale=scale)
    if d not in BWD_HEAD_DIMS[q.dtype]:
        raise ValueError(f"flash_attention_bwd_cuda takes head dims {BWD_HEAD_DIMS[q.dtype]} in "
                         f"{q.dtype}, got {d} (ROADMAP.md queue 1)")
    if not (_aligned(q, k, v, o, do) and lse.is_contiguous()):
        raise ValueError("flash_attention_bwd_cuda needs contiguous, 16-byte aligned tensors")
    hkv, sk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    # each key tile's dQ term, added in key-tile order by the kernel's last pass
    key_tile = _build.build().repro_flash_bwd_key_tile(code)
    dq_part = torch.empty((cdiv(sk, key_tile), *q.shape), dtype=torch.float32, device=q.device)
    _build.launch(
        "repro_flash_attention_bwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq_part.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), code, b, hq, hkv, sq, sk, d, int(causal),
        -1 if window is None else int(window), d**-0.5 if scale is None else float(scale),
    )
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
