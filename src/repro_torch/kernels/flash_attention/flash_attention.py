"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

The counterpart of ``flash_attention_pallas``: online-softmax attention of
q (B, Hq, Sq, D) against k, v (B, Hkv, Sk, D), Hq % Hkv == 0, with the
causal and sliding-window masks of the TPU kernel. The CUDA kernel takes
D in (16, 32, 64, 128, 256) and any Sq, Sk. On a CUDA tensor the wrapper
launches the kernel or raises; on a CPU tensor it computes the plain
version in ``ref.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import on_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention_cuda", "HEAD_DIMS"]

# Head dims the kernel is instantiated for: every dense config in configs/.
HEAD_DIMS = (16, 32, 64, 128, 256)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """softmax(q k^T * scale + mask) v in q's dtype; scale defaults to D**-0.5."""
    if window is not None and not causal:
        raise ValueError("sliding window requires causal=True (backward window)")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad attention shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    code = _build.dtype_code(q, k, v)
    if not on_cuda(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda takes head dims {HEAD_DIMS}, got {d}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs contiguous, 16-byte aligned q, k, v")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    hkv, sk = k.shape[1], k.shape[2]
    _build.launch(
        "repro_flash_attention", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), code, b, hq, hkv, sq, sk, d, int(causal),
        -1 if window is None else int(window), d**-0.5 if scale is None else float(scale),
    )
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
