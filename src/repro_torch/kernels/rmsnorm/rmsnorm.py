"""Wrapper of the RMSNorm kernel (``csrc/rmsnorm.cu``).

The counterpart of ``rmsnorm_pallas``: y = x * rsqrt(mean(x^2) + eps) * w
over the last dim of (R, D) rows, fp32 maths, output in x's dtype. On a CUDA
tensor the wrapper launches the kernel or raises; on a CPU tensor it computes
the plain version in ``ref.py``. The kernel holds a row in registers: it
takes D up to 16384 in bf16 and 8192 in fp32, or 2048 where D is not a
multiple of 16 bytes or a pointer is off 16 bytes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import on_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

__all__ = ["rmsnorm_cuda"]


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """(R, D) rows, (D,) scale in fp32 or x's dtype -> (R, D) in x's dtype."""
    if x.ndim != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"bad rmsnorm shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    code, wcode = _build.dtype_code(x), _build.dtype_code(w)
    if w.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"w must be float32 or {x.dtype}, got {w.dtype}")
    if not on_cuda(x, w):
        return rmsnorm_ref(x, w, eps)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_cuda needs contiguous x and w")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    r, d = x.shape
    _build.launch(
        "repro_rmsnorm", x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
        code, wcode, r, d, eps,
    )
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0
