"""Wrappers of the RMSNorm kernels (``csrc/rmsnorm.cu``).

:func:`rmsnorm_cuda` is the counterpart of ``rmsnorm_pallas``: y = x *
rsqrt(mean(x^2) + eps) * w over the last dim of (R, D) rows, fp32 maths,
output in x's dtype. :func:`rmsnorm_bwd_cuda` is its gradient, which the JAX
package leaves to XLA (it has no Pallas backward). On a CUDA tensor each
wrapper launches its kernel or raises; on a CPU tensor it computes the plain
version in ``ref.py``. The kernels hold a row in registers: they take D up
to 16384 in bf16 and 8192 in fp32, or 2048 where D is not a multiple of 16
bytes or a pointer is off 16 bytes.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import on_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

__all__ = ["rmsnorm_cuda", "rmsnorm_bwd_cuda"]

# Blocks of the backward kernel, per SM: enough rows in flight to fill the
# card, few enough fp32 partial rows of dw for the second pass to add.
BWD_BLOCKS_PER_SM = 4
_SMS: Dict[torch.device, int] = {}


def _check(x: torch.Tensor, w: torch.Tensor) -> Tuple[int, int]:
    if x.ndim != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"bad rmsnorm shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    code, wcode = _build.dtype_code(x), _build.dtype_code(w)
    if w.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"w must be float32 or {x.dtype}, got {w.dtype}")
    return code, wcode


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """(R, D) rows, (D,) scale in fp32 or x's dtype -> (R, D) in x's dtype."""
    code, wcode = _check(x, w)
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


def rmsnorm_bwd_cuda(
    x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of :func:`rmsnorm_cuda` given the output's gradient ``dy``:
    dx (R, D) in x's dtype, dw (D,) in w's, dw the same bits on every run."""
    code, wcode = _check(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x {tuple(x.shape)} {x.dtype}")
    if not on_cuda(x, w, dy):
        return rmsnorm_bwd_ref(x, w, dy, eps)
    if not (x.is_contiguous() and w.is_contiguous() and dy.is_contiguous()):
        raise ValueError("rmsnorm_bwd_cuda needs contiguous x, w and dy")
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    r, d = x.shape
    if r == 0:
        return dx, dw.zero_()
    if x.device not in _SMS:
        _SMS[x.device] = _build.device_limits(x.device)[0]
    groups = min(r, BWD_BLOCKS_PER_SM * _SMS[x.device])
    partial = torch.empty((groups, d), dtype=torch.float32, device=x.device)
    _build.launch(
        "repro_rmsnorm_bwd", x.device, x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), partial.data_ptr(), code, wcode, r, d, groups, eps,
    )
    rmsnorm_bwd_cuda.launches += 1
    return dx, dw


rmsnorm_bwd_cuda.launches = 0
