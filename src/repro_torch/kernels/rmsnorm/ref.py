"""Plain PyTorch RMSNorm, the counterpart of ``repro.kernels.rmsnorm.ref``.

fp32 maths, one rounding to x's dtype. The wrappers use these for CPU
tensors; ``chip_smoke.py`` holds the CUDA kernels against them.
:func:`rmsnorm_bwd_ref` is the plain version of the backward kernel, which
the JAX package has no Pallas counterpart of (it differentiates its pure-JAX
``rmsnorm``).
"""
from __future__ import annotations

from typing import Tuple

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rmsnorm_bwd_ref(
    x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of :func:`rmsnorm_ref` over (R, D) rows, in fp32 maths:
    xh = x * rstd, dx = rstd * (w * dy - xh * mean(xh * w * dy)),
    dw = sum over rows of dy * xh; dx in x's dtype, dw in w's."""
    xf, wf, gf = x.float(), w.float(), dy.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xh = xf * rstd
    c = torch.mean(xh * wf * gf, dim=-1, keepdim=True)
    dx = rstd * (wf * gf - xh * c)
    dw = (gf * xh).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)
