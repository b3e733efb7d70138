"""Plain PyTorch RMSNorm, the counterpart of ``repro.kernels.rmsnorm.ref``.

fp32 maths, one rounding to x's dtype. The wrapper uses it for CPU tensors;
``chip_smoke.py`` holds the CUDA kernel against it.
"""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
