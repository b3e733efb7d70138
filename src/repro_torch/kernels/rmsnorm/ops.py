"""Public RMSNorm op (any leading dims), the counterpart of ``repro.kernels.rmsnorm.ops``.

The JAX op takes a row-block size and an interpret flag; the CUDA kernel
fixes its own blocks and the tensor's device picks kernel or plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda

__all__ = ["rmsnorm"]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    *lead, d = x.shape
    out = rmsnorm_cuda(x.reshape(-1, d).contiguous(), w.contiguous(), eps=eps)
    return out.reshape(*lead, d)
