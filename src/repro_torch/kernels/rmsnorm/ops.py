"""Public RMSNorm op (any leading dims), the counterpart of ``repro.kernels.rmsnorm.ops``.

The JAX op takes a row-block size and an interpret flag; the CUDA kernel
fixes its own blocks and the tensor's device picks kernel or plain version.
Where autograd records (grad enabled and x or w requiring grad) the op runs
as :class:`RMSNorm`, whose backward is the backward kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda

__all__ = ["rmsnorm", "RMSNorm"]


class RMSNorm(torch.autograd.Function):
    """The forward kernel on (R, D) rows and the backward kernel."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm_cuda(x, w, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd_cuda(x, w, dy.contiguous(), eps=ctx.eps)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    *lead, d = x.shape
    x2, w = x.reshape(-1, d).contiguous(), w.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        out = RMSNorm.apply(x2, w, eps)
    else:
        out = rmsnorm_cuda(x2, w, eps=eps)
    return out.reshape(*lead, d)
