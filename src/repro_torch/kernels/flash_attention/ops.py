"""Public flash-attention op, the counterpart of ``repro.kernels.flash_attention.ops``.

The JAX op takes block sizes and an interpret flag; the CUDA kernel fixes
its own tiles and masks ragged ends, and the tensors' device picks kernel or
plain version. The op makes its operands contiguous for the kernel. Where
autograd records (grad enabled and an input that requires grad) it runs as
:class:`FlashAttention`, whose backward is the backward kernel; the JAX
package differentiates its pure-JAX ``chunked_attention`` there instead.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)

__all__ = ["flash_attention", "FlashAttention"]


class FlashAttention(torch.autograd.Function):
    """The forward kernel (with its row log-sum-exp) and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout.contiguous(),
                                              causal=causal, window=window, scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, scale)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)
