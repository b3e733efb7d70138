"""Public flash-attention op, the counterpart of ``repro.kernels.flash_attention.ops``.

The JAX op takes block sizes and an interpret flag; the CUDA kernel fixes
its own tiles and masks ragged ends, and the tensors' device picks kernel or
plain version. The op makes its operands contiguous for the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda

__all__ = ["flash_attention"]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    return flash_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(),
        causal=causal, window=window, scale=scale,
    )
