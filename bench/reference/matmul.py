"""The plain reference of a dense multiply, and its lower-precision control.

:func:`product` is ``a @ b`` in float64 on the operands as given (bf16
operands are exact in float64), so it is the product the program
approximates. :func:`control` is the same product put in the program's
place one precision below the configuration's: TF32 operands for fp32
(operands rounded to TF32's 10-bit mantissa, to nearest, then an fp32
product with TF32 off), fp8 e4m3 operands for bf16 (rounded to
``float8_e4m3fn``, then a bf16 product). The rounding is written out so
that the control computes the same on the card and on a CPU.
"""
from __future__ import annotations

import torch


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float64."""
    return torch.matmul(a.double(), b.double())


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to nearest (ties to even) at TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def control(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product one precision below the operands' dtype, in that dtype."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if a.dtype == torch.float32:
            return torch.matmul(round_tf32(a), round_tf32(b))
        if a.dtype == torch.bfloat16:
            f8 = torch.float8_e4m3fn
            return torch.matmul(a.to(f8).to(a.dtype), b.to(f8).to(b.dtype))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    raise TypeError(f"no control for {a.dtype}")
