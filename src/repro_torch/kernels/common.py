"""Shared helpers of the kernel wrappers.

The JAX package picks between a compiled and an interpreted Pallas kernel
with ``default_interpret()``. Here the tensor decides: :func:`on_cuda` is
true for a CUDA tensor, whose wrapper then launches the hand-written kernel
(or raises), and false for a CPU tensor, whose wrapper computes the plain
PyTorch version. No wrapper moves data between devices or falls back from a
failed build or launch.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["on_cuda", "out_dtype_of", "pick_block", "cdiv"]

# The output types of the matmul-type kernels and their plain versions.
OUT_DTYPES = (torch.float32, torch.bfloat16)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on one CUDA device, False when on the CPU.

    Raises for mixed devices and for any other device type: no kernel or
    plain version is defined there.
    """
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {device}")
    return device.type == "cuda"


def out_dtype_of(out_dtype: Optional[torch.dtype], operand: torch.Tensor) -> torch.dtype:
    """The reference's rule ``out_dtype or a.dtype``: fp32 or bf16, else TypeError."""
    dtype = out_dtype or operand.dtype
    if dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {dtype}")
    return dtype


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pick_block(dim: int, preferred: int, align: int = 128) -> int:
    """Largest block <= preferred that divides dim, preferring ``align``.

    Kept from the JAX package, where blocks had to divide the array. The
    Hopper kernels fix their own tiles and mask the ragged edge, so they do
    not call it.
    """
    if dim <= preferred:
        return dim
    b = preferred
    while b >= align:
        if dim % b == 0:
            return b
        b -= align
    b = preferred
    while b > 1:
        if dim % b == 0:
            return b
        b -= 1
    return 1
