"""Shared helpers of the kernel wrappers.

The JAX package picks between a compiled and an interpreted Pallas kernel
with ``default_interpret()``. Here the tensor decides: :func:`on_cuda` is
true for a CUDA tensor, whose wrapper then launches the hand-written kernel
(or raises), and false for a CPU tensor, whose wrapper computes the plain
PyTorch version. No wrapper moves data between devices or falls back from a
failed build or launch.
"""
from __future__ import annotations

import torch

__all__ = ["on_cuda", "pick_block", "cdiv"]


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
