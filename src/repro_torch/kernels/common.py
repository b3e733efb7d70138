"""Shared helpers of the kernel wrappers.

The JAX package picks between a compiled and an interpreted Pallas kernel
with ``default_interpret()``. Here the tensor decides: :func:`on_cuda` is
true for a CUDA tensor, whose wrapper then launches the hand-written kernel
(or raises), and false for a CPU tensor, whose wrapper computes the plain
PyTorch version. No wrapper moves data between devices or falls back from a
failed build or launch.

The dry-run (``launch/op_analysis.py``) runs a step on fake CUDA tensors,
which hold no data: just before its launch each wrapper calls
:func:`traced`, which records the call's name and cost
(``kernels/cost.py``) with the active analysis and tells the wrapper to
launch nothing. On real tensors it is one check, and the launch follows.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["on_cuda", "out_dtype_of", "pick_block", "cdiv", "traced", "set_analysis"]

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


# The analysis that records kernel calls on fake tensors, or None.
_analysis = None


def set_analysis(analysis):
    """Make ``analysis`` (an object with ``kernel(name, cost)``, or None) the
    one :func:`traced` records with; returns the one it replaces."""
    global _analysis
    previous, _analysis = _analysis, analysis
    return previous


def traced(fn, cost, *tensors: torch.Tensor) -> bool:
    """Called by a wrapper where it would launch ``fn``'s kernel on CUDA
    tensors. Real tensors: False, and the wrapper launches. Fake tensors:
    ``fn``'s name and ``cost`` (a ``kernels.cost.Cost``) go to the active
    analysis and the answer is True, so the wrapper returns its outputs
    unwritten. A fake tensor with no analysis, and a real one under an
    analysis, raise."""
    fake = any(isinstance(t, FakeTensor) for t in tensors)
    if fake != (_analysis is not None):
        what = "fake tensor with no analysis" if fake else "real tensor under an analysis"
        raise RuntimeError(f"{fn.__name__}: a {what}; the kernel is neither launched nor recorded")
    if fake:
        _analysis.kernel(fn.__name__, cost)
    return fake


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
