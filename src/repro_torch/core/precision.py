"""Matmul precision names and how the port maps them onto the card.

The JAX package threads a ``precision=`` name into each ``jnp.einsum`` and
``jnp.matmul``. PyTorch has no per-call argument; TF32 is a process switch
(``torch.backends.cuda.matmul.allow_tf32``). :func:`matmul_precision` sets
that switch for the duration of one call and restores it afterwards:

* ``"high"`` and ``"tensorfloat32"`` allow TF32 (about three decimal digits
  per product, fp32 accumulation);
* ``None`` and every other name run full fp32 with TF32 off, which is what
  the JAX reference computes on the CPU.

bf16 operands are unaffected: their products accumulate in fp32 either way.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch

__all__ = ["PRECISIONS", "TF32_PRECISIONS", "matmul_precision"]

# The names repro.core.backend.set_default_matmul_precision accepts.
PRECISIONS: Tuple[str, ...] = (
    "default", "fastest", "high", "highest", "bfloat16", "float32", "tensorfloat32",
)
TF32_PRECISIONS: Tuple[str, ...] = ("high", "tensorfloat32")


@contextlib.contextmanager
def matmul_precision(precision: Optional[str]) -> Iterator[None]:
    """Run the body with TF32 on for "high"/"tensorfloat32", else off."""
    if precision is not None and precision not in PRECISIONS:
        raise ValueError(f"unknown matmul precision {precision!r}")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision in TF32_PRECISIONS
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
