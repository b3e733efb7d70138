"""Public matmul ops, the counterparts of ``repro.kernels.matmul.ops``.

The JAX ops jit the Pallas calls and take block sizes; here the kernel fixes
its own tiles and PyTorch runs eagerly, so the ops are the wrappers.
"""
from __future__ import annotations

from repro_torch.kernels.matmul.matmul import batched_matmul_cuda as batched_matmul
from repro_torch.kernels.matmul.matmul import matmul_cuda as matmul

__all__ = ["matmul", "batched_matmul"]
