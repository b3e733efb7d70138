"""Wrappers of the tiled matmul kernel (``csrc/matmul.cu``).

Stark multiplies its leaf blocks on one node through BLAS; the JAX package
does it with a Pallas MXU kernel. Here it is a hand-written CUDA kernel with
fp32 accumulation: :func:`batched_matmul_cuda` is the leaf stage batched over
the 7^depth tag index (``batched_matmul_pallas``), and :func:`matmul_cuda`
(``matmul_pallas``) is the same kernel with a batch of one.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it computes the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import on_cuda
from repro_torch.kernels.matmul.ref import batched_matmul_ref

__all__ = ["matmul_cuda", "batched_matmul_cuda"]


def batched_matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(mb, m, k) x (mb, k, n) -> (mb, m, n), fp32 accumulation, a's dtype."""
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"bad batched matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    code = _build.dtype_code(a, b)
    if not on_cuda(a, b):
        return batched_matmul_ref(a, b)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("batched_matmul_cuda needs contiguous operands")
    (mb, m, k), n = a.shape, b.shape[2]
    out = torch.empty((mb, m, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    _build.launch(
        "repro_batched_matmul", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
        code, mb, m, k, n,
    )
    batched_matmul_cuda.launches += 1
    return out


batched_matmul_cuda.launches = 0


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) x (k, n) -> (m, n): the batched kernel with a batch of one."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"bad matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    return batched_matmul_cuda(a[None], b[None])[0]
