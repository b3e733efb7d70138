"""Wrappers of the tiled matmul kernel (``csrc/matmul.cu``).

Stark multiplies its leaf blocks on one node through BLAS; the JAX package
does it with a Pallas MXU kernel. Here it is a hand-written CUDA kernel with
fp32 accumulation (fp32 on the CUDA cores' FMA, bf16 on Hopper's ``wgmma``,
both fed by a TMA ring): :func:`batched_matmul_cuda` is the leaf stage
batched over the 7^depth tag index (``batched_matmul_pallas``), and
:func:`matmul_cuda` (``matmul_pallas``) is the same kernel with a batch of
one. Each counts only the launches it makes itself. Both take the
reference's ``out_dtype`` (fp32 or bf16, the operands' dtype by default):
the fp32 accumulators are stored as they are or rounded once.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it computes the plain version in ``ref.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.common import on_cuda, out_dtype_of, traced
from repro_torch.kernels.matmul.ref import batched_matmul_ref

__all__ = ["matmul_cuda", "batched_matmul_cuda"]


def _check(a: torch.Tensor, b: torch.Tensor) -> int:
    """The dtype code of (mb, m, k) x (mb, k, n) operands; raises on bad shapes or dtypes."""
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"bad batched matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    return _build.dtype_code(a, b)


def _launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, code: int) -> None:
    """Runs the kernel on CUDA operands into a non-empty ``out``."""
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the matmul kernel needs contiguous operands")
    (mb, m, k), n = a.shape, b.shape[2]
    _build.launch(
        "repro_batched_matmul", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
        code, _build.dtype_code(out), mb, m, k, n,
    )


def batched_matmul_cuda(
    a: torch.Tensor, b: torch.Tensor, *, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """(mb, m, k) x (mb, k, n) -> (mb, m, n), fp32 accumulation, in ``out_dtype``."""
    code = _check(a, b)
    dtype = out_dtype_of(out_dtype, a)
    if not on_cuda(a, b):
        return batched_matmul_ref(a, b, dtype)
    out = torch.empty((a.shape[0], a.shape[1], b.shape[2]), dtype=dtype, device=a.device)
    if out.numel() and not traced(batched_matmul_cuda, cost.matmul(*a.shape, b.shape[2], a.dtype, dtype), a, b):
        _launch(a, b, out, code)
        batched_matmul_cuda.launches += 1
    return out


batched_matmul_cuda.launches = 0


def matmul_cuda(
    a: torch.Tensor, b: torch.Tensor, *, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """(m, k) x (k, n) -> (m, n): the batched kernel with a batch of one."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"bad matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    a3, b3 = a[None], b[None]
    code = _check(a3, b3)
    dtype = out_dtype_of(out_dtype, a)
    if not on_cuda(a, b):
        return batched_matmul_ref(a3, b3, dtype)[0]
    out = torch.empty((1, a.shape[0], b.shape[1]), dtype=dtype, device=a.device)
    if out.numel() and not traced(matmul_cuda, cost.matmul(1, *a.shape, b.shape[1], a.dtype, dtype), a, b):
        _launch(a3, b3, out, code)
        matmul_cuda.launches += 1
    return out[0]


matmul_cuda.launches = 0
