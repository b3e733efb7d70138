"""Wrappers of the RMSNorm kernels (``csrc/rmsnorm.cu``).

:func:`rmsnorm_cuda` is the counterpart of ``rmsnorm_pallas``: y = x *
rsqrt(mean(x^2) + eps) * w over the last dim of (R, D) rows, fp32 maths,
output in x's dtype. :func:`rmsnorm_bwd_cuda` is its gradient, which the JAX
package leaves to XLA (it has no Pallas backward). On a CUDA tensor each
wrapper launches its kernel or raises; on a CPU tensor it computes the plain
version in ``ref.py``. The kernels hold a row in registers: they take D up
to 16384 in bf16 and 8192 in fp32, or 2048 where D is not a multiple of 16
bytes or a pointer is off 16 bytes. The backward's launch plan,
:func:`rmsnorm_bwd_plan`, is a plain function of the shape and the device's
SM count, so that it can be checked without one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.common import cdiv, on_cuda, traced
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

__all__ = ["rmsnorm_cuda", "rmsnorm_bwd_cuda", "rmsnorm_bwd_plan", "RmsnormBwdPlan"]

# The backward kernel's constants (csrc/rmsnorm.cu): vectors of 16 bytes (or
# elements) a thread holds, threads of a block unless a row takes more, and
# the columns a reducing block adds at a time.
_BWD_MAXV, _BWD_THREADS, _REDUCE_COLS = 4, 256, 64
_SMS: Dict[torch.device, int] = {}
# The backward's turn counts, one pair a device; the kernel leaves them 0.
_COUNTS: Dict[torch.device, torch.Tensor] = {}


@dataclass(frozen=True)
class RmsnormBwdPlan:
    """How the backward kernel covers (rows, d) on one device: ``groups``
    persistent blocks (at most ``per_sm`` an SM, so all are resident) of
    ``block`` threads, ``row`` threads a row and ``block / row`` rows at a
    time; each writes a row of fp32 dw partials (``scratch_bytes`` in all),
    which the last ``reducers`` blocks to finish add in block order."""

    row: int
    block: int
    per_sm: int
    groups: int
    reducers: int
    smem_bytes: int
    scratch_bytes: int


def rmsnorm_bwd_plan(rows: int, d: int, itemsize: int, sms: int, vec: bool = True) -> RmsnormBwdPlan:
    """The plan at (rows, d) of elements of ``itemsize`` bytes (4 fp32, 2
    bf16) on ``sms`` SMs; ``vec``: x, w, dy and dx allow 16-byte vectors
    (their pointers aligned), as the kernel decides for itself."""
    if rows < 1 or d < 1 or sms < 1 or itemsize not in (2, 4):
        raise ValueError(f"bad rmsnorm backward plan input: rows {rows}, d {d}, itemsize {itemsize}, sms {sms}")
    per_vec = 16 // itemsize if vec and d % (16 // itemsize) == 0 else 1
    nvec = d // per_vec
    row = next((r for r in (32, 64, 128, 256, 512) if nvec <= r * _BWD_MAXV), None)
    if row is None:
        raise ValueError(f"rmsnorm backward takes rows of at most {512 * _BWD_MAXV} vectors, got d {d}")
    block = max(row, _BWD_THREADS)
    slots = block // row
    per_sm = 2 if block <= _BWD_THREADS else 1
    groups = min(cdiv(rows, slots), per_sm * sms)
    reducers = min(groups, cdiv(d, _REDUCE_COLS))
    # static shared memory: the slots' dw sums, the rows' partial sums, the reduction
    smem = 4 * ((slots * row * _BWD_MAXV * per_vec if slots > 1 else 0) + 2 * max(block // 32, 1)
                + block // 64 * _REDUCE_COLS + 1)
    return RmsnormBwdPlan(row, block, per_sm, groups, reducers, smem, 4 * groups * d)


def _check(x: torch.Tensor, w: torch.Tensor) -> Tuple[int, int]:
    if x.ndim != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"bad rmsnorm shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    code, wcode = _build.dtype_code(x), _build.dtype_code(w)
    if w.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"w must be float32 or {x.dtype}, got {w.dtype}")
    return code, wcode


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """(R, D) rows, (D,) scale in fp32 or x's dtype -> (R, D) in x's dtype."""
    code, wcode = _check(x, w)
    if not on_cuda(x, w):
        return rmsnorm_ref(x, w, eps)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_cuda needs contiguous x and w")
    out = torch.empty_like(x)
    r, d = x.shape
    if out.numel() == 0 or traced(rmsnorm_cuda, cost.rmsnorm(r, d, x.dtype, w.dtype), x, w):
        return out
    _build.launch(
        "repro_rmsnorm", x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
        code, wcode, r, d, eps,
    )
    rmsnorm_cuda.launches += 1
    return out


rmsnorm_cuda.launches = 0


def rmsnorm_bwd_cuda(
    x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of :func:`rmsnorm_cuda` given the output's gradient ``dy``:
    dx (R, D) in x's dtype, dw (D,) in w's, dw the same bits on every run."""
    code, wcode = _check(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x {tuple(x.shape)} {x.dtype}")
    if not on_cuda(x, w, dy):
        return rmsnorm_bwd_ref(x, w, dy, eps)
    if not (x.is_contiguous() and w.is_contiguous() and dy.is_contiguous()):
        raise ValueError("rmsnorm_bwd_cuda needs contiguous x, w and dy")
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    r, d = x.shape
    if r == 0:
        return dx, dw.zero_()
    if traced(rmsnorm_bwd_cuda, cost.rmsnorm_bwd(r, d, x.dtype, w.dtype), x, w, dy):
        return dx, dw
    if x.device not in _SMS:
        _SMS[x.device] = _build.device_limits(x.device)[0]
        _COUNTS[x.device] = torch.zeros(2, dtype=torch.int32, device=x.device)
    vec = all(t.data_ptr() % 16 == 0 for t in (x, w, dy, dx))
    plan = rmsnorm_bwd_plan(r, d, x.element_size(), _SMS[x.device], vec)
    partial = torch.empty((plan.groups, d), dtype=torch.float32, device=x.device)
    _build.launch(
        "repro_rmsnorm_bwd", x.device, x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), partial.data_ptr(), _COUNTS[x.device].data_ptr(), code, wcode, r, d,
        plan.groups, plan.reducers, eps,
    )
    rmsnorm_bwd_cuda.launches += 1
    return dx, dw


rmsnorm_bwd_cuda.launches = 0
