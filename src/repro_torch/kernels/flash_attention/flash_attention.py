"""Wrappers of the flash-attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``).

:func:`flash_attention_cuda` is the counterpart of ``flash_attention_pallas``:
online-softmax attention of q (B, Hq, Sq, D) against k, v (B, Hkv, Sk, D),
Hq % Hkv == 0, with the causal and sliding-window masks of the TPU kernel.
The CUDA kernel takes D in (16, 32, 64, 128, 256) and any Sq, Sk; asked for
``return_lse`` it also writes the row log-sum-exp that the backward reads.
:func:`flash_attention_bwd_cuda` is its gradient, which the JAX package
leaves to XLA (it has no Pallas backward), at every head dim in fp32 and
bf16. It gives the same bits on every run: in bf16 the key tiles add their
dQ terms to one fp32 sum of dQ's size in key-tile order, in fp32 a last pass
adds per-key-tile partials (Sk / 32 times dQ's size). Its launch plan,
:func:`flash_bwd_plan`, is a plain function of the shapes and two numbers
of the device, so that it can be checked without one. On a CUDA tensor each
wrapper launches its kernel or raises; on a CPU tensor it computes the plain
version in ``ref.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.common import cdiv, on_cuda, traced
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda", "flash_bwd_plan", "BwdPlan",
           "HEAD_DIMS", "BWD_HEAD_DIMS"]

# Head dims the kernel is instantiated for: every dense config in configs/.
HEAD_DIMS = (16, 32, 64, 128, 256)
# Head dims of the backward kernel by dtype.
BWD_HEAD_DIMS = {torch.float32: HEAD_DIMS, torch.bfloat16: HEAD_DIMS}

# The backward kernels' constants (csrc/flash_attention_bwd.cu): fp32 keys a
# block and threads; bf16 query rows a step, threads (two consumer
# warpgroups and a producer), and the bytes of a 64 x 64 bf16 box. The bf16
# kernel takes 128 keys a block at D <= 64 and 64 above.
_F32_TILE, _F32_THREADS = 32, 256
_TILE, _THREADS, _BOX_BYTES = 64, 384, 64 * 64 * 2


@dataclass(frozen=True)
class BwdPlan:
    """How the backward kernel of one dtype covers a shape on one device.

    ``grid`` blocks each own ``tile`` keys of one KV head of one batch entry
    and, in bf16, one of ``parts`` equal shares of the KV head's query heads
    (walked 64 query rows a step);
    the bf16 kernel streams its query tiles through ``stages`` stages of
    shared memory. ``scratch`` names the device buffers it needs beside its
    outputs, in bytes.
    """

    tile: int
    grid: int
    threads: int
    parts: int
    stages: int
    smem_bytes: int
    scratch: Dict[str, int]

    @property
    def scratch_bytes(self) -> int:
        return sum(self.scratch.values())


def flash_bwd_plan(b: int, hq: int, hkv: int, sq: int, sk: int, d: int, causal: bool,
                   window: Optional[int], sms: int, smem_per_block: int,
                   dtype: torch.dtype = torch.bfloat16) -> BwdPlan:
    """The launch plan of the backward at q (b, hq, sq, d) against k, v
    (b, hkv, sk, d) on a device with ``sms`` SMs and ``smem_per_block``
    bytes of shared memory a block may opt in to.

    bf16: a block a (key tile, part, batch entry, KV head); ``parts`` is the
    least divisor of the group (hq / hkv) that gives at least ``sms`` blocks,
    or the whole group, so that MQA at one KV head still fills the card. The
    scratch is the query tiles' lse and delta, dQ's fp32 sum (none at one key
    tile), dK's and dV's fp32 sums when parts > 1, and the turn counts: none
    of it grows with the number of key tiles. fp32: a block a (key tile,
    KV head, batch entry) and a partial dQ per key tile. The masks do not
    change the plan.
    """
    if min(b, hq, hkv, sq, sk, sms) < 1 or hq % hkv or d not in HEAD_DIMS:
        raise ValueError(f"bad flash backward shape: b {b}, hq {hq}, hkv {hkv}, sq {sq}, sk {sk}, "
                         f"d {d}, sms {sms}")
    del causal, window  # the grid covers every key tile; a block skips dead query tiles
    if dtype == torch.float32:
        tile, parts, stages = _F32_TILE, 1, 1
        grid = cdiv(sk, tile) * hkv * b
        smem = (4 * tile * (d + 1) + 2 * tile * (tile + 1) + 2 * tile) * 4
        scratch = {"delta": 4 * b * hq * sq, "dq_part": 4 * cdiv(sk, tile) * b * hq * sq * d}
        threads = _F32_THREADS
    elif dtype == torch.bfloat16:
        dp = max(d, 64)
        tile, stages = (128 if dp == 64 else 64), (2 if dp == 256 else 3)
        halves, boxes = tile // 64, dp // 64
        # alignment slack, K and V, the ring of Q and dO, P^T and dS^T (hi and
        # lo of each 64-key half), the ring's lse and delta
        smem = (1024 + (2 * halves + 2 * stages) * boxes * _BOX_BYTES + 4 * halves * _BOX_BYTES
                + stages * 2 * _TILE * 4)
        nkt, nt, group = cdiv(sk, tile), cdiv(sq, _TILE), hq // hkv
        parts = next((p for p in range(1, group + 1) if group % p == 0 and nkt * b * hkv * p >= sms), group)
        grid = nkt * parts * b * hkv
        scratch = {"lse_delta": 4 * b * hq * nt * 2 * _TILE,
                   "dq_acc": 4 * b * hq * sq * d if nkt > 1 else 0,
                   "dkv_acc": 2 * 4 * b * hkv * sk * d if parts > 1 else 0,
                   "counts": 4 * (b * hq * nt + (b * hkv * nkt if parts > 1 else 0))}
        threads = _THREADS
    else:
        raise TypeError(f"flash backward takes float32 or bfloat16, got {dtype}")
    if smem > smem_per_block:
        raise ValueError(f"flash backward at d {d} needs {smem} bytes of shared memory, the device "
                         f"has {smem_per_block} a block")
    if grid > 2**31 - 1:
        raise ValueError(f"flash backward grid of {grid} blocks is too large")
    return BwdPlan(tile, grid, threads, parts, stages, smem, scratch)


_LIMITS: Dict[torch.device, Tuple[int, int]] = {}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window) -> None:
    if window is not None and not causal:
        raise ValueError("sliding window requires causal=True (backward window)")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad attention shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """softmax(q k^T * scale + mask) v in q's dtype; scale defaults to D**-0.5.

    With ``return_lse``: (out, lse), lse (B, Hq, Sq) fp32 the row
    log-sum-exp of the scaled, masked scores (+inf for a row with no live
    key). ``out`` is the same either way.
    """
    _check(q, k, v, causal, window)
    b, hq, sq, d = q.shape
    code = _build.dtype_code(q, k, v)
    if not on_cuda(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale, return_lse=return_lse)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda takes head dims {HEAD_DIMS}, got {d}")
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if return_lse else None
    hkv, sk = k.shape[1], k.shape[2]
    if out.numel() == 0 or traced(
            flash_attention_cuda, cost.flash(b, hq, hkv, sq, sk, d, causal, window, q.dtype, return_lse),
            q, k, v):
        return (out, lse) if return_lse else out
    if not _aligned(q, k, v):
        raise ValueError("flash_attention_cuda needs contiguous, 16-byte aligned q, k, v")
    _build.launch(
        "repro_flash_attention", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), code, b, hq, hkv, sq, sk, d,
        int(causal), -1 if window is None else int(window), d**-0.5 if scale is None else float(scale),
    )
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_cuda` given its output ``o``, its
    ``lse`` and the output's gradient ``do``; each in its input's dtype."""
    _check(q, k, v, causal, window)
    b, hq, sq, d = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, hq, sq):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)} "
                         f"do not match q {tuple(q.shape)}")
    code = _build.dtype_code(q, k, v, o, do)
    if lse.dtype != torch.float32:
        raise TypeError(f"lse must be float32, got {lse.dtype}")
    if not on_cuda(q, k, v, o, lse, do):
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window, scale=scale)
    if d not in BWD_HEAD_DIMS[q.dtype]:
        raise ValueError(f"flash_attention_bwd_cuda takes head dims {BWD_HEAD_DIMS[q.dtype]} in "
                         f"{q.dtype}, got {d}")
    hkv, sk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if traced(flash_attention_bwd_cuda, cost.flash_bwd(b, hq, hkv, sq, sk, d, causal, window, q.dtype),
              q, k, v, o, lse, do):
        return dq, dk, dv
    if not (_aligned(q, k, v, o, do) and lse.is_contiguous()):
        raise ValueError("flash_attention_bwd_cuda needs contiguous, 16-byte aligned tensors")
    if q.device not in _LIMITS:
        _LIMITS[q.device] = _build.device_limits(q.device)
    plan = flash_bwd_plan(b, hq, hkv, sq, sk, d, causal, window, *_LIMITS[q.device], dtype=q.dtype)
    bufs = [torch.empty(max(n, 16) // 4, dtype=torch.int32 if name == "counts" else torch.float32,
                        device=q.device) for name, n in plan.scratch.items()]
    if q.dtype == torch.float32:
        bufs += [bufs[0], bufs[0]]  # no dK, dV sums or counts
    stats, acc, dkv_acc, counts = bufs
    _build.launch(
        "repro_flash_attention_bwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), stats.data_ptr(), acc.data_ptr(),
        dkv_acc.data_ptr(), counts.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), code,
        b, hq, hkv, sq, sk, d, int(causal), -1 if window is None else int(window),
        d**-0.5 if scale is None else float(scale), plan.parts,
    )
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
