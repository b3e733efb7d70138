"""Wrappers of the sLSTM sequence kernels (``csrc/slstm.cu``, ``csrc/slstm_bwd.cu``).

:func:`slstm_seq_cuda` is the counterpart of ``slstm_seq_pallas``: the whole
sLSTM recurrence over S steps, wx (B, S, 4, H, dh) input pre-activations
(z/i/f/o order), r (4, H, dh, dh) per-head recurrent mixing, state {c, n, m,
h} (B, H, dh), all fp32. Returns (final state, hs (B, S, H, dh)); with
``save`` also what the backward reads. :func:`slstm_seq_bwd_cuda` is its
gradient, which the JAX package forms in XLA (the VJP of its scan; no
Pallas backward): the backward kernel's reverse-time recurrence gives dwx
and the initial state's gradients, and dr is one fp32 batched product after
it (tracer span ``slstm.dr``). The inputs are not changed. On a CUDA tensor
each wrapper launches its kernel or raises (a grid that cannot be resident
at once is refused by the launch); on a CPU tensor it computes the plain
version in ``ref.py``.

Each kernel runs all S steps in one cooperative launch, one block an SM.
Their launch plans, :func:`slstm_plan` and :func:`slstm_bwd_plan`, are plain
functions of the shape and two numbers of the device, so that they can be
checked without one.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels.common import cdiv, on_cuda, traced
from repro_torch.kernels.slstm.ref import slstm_dr, slstm_seq_bwd_ref, slstm_seq_ref
from repro_torch.obs.tracer import get_tracer

__all__ = ["slstm_seq_cuda", "slstm_seq_bwd_cuda", "slstm_plan", "slstm_bwd_plan", "SlstmPlan", "SlstmBwdPlan"]

_STATE = ("c", "n", "m", "h")

# The kernels' constants (csrc/slstm.cuh): columns per tile, batch rows per
# pass at most, and the floats of the forward's reduction buffer (8 warps x
# BT x 4 x COLS; the backward's is 8 x ROWS x COLS).
COLS, BT = 16, 4
_RED_FLOATS = 8 * BT * 4 * COLS
_SAVED = ("pre", "c", "n", "m")


@dataclass(frozen=True)
class SlstmPlan:
    """How the persistent sLSTM kernel covers (H, dh) on one device.

    ``blocks`` blocks of the grid (one an SM) each own ``tiles_per_block``
    consecutive tiles of COLS output columns, numbered head by head; the
    r slices of the first ``resident`` of them live in shared memory for the
    whole call, and the rest are read from L2 every step.
    """

    blocks: int
    tiles_per_block: int
    resident: int
    smem_bytes: int
    blocks_per_head: int

    @property
    def cols_per_block(self) -> int:
        return self.tiles_per_block * COLS

    @property
    def r_resident(self) -> bool:
        return self.resident == self.tiles_per_block


@dataclass(frozen=True)
class SlstmBwdPlan(SlstmPlan):
    """The backward kernel's plan: :class:`SlstmPlan` and

    ``rows``, the batch rows a pass (the kernel's ROWS template: 1 at B = 1,
    2 at B = 2, else BT); ``ring_floats``, the size of the ring through which
    the blocks exchange dpre, 2 slots x H x B x 4 gates x ``dh_pad`` (dh
    rounded up to 4 floats, so that every block's staging is one 16-byte
    aligned run of float4 loads).
    """

    rows: int = BT
    dh_pad: int = 0
    ring_floats: int = 0


def slstm_plan(heads: int, dh: int, steps: int, sms: int, smem_per_block: int) -> SlstmPlan:
    """The launch plan of ``steps`` steps at H heads of width dh on a device
    with ``sms`` SMs and ``smem_per_block`` bytes of shared memory a block may
    opt in to.

    The grid has at most one block an SM, so that every block can be
    resident at once (the blocks of a head wait for each other every step);
    r's slices fill the shared memory left beside the staged h (BT x dh) and
    the reduction buffer. A single step (a decode step) reads each element
    of r once, so there nothing is copied to shared memory first.
    """
    return _plan(heads, dh, steps, sms, smem_per_block, (BT * dh + _RED_FLOATS) * 4)


def slstm_bwd_plan(heads: int, dh: int, steps: int, sms: int, smem_per_block: int, *,
                   batch: int) -> SlstmBwdPlan:
    """The backward kernel's plan for ``batch`` rows, made as
    :func:`slstm_plan`'s: a tile is COLS columns of r's d index (its slice
    of r, transposed, is the forward's size), and a pass stages four gates
    of dpre a row (rows x 4 x dh_pad floats) from the exchange ring. Over S steps it forms S dot-product passes
    (none at t = S-1, one at t = -1), so at S = 1 r is read once and nothing
    is made resident."""
    if batch < 1:
        raise ValueError(f"bad sLSTM backward batch {batch}")
    rows = batch if batch <= 2 else BT
    dh_pad = cdiv(dh, 4) * 4
    plan = _plan(heads, dh, steps, sms, smem_per_block, (rows * 4 * dh_pad + 8 * rows * COLS) * 4)
    return SlstmBwdPlan(**asdict(plan), rows=rows, dh_pad=dh_pad, ring_floats=2 * heads * batch * 4 * dh_pad)


def _plan(heads: int, dh: int, steps: int, sms: int, smem_per_block: int, fixed: int) -> SlstmPlan:
    if heads < 1 or dh < 1 or steps < 1 or sms < 1:
        raise ValueError(f"bad sLSTM plan input: heads {heads}, dh {dh}, steps {steps}, sms {sms}")
    per_head = cdiv(dh, COLS)
    units = heads * per_head
    tiles_per_block = cdiv(units, sms)
    blocks = cdiv(units, tiles_per_block)
    tile = 4 * dh * COLS * 4
    if fixed > smem_per_block:
        raise ValueError(f"sLSTM dh {dh} needs {fixed} bytes of shared memory, the device has "
                         f"{smem_per_block} a block")
    resident = 0 if steps == 1 else min(tiles_per_block, (smem_per_block - fixed) // tile)
    # the most blocks that hold tiles of one head
    blocks_per_head = max(((h + 1) * per_head - 1) // tiles_per_block - h * per_head // tiles_per_block
                          + 1 for h in range(heads))
    return SlstmPlan(blocks, tiles_per_block, resident, fixed + resident * tile, blocks_per_head)


def _check(wx_shape, r: torch.Tensor, state: Dict[str, torch.Tensor]) -> None:
    if len(wx_shape) != 5 or wx_shape[2] != 4:
        raise ValueError(f"wx must be (B, S, 4, H, dh), got {tuple(wx_shape)}")
    b, _, _, h, dh = wx_shape
    if tuple(r.shape) != (4, h, dh, dh):
        raise ValueError(f"r must be {(4, h, dh, dh)}, got {tuple(r.shape)}")
    for k in _STATE:
        if tuple(state[k].shape) != (b, h, dh):
            raise ValueError(f"state {k!r} must be {(b, h, dh)}, got {tuple(state[k].shape)}")


def slstm_seq_cuda(wx: torch.Tensor, r: torch.Tensor, state: Dict[str, torch.Tensor], *, save: bool = False):
    """Returns (final state, hs); with ``save`` (training) also {pre (B, S, 4,
    H, dh), c, n, m (B, S, H, dh)}, each step's gate pre-activations and the
    state after it, which :func:`slstm_seq_bwd_cuda` reads."""
    _check(tuple(wx.shape), r, state)
    b, s, _, h, dh = wx.shape
    states = [state[k] for k in _STATE]
    if any(t.dtype != torch.float32 for t in (wx, r, *states)):
        raise TypeError("slstm_seq_cuda takes float32 wx, r and state")
    if not on_cuda(wx, r, *states):
        return slstm_seq_ref(wx, r, state, save=save)
    if not all(t.is_contiguous() for t in (wx, r, *states)):
        raise ValueError("slstm_seq_cuda needs contiguous wx, r and state")
    c, n, m = (torch.empty_like(t) for t in states[:3])
    hs = torch.empty((b, s, h, dh), dtype=torch.float32, device=wx.device)
    saved = None
    if save:
        saved = {"pre": torch.empty_like(wx),
                 **{k: torch.empty_like(hs) for k in ("c", "n", "m")}}
    if not traced(slstm_seq_cuda, cost.slstm(b, s, h, dh, save), wx, r, *states):
        counters = torch.zeros(h, dtype=torch.int32, device=wx.device)
        plan = slstm_plan(h, dh, s, *_build.device_limits(wx.device))
        _build.launch(
            "repro_slstm_seq", wx.device, wx.data_ptr(), r.data_ptr(), states[3].data_ptr(),
            *(t.data_ptr() for t in states[:3]), c.data_ptr(), n.data_ptr(), m.data_ptr(),
            hs.data_ptr(), *((saved[k].data_ptr() for k in _SAVED) if save else (None,) * 4),
            counters.data_ptr(), b, s, h, dh, plan.blocks, plan.tiles_per_block, plan.resident,
        )
        slstm_seq_cuda.launches += 1
    final = {"c": c, "n": n, "m": m, "h": hs[:, -1].clone()}
    return (final, hs, saved) if save else (final, hs)


slstm_seq_cuda.launches = 0


def slstm_seq_bwd_cuda(
    r: torch.Tensor,
    state: Dict[str, torch.Tensor],
    hs: torch.Tensor,
    saved: Dict[str, torch.Tensor],
    dhs: torch.Tensor,
    dstate: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """The gradients of ``slstm_seq_cuda(wx, r, state)``: given the saving
    forward's ``hs`` and ``saved``, ``dhs`` (B, S, H, dh) and the final
    state's ``dstate`` {c, n, m, h}, returns (dwx (B, S, 4, H, dh), dr (4, H,
    dh, dh), the initial state's gradients {c, n, m, h}), all fp32. The
    kernel's sums run in a fixed order: a rerun gives the same bits."""
    _check(tuple(saved["pre"].shape), r, state)
    b, s, _, h, dh = saved["pre"].shape
    seq = (b, s, h, dh)
    for name, t in (("hs", hs), ("dhs", dhs), *((f"saved {k!r}", saved[k]) for k in ("c", "n", "m"))):
        if tuple(t.shape) != seq:
            raise ValueError(f"{name} must be {seq}, got {tuple(t.shape)}")
    for k in _STATE:
        if tuple(dstate[k].shape) != (b, h, dh):
            raise ValueError(f"dstate {k!r} must be {(b, h, dh)}, got {tuple(dstate[k].shape)}")
    tensors = (r, hs, dhs, *(state[k] for k in _STATE), *(saved[k] for k in _SAVED),
               *(dstate[k] for k in _STATE))
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("slstm_seq_bwd_cuda takes float32 tensors")
    if not on_cuda(*tensors):
        return slstm_seq_bwd_ref(r, state, hs, saved, dhs, dstate)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("slstm_seq_bwd_cuda needs contiguous tensors")
    rt = r.transpose(-1, -2).contiguous()  # rt[g, h, e, d] = r[g, h, d, e]
    dwx = torch.empty_like(saved["pre"])
    d0 = {k: torch.empty_like(state[k]) for k in _STATE}
    if not traced(slstm_seq_bwd_cuda, cost.slstm_bwd(b, s, h, dh, dr=False), *tensors):
        plan = slstm_bwd_plan(h, dh, s, *_build.device_limits(r.device), batch=b)
        counters = torch.zeros(h, dtype=torch.int32, device=r.device)
        ring = torch.empty(plan.ring_floats, dtype=torch.float32, device=r.device)  # written before read
        _build.launch(
            "repro_slstm_seq_bwd", r.device, rt.data_ptr(), *(saved[k].data_ptr() for k in _SAVED),
            *(state[k].data_ptr() for k in ("c", "n", "m")), dhs.data_ptr(),
            *(dstate[k].data_ptr() for k in ("h", "c", "n", "m")), dwx.data_ptr(),
            *(d0[k].data_ptr() for k in ("h", "c", "n", "m")), counters.data_ptr(), ring.data_ptr(),
            b, s, h, dh, plan.blocks, plan.tiles_per_block, plan.resident, plan.rows,
        )
        slstm_seq_bwd_cuda.launches += 1
    with get_tracer().span("slstm.dr", cat="slstm"):  # a span a profiled step can attribute
        dr = slstm_dr(state["h"], hs, dwx)
    return dwx, dr, d0


slstm_seq_bwd_cuda.launches = 0
