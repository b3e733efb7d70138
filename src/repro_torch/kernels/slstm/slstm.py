"""Wrapper of the sLSTM sequence kernel (``csrc/slstm.cu``).

The counterpart of ``slstm_seq_pallas``: the whole sLSTM recurrence over S
steps, wx (B, S, 4, H, dh) input pre-activations (z/i/f/o order), r
(4, H, dh, dh) per-head recurrent mixing, state {c, n, m, h} (B, H, dh), all
fp32. Returns (final state, hs (B, S, H, dh)). The inputs are not changed:
the kernel reads the initial state and writes the final one apart. On a CUDA
tensor the wrapper launches the kernel or raises (a grid that cannot be
resident at once is refused by the launch); on a CPU tensor it computes the
plain version in ``ref.py``.

The kernel runs all S steps in one cooperative launch, one block an SM. Its
launch plan, :func:`slstm_plan`, is a plain function of the shape and two
numbers of the device, so that it can be checked without one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import cdiv, on_cuda
from repro_torch.kernels.slstm.ref import slstm_seq_ref

__all__ = ["slstm_seq_cuda", "slstm_plan", "SlstmPlan"]

_STATE = ("c", "n", "m", "h")

# The kernel's constants (csrc/slstm.cu): output columns per tile, batch rows
# per pass, and the floats of its reduction buffer (8 warps x BT x 4 x COLS).
COLS, BT = 16, 4
_RED_FLOATS = 8 * BT * 4 * COLS


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
    if heads < 1 or dh < 1 or steps < 1 or sms < 1:
        raise ValueError(f"bad sLSTM plan input: heads {heads}, dh {dh}, steps {steps}, sms {sms}")
    per_head = cdiv(dh, COLS)
    units = heads * per_head
    tiles_per_block = cdiv(units, sms)
    blocks = cdiv(units, tiles_per_block)
    fixed = (BT * dh + _RED_FLOATS) * 4
    tile = 4 * dh * COLS * 4
    if fixed > smem_per_block:
        raise ValueError(f"sLSTM dh {dh} needs {fixed} bytes of shared memory, the device has "
                         f"{smem_per_block} a block")
    resident = 0 if steps == 1 else min(tiles_per_block, (smem_per_block - fixed) // tile)
    # the most blocks that hold tiles of one head
    blocks_per_head = max(((h + 1) * per_head - 1) // tiles_per_block - h * per_head // tiles_per_block
                          + 1 for h in range(heads))
    return SlstmPlan(blocks, tiles_per_block, resident, fixed + resident * tile, blocks_per_head)


def slstm_seq_cuda(
    wx: torch.Tensor, r: torch.Tensor, state: Dict[str, torch.Tensor]
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    if wx.ndim != 5 or wx.shape[2] != 4:
        raise ValueError(f"wx must be (B, S, 4, H, dh), got {tuple(wx.shape)}")
    b, s, _, h, dh = wx.shape
    if tuple(r.shape) != (4, h, dh, dh):
        raise ValueError(f"r must be {(4, h, dh, dh)}, got {tuple(r.shape)}")
    states = [state[k] for k in _STATE]
    for k, t in zip(_STATE, states):
        if tuple(t.shape) != (b, h, dh):
            raise ValueError(f"state {k!r} must be {(b, h, dh)}, got {tuple(t.shape)}")
    if any(t.dtype != torch.float32 for t in (wx, r, *states)):
        raise TypeError("slstm_seq_cuda takes float32 wx, r and state")
    if not on_cuda(wx, r, *states):
        return slstm_seq_ref(wx, r, state)
    if not all(t.is_contiguous() for t in (wx, r, *states)):
        raise ValueError("slstm_seq_cuda needs contiguous wx, r and state")
    c, n, m = (torch.empty_like(t) for t in states[:3])
    hs = torch.empty((b, s, h, dh), dtype=torch.float32, device=wx.device)
    counters = torch.zeros(h, dtype=torch.int32, device=wx.device)
    plan = slstm_plan(h, dh, s, *_build.device_limits(wx.device))
    _build.launch(
        "repro_slstm_seq", wx.device, wx.data_ptr(), r.data_ptr(), states[3].data_ptr(),
        *(t.data_ptr() for t in states[:3]), c.data_ptr(), n.data_ptr(), m.data_ptr(),
        hs.data_ptr(), counters.data_ptr(), b, s, h, dh,
        plan.blocks, plan.tiles_per_block, plan.resident,
    )
    slstm_seq_cuda.launches += 1
    return {"c": c, "n": n, "m": m, "h": hs[:, -1].clone()}, hs


slstm_seq_cuda.launches = 0
