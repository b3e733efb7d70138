"""Wrapper of the sLSTM sequence kernel (``csrc/slstm.cu``).

The counterpart of ``slstm_seq_pallas``: the whole sLSTM recurrence over S
steps, wx (B, S, 4, H, dh) input pre-activations (z/i/f/o order), r
(4, H, dh, dh) per-head recurrent mixing, state {c, n, m, h} (B, H, dh), all
fp32. Returns (final state, hs (B, S, H, dh)). The inputs are not changed:
the kernel updates copies of c, n and m in place. On a CUDA tensor the
wrapper launches the kernel or raises; on a CPU tensor it computes the plain
version in ``ref.py``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import on_cuda
from repro_torch.kernels.slstm.ref import slstm_seq_ref

__all__ = ["slstm_seq_cuda"]

_STATE = ("c", "n", "m", "h")


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
    c, n, m = (t.clone() for t in states[:3])
    hs = torch.empty((b, s, h, dh), dtype=torch.float32, device=wx.device)
    _build.launch(
        "repro_slstm_seq", wx.device, wx.data_ptr(), r.data_ptr(), states[3].data_ptr(),
        c.data_ptr(), n.data_ptr(), m.data_ptr(), hs.data_ptr(), b, s, h, dh,
    )
    slstm_seq_cuda.launches += 1
    return {"c": c, "n": n, "m": m, "h": hs[:, -1].clone()}, hs


slstm_seq_cuda.launches = 0
