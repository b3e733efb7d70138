"""Plain PyTorch sLSTM sequence, the counterpart of ``repro.kernels.slstm.ref``.

A loop over S of :func:`slstm_step`, the port of ``_slstm_step``
(``repro/models/xlstm.py:248-263``), in fp32 with TF32 off. The wrapper uses
it for CPU tensors; ``chip_smoke.py`` holds the CUDA kernel against it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from repro_torch.core.precision import matmul_precision

__all__ = ["slstm_step", "slstm_seq_ref"]


def slstm_step(r: torch.Tensor, state: Dict[str, torch.Tensor], wx_t: torch.Tensor):
    """One step. r (4, H, dh, dh); state {c, n, m, h} (B, H, dh); wx_t (B, 4, H, dh)."""
    h_prev = state["h"]
    with matmul_precision("highest"):
        rec = torch.einsum("bhd,ghde->bghe", h_prev, r)  # (B, 4, H, dh)
    pre = wx_t + rec
    z = torch.tanh(pre[:, 0])
    i_pre = pre[:, 1]
    log_f = F.logsigmoid(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(log_f + state["m"], i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + state["m"] - m_new)
    c_new = f_g * state["c"] + i_g * z
    n_new = f_g * state["n"] + i_g
    h_new = o * c_new / torch.clamp_min(n_new, 1.0)
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new}, h_new


def slstm_seq_ref(
    wx: torch.Tensor, r: torch.Tensor, state: Dict[str, torch.Tensor]
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """wx (B, S, 4, H, dh); r (4, H, dh, dh); state {c, n, m, h} (B, H, dh).

    Returns (final state, hs (B, S, H, dh)), all fp32.
    """
    r32 = r.float()
    st = {k: state[k].float() for k in ("c", "n", "m", "h")}
    hs = []
    for t in range(wx.shape[1]):
        st, h_t = slstm_step(r32, st, wx[:, t].float())
        hs.append(h_t)
    return st, torch.stack(hs, dim=1)
