"""Public sLSTM sequence op, the counterpart of ``repro.kernels.slstm.ops``.

The JAX op takes an interpret flag; here the tensors' device picks kernel or
plain version. The op casts its operands to fp32 and makes them contiguous
for the kernel. The kernel has no backward yet (ROADMAP.md queue 1, the
sLSTM backward kernel): on a CUDA tensor that autograd would record, the op
raises. On the CPU the plain version differentiates as PyTorch code.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.slstm.slstm import slstm_seq_cuda

__all__ = ["slstm_seq"]


def slstm_seq(
    wx: torch.Tensor, r: torch.Tensor, state: Dict[str, torch.Tensor]
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """wx (B, S, 4, H, dh); r (4, H, dh, dh); state {c, n, m, h} (B, H, dh).

    Returns (final state, hs (B, S, H, dh)), all fp32.
    """
    def f32(t: torch.Tensor) -> torch.Tensor:
        return t.float().contiguous()

    if wx.is_cuda and torch.is_grad_enabled() and any(
        t.requires_grad for t in (wx, r, *state.values())
    ):
        raise NotImplementedError(
            "slstm_seq has no backward kernel on the card yet (ROADMAP.md queue 1: the sLSTM "
            "backward kernel); xLSTM trains on the CPU only"
        )

    return slstm_seq_cuda(f32(wx), f32(r), {k: f32(state[k]) for k in ("c", "n", "m", "h")})
