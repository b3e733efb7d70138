"""Public sLSTM sequence op, the counterpart of ``repro.kernels.slstm.ops``.

The JAX op takes an interpret flag; here the tensors' device picks kernel or
plain version. The op casts its operands to fp32 and makes them contiguous
for the kernels. Where autograd records (grad enabled and any operand
requiring grad) it runs as :class:`SlstmSeq`: the forward kernel in its
saving mode, and the backward kernel for the gradients (on the CPU, their
plain versions). Otherwise it runs the forward alone.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.slstm.slstm import slstm_seq_bwd_cuda, slstm_seq_cuda

__all__ = ["slstm_seq", "SlstmSeq"]

_STATE = ("c", "n", "m", "h")


class SlstmSeq(torch.autograd.Function):
    """(wx, r, c, n, m, h) -> (c, n, m, h, hs): the sequence kernel, saving
    each step's gate pre-activations and state, and the backward kernel."""

    @staticmethod
    def forward(ctx, wx, r, c, n, m, h):
        state = dict(zip(_STATE, (c, n, m, h)))
        final, hs, saved = slstm_seq_cuda(wx, r, state, save=True)
        ctx.save_for_backward(r, c, n, m, h, hs, saved["pre"], saved["c"], saved["n"], saved["m"])
        return final["c"], final["n"], final["m"], final["h"], hs

    @staticmethod
    def backward(ctx, dc, dn, dm, dh, dhs):
        r, c, n, m, h, hs, pre, cs, ns, ms = ctx.saved_tensors
        dwx, dr, d0 = slstm_seq_bwd_cuda(
            r, dict(zip(_STATE, (c, n, m, h))), hs, {"pre": pre, "c": cs, "n": ns, "m": ms},
            dhs.contiguous(), {k: g.contiguous() for k, g in zip(_STATE, (dc, dn, dm, dh))})
        grads = (dwx, dr, *(d0[k] for k in _STATE))
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def slstm_seq(
    wx: torch.Tensor, r: torch.Tensor, state: Dict[str, torch.Tensor]
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """wx (B, S, 4, H, dh); r (4, H, dh, dh); state {c, n, m, h} (B, H, dh).

    Returns (final state, hs (B, S, H, dh)), all fp32.
    """
    def f32(t: torch.Tensor) -> torch.Tensor:
        return t.float().contiguous()

    wx, r = f32(wx), f32(r)
    st = {k: f32(state[k]) for k in _STATE}
    if torch.is_grad_enabled() and any(t.requires_grad for t in (wx, r, *st.values())):
        *final, hs = SlstmSeq.apply(wx, r, *(st[k] for k in _STATE))
        return dict(zip(_STATE, final)), hs
    return slstm_seq_cuda(wx, r, st)
