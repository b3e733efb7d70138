"""Plain PyTorch sLSTM sequence and its backward, the counterpart of ``repro.kernels.slstm.ref``.

A loop over S of the port of ``_slstm_step`` (``repro/models/xlstm.py:248-263``:
the gate pre-activations, then the gates), in fp32 with TF32 off. With ``save`` it
also returns what the backward reads: every step's gate pre-activations and
state. :func:`slstm_seq_bwd_ref` is the reverse-time recurrence of the
backward kernel (``csrc/slstm_bwd.cu:slstm_seq_bwd_kernel``), step by step
with the direct VJP of a step (:func:`step_vjp`); :func:`step_vjp_affine` is
the kernel's own order of the same arithmetic, which the tests hold to it.
The JAX package differentiates its scan in XLA. The wrappers use these for
CPU tensors; ``chip_smoke.py`` holds the CUDA kernels against them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from repro_torch.core.precision import matmul_precision

__all__ = ["slstm_seq_ref", "step_vjp", "step_vjp_affine", "slstm_dr", "slstm_seq_bwd_ref"]

_STATE = ("c", "n", "m", "h")


def _pre(r: torch.Tensor, h_prev: torch.Tensor, wx_t: torch.Tensor) -> torch.Tensor:
    with matmul_precision("highest"):
        rec = torch.einsum("bhd,ghde->bghe", h_prev, r)  # (B, 4, H, dh)
    return wx_t + rec


def _gates(pre: torch.Tensor, state: Dict[str, torch.Tensor]):
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
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new}


def slstm_seq_ref(wx: torch.Tensor, r: torch.Tensor, state: Dict[str, torch.Tensor], *, save: bool = False):
    """wx (B, S, 4, H, dh); r (4, H, dh, dh); state {c, n, m, h} (B, H, dh).

    Returns (final state, hs (B, S, H, dh)), all fp32; with ``save`` also
    {pre (B, S, 4, H, dh), c, n, m (B, S, H, dh)}: each step's gate
    pre-activations and the state after it.
    """
    r32 = r.float()
    st = {k: state[k].float() for k in _STATE}
    hs, pres, states = [], [], []
    for t in range(wx.shape[1]):
        pre = _pre(r32, st["h"], wx[:, t].float())
        st = _gates(pre, st)
        hs.append(st["h"])
        if save:
            pres.append(pre)
            states.append(st)
    hs = torch.stack(hs, dim=1)
    if not save:
        return st, hs
    saved = {"pre": torch.stack(pres, dim=1),
             **{k: torch.stack([s[k] for s in states], dim=1) for k in ("c", "n", "m")}}
    return st, hs, saved


def step_vjp(p, c, n, m, c1, n1, m1, dh, dc, dn, dm):
    """The VJP of one step, elementwise, in the order of the chain rule.

    p (B, 4, H, dh): the gate pre-activations; c, n, m: the state before the
    step; c1, n1, m1: after it; dh: the gradient of h_t; dc, dn, dm: those of
    c1, n1, m1. Returns (dp, dc, dn, dm): the gradients of p and of the state
    before. Ties follow PyTorch's autograd: max(n', 1) passes the gradient
    when n' >= 1 (``clamp_min``), max(log_f + m, pre_i) splits it in halves
    (``maximum``).
    """
    z = torch.tanh(p[:, 0])
    lf = F.logsigmoid(p[:, 2])
    o = torch.sigmoid(p[:, 3])
    a = lf + m
    ig = torch.exp(p[:, 1] - m1)
    fg = torch.exp(a - m1)
    nn = torch.clamp_min(n1, 1.0)
    h = o * c1 / nn
    dq = dh / nn
    d_o = dq * c1
    dc1 = dc + dq * o
    dn1 = dn + torch.where(n1 >= 1.0, -dq * h, 0.0)
    df = dc1 * c + dn1 * n
    di = dc1 * z + dn1
    dz = dc1 * ig
    ga = df * fg
    gi = di * ig
    dmt = dm - ga - gi
    to_a = torch.where(a > p[:, 1], 1.0, torch.where(a == p[:, 1], 0.5, 0.0))
    to_i = torch.where(a < p[:, 1], 1.0, torch.where(a == p[:, 1], 0.5, 0.0))
    share_a, share_i = dmt * to_a, dmt * to_i
    dp = torch.stack([dz * (1.0 - z * z), gi + share_i, (ga + share_a) / (1.0 + torch.exp(p[:, 2])),
                      d_o * o * (1.0 - o)], dim=1)
    return dp, dc1 * fg, dn1 * fg, ga + share_a


def step_vjp_affine(p, c, n, m, c1, n1, m1, dh, dc, dn, dm):
    """:func:`step_vjp` in the backward kernel's order: the saved values and
    the carried gradients first reduce the step to coefficients affine in dh
    (each output x0 + dh * x1), which the kernel forms before it waits for
    the other blocks; dh, which the exchange completes, then enters each
    output once. The same arguments and results as :func:`step_vjp`, to
    rounding. At the zero-state tie (n' = 1, m' = pre_i, f = 0) the two terms
    of pre_i's gradient cancel exactly in dh's coefficient and in
    :func:`step_vjp`'s order in the constant part.
    """
    z = torch.tanh(p[:, 0])
    lf = F.logsigmoid(p[:, 2])
    o = torch.sigmoid(p[:, 3])
    a = lf + m
    ig = torch.exp(p[:, 1] - m1)
    fg = torch.exp(a - m1)
    nn = torch.clamp_min(n1, 1.0)
    q = 1.0 / nn
    h = o * c1 / nn
    kc = q * o  # dc1 = dc + dh * kc
    kn = torch.where(n1 >= 1.0, -q * h, 0.0)  # dn1 = dn + dh * kn
    df0, df1 = dc * c + dn * n, kc * c + kn * n
    di0, di1 = dc * z + dn, kc * z + kn
    ga0, ga1 = df0 * fg, df1 * fg
    gi0, gi1 = di0 * ig, di1 * ig
    dmt0, dmt1 = dm - ga0 - gi0, -ga1 - gi1
    ta = torch.where(a > p[:, 1], 1.0, torch.where(a == p[:, 1], 0.5, 0.0))
    ti = torch.where(a < p[:, 1], 1.0, torch.where(a == p[:, 1], 0.5, 0.0))
    dlf0, dlf1 = ga0 + ta * dmt0, ga1 + ta * dmt1
    kz = ig * (1.0 - z * z)
    sf = 1.0 / (1.0 + torch.exp(p[:, 2]))
    p0 = torch.stack([dc * kz, gi0 + ti * dmt0, dlf0 * sf, torch.zeros_like(dc)], dim=1)
    p1 = torch.stack([kc * kz, gi1 + ti * dmt1, dlf1 * sf, q * c1 * o * (1.0 - o)], dim=1)
    return p0 + dh[:, None] * p1, dc * fg + dh * (kc * fg), dn * fg + dh * (kn * fg), dlf0 + dh * dlf1


def slstm_dr(h0: torch.Tensor, hs: torch.Tensor, dwx: torch.Tensor) -> torch.Tensor:
    """dr[g,h,d,e] = sum_{b,t} h_{t-1}[b,h,d] dwx[b,t,g,h,e]: one fp32 batched
    product per head over the B * S rows (TF32 off), as XLA forms it in the
    JAX package."""
    b, s, _, h, dh = dwx.shape
    h_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1).reshape(b * s, h, dh).permute(1, 2, 0)
    grads = dwx.reshape(b * s, 4, h, dh).permute(2, 0, 1, 3).reshape(h, b * s, 4 * dh)
    with matmul_precision("highest"):
        dr = torch.bmm(h_prev, grads)  # (H, dh, 4 * dh)
    return dr.reshape(h, dh, 4, dh).permute(2, 0, 1, 3).contiguous()


def slstm_seq_bwd_ref(
    r: torch.Tensor,
    state: Dict[str, torch.Tensor],
    hs: torch.Tensor,
    saved: Dict[str, torch.Tensor],
    dhs: torch.Tensor,
    dstate: Dict[str, torch.Tensor],
    *,
    vjp=step_vjp,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """The gradients of ``slstm_seq_ref(wx, r, state)``'s outputs, given the
    saving forward's ``hs`` and ``saved``, the gradient ``dhs`` of hs and
    ``dstate`` of the final state. Returns (dwx (B, S, 4, H, dh), dr (4, H,
    dh, dh), the initial state's gradients {c, n, m, h}), all fp32. ``vjp``
    is a step's VJP: :func:`step_vjp`, or the kernel's order of it,
    :func:`step_vjp_affine`."""
    r32 = r.float()
    pre = saved["pre"]
    s = pre.shape[1]
    dc, dn, dm = (dstate[k].float() for k in ("c", "n", "m"))
    rec = dstate["h"].float()
    dwx = []
    for t in range(s - 1, -1, -1):
        prev = {k: state[k].float() if t == 0 else saved[k][:, t - 1] for k in ("c", "n", "m")}
        dp, dc, dn, dm = vjp(pre[:, t], prev["c"], prev["n"], prev["m"], saved["c"][:, t],
                             saved["n"][:, t], saved["m"][:, t], dhs[:, t] + rec, dc, dn, dm)
        dwx.append(dp)
        with matmul_precision("highest"):
            rec = torch.einsum("bghe,ghde->bhd", dp, r32)
    dwx = torch.stack(dwx[::-1], dim=1)
    return dwx, slstm_dr(state["h"].float(), hs, dwx), {"c": dc, "n": dn, "m": dm, "h": rec}
