"""Griffin-style recurrent block: causal conv + RG-LRU (recurrentgemma).

The port of ``repro.models.rglru``. RG-LRU (arXiv:2402.19427):

    r_t = sigmoid(W_a x_t)                     recurrence gate
    i_t = sigmoid(W_x x_t)                     input gate
    log a_t = -c * r_t * softplus(Lambda)      per-channel learnable decay
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence is a first-order linear scan with input-dependent decay. Over
a sequence it runs as :func:`associative_scan`, the odd/even recursion of
``jax.lax.associative_scan`` on strided views: O(log S) rounds of
elementwise ops, with the JAX scan's association order, so fp32 results
agree closely. A decode step is the same scan at S = 1. Parameter names are
the JAX package's, so ``convert.params_from_jax`` maps them by name.

Precision follows the JAX code: the in/out projections and the conv run in
the model dtype; the gate projections ``wa`` and ``wx`` are fp32 products
with TF32 off through the naive backend whatever ``cfg.matmul_backend``
says, and the
state ``{h, conv}`` is fp32. The state a block returns is new tensors, and
the state passed in is never written in place
(``serving.kv_pool.CacheLayout.gather`` relies on this). With the tracer on
(``repro_torch.obs``) the gates and the scan record the span ``rglru.scan``.
Under a sharding context the block constrains the recurrent branch's input
and its output as the JAX package does (``rglru.py:108,117``); those only
pin layouts at the block boundary, and the scan runs on the global tensor.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.core.precision import matmul_precision
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Linear, init_linear, linear
from repro_torch.models.mlp import _ACTS
from repro_torch.models.sharding import constrain
from repro_torch.obs.tracer import get_tracer

__all__ = ["RGLRU", "init_rglru", "init_rglru_state", "rglru_block", "associative_scan"]

_F32 = torch.float32


class RGLRU(nn.Module):
    """``in_gate`` and ``in_rec`` (d, W), the depthwise conv ``conv_w`` (cw, W)
    and ``conv_b`` (W), the gates ``wa`` and ``wx`` (W, W) in fp32 with bias,
    the decay ``lam`` (W) in fp32, and ``out`` (W, d)."""

    def __init__(self, in_gate: Linear, in_rec: Linear, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 wa: Linear, wx: Linear, lam: torch.Tensor, out: Linear):
        super().__init__()
        self.in_gate, self.in_rec, self.wa, self.wx, self.out = in_gate, in_rec, wa, wx, out
        self.conv_w = nn.Parameter(conv_w, requires_grad=False)
        self.conv_b = nn.Parameter(conv_b, requires_grad=False)
        self.lam = nn.Parameter(lam, requires_grad=False)


def init_rglru(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> RGLRU:
    d, w, dev = cfg.d_model, cfg.rnn_width, gen.device
    # Lambda init so a^c in [0.9, 0.999] at r=1 (paper's stable range).
    lam = 2.0 + 4.0 * torch.rand((w,), generator=gen, device=dev, dtype=_F32)
    in_gate = init_linear(gen, d, (w,), dtype)  # gelu branch
    in_rec = init_linear(gen, d, (w,), dtype)  # recurrent branch
    conv_w = torch.randn((cfg.conv_width, w), generator=gen, device=dev, dtype=_F32) * 0.1
    return RGLRU(
        in_gate, in_rec, conv_w.to(dtype), torch.zeros((w,), dtype=dtype, device=dev),
        init_linear(gen, w, (w,), _F32, bias=True),
        init_linear(gen, w, (w,), _F32, bias=True),
        lam,
        init_linear(gen, w, (d,), dtype, scale=w**-0.5),
    )


def init_rglru_state(cfg: ModelConfig, batch: int, device="cuda") -> Dict[str, torch.Tensor]:
    w = cfg.rnn_width
    return {
        "h": torch.zeros((batch, w), dtype=_F32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=_F32, device=device),
    }


def _causal_conv(x: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 tail: Optional[torch.Tensor]):
    """Depthwise causal conv via shifted adds. x: (B, S, W); tail: (B, cw-1, W).
    Returns the conv output and the new tail (the last cw-1 inputs)."""
    cw = conv_w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    padded = torch.cat([tail.to(x.dtype), x], dim=1)  # (B, S+cw-1, W)
    s = x.shape[1]
    out = None
    for j in range(cw):
        term = padded[:, j:j + s, :] * conv_w[cw - 1 - j].to(x.dtype)
        out = term if out is None else out + term
    new_tail = padded[:, -(cw - 1):, :] if cw > 1 else tail
    return out + conv_b.to(x.dtype), new_tail


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along ``dim`` (even may be one longer)."""
    shape = list(even.shape)
    shape[dim] += odd.shape[dim]
    out = even.new_empty(shape)
    idx = [slice(None)] * even.ndim
    idx[dim] = slice(0, None, 2)
    out[tuple(idx)] = even
    idx[dim] = slice(1, None, 2)
    out[tuple(idx)] = odd
    return out


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor], dim: int) -> list:
    """Inclusive scan of ``elems`` (tensors of one length along ``dim``) under
    the associative ``fn(left, right) -> combined``, both lists of tensors.

    ``jax.lax.associative_scan``'s recursion (Blelloch's odd/even scheme):
    combine adjacent pairs, scan the half-length result, then fill in the
    even positions from the odd ones. Each round is a few elementwise ops on
    strided views, so a sequence of S takes about 2 log2(S) rounds.
    """
    n = elems[0].shape[dim]
    if n < 2:
        return list(elems)

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = fn([sl(e, 0, -1, 2) for e in elems], [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn([sl(o, 0, -1) for o in odd], [sl(e, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
    return [_interleave(ev, od, dim) for ev, od in zip(even, odd)]


def _linear_recurrence(left, right):
    """h_t = a_t h_{t-1} + b_t as an associative pair operation."""
    (a1, b1), (a2, b2) = left, right
    return [a1 * a2, a2 * b1 + b2]


def _rglru_scan(xr: torch.Tensor, params: RGLRU, cfg: ModelConfig, h0: Optional[torch.Tensor]):
    """xr: (B, S, W) conv output -> (B, S, W) recurrence output, final h."""
    xf = xr.to(_F32)
    with matmul_precision("highest"):  # TF32 off
        r = torch.sigmoid(linear(params.wa, xf, site="rglru.wa"))
        i = torch.sigmoid(linear(params.wx, xf, site="rglru.wx"))
    softplus = torch.logaddexp(params.lam, torch.zeros_like(params.lam))  # jax.nn.softplus
    log_a = -cfg.rglru_c * r * softplus  # (B, S, W)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (i * xf)
    if h0 is not None:
        # fold the carried state in as a virtual step 0 contribution
        gated[:, 0, :] = gated[:, 0, :] + a[:, 0, :] * h0
    _, h = associative_scan(_linear_recurrence, [a, gated], dim=1)
    return h, h[:, -1, :]


def rglru_block(
    params: RGLRU,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Griffin recurrent block: gelu gate branch x (conv -> RG-LRU) branch.
    With a ``state`` it returns the new state, else None."""
    backend = cfg.matmul_backend
    gate = _ACTS["gelu"](linear(params.in_gate, x, backend, site="rglru.in_gate"))
    rec_in = linear(params.in_rec, x, backend, site="rglru.in_rec")
    rec_in = constrain(rec_in, "batch", "seq", "d_ff")

    tail = state["conv"] if state is not None else None
    conv_out, new_tail = _causal_conv(rec_in, params.conv_w, params.conv_b, tail)
    h0 = state["h"] if state is not None else None
    with get_tracer().span("rglru.scan", cat="rglru"):
        h, h_last = _rglru_scan(conv_out, params, cfg, h0)

    merged = gate * h.to(x.dtype)
    out = linear(params.out, merged, backend, site="rglru.out")
    out = constrain(out, "batch", "seq", "d_model")
    new_state = None
    if state is not None:
        new_state = {"h": h_last, "conv": new_tail.to(_F32)}
    return out, new_state
