"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The port of ``repro.models.xlstm``: the stabilized recurrences of
arXiv:2405.04517, with the q/k/v/out projections routed through the
configured matmul backend. Parameter names are the JAX package's, so
``convert.params_from_jax`` maps them by name.

* mLSTM runs the sequential scan (:func:`_mlstm_step`, a Python loop over
  time) or, when ``cfg.mlstm_chunk`` divides a sequence longer than one
  token, the exact chunkwise-parallel form (:func:`mlstm_chunkwise`).
* sLSTM runs :func:`repro_torch.kernels.slstm.ops.slstm_seq` for every
  sequence length, one decode token included: the hand-written CUDA kernel
  on the card (where the JAX block runs a ``lax.scan`` of the same step),
  its plain version on the CPU. Under autograd (training) the op saves each
  step's gate pre-activations and state, and its gradient is the backward
  kernel (``csrc/slstm_bwd.cu``, the reverse-time recurrence; the JAX
  package differentiates its scan) with dr one batched product after it.
  ``r`` trains like every other leaf: ``init_train_state`` turns its
  ``requires_grad`` on. Both kernels sum in a fixed order, so remat's
  recompute of the forward gives the saved tensors the same bits.

Precision follows the JAX code: q, k, v and the output gate are projected
in the model dtype and cast to fp32; the i/f gate projections (``wi``,
``wf``) and the sLSTM input projection run in fp32; every recurrent state
is fp32 whatever ``cfg.dtype`` or ``cfg.cache_dtype`` says.

Contract: the state a block returns is new tensors, and the state passed in
is never written in place. ``serving.kv_pool.CacheLayout.gather`` relies on
this: it hands a slot pool's recurrent state to the decode step without a
copy. ``tests/test_torch_serving.py`` and ``tests/test_torch_cuda.py`` hold
it on the CPU and on the card.

Under a sharding context both blocks constrain their output as the JAX
package does (``xlstm.py:222,283``). Those constraints only pin layouts at
the block boundary: the recurrences, the sLSTM kernel among them, run on
the global tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.kernels.slstm.ops import slstm_seq
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Linear, init_linear, linear
from repro_torch.models.sharding import constrain

__all__ = [
    "MLSTM",
    "SLSTM",
    "init_mlstm",
    "mlstm_block",
    "mlstm_chunkwise",
    "init_mlstm_state",
    "init_slstm",
    "slstm_block",
    "init_slstm_state",
]

_F32 = torch.float32


# ----------------------------------------------------------------- mLSTM
class MLSTM(nn.Module):
    """Flat projections ``wq``, ``wk`` (d, qk), ``wv``, ``wo`` (d, v), gates
    ``wi``, ``wf`` (d, H) in fp32 with bias, and ``out`` (v, d)."""

    def __init__(self, wq: Linear, wk: Linear, wv: Linear, wi: Linear, wf: Linear, wo: Linear,
                 out: Linear):
        super().__init__()
        self.wq, self.wk, self.wv, self.wi, self.wf, self.wo, self.out = wq, wk, wv, wi, wf, wo, out


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> MLSTM:
    d, h = cfg.d_model, cfg.n_heads
    qk, dv = cfg.mlstm_qk_dim, cfg.mlstm_v_dim
    return MLSTM(
        init_linear(gen, d, (qk,), dtype),
        init_linear(gen, d, (qk,), dtype),
        init_linear(gen, d, (dv,), dtype),
        init_linear(gen, d, (h,), _F32, bias=True),
        init_linear(gen, d, (h,), _F32, bias=True),
        init_linear(gen, d, (dv,), dtype),
        init_linear(gen, dv, (d,), dtype, scale=dv**-0.5),
    )


def init_mlstm_state(cfg: ModelConfig, batch: int, device="cuda") -> Dict[str, torch.Tensor]:
    h = cfg.n_heads
    dk, dv = cfg.mlstm_qk_dim // h, cfg.mlstm_v_dim // h
    return {
        "C": torch.zeros((batch, h, dk, dv), dtype=_F32, device=device),
        "n": torch.zeros((batch, h, dk), dtype=_F32, device=device),
        "m": torch.full((batch, h), -1e30, dtype=_F32, device=device),
    }


def mlstm_chunkwise(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    i_pre: torch.Tensor,
    f_pre: torch.Tensor,
    state: Dict[str, torch.Tensor],
    chunk: int,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Chunkwise-parallel mLSTM, exact: the same stabilizers as the scan.

    The state is written once per chunk and the intra-chunk work is
    (L x L) products:

      b_t = cumsum(log f);  m_t = max(m_prev + b_t, b_t + cummax(li - b))
      W_ij = exp(b_i - b_j + li_j - m_i)   (j <= i)
      h_i  = [e_i q_i C_prev + ((q K^T) o W) V] / max(|den_i|, 1)

    with e_i = exp(m_prev + b_i - m_i). Shapes: q, k (B, H, S, dk); v
    (B, H, S, dv); i_pre, f_pre (B, H, S). Returns (state, h (B, H, S, dv)).
    """
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence length {s}")
    nc, L = s // chunk, chunk

    qc = q.reshape(b, h, nc, L, dk)
    kc = k.reshape(b, h, nc, L, dk)
    vc = v.reshape(b, h, nc, L, dv)
    li = i_pre.reshape(b, h, nc, L)
    lf = F.logsigmoid(f_pre).reshape(b, h, nc, L)

    bcum = torch.cumsum(lf, dim=-1)  # (B, H, nc, L) local log-decay prefix
    cummax_u = torch.cummax(li - bcum, dim=3).values
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))  # j <= i

    c_st, n_st, m_st = state["C"], state["n"], state["m"]
    hs = []
    for j in range(nc):
        qj, kj, vj = qc[:, :, j], kc[:, :, j], vc[:, :, j]
        bj, lij, cmx = bcum[:, :, j], li[:, :, j], cummax_u[:, :, j]
        m_rows = torch.maximum(m_st[..., None] + bj, bj + cmx)  # (B, H, L)
        e = torch.exp(m_st[..., None] + bj - m_rows)
        logw = bj[..., :, None] - bj[..., None, :] + lij[..., None, :] - m_rows[..., :, None]
        # masked before the exp: above the diagonal logw grows with the decay
        # summed over j - i steps and exp overflows to inf, whose gradient
        # under a later mask is 0 * inf = NaN (the JAX form, where(tri,
        # exp(logw), 0), gives NaN gradients so); exp(-inf) is the same 0
        w = torch.exp(torch.where(tri, logw, -torch.inf))  # (B, H, L, L)
        scores = torch.einsum("bhld,bhmd->bhlm", qj, kj) * w
        num = (e[..., None] * torch.einsum("bhld,bhdv->bhlv", qj, c_st)
               + torch.einsum("bhlm,bhmv->bhlv", scores, vj))
        den = e * torch.einsum("bhld,bhd->bhl", qj, n_st) + torch.sum(scores, dim=-1)
        hs.append(num / torch.clamp_min(torch.abs(den), 1.0)[..., None])

        # state update with the chunk-end stabilizer m_last
        m_last = m_rows[..., -1]
        b_last = bj[..., -1]
        carry_decay = torch.exp(m_st + b_last - m_last)  # (B, H)
        src_w = torch.exp(b_last[..., None] - bj + lij - m_last[..., None])  # (B, H, L)
        c_st = (carry_decay[..., None, None] * c_st
                + torch.einsum("bhl,bhld,bhlv->bhdv", src_w, kj, vj))
        n_st = carry_decay[..., None] * n_st + torch.einsum("bhl,bhld->bhd", src_w, kj)
        m_st = m_last
    h_seq = torch.stack(hs, dim=2).reshape(b, h, s, dv)
    return {"C": c_st, "n": n_st, "m": m_st}, h_seq


def _mlstm_step(state: Dict[str, torch.Tensor], inputs):
    """One stabilized mLSTM step. inputs at t: q, k, v (B, H, *), i, f (B, H)."""
    q, k, v, i_pre, f_pre = inputs
    c_st, n_st, m_st = state["C"], state["n"], state["m"]
    log_f = F.logsigmoid(f_pre)  # (B, H)
    m_new = torch.maximum(log_f + m_st, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m_st - m_new)
    c_new = f_g[..., None, None] * c_st + i_g[..., None, None] * (k[..., :, None] * v[..., None, :])
    n_new = f_g[..., None] * n_st + i_g[..., None] * k
    h_num = torch.einsum("bhk,bhkv->bhv", q, c_new)
    h_den = torch.abs(torch.einsum("bhk,bhk->bh", q, n_new))
    h = h_num / torch.clamp_min(h_den, 1.0)[..., None]
    return {"C": c_new, "n": n_new, "m": m_new}, h


def mlstm_block(
    params: MLSTM,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """(B, S, D) -> (B, S, D). With ``state``: the recurrent continuation
    (prefill into a cache, decode), returning the new state."""
    b, s, _ = x.shape
    backend = cfg.matmul_backend
    h = cfg.n_heads
    dk, dv_h = cfg.mlstm_qk_dim // h, cfg.mlstm_v_dim // h
    q = linear(params.wq, x, backend, site="mlstm.wq").reshape(b, s, h, dk).float() * dk**-0.5
    k = linear(params.wk, x, backend, site="mlstm.wk").reshape(b, s, h, dk).float() * dk**-0.5
    v = linear(params.wv, x, backend, site="mlstm.wv").reshape(b, s, h, dv_h).float()
    i_pre = linear(params.wi, x.float())  # (B, S, H)
    f_pre = linear(params.wf, x.float())
    o_gate = torch.sigmoid(linear(params.wo, x, backend).reshape(b, s, h, dv_h).float())

    st = state if state is not None else init_mlstm_state(cfg, b, x.device)
    if cfg.mlstm_chunk and s > 1 and s % cfg.mlstm_chunk == 0:
        new_state, h_hf = mlstm_chunkwise(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            i_pre.transpose(1, 2), f_pre.transpose(1, 2), st, cfg.mlstm_chunk,
        )
        hs = h_hf.transpose(1, 2)  # (B, S, H, dv_h)
    else:
        new_state, steps = st, []
        for t in range(s):
            new_state, h_t = _mlstm_step(new_state, (q[:, t], k[:, t], v[:, t], i_pre[:, t], f_pre[:, t]))
            steps.append(h_t)
        hs = torch.stack(steps, dim=1)  # (B, S, H, dv_h)
    hs = hs * o_gate
    out = linear(params.out, hs.reshape(b, s, cfg.mlstm_v_dim).to(x.dtype), backend,
                 site="mlstm.out")
    out = constrain(out, "batch", "seq", "d_model")
    return out, (new_state if state is not None else None)


# ----------------------------------------------------------------- sLSTM
class SLSTM(nn.Module):
    """``w`` (d, 4, H, dh) stacked z/i/f/o input projections with bias, ``r``
    (4, H, dh, dh) fp32 per-head recurrent mixing, and ``out`` (d, d)."""

    def __init__(self, w: Linear, r: torch.Tensor, out: Linear):
        super().__init__()
        self.w = w
        self.r = nn.Parameter(r, requires_grad=False)
        self.out = out


def init_slstm(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> SLSTM:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    r = torch.randn((4, h, dh, dh), generator=gen, device=gen.device, dtype=_F32) * dh**-0.5
    return SLSTM(
        init_linear(gen, d, (4, h, dh), dtype, bias=True),
        r,
        init_linear(gen, d, (d,), dtype, scale=d**-0.5),
    )


def init_slstm_state(cfg: ModelConfig, batch: int, device="cuda") -> Dict[str, torch.Tensor]:
    h = cfg.n_heads
    shape = (batch, h, cfg.d_model // h)
    return {
        "c": torch.zeros(shape, dtype=_F32, device=device),
        "n": torch.zeros(shape, dtype=_F32, device=device),
        "m": torch.full(shape, -1e30, dtype=_F32, device=device),
        "h": torch.zeros(shape, dtype=_F32, device=device),
    }


def slstm_block(
    params: SLSTM,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    b, s, d = x.shape
    wx = linear(params.w, x.float())  # (B, S, 4, H, dh) fp32: x fp32 against w in the model dtype
    st = state if state is not None else init_slstm_state(cfg, b, x.device)
    new_state, hs = slstm_seq(wx, params.r, st)
    out = linear(params.out, hs.reshape(b, s, d).to(x.dtype), cfg.matmul_backend)
    out = constrain(out, "batch", "seq", "d_model")
    return out, (new_state if state is not None else None)
