"""Plain reference of an OLMoE-style MoE decoder's training step, as one
chip's share of expert parallelism, with its fp8 control and two planted
faults.

The mathematics of OLMoE-1B-7B (arXiv:2409.02060; the published
``config.json``): each layer pre-norm, ``h = x + Attn(RMSNorm(x))`` and
``y = h + MoE(RMSNorm(h))``. Attention: ``q = RMSNorm_q(x Wq)`` and
``k = RMSNorm_k(x Wk)`` over their whole widths when ``qk_norm``, ``v = x Wv``,
rotary positions over the whole head dim (pairs (x[:h], x[h:])), causal
softmax attention with scale hd^-1/2, then ``Wo``. MoE: ``p = softmax(h Wr)``
with the router in fp32, the top-k picks I and their gates ``p_I`` (divided
by their sum only when ``norm_topk_prob``), and ``MoE(h) = sum over the picks
of held experts of p_e * W_down,e(silu(W_gate,e h) * W_up,e h)``: the layer
holds experts ``[expert_first, expert_first + experts_held)`` of the
router's ``n_experts`` and adds only their terms, none dropped. Loss: the
mean next-token cross entropy over fp32 logits of an untied unembedding,
plus ``router_aux_coef`` times each layer's Switch load-balancing term over
all ``n_experts`` (``n_experts * sum_e f_e * P_e``, f_e the share of top-k
picks, P_e the mean probability, over the micro-batch's tokens). RMSNorm
weights are 1 + scale. Then AdamW as ``dense_lm.Trainer`` has it.

Plain PyTorch: ``torch.matmul`` for the products (fp32 accumulation; TF32
off while a step runs), attention materialised in fp32 one block of queries
at a time, each layer and each attention block under
``torch.utils.checkpoint``, the held experts one after another, each
token's terms added in fp32 and rounded once. Parameters and activations
in the configuration's dtype, the router and the moments in fp32.

``fp8=True`` is the control: every product of a weight (the projections,
the experts, the unembedding; not the fp32 router) on operands rounded to
``float8_e4m3fn``, as ``dense_lm`` does it. ``capacity`` is a planted fault:
the assignments past ``capacity`` times an even share of the micro-batch's
picks (in token order, per expert, as Switch's capacity drops them) are
dropped. ``mask`` (the half-batch fault) weights the tokens of the cross
entropy.

Leaves are named as the program names its parameters, so that the
benchmark hands both sides the same values.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from reference import dense_lm


def leaf_specs(model: dict) -> List[Tuple[str, Tuple[int, ...], float, bool]]:
    """(name, shape, scale, fp32) of every parameter: matrices N(0, 1) times
    1/sqrt(fan in), RMSNorm scales N(0, 1) times 0.1; only the router in fp32."""
    d, h, hkv, hd = (model[k] for k in ("d_model", "n_heads", "n_kv_heads", "head_dim"))
    e, held, f = model["n_experts"], model["experts_held"], model["d_expert"]
    out = [("embed.embedding", (model["vocab"], d), d**-0.5, False),
           ("embed.unembedding", (d, model["vocab"]), d**-0.5, False)]
    for i in range(model["n_layers"]):
        p = f"layers.{i}."
        out += [
            (p + "ln1.scale", (d,), 0.1, False),
            (p + "mixer.wq.w", (d, h * hd), d**-0.5, False),
            (p + "mixer.wk.w", (d, hkv * hd), d**-0.5, False),
            (p + "mixer.wv.w", (d, hkv * hd), d**-0.5, False),
            (p + "mixer.wo.w", (h * hd, d), (h * hd) ** -0.5, False),
            (p + "ln2.scale", (d,), 0.1, False),
            (p + "ffn.router.w", (d, e), d**-0.5, True),
            (p + "ffn.w_gate", (held, d, f), d**-0.5, False),
            (p + "ffn.w_up", (held, d, f), d**-0.5, False),
            (p + "ffn.w_down", (held, f, d), f**-0.5, False),
        ]
        if model["qk_norm"]:
            out += [(p + "mixer.q_norm.scale", (h * hd,), 0.1, False),
                    (p + "mixer.k_norm.scale", (hkv * hd,), 0.1, False)]
    return out + [("final_norm.scale", (d,), 0.1, False)]


def make_weights(model: dict, gen: torch.Generator, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every leaf, drawn from ``gen`` on its device: one flat buffer per
    dtype filled by a few large normal draws, scaled in runs of one scale,
    and cut into views."""
    out = {}
    for fp32 in (False, True):
        specs = sorted((s for s in leaf_specs(model) if s[3] == fp32), key=lambda s: s[2])
        total = sum(math.prod(shape) for _, shape, _, _ in specs)
        flat = torch.empty(total, dtype=torch.float32 if fp32 else dtype, device=gen.device)
        for a in range(0, total, 1 << 30):
            flat[a:a + (1 << 30)].normal_(generator=gen)
        at = 0
        for name, shape, scale, _ in specs:
            size = math.prod(shape)
            out[name] = flat[at:at + size].view(shape)
            out[name].mul_(scale)
            at += size
    return out


def keep_within_capacity(idx: torch.Tensor, n_experts: int, capacity: float) -> torch.Tensor:
    """(T, k) picks -> (T, k) bool: each pick's place among its expert's
    picks, in (token, k) order, below int(T * k * capacity / n_experts)."""
    t, k = idx.shape
    cap = max(int(t * k * capacity / n_experts), k)
    onehot = F.one_hot(idx.reshape(-1), n_experts)
    place = (onehot.cumsum(0) * onehot).sum(-1) - 1
    return (place < cap).view(t, k)


class MoeLM(dense_lm.DenseLM):
    """The forward and loss of the MoE decoder over named leaves."""

    def __init__(self, model: dict, fp8: bool = False, capacity: Optional[float] = None,
                 q_block: int = 1024):
        super().__init__(model, fp8)
        self.capacity = capacity
        self.q_block = q_block
        self.held = self.dropped = 0  # assignments to held experts, and those dropped

    def attention_rows(self, q, k, v, a: int):
        """Queries [a, a + q.shape[2]) against keys [0, a + q.shape[2])."""
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
        rows = torch.arange(a, a + q.shape[2], device=q.device)[:, None]
        live = torch.arange(k.shape[2], device=q.device)[None, :] <= rows
        probs = torch.softmax(scores.masked_fill(~live, float("-inf")), dim=-1)
        return torch.matmul(probs, v.float()).to(q.dtype)

    def attention(self, q, k, v):
        s, out = q.shape[2], []
        for a in range(0, s, self.q_block):
            b = min(a + self.q_block, s)
            out.append(checkpoint(self.attention_rows, q[:, :, a:b], k[:, :, :b], v[:, :, :b], a,
                                  use_reentrant=False))
        return torch.cat(out, dim=2)

    def moe(self, h: torch.Tensor, w: Dict[str, torch.Tensor], p: str):
        m = self.m
        e, top, first = m["n_experts"], m["top_k"], m["expert_first"]
        t = h.reshape(-1, h.shape[-1])
        probs = torch.softmax(torch.matmul(t.float(), w[p + "ffn.router.w"]), dim=-1)
        gates, idx = torch.topk(probs, top, dim=-1)
        if m["norm_topk_prob"]:
            gates = gates / gates.sum(-1, keepdim=True)
        share = F.one_hot(idx, e).float().sum(1).mean(0)
        aux = e * (probs.mean(0) * share).sum() * m["router_aux_coef"]
        keep = torch.ones_like(idx, dtype=torch.bool)
        if self.capacity is not None:
            keep = keep_within_capacity(idx, e, self.capacity)
            mine = (idx >= first) & (idx < first + m["experts_held"])
            self.held += int(mine.sum())
            self.dropped += int((mine & ~keep).sum())
        out = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        for j in range(m["experts_held"]):
            tok, pick = ((idx == first + j) & keep).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            xe = t[tok]
            he = F.silu(self.mm(xe, w[p + "ffn.w_gate"][j])) * self.mm(xe, w[p + "ffn.w_up"][j])
            ye = self.mm(he, w[p + "ffn.w_down"][j])
            out = out.index_add(0, tok, ye.float() * gates[tok, pick, None])
        return out.to(h.dtype).view_as(h), aux

    def layer(self, x: torch.Tensor, w: Dict[str, torch.Tensor], i: int):
        m, p = self.m, f"layers.{i}."
        b, s, _ = x.shape
        hd = m["head_dim"]
        h = self.rmsnorm(x, w[p + "ln1.scale"])
        q, k = self.mm(h, w[p + "mixer.wq.w"]), self.mm(h, w[p + "mixer.wk.w"])
        if m["qk_norm"]:
            q, k = self.rmsnorm(q, w[p + "mixer.q_norm.scale"]), self.rmsnorm(k, w[p + "mixer.k_norm.scale"])
        q = q.view(b, s, m["n_heads"], hd).transpose(1, 2)
        k = k.view(b, s, m["n_kv_heads"], hd).transpose(1, 2)
        v = self.mm(h, w[p + "mixer.wv.w"]).view(b, s, m["n_kv_heads"], hd).transpose(1, 2)
        o = self.attention(self.rope(q), self.rope(k), v).transpose(1, 2).reshape(b, s, -1)
        x = x + self.mm(o, w[p + "mixer.wo.w"])
        y, aux = self.moe(self.rmsnorm(x, w[p + "ln2.scale"]), w, p)
        return x + y, aux

    def loss(self, w: Dict[str, torch.Tensor], tokens: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor | None = None, rows: int = 512) -> torch.Tensor:
        x = w["embed.embedding"][tokens]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self.m["n_layers"]):
            x, a = checkpoint(self.layer, x, w, i, use_reentrant=False)
            aux = aux + a
        x = self.rmsnorm(x, w["final_norm.scale"]).reshape(-1, x.shape[-1])
        unemb, flat = w["embed.unembedding"].t(), labels.reshape(-1)
        nll = torch.cat([
            checkpoint(self.head, x[a:a + rows], unemb, flat[a:a + rows], use_reentrant=False)
            for a in range(0, x.shape[0], rows)])
        if mask is None:
            return nll.mean() + aux
        mask = mask.reshape(-1)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0) + aux


class Trainer(dense_lm.Trainer):
    """``dense_lm.Trainer``'s steps (AdamW with clipping, fp32 moments,
    fp32 gradient accumulation) on :class:`MoeLM`."""

    def __init__(self, model: dict, opt: dict, weights: Dict[str, torch.Tensor], fp8: bool = False,
                 capacity: Optional[float] = None):
        super().__init__(model, opt, weights, fp8)
        self.net = MoeLM(model, fp8, capacity)
