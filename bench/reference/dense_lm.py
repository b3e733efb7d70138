"""Plain reference of a dense decoder LM's training step, and its fp8 control.

The mathematics of a pre-norm decoder with RMSNorm (weight 1 + scale),
rotary positions over the whole head dim (pairs (x[:h], x[h:])), grouped
query attention with a causal mask, a SwiGLU MLP, a tied embedding and the
mean next-token cross entropy over fp32 logits; then AdamW with clipping
by the global norm, bias correction, weight decay on matrices, a cosine
schedule with linear warm-up and fp32 moments, and gradients of
micro-batches summed in fp32 and divided by their count.

Everything is plain PyTorch: ``torch.matmul`` for the products (fp32
accumulation; TF32 off), attention materialised in fp32, each layer under
``torch.utils.checkpoint`` so that its activations fit. Parameters and
activations are kept in the configuration's dtype, moments in fp32.
With ``fp8=True`` every product of a weight (the projections and the
unembedding) takes its operands, and in the backward its incoming
gradient, rounded to ``float8_e4m3fn`` with a per-tensor scale: the
control, one precision below bf16.

Leaves are named as the program names its parameters, so that the
benchmark can hand both sides the same values; :func:`leaf_specs` lists
them with their shapes and the scale of their normal draws.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

_F8 = torch.float8_e4m3fn
_F8_MAX = 448.0


def leaf_specs(model: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, scale) of every parameter: matrices are N(0, 1) times
    1/sqrt(fan in), RMSNorm scales N(0, 1) times 0.1."""
    d, h, hkv, hd, f = (model[k] for k in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff"))
    out = [("embed.embedding", (model["vocab"], d), d**-0.5)]
    for i in range(model["n_layers"]):
        p = f"layers.{i}."
        out += [
            (p + "ln1.scale", (d,), 0.1),
            (p + "mixer.wq.w", (d, h * hd), d**-0.5),
            (p + "mixer.wk.w", (d, hkv * hd), d**-0.5),
            (p + "mixer.wv.w", (d, hkv * hd), d**-0.5),
            (p + "mixer.wo.w", (h * hd, d), (h * hd) ** -0.5),
            (p + "ln2.scale", (d,), 0.1),
            (p + "ffn.up.w", (d, f), d**-0.5),
            (p + "ffn.down.w", (f, d), f**-0.5),
            (p + "ffn.gate.w", (d, f), d**-0.5),
        ]
    return out + [("final_norm.scale", (d,), 0.1)]


def make_weights(model: dict, gen: torch.Generator, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every leaf, drawn from ``gen`` on its device in ``dtype``: one flat
    buffer filled by a few large normal draws, laid out by scale so that a
    few multiplications scale it, and cut into views."""
    specs = sorted(leaf_specs(model), key=lambda s: s[2])
    total = sum(math.prod(shape) for _, shape, _ in specs)
    flat = torch.empty(total, dtype=dtype, device=gen.device)
    chunk = 1 << 30
    for a in range(0, total, chunk):
        flat[a:a + chunk].normal_(generator=gen)
    out, at, runs = {}, 0, []
    for name, shape, scale in specs:
        size = math.prod(shape)
        out[name] = flat[at:at + size].view(shape)
        if runs and runs[-1][2] == scale:
            runs[-1][1] = at + size
        else:
            runs.append([at, at + size, scale])
        at += size
    for a, b, scale in runs:
        flat[a:b].mul_(scale)
    return out


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale, back in x's dtype; in
    blocks of rows, so that a large weight needs no fp32 copy."""
    amax = float(x.abs().amax())
    scale = _F8_MAX / amax if amax > 0 else 1.0
    out = torch.empty_like(x)
    flat, dst = x.reshape(-1, x.shape[-1]), out.view(-1, x.shape[-1])
    step = max(1, (1 << 26) // x.shape[-1])
    for a in range(0, flat.shape[0], step):
        dst[a:a + step] = ((flat[a:a + step].float() * scale).to(_F8).float() / scale).to(x.dtype)
    return out


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x), _fp8(w)
        ctx.save_for_backward(xq, wq)
        return torch.matmul(xq, wq)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g)
        dx = torch.matmul(gq, wq.t())
        dw = torch.matmul(xq.reshape(-1, xq.shape[-1]).t(), gq.reshape(-1, gq.shape[-1]))
        return dx, dw


class DenseLM:
    """The forward and loss of the decoder over named leaves."""

    def __init__(self, model: dict, fp8: bool = False):
        self.m = model
        self.fp8 = fp8

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return _Fp8Matmul.apply(x, w) if self.fp8 else torch.matmul(x, w)

    def rmsnorm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.m["norm_eps"])
        return (y * (1.0 + scale.float())).to(x.dtype)

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        s, hd = x.shape[2], x.shape[3]
        half = hd // 2
        exps = torch.arange(half, device=x.device, dtype=torch.float32) / half
        inv = 1.0 / self.m["rope_theta"] ** exps
        ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
        cos, sin = torch.cos(ang), torch.sin(ang)
        xf = x.float()
        x1, x2 = xf[..., :half], xf[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)

    def attention(self, q, k, v):
        group = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
        s = q.shape[2]
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
        causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        return torch.matmul(probs, v.float()).to(q.dtype)

    def layer(self, x: torch.Tensor, w: Dict[str, torch.Tensor], i: int) -> torch.Tensor:
        m, p = self.m, f"layers.{i}."
        b, s, _ = x.shape
        h = self.rmsnorm(x, w[p + "ln1.scale"])
        hd = m["head_dim"]
        q = self.mm(h, w[p + "mixer.wq.w"]).view(b, s, m["n_heads"], hd).transpose(1, 2)
        k = self.mm(h, w[p + "mixer.wk.w"]).view(b, s, m["n_kv_heads"], hd).transpose(1, 2)
        v = self.mm(h, w[p + "mixer.wv.w"]).view(b, s, m["n_kv_heads"], hd).transpose(1, 2)
        o = self.attention(self.rope(q), self.rope(k), v).transpose(1, 2).reshape(b, s, -1)
        x = x + self.mm(o, w[p + "mixer.wo.w"])
        h = self.rmsnorm(x, w[p + "ln2.scale"])
        g = F.silu(self.mm(h, w[p + "ffn.gate.w"])) * self.mm(h, w[p + "ffn.up.w"])
        return x + self.mm(g, w[p + "ffn.down.w"])

    def head(self, x: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Each row's next-token negative log-likelihood over fp32 logits."""
        logits = self.mm(x, emb.t()).float()
        return torch.logsumexp(logits, -1) - torch.gather(logits, -1, labels[..., None])[..., 0]

    def loss(self, w: Dict[str, torch.Tensor], tokens: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor | None = None, rows: int = 512) -> torch.Tensor:
        emb = w["embed.embedding"]
        x = emb[tokens]
        for i in range(self.m["n_layers"]):
            x = checkpoint(self.layer, x, w, i, use_reentrant=False)
        x = self.rmsnorm(x, w["final_norm.scale"]).reshape(-1, x.shape[-1])
        # The logits in blocks of rows, each recomputed in the backward.
        flat = labels.reshape(-1)
        nll = torch.cat([
            checkpoint(self.head, x[a:a + rows], emb, flat[a:a + rows], use_reentrant=False)
            for a in range(0, x.shape[0], rows)])
        if mask is None:
            return nll.mean()
        mask = mask.reshape(-1)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def cosine_lr(step: int, opt: dict) -> float:
    """Linear warm-up to ``lr``, then a cosine to ``min_lr_ratio`` x ``lr``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    warmup, floor = opt["warmup_steps"], opt["min_lr_ratio"]
    progress = min(max((step - warmup) / max(opt["total_steps"] - warmup, 1), 0.0), 1.0)
    scale = floor + (1.0 - floor) * 0.5 * (1.0 + math.cos(math.pi * progress))
    return opt["lr"] * warm * scale


class Trainer:
    """Training steps of :class:`DenseLM` on leaves it updates in place."""

    def __init__(self, model: dict, opt: dict, weights: Dict[str, torch.Tensor], fp8: bool = False):
        self.net = DenseLM(model, fp8)
        self.opt = opt
        self.w = {n: t.detach().requires_grad_(True) for n, t in weights.items()}
        self.m = {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                  for n, t in self.w.items()}
        self.v = {n: torch.zeros_like(m) for n, m in self.m.items()}
        self.step_count = 0

    def grads(self, micro: List[Dict[str, torch.Tensor]]) -> Tuple[float, Dict[str, torch.Tensor]]:
        """The mean loss over the micro-batches and the gradient of that mean."""
        acc = None if len(micro) == 1 else {n: torch.zeros_like(m) for n, m in self.m.items()}
        total = 0.0
        for mb in micro:
            loss = self.net.loss(self.w, mb["tokens"], mb["labels"], mb.get("mask"))
            grads = torch.autograd.grad(loss, list(self.w.values()))
            total += float(loss.detach())
            if acc is None:
                return total, dict(zip(self.w, grads))
            for (n, a), g in zip(acc.items(), grads):
                a.add_(g)
        return total / len(micro), {n: a.div_(len(micro)) for n, a in acc.items()}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        o = self.opt
        self.step_count += 1
        t = self.step_count
        lr = cosine_lr(t, o)
        gnorm = math.sqrt(sum(float(g.float().pow(2).sum()) for g in grads.values()))
        scale = min(o["clip_norm"] / max(gnorm, 1e-12), 1.0) if o["clip_norm"] else 1.0
        b1c, b2c = 1.0 - o["b1"] ** t, 1.0 - o["b2"] ** t
        for n, p in self.w.items():
            g = grads[n].float() * scale
            m, v = self.m[n], self.v[n]
            m.mul_(o["b1"]).add_(g, alpha=1.0 - o["b1"])
            v.mul_(o["b2"]).addcmul_(g, g, value=1.0 - o["b2"])
            delta = (m / b1c) / ((v / b2c).sqrt() + o["eps"])
            pf = p.float()
            if o["weight_decay"] and p.ndim >= 2:
                delta = delta + o["weight_decay"] * pf
            p.copy_(pf - lr * delta)

    def step(self, micro: List[Dict[str, torch.Tensor]]) -> float:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            loss, grads = self.grads(micro)
            self.update(grads)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        return loss
