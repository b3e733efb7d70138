"""Whisper-style encoder-decoder backbone (the audio frontend is a stub).

The port of ``repro.models.encdec``. Encoder: bidirectional self-attention
blocks over precomputed frame embeddings (B, enc_seq, d_model) with
sinusoidal positions. Decoder: causal self-attention, cross-attention and a
MLP, with a KV cache for the self-attention and the cross K/V computed once
from the encoder output. On the card every attention of the stack runs the
flash kernel, but the decoder's self-attention at a decode step (plain
``decode_attention``, as in the JAX package); cross-attention runs it at
every step, one query against the encoder's frames.

The caches are written in place, as the rest of the port does: the prefill
copies its cross K/V into ``cache["cross"][i]`` and a decode step reads them
from there. In train mode (autograd recording, no cache) with ``cfg.remat``
each encoder and decoder layer runs under ``torch.utils.checkpoint``, as
``jax.checkpoint`` wraps them (``repro/models/encdec.py:107,171``); the
decoder layer computes its cross K/V from ``enc_out`` inside, so they are
recomputed too. Under a sharding context the encoder's input is
constrained as in the JAX package (``encdec.py:94``); the self-attention
blocks run their projections and attention core per position
(``attention.py``), and cross-attention, which the JAX package does not
constrain, runs on the global tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (
    Attention,
    attention_block,
    cross_attention_block,
    encode_cross_kv,
    init_attention,
    init_cross_attention,
    init_kv_cache,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Embed, Norm, embed, layernorm, unembed
from repro_torch.models.mlp import MLP, init_mlp, mlp_block
from repro_torch.models.sharding import bind, constrain

__all__ = ["EncDec", "init_encdec_params", "encode", "decode_forward", "init_encdec_cache"]


def _sinusoid_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings (..., S, d) at integer positions (..., S), in fp32."""
    pos = positions.float()[..., None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    angle = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


class EncLayer(nn.Module):
    """``ln1`` + bidirectional ``attn``, ``ln2`` + ``mlp``."""

    def __init__(self, ln1: Norm, attn: Attention, ln2: Norm, mlp: MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class DecLayer(nn.Module):
    """``ln1`` + causal ``self_attn``, ``ln_x`` + ``cross_attn``, ``ln2`` + ``mlp``."""

    def __init__(self, ln1: Norm, self_attn: Attention, ln_x: Norm, cross_attn: Attention,
                 ln2: Norm, mlp: MLP):
        super().__init__()
        self.ln1, self.self_attn, self.ln_x = ln1, self_attn, ln_x
        self.cross_attn, self.ln2, self.mlp = cross_attn, ln2, mlp


class EncDec(nn.Module):
    """``embed`` (tied: whisper's output head is the embedding), ``enc`` and
    ``enc_norm``, ``dec`` and ``dec_norm``; ``cfg`` rides along."""

    def __init__(self, cfg: ModelConfig, embed: Embed, enc, enc_norm: Norm, dec, dec_norm: Norm):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.enc = nn.ModuleList(enc)
        self.enc_norm = enc_norm
        self.dec = nn.ModuleList(dec)
        self.dec_norm = dec_norm


def init_encdec_params(cfg: ModelConfig, gen: torch.Generator) -> EncDec:
    """Every parameter drawn from ``gen`` on its device in ``cfg.dtype``
    (normal draws in fp32, scaled, then cast, as the JAX package does)."""
    dtype, device = getattr(torch, cfg.dtype), gen.device

    def ln():
        return Norm("layernorm", cfg.d_model, dtype, device)

    emb = torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=device, dtype=torch.float32)
    emb = (emb * cfg.d_model**-0.5).to(dtype)
    enc = [EncLayer(ln(), init_attention(gen, cfg, dtype), ln(), init_mlp(gen, cfg, dtype))
           for _ in range(cfg.enc_layers)]
    dec = [DecLayer(ln(), init_attention(gen, cfg, dtype), ln(),
                    init_cross_attention(gen, cfg, dtype), ln(), init_mlp(gen, cfg, dtype))
           for _ in range(cfg.n_layers)]
    return EncDec(cfg, Embed(emb), enc, ln(), dec, ln())


def encode(params: EncDec, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings -> encoder states (B, S_enc, D)."""
    x = frames.to(getattr(torch, cfg.dtype))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    # the sinusoid in fp32, rounded once to the model dtype
    x = x + _sinusoid_at(positions, cfg.d_model).to(x.dtype)
    x = constrain(x, "batch", "seq", "d_model")

    def layer(lp: EncLayer, x: torch.Tensor) -> torch.Tensor:
        h = layernorm(lp.ln1, x, cfg.norm_eps)
        # bidirectional; whisper has no rope (the sinusoid is added above)
        mix, _ = attention_block(lp.attn, h, cfg, positions=positions, causal=False)
        x = x + mix
        return x + mlp_block(lp.mlp, layernorm(lp.ln2, x, cfg.norm_eps), cfg)

    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params.enc:
        x = checkpoint(bind(layer), lp, x, use_reentrant=False) if remat else layer(lp, x)
    return layernorm(params.enc_norm, x, cfg.norm_eps)


def init_encdec_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *,
                      device="cuda") -> dict:
    """``pos``, a self-attention KV cache per decoder layer (in
    ``cfg.cache_dtype`` when set) and the cross K/V per layer in ``dtype``,
    filled by the prefill."""
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (batch, cfg.n_kv_heads, cfg.enc_seq, cfg.head_dim)
    return {
        "pos": torch.zeros((), dtype=torch.long, device=device),
        "self": [init_kv_cache(cfg, batch, max_seq, dtype, device) for _ in range(cfg.n_layers)],
        "cross": [
            {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)
        ],
    }


def decode_forward(
    params: EncDec,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    enc_out: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """The decoder stack. With ``enc_out`` (train, prefill) the cross K/V are
    computed from it, and copied into the cache when one is given; without
    it (decode steps) they are read from the cache.

    Returns (logits (B, S, V), the cache written in place or None, aux 0).
    """
    x = embed(params.embed, tokens)
    b, s = tokens.shape
    cache_pos = cache["pos"] if cache is not None else None
    base = torch.arange(s, device=x.device)[None, :]
    positions = (base + cache_pos if cache_pos is not None else base).expand(b, s)
    x = x + _sinusoid_at(positions, cfg.d_model).to(x.dtype)

    new_cache = None
    if cache is not None:
        new_cache = {"pos": cache_pos + s, "self": [], "cross": cache["cross"]}
    if enc_out is None and cache is None:
        raise ValueError("a decode step without enc_out needs the cached cross K/V")

    def layer(lp: DecLayer, x: torch.Tensor, i: int):
        h = layernorm(lp.ln1, x, cfg.norm_eps)
        mix, nc = attention_block(
            lp.self_attn, h, cfg, positions=positions, causal=True,
            cache=cache["self"][i] if cache is not None else None, cache_pos=cache_pos,
        )
        x = x + mix
        if enc_out is not None:
            ck, cv = encode_cross_kv(lp.cross_attn, enc_out, cfg)
            if cache is not None:
                cache["cross"][i]["k"].copy_(ck)
                cache["cross"][i]["v"].copy_(cv)
        else:
            ck, cv = cache["cross"][i]["k"], cache["cross"][i]["v"]
        x = x + cross_attention_block(lp.cross_attn, layernorm(lp.ln_x, x, cfg.norm_eps),
                                      (ck, cv), cfg)
        return x + mlp_block(lp.mlp, layernorm(lp.ln2, x, cfg.norm_eps), cfg), nc

    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for i, lp in enumerate(params.dec):
        if remat:
            x, nc = checkpoint(bind(layer), lp, x, i, use_reentrant=False)
        else:
            x, nc = layer(lp, x, i)
        if new_cache is not None:
            new_cache["self"].append(nc)

    x = layernorm(params.dec_norm, x, cfg.norm_eps)
    logits = unembed(params.embed, x, tied=True)
    return logits, new_cache, torch.zeros((), dtype=torch.float32, device=x.device)
