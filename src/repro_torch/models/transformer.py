"""Decoder-LM assembly: pattern-cycled blocks and serving caches.

The port of ``repro.models.transformer`` for every decoder-only family: the
layer kinds ``attn``, ``local_attn``, ``mlstm``, ``slstm`` and ``rglru``,
with a dense MLP or an MoE FFN. The JAX package stacks layers into scan
groups for its compiler; run eagerly on one card, the port keeps the layers
as an ``nn.ModuleList`` in layer order (``convert.params_from_jax`` unstacks
the JAX groups onto it). In train mode (no cache, autograd recording) with
``cfg.remat`` it rematerializes as the JAX package does: each group of
``len(cfg.block_pattern)`` layers, and each tail layer alone, runs under
``torch.utils.checkpoint``, so the backward recomputes its forward (the
flash and RMSNorm forward kernels run twice per layer and step).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import attention_block, init_attention, init_kv_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Embed, Norm, embed, layernorm, rmsnorm, unembed
from repro_torch.models.mlp import MLP, init_mlp, mlp_block
from repro_torch.models.moe import MoE, init_moe, moe_block
from repro_torch.models.rglru import init_rglru, init_rglru_state, rglru_block
from repro_torch.models.sharding import bind, constrain
from repro_torch.models.xlstm import (
    init_mlstm,
    init_mlstm_state,
    init_slstm,
    init_slstm_state,
    mlstm_block,
    slstm_block,
)

__all__ = ["Layer", "Transformer", "init_params", "init_cache", "forward", "check_ported"]

def check_ported(cfg: ModelConfig) -> None:
    """Raise ValueError on a block kind the model does not know."""
    for kind in dict.fromkeys(cfg.layer_kinds()):
        if kind not in _INIT_MIXER:
            raise ValueError(f"unknown block kind {kind!r}")


class Layer(nn.Module):
    """One block: ``ln1`` + ``mixer`` (attention, mLSTM, sLSTM or RG-LRU), then
    ``ln2`` + ``ffn`` (an MLP or an MoE) when the config has an FFN."""

    def __init__(self, ln1: Norm, mixer: nn.Module, ln2: Optional[Norm],
                 ffn: Optional[MLP | MoE]):
        super().__init__()
        self.ln1, self.mixer, self.ln2, self.ffn = ln1, mixer, ln2, ffn


class Transformer(nn.Module):
    """``embed``, ``layers`` (in layer order) and ``final_norm``; ``cfg`` rides along."""

    def __init__(self, cfg: ModelConfig, embed: Embed, layers, final_norm: Norm):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm

    def forward(self, tokens, *, positions=None, cache=None, causal=True):
        return forward(self, tokens, self.cfg, positions=positions, cache=cache, causal=causal)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _norm(cfg: ModelConfig, params: Norm, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(params, x, cfg.norm_eps)
    return rmsnorm(params, x, cfg.norm_eps)


def _init_norm(cfg: ModelConfig, dtype: torch.dtype, device) -> Norm:
    return Norm(cfg.norm, cfg.d_model, dtype, device)


_INIT_MIXER = {"attn": init_attention, "local_attn": init_attention,
               "mlstm": init_mlstm, "slstm": init_slstm, "rglru": init_rglru}


def _has_ffn(cfg: ModelConfig) -> bool:
    """MoE layers always have one (olmoe's d_ff is 0); xLSTM's d_ff = 0 has none."""
    return cfg.is_moe or cfg.d_ff > 0


def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype: torch.dtype) -> Layer:
    ln1 = _init_norm(cfg, dtype, gen.device)
    mixer = _INIT_MIXER[kind](gen, cfg, dtype)
    if not _has_ffn(cfg):
        return Layer(ln1, mixer, None, None)
    ffn = init_moe(gen, cfg, dtype) if cfg.is_moe else init_mlp(gen, cfg, dtype)
    return Layer(ln1, mixer, _init_norm(cfg, dtype, gen.device), ffn)


def _init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int, dtype, device) -> dict:
    """One layer's serving cache: {k, v} in ``dtype`` for attention, the
    recurrent state (always fp32, O(1) in ``max_seq``) for mLSTM, sLSTM and
    RG-LRU."""
    if kind == "mlstm":
        return init_mlstm_state(cfg, batch, device)
    if kind == "slstm":
        return init_slstm_state(cfg, batch, device)
    if kind == "rglru":
        return init_rglru_state(cfg, batch, device)
    if kind == "local_attn" and cfg.local_window:
        # ring buffer: O(window) regardless of context length
        return init_kv_cache(cfg, batch, min(max_seq, cfg.local_window), dtype, device)
    return init_kv_cache(cfg, batch, max_seq, dtype, device)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Transformer:
    """The decoder LM, with every parameter drawn from ``gen`` on its device
    in ``cfg.dtype`` (normal draws in fp32, scaled, then cast, as the JAX
    package does; the draws themselves differ from ``jax.random``'s)."""
    check_ported(cfg)
    dtype, device = _dtype(cfg.dtype), gen.device
    emb = torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=device, dtype=torch.float32)
    emb = (emb * cfg.d_model**-0.5).to(dtype)
    unemb = None
    if not cfg.tie_embeddings:
        unemb = torch.randn((cfg.d_model, cfg.vocab), generator=gen, device=device, dtype=torch.float32)
        unemb = (unemb * cfg.d_model**-0.5).to(dtype)
    layers = [_init_layer(gen, cfg, cfg.block_kind(i), dtype) for i in range(cfg.n_layers)]
    return Transformer(cfg, Embed(emb, unemb), layers, _init_norm(cfg, dtype, device))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *, device="cuda") -> dict:
    """Serving cache: ``pos`` and one entry per layer, in layer order."""
    dtype = dtype or _dtype(cfg.dtype)
    return {
        "pos": torch.zeros((), dtype=torch.long, device=device),
        "layers": [
            _init_layer_cache(cfg, cfg.block_kind(i), batch, max_seq, dtype, device)
            for i in range(cfg.n_layers)
        ],
    }


def _apply_layer(lparams: Layer, x, cfg: ModelConfig, kind: str, *, positions, cache_entry,
                 cache_pos, causal: bool, index: Optional[int] = None):
    """One block (the ``index``-th): pre-norm mixer + residual (+ pre-norm FFN +
    residual). Returns (x, new cache entry, the MoE router's aux loss or None)."""
    h = _norm(cfg, lparams.ln1, x)
    if kind == "mlstm":
        mix, new_cache = mlstm_block(lparams.mixer, h, cfg, state=cache_entry)
    elif kind == "slstm":
        mix, new_cache = slstm_block(lparams.mixer, h, cfg, state=cache_entry)
    elif kind == "rglru":
        mix, new_cache = rglru_block(lparams.mixer, h, cfg, state=cache_entry)
    else:
        window = cfg.local_window if kind == "local_attn" and cfg.local_window else None
        ring = kind == "local_attn" and bool(cfg.local_window)
        mix, new_cache = attention_block(
            lparams.mixer, h, cfg,
            positions=positions, causal=causal, window=window,
            cache=cache_entry, cache_pos=cache_pos, ring=ring,
        )
    x = x + mix
    aux = None
    if lparams.ffn is not None:
        h2 = _norm(cfg, lparams.ln2, x)
        if cfg.is_moe:
            f, aux = moe_block(lparams.ffn, h2, cfg, layer=index)
        else:
            f = mlp_block(lparams.ffn, h2, cfg)
        x = x + f
    return constrain(x, "batch", "seq", "d_model"), new_cache, aux


def _run_layers(params: Transformer, x, cfg: ModelConfig, idx: range, positions, causal: bool):
    """Layers ``idx`` in train mode (no cache): (x, the sum of their aux losses)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in idx:
        x, _, a = _apply_layer(params.layers[i], x, cfg, cfg.block_kind(i), positions=positions,
                               cache_entry=None, cache_pos=None, causal=causal, index=i)
        if a is not None:
            aux = aux + a
    return x, aux


def remat_spans(cfg: ModelConfig) -> list:
    """The layer ranges that train mode rematerializes as one: each group of
    ``len(cfg.block_pattern)`` layers, then each tail layer alone
    (``repro/models/transformer.py:288,323``)."""
    period = len(cfg.block_pattern)
    n_groups = cfg.n_layers // period
    groups = [range(g * period, (g + 1) * period) for g in range(n_groups)]
    return groups + [range(i, i + 1) for i in range(n_groups * period, cfg.n_layers)]


def forward(
    params: Transformer,
    tokens_or_embeds: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Run the decoder stack.

    Args:
      tokens_or_embeds: (B, S) int tokens, or (B, S, D) precomputed embeds.
      positions: (B, S) or (B, S, 3) for mrope; defaults to arange (train)
        or the cache's ``pos`` offset (decode/prefill).
      cache: serving cache -> decode/prefill mode, written in place; None ->
        train mode (rematerialized per :func:`remat_spans` when ``cfg.remat``
        and autograd records).

    Returns:
      (logits (B, S, V), new_cache or None, aux_loss scalar)
    """
    check_ported(cfg)
    if tokens_or_embeds.ndim == 2:
        x = embed(params.embed, tokens_or_embeds)
    else:
        x = tokens_or_embeds.to(_dtype(cfg.dtype))
    b, s = x.shape[0], x.shape[1]

    # cache["pos"] is a scalar for lockstep batches, or (B,) for the
    # continuous-batching engine's slot-indexed decode.
    cache_pos = cache["pos"] if cache is not None else None
    if positions is None:
        if cache_pos is None:
            off = 0
        elif cache_pos.ndim == 1:
            off = cache_pos[:, None]  # (B, 1) broadcasts over seq
        else:
            off = cache_pos
        positions = (torch.arange(s, device=x.device)[None, :] + off).expand(b, s)
        if cfg.mrope:
            positions = positions[..., None].expand(b, s, 3)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = {"pos": cache_pos + s, "layers": []} if cache is not None else None
    if cache is None and cfg.remat and torch.is_grad_enabled():
        for idx in remat_spans(cfg):
            x, aux = checkpoint(bind(_run_layers), params, x, cfg, idx, positions, causal,
                                use_reentrant=False)
            aux_total = aux_total + aux
    else:
        for i, lparams in enumerate(params.layers):
            x, nc, aux = _apply_layer(
                lparams, x, cfg, cfg.block_kind(i),
                positions=positions,
                cache_entry=cache["layers"][i] if cache is not None else None,
                cache_pos=cache_pos, causal=causal, index=i,
            )
            if aux is not None:
                aux_total = aux_total + aux
            if cache is not None:
                new_cache["layers"].append(nc)

    x = _norm(cfg, params.final_norm, x)
    logits = unembed(params.embed, x, tied=cfg.tie_embeddings, softcap=cfg.logit_softcap)
    return logits, new_cache, aux_total
