"""Unified model API over the decoder-only and encoder-decoder stacks.

The port of ``repro.models.model``: serving and training talk to these six
functions, and the family dispatch lives here and nowhere else. Serving's
two run under ``torch.inference_mode``; ``apply_train`` and ``loss_fn``
record autograd where the parameters require grad
(``training.train_step.init_train_state`` turns that on).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig

__all__ = ["init_params", "init_cache", "apply_train", "apply_prefill", "apply_decode", "loss_fn"]


def init_params(cfg: ModelConfig, gen: torch.Generator):
    if cfg.is_encdec:
        return encdec.init_encdec_params(cfg, gen)
    return transformer.init_params(cfg, gen)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *, device="cuda") -> dict:
    if cfg.is_encdec:
        return encdec.init_encdec_cache(cfg, batch, max_seq, dtype, device=device)
    return transformer.init_cache(cfg, batch, max_seq, dtype, device=device)


def apply_train(
    params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits and the MoE router's aux loss. batch: tokens
    (B, S) [+ frames (encoder-decoder) / positions (mrope)]."""
    if cfg.is_encdec:
        enc_out = encdec.encode(params, batch["frames"], cfg)
        logits, _, aux = encdec.decode_forward(params, batch["tokens"], cfg, enc_out=enc_out)
        return logits, aux
    logits, _, aux = transformer.forward(params, batch["tokens"], cfg,
                                         positions=batch.get("positions"))
    return logits, aux


def loss_fn(
    params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy (+ router aux) over fp32 logits; ``batch["mask"]``,
    when given, weights the tokens. Returns (loss, {loss, ce, aux, ppl})."""
    logits, aux = apply_train(params, batch, cfg)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("mask")
    if mask is not None:
        ce = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    else:
        ce = torch.mean(nll)
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux, "ppl": torch.exp(ce)}


@torch.inference_mode()
def apply_prefill(
    params, batch: Dict[str, torch.Tensor], cache: dict, cfg: ModelConfig
) -> Tuple[torch.Tensor, dict]:
    """Fill the cache with a prompt (in place); return last-position logits + cache.
    An encoder-decoder config encodes ``batch["frames"]`` first."""
    if cfg.is_encdec:
        enc_out = encdec.encode(params, batch["frames"], cfg)
        logits, new_cache, _ = encdec.decode_forward(
            params, batch["tokens"], cfg, enc_out=enc_out, cache=cache
        )
        return logits[:, -1], new_cache
    logits, new_cache, _ = transformer.forward(
        params, batch["tokens"], cfg, positions=batch.get("positions"), cache=cache,
    )
    return logits[:, -1], new_cache


@torch.inference_mode()
def apply_decode(
    params,
    tokens: torch.Tensor,  # (B, 1)
    cache: dict,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """One decode step against the cache (written in place); returns (B, V) logits."""
    if cfg.is_encdec:
        logits, new_cache, _ = encdec.decode_forward(params, tokens, cfg, cache=cache)
        return logits[:, -1], new_cache
    logits, new_cache, _ = transformer.forward(params, tokens, cfg, positions=positions, cache=cache)
    return logits[:, -1], new_cache
