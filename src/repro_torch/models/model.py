"""Unified model API over the decoder-only and encoder-decoder stacks.

The port of ``repro.models.model``: serving talks to these four functions,
and the family dispatch lives here and nowhere else. ``apply_train`` and
``loss_fn`` come with the training slice (ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig

__all__ = ["init_params", "init_cache", "apply_prefill", "apply_decode"]


def init_params(cfg: ModelConfig, gen: torch.Generator):
    if cfg.is_encdec:
        return encdec.init_encdec_params(cfg, gen)
    return transformer.init_params(cfg, gen)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *, device="cuda") -> dict:
    if cfg.is_encdec:
        return encdec.init_encdec_cache(cfg, batch, max_seq, dtype, device=device)
    return transformer.init_cache(cfg, batch, max_seq, dtype, device=device)


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
