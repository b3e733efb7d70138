"""Unified model API over the decoder-only stacks.

The port of ``repro.models.model`` for decoder-only configs: serving talks to
these four functions. Encoder-decoder configs (whisper) raise
:class:`NotImplementedError`; ``apply_train`` and ``loss_fn`` come with the
training slice (both ROADMAP.md queue 1 item 9).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

__all__ = ["init_params", "init_cache", "apply_prefill", "apply_decode"]

_ENCDEC = "ROADMAP.md queue 1 item 9 (encoder-decoder models: whisper)"


def _decoder_only(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported to repro_torch yet: see {_ENCDEC}"
        )


def init_params(cfg: ModelConfig, gen: torch.Generator) -> transformer.Transformer:
    _decoder_only(cfg)
    return transformer.init_params(cfg, gen)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, *, device="cuda") -> dict:
    _decoder_only(cfg)
    return transformer.init_cache(cfg, batch, max_seq, dtype, device=device)


@torch.inference_mode()
def apply_prefill(
    params, batch: Dict[str, torch.Tensor], cache: dict, cfg: ModelConfig
) -> Tuple[torch.Tensor, dict]:
    """Fill the cache with a prompt (in place); return last-position logits + cache."""
    _decoder_only(cfg)
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
    _decoder_only(cfg)
    logits, new_cache, _ = transformer.forward(params, tokens, cfg, positions=positions, cache=cache)
    return logits[:, -1], new_cache
