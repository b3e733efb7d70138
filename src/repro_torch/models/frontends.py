"""Modality frontend stubs, the port of ``repro.models.frontends``.

[audio] whisper-tiny: the real model has a 2-conv mel-spectrogram stem.
Here the encoder consumes precomputed frame embeddings of shape
(B, enc_seq, d_model) directly: :func:`audio_frames_spec` describes them and
:func:`make_stub_frames` draws them.

[vlm] qwen2-vl-72b: the backbone receives ordinary token ids plus M-RoPE
position triplets (B, S, 3); for text-only inputs all three streams equal
arange(S) (:func:`make_stub_positions`); :func:`mrope_positions_spec`
describes them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["audio_frames_spec", "mrope_positions_spec", "make_stub_frames", "make_stub_positions"]


def audio_frames_spec(cfg: ModelConfig, batch: int) -> torch.Tensor:
    """The frames' shape and dtype as a ``meta`` tensor (JAX's ShapeDtypeStruct)."""
    return torch.empty((batch, cfg.enc_seq, cfg.d_model), dtype=getattr(torch, cfg.dtype),
                       device="meta")


def mrope_positions_spec(batch: int, seq: int) -> torch.Tensor:
    """The M-RoPE position triplets' shape and dtype (int32, as JAX's) as a ``meta`` tensor."""
    return torch.empty((batch, seq, 3), dtype=torch.int32, device="meta")


def make_stub_frames(cfg: ModelConfig, batch: int, gen: Optional[torch.Generator] = None, *,
                     device="cuda") -> torch.Tensor:
    """Pseudo-frames (B, enc_seq, d_model): standard normal draws in fp32 from
    ``gen`` (by default one seeded 0 on ``device``), cast to ``cfg.dtype``.
    The draws differ from ``jax.random``'s; tests feed both packages the same
    numpy frames instead."""
    gen = gen if gen is not None else torch.Generator(device=device).manual_seed(0)
    x = torch.randn((batch, cfg.enc_seq, cfg.d_model), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return x.to(getattr(torch, cfg.dtype))


def make_stub_positions(batch: int, seq: int, offset: int = 0, *, device="cuda") -> torch.Tensor:
    """Text-only M-RoPE positions (B, S, 3): all three streams identical."""
    base = torch.arange(seq, dtype=torch.long, device=device) + offset
    return base[None, :, None].expand(batch, seq, 3)
