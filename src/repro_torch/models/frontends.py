"""Modality frontend stubs: the M-RoPE text positions of ``repro.models.frontends``.

The audio frames stub comes with the encoder-decoder family (ROADMAP.md
queue 1 item 9).
"""
from __future__ import annotations

import torch

__all__ = ["make_stub_positions"]


def make_stub_positions(batch: int, seq: int, offset: int = 0, *, device="cuda") -> torch.Tensor:
    """Text-only M-RoPE positions (B, S, 3): all three streams identical."""
    base = torch.arange(seq, dtype=torch.long, device=device) + offset
    return base[None, :, None].expand(batch, seq, 3)
