"""Rotary position embeddings: standard RoPE and qwen2-vl style M-RoPE.

The port of ``repro.models.rope``. M-RoPE splits each head's rotary dims into
three sections (temporal / height / width), each rotated by its own position
stream; for pure text all three streams are equal and M-RoPE is RoPE.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["rope_frequencies", "apply_rope", "apply_mrope"]


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim/2,) in fp32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta**exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., :half], x[..., half:]) by angles (..., half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (B, H, S, d); positions: (B, S) int."""
    inv = rope_frequencies(x.shape[-1], theta, x.device)  # (half,)
    angles = positions.float()[:, None, :, None] * inv  # (B, 1, S, half)
    return _rotate(x.float(), angles).to(x.dtype)


def apply_mrope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float,
    sections: Tuple[int, int, int],
) -> torch.Tensor:
    """M-RoPE: x (B, H, S, d); positions (B, S, 3) [t, h, w] streams.

    sections partition the half-dim: sum(sections) == d // 2. Frequency slot
    j belongs to section s(j) and uses stream s(j)'s positions.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} must sum to half the head dim {half}")
    inv = rope_frequencies(x.shape[-1], theta, x.device)  # (half,)
    stream_idx = torch.cat(
        [torch.full((n,), i, dtype=torch.long, device=x.device) for i, n in enumerate(sections)]
    )  # (half,)
    pos_per_freq = positions.float()[:, :, stream_idx]  # (B, S, half)
    angles = pos_per_freq[:, None, :, :] * inv  # (B, 1, S, half)
    return _rotate(x.float(), angles).to(x.dtype)
