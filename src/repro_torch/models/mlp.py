"""Dense MLP blocks: SwiGLU (llama/phi/qwen), GeGLU (gemma), plain GELU.

The port of ``repro.models.mlp``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Linear, init_linear, linear
from repro_torch.models.sharding import constrain

__all__ = ["MLP", "init_mlp", "mlp_block"]

_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


class MLP(nn.Module):
    """``up`` (d, f), ``down`` (f, d) and, for a gated MLP, ``gate`` (d, f)."""

    def __init__(self, up: Linear, down: Linear, gate: Optional[Linear] = None):
        super().__init__()
        self.up, self.down, self.gate = up, down, gate


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, d_ff: int | None = None) -> MLP:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return MLP(
        init_linear(gen, d, (f,), dtype),
        init_linear(gen, f, (d,), dtype, scale=f**-0.5),
        init_linear(gen, d, (f,), dtype) if cfg.glu else None,
    )


def mlp_block(params: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    backend = cfg.matmul_backend
    act = _ACTS[cfg.act]
    up = linear(params.up, x, backend, w_logical=("fsdp", "d_ff"), site="mlp.up")
    up = constrain(up, "batch", "seq", "d_ff")
    if params.gate is not None:
        gate = linear(params.gate, x, backend, w_logical=("fsdp", "d_ff"), site="mlp.gate")
        gate = constrain(gate, "batch", "seq", "d_ff")
        h = act(gate) * up
    else:
        h = act(up)
    out = linear(params.down, h, backend, w_logical=("d_ff", "fsdp"), site="mlp.down")
    return constrain(out, "batch", "seq", "d_model")
