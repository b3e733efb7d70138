"""Primitive layers: linear (backend-routed), norms, embeddings.

The port of ``repro.models.layers``. Every dense projection funnels through
:func:`linear`, which routes the matmul to the configured backend: this is
where Stark's Strassen engine plugs into the model stack. :func:`rmsnorm`
runs the RMSNorm kernel (``kernels/rmsnorm``) on the card, and its backward
kernel when autograd records. Parameters are created with
``requires_grad=False``, for serving; ``training.train_step.init_train_state``
turns it on.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core.backend import NAIVE_BACKEND, MatmulBackend
from repro_torch.core.backend import matmul as backend_matmul
from repro_torch.kernels.rmsnorm.ops import rmsnorm as rmsnorm_op
from repro_torch.models.sharding import constrain

__all__ = [
    "Linear", "Norm", "Embed",
    "linear", "rmsnorm", "layernorm", "embed", "unembed", "init_linear",
]


class Linear(nn.Module):
    """A (d_in, *out_dims) projection ``w`` with an optional bias ``b``."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)
        if b is None:
            self.register_parameter("b", None)
        else:
            self.b = nn.Parameter(b, requires_grad=False)


class Norm(nn.Module):
    """RMSNorm (``scale``, zeros: the model multiplies by 1 + scale) or
    LayerNorm (``scale`` ones and ``bias`` zeros), as ``cfg.norm`` says."""

    def __init__(self, kind: str, d: int, dtype: torch.dtype, device):
        super().__init__()
        if kind == "layernorm":
            self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device), requires_grad=False)
            self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device), requires_grad=False)
        else:
            self.scale = nn.Parameter(torch.zeros(d, dtype=dtype, device=device), requires_grad=False)


class Embed(nn.Module):
    """Token table ``embedding`` (V, D), and ``unembedding`` (D, V) when untied."""

    def __init__(self, embedding: torch.Tensor, unembedding: Optional[torch.Tensor] = None):
        super().__init__()
        self.embedding = nn.Parameter(embedding, requires_grad=False)
        if unembedding is None:
            self.register_parameter("unembedding", None)
        else:
            self.unembedding = nn.Parameter(unembedding, requires_grad=False)


def init_linear(
    gen: torch.Generator,
    d_in: int,
    shape_out: Union[int, Sequence[int]],
    dtype: torch.dtype,
    *,
    bias: bool = False,
    scale: Optional[float] = None,
) -> Linear:
    """He-style init of a (d_in, *shape_out) projection on ``gen``'s device."""
    if isinstance(shape_out, int):
        shape_out = (shape_out,)
    scale = scale if scale is not None else d_in**-0.5
    w = torch.randn((d_in, *shape_out), generator=gen, device=gen.device, dtype=torch.float32)
    w = (w * scale).to(dtype)
    b = torch.zeros(tuple(shape_out), dtype=dtype, device=gen.device) if bias else None
    return Linear(w, b)


def linear(
    params: Linear,
    x: torch.Tensor,
    backend: MatmulBackend = NAIVE_BACKEND,
    w_logical=None,
    site: Optional[str] = None,
) -> torch.Tensor:
    """y = x @ w (+ b), with w (d_in, *out_dims) flattened for routing.

    The backend decides per shape whether this projection runs as a plain
    matmul or through the Strassen pipeline. ``w_logical`` (in, out) names
    w's logical dims: under a sharding context the product runs per position
    on the slabs they give (``backend.matmul``). ``site`` tags the call's span.
    """
    w = params.w
    d_in, out_dims = w.shape[0], w.shape[1:]
    y = backend_matmul(x, w.reshape(d_in, -1), backend, w_logical=w_logical, site=site)
    y = y.reshape(*x.shape[:-1], *out_dims)
    if params.b is not None:
        y = y + params.b.to(y.dtype)
    return y


def rmsnorm(params: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale): the RMSNorm kernel with w = 1 + scale in
    fp32. In training the gradient reaches ``scale`` through w."""
    return rmsnorm_op(x, 1.0 + params.scale.float(), eps=eps)


def layernorm(params: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params.scale.float() + params.bias.float()
    return y.to(x.dtype)


def embed(params: Embed, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup: (B, S) int -> (B, S, D)."""
    return constrain(F.embedding(tokens, params.embedding), "batch", "seq", "d_model")


def unembed(params: Embed, x: torch.Tensor, *, tied: bool = False, softcap: float = 0.0) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) logits."""
    w = params.embedding.T if tied else params.unembedding
    logits = torch.matmul(x, w.to(x.dtype))
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    return constrain(logits, "batch", "seq", "vocab")
