"""AdamW + cosine schedule + global-norm clipping: the port of ``repro.optim.adamw``.

The same maths as the JAX package: clipping by the global norm, bias
correction, weight decay on tensors with ``ndim >= 2`` only (matrices, not
norms or biases), and the moments kept in ``moment_dtype`` (fp32 by default,
whatever the parameters' dtype, which ``torch.optim.AdamW`` would not do).
Plain tensor ops under ``torch.no_grad``. Where the JAX package returns new
trees, :func:`apply_updates` writes the parameters and moments in place: a
second copy of phi4-mini's 46 GB of state would not fit the card. The step
count, the learning rate and the clip scale stay 0-d tensors on the state's
device, so an update needs no host sync.

Moments and gradients are keyed by the module's parameter names
(``named_parameters``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "apply_updates", "cosine_schedule",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Dict[str, torch.Tensor]  # keyed like the parameters
    v: Dict[str, torch.Tensor]


def init_opt_state(params: nn.Module, cfg: AdamWConfig) -> OptState:
    dt = getattr(torch, cfg.moment_dtype)
    named = dict(params.named_parameters())
    device = next(iter(named.values())).device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=dt, device=p.device) for n, p in named.items()}

    return OptState(step=torch.zeros((), dtype=torch.int32, device=device), m=zeros(), v=zeros())


def cosine_schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_ratio * lr`` at
    ``total_steps``; fp32, as the JAX package computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    leaves = list(tree.values())
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        total = total + torch.sum(x.float() ** 2)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(
    params: nn.Module, grads: Dict[str, torch.Tensor], state: OptState, cfg: AdamWConfig
) -> Tuple[nn.Module, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step with clipping, in place; returns (params, state, metrics).

    ``grads`` is keyed like the parameters; a missing or None gradient is
    zero (a parameter the loss does not reach, as ``jax.grad`` gives zeros).
    """
    step = state.step + 1
    lr = cosine_schedule(step, cfg)
    named = dict(params.named_parameters())
    grads = {n: grads[n] if grads.get(n) is not None else torch.zeros_like(p)
             for n, p in named.items()}

    gnorm = global_norm(grads)
    if cfg.clip_norm:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    b1c = 1.0 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1.0 - torch.pow(cfg.b2, step.to(torch.float32))

    for name, p in named.items():
        m, v = state.m[name], state.v[name]
        g32 = grads[name].float() * scale  # a new fp32 tensor, reused below for the update
        m32, v32 = m.float(), v.float()  # the moments themselves when they are fp32
        m32.mul_(cfg.b1).add_(g32, alpha=1.0 - cfg.b1)
        v32.mul_(cfg.b2).addcmul_(g32, g32, value=1.0 - cfg.b2)
        delta = torch.div(m32, b1c, out=g32)
        delta.div_(torch.div(v32, b2c).sqrt_().add_(cfg.eps))
        if cfg.weight_decay and p.ndim >= 2:  # decay matrices, not norms/bias
            delta.add_(p.float(), alpha=cfg.weight_decay)
        p32 = p.float()  # p itself when it is fp32
        p32.sub_(delta.mul_(lr))
        if p32 is not p:
            p.copy_(p32)
        if m32 is not m:
            m.copy_(m32)
            v.copy_(v32)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step=step, m=state.m, v=state.v), metrics
