"""Train step: gradients + AdamW update, with microbatched gradient
accumulation; the port of ``repro.training.train_step``.

``make_train_step(cfg, opt_cfg, accum_steps=)(state, batch)`` runs the loss
forward and backward through the model's kernels (the flash and RMSNorm
backward kernels on the card) and applies AdamW in place. The JAX step is a
pure function that ``jit`` compiles once; eagerly on one card the state's
tensors are updated in place and the same :class:`TrainState` comes back,
with the step count advanced. Accumulation splits the batch into
``accum_steps`` microbatches along dim 0, run one after another: activation
memory scales with the slice. Their gradients add up in fp32 buffers, which
are divided by ``accum_steps``, as the JAX ``scan`` does. With the tracer on,
a step records the spans ``train.step.body`` and, inside it,
``train.optimizer`` (the AdamW update), which a profiler trace can
attribute device time to.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch import nn

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import constrain
from repro_torch.obs import tracer as obs_tracer
from repro_torch.optim.adamw import AdamWConfig, OptState, apply_updates, init_opt_state

__all__ = ["TrainState", "init_train_state", "make_train_step"]


class TrainState(NamedTuple):
    params: nn.Module
    opt: OptState


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, gen: torch.Generator) -> TrainState:
    """Parameters drawn from ``gen`` on its device, made trainable, and zero moments."""
    params = M.init_params(cfg, gen)
    for p in params.parameters():
        p.requires_grad_(True)
    return TrainState(params=params, opt=init_opt_state(params, opt_cfg))


def _microbatches(batch: Dict[str, torch.Tensor], accum: int) -> list:
    """(GB, ...) -> accum dicts of (GB/accum, ...) slices, each (accum, GB/accum,
    ...) stack constrained with its microbatch rows on ``"batch"`` as the JAX
    package constrains it (a layout record under a sharding context)."""
    stacks = {}
    for name, x in batch.items():
        if x.shape[0] % accum:
            raise ValueError(f"batch[{name!r}] of {x.shape[0]} rows does not split into {accum}")
        out = x.reshape(accum, x.shape[0] // accum, *x.shape[1:])
        stacks[name] = constrain(out, None, "batch", *([None] * (out.ndim - 2)))
    return [{name: x[i] for name, x in stacks.items()} for i in range(accum)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *, accum_steps: int = 1):
    """Returns train_step(state, batch) -> (state, metrics), metrics 0-d tensors."""

    def grads_of(params: nn.Module, batch: Dict[str, torch.Tensor]):
        for p in params.parameters():
            p.grad = None
        loss, metrics = M.loss_fn(params, batch, cfg)
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with obs_tracer.get_tracer().span("train.step.body", cat="train", track="train",
                                          accum=accum_steps):
            return _train_step_body(state, batch)

    def _train_step_body(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        named = dict(params.named_parameters())
        if accum_steps == 1:
            metrics = grads_of(params, batch)
            grads = {n: p.grad for n, p in named.items()}
        else:
            acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for n, p in named.items()}
            loss_sum = torch.zeros((), dtype=torch.float32, device=next(iter(acc.values())).device)
            for mb in _microbatches(batch, accum_steps):
                loss_sum = loss_sum + grads_of(params, mb)["loss"]
                for n, p in named.items():
                    if p.grad is not None:
                        acc[n].add_(p.grad)
            grads = {n: a.div_(accum_steps) for n, a in acc.items()}
            metrics = {"loss": loss_sum / accum_steps}
        with obs_tracer.get_tracer().span("train.optimizer", cat="train", track="train"):
            _, opt, opt_metrics = apply_updates(params, grads, state.opt, opt_cfg)
        for p in named.values():
            p.grad = None
        metrics = {**metrics, **opt_metrics}
        metrics = {k: v for k, v in metrics.items() if v.ndim == 0}
        return TrainState(params=params, opt=opt), metrics

    return train_step
