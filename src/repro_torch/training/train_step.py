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
are divided by ``accum_steps``, as the JAX ``scan`` does.

With the tracer on, a step records ``train.step.body``, whose ``step``
attribute (a count of this step function's traced calls) every span of the
step carries too, and inside it one span per phase, which a profiler trace
can attribute device time to:

- ``train.forward``: ``M.loss_fn``, once per microbatch (``mb``, ``tokens``);
- ``train.backward``: the backward, once per microbatch. On the card,
  autograd runs the backward's nodes on its own thread for the device, not
  on the caller's, and a device trace credits a launch only to the ranges
  open on the launching thread. So this span is opened by a hook on the
  loss, when the engine reaches the loss's node, and closed by a callback
  queued on the engine, when it has run the whole graph: both run on that
  thread (checked on the H100). It names ``train.step.body`` as its parent
  across the threads, and holds every launch of the backward,
  rematerialization's recompute included;
- ``train.accumulate`` (``accum_steps`` > 1): the zeroing of the fp32
  buffers, each microbatch's add pass and the final divide, a span each
  (``leaves``, ``elements``);
- ``train.optimizer``: the AdamW update (``leaves``, ``elements``).

With the tracer off a step registers no hook, queues no callback and
builds no span attributes.
"""
from __future__ import annotations

import itertools
from typing import Dict, NamedTuple, Optional

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


def _span_backward(tracer: obs_tracer.Tracer, loss: torch.Tensor, body: obs_tracer.Span,
                   attrs: dict) -> None:
    """Record ``train.backward`` around ``loss.backward()``'s graph, on the
    thread that runs its nodes (see the module's docstring)."""
    opened = []

    def close() -> None:
        opened.pop().__exit__(None, None, None)

    def open_(grad: torch.Tensor) -> None:
        span = tracer.span("train.backward", cat="train", track="train", parent=body, **attrs)
        span.__enter__()
        opened.append(span)
        torch.autograd.Variable._execution_engine.queue_callback(close)

    loss.register_hook(open_)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *, accum_steps: int = 1):
    """Returns train_step(state, batch) -> (state, metrics), metrics 0-d tensors."""
    traced_steps = itertools.count(1)

    def grads_of(params: nn.Module, batch: Dict[str, torch.Tensor],
                 body: Optional[obs_tracer.Span], mb: int):
        for p in params.parameters():
            p.grad = None
        tracer = obs_tracer.get_tracer()
        attrs = {} if body is None else {
            "step": body.attrs["step"], "mb": mb, "tokens": batch["tokens"].numel()}
        with tracer.span("train.forward", cat="train", track="train", **attrs):
            loss, metrics = M.loss_fn(params, batch, cfg)
        if body is not None:
            _span_backward(tracer, loss, body, attrs)
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        tracer = obs_tracer.get_tracer()
        if not tracer.enabled:
            return _train_step_body(state, batch, None)
        with tracer.span("train.step.body", cat="train", track="train", accum=accum_steps,
                         step=next(traced_steps)) as body:
            return _train_step_body(state, batch, body)

    def _train_step_body(state: TrainState, batch: Dict[str, torch.Tensor],
                         body: Optional[obs_tracer.Span]):
        tracer = obs_tracer.get_tracer()
        params = state.params
        named = dict(params.named_parameters())
        work = {} if body is None else {
            "step": body.attrs["step"], "leaves": len(named),
            "elements": sum(p.numel() for p in named.values())}
        if accum_steps == 1:
            metrics = grads_of(params, batch, body, 0)
            grads = {n: p.grad for n, p in named.items()}
        else:
            with tracer.span("train.accumulate", cat="train", track="train", **work):
                acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                       for n, p in named.items()}
                loss_sum = torch.zeros((), dtype=torch.float32,
                                       device=next(iter(acc.values())).device)
            for i, mb in enumerate(_microbatches(batch, accum_steps)):
                loss = grads_of(params, mb, body, i)["loss"]
                with tracer.span("train.accumulate", cat="train", track="train", **work):
                    loss_sum = loss_sum + loss
                    for n, p in named.items():
                        if p.grad is not None:
                            acc[n].add_(p.grad)
            with tracer.span("train.accumulate", cat="train", track="train", **work):
                grads = {n: a.div_(accum_steps) for n, a in acc.items()}
                metrics = {"loss": loss_sum / accum_steps}
        with tracer.span("train.optimizer", cat="train", track="train", **work):
            _, opt, opt_metrics = apply_updates(params, grads, state.opt, opt_cfg)
        for p in named.values():
            p.grad = None
        metrics = {**metrics, **opt_metrics}
        metrics = {k: v for k, v in metrics.items() if v.ndim == 0}
        return TrainState(params=params, opt=opt), metrics

    return train_step
