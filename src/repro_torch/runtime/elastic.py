"""Elastic scaling + fault tolerance + straggler policy: the port of
``repro.runtime.elastic``, on the port's ``obs`` tracer and metrics.

When a host (or its card) disappears the job resumes on the survivors; a
synchronous data-parallel program recovers as a whole job:

  1. Checkpoint/restart (runtime/checkpoint.py): atomic, manifest-gated.
  2. Re-mesh: on restart, :func:`plan_mesh` fits the canonical logical mesh
     to the surviving device count: the data axis shrinks or grows, the
     model axis stays fixed so parameter shards remain valid, and
     :func:`rebalance_accum` preserves the global batch by raising gradient
     accumulation.
  3. Straggler mitigation: :class:`StragglerMonitor` tracks each step's wall
     clock against a rolling median; a sustained slowdown beyond
     ``threshold`` flags the job for checkpoint + restart (the launcher then
     exits with code 75 for its supervisor).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional, Tuple

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracer as obs_tracer

__all__ = ["plan_mesh", "rebalance_accum", "StragglerMonitor", "ElasticError"]


class ElasticError(RuntimeError):
    pass


def plan_mesh(
    n_devices: int,
    *,
    model_parallel: int = 16,
    pods: Optional[int] = None,
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Fit the canonical (pod, data, model) mesh to a device count.

    The model axis is immutable (parameter shards must stay valid across
    restarts); the data axis absorbs all elasticity. Returns (shape, axes).
    """
    if n_devices % model_parallel:
        raise ElasticError(
            f"{n_devices} devices not divisible by model_parallel={model_parallel}"
        )
    rest = n_devices // model_parallel
    if pods and pods > 1:
        if rest % pods:
            raise ElasticError(f"data x pod mismatch: {rest} vs pods={pods}")
        return (pods, rest // pods, model_parallel), ("pod", "data", "model")
    return (rest, model_parallel), ("data", "model")


def rebalance_accum(
    global_batch: int, seq_len: int, n_data_shards: int, *, per_shard_tokens_budget: int
) -> int:
    """Grad-accumulation steps preserving global batch on fewer devices."""
    per_shard = (global_batch // max(n_data_shards, 1)) * seq_len
    accum = max(1, -(-per_shard // per_shard_tokens_budget))
    while global_batch % (accum * n_data_shards) and accum < global_batch:
        accum += 1
    return accum


@dataclasses.dataclass
class StragglerMonitor:
    """Rolling-median step-time watchdog; flags sustained slowdowns.

    Two obs gauges are set every step: ``elastic.step_over_median`` (the last
    step's wall clock over the rolling median; above ``threshold`` the step
    counts as slow) and ``elastic.slow_streak`` (consecutive slow steps;
    ``patience`` of them raise the flag, counted by
    ``elastic.straggler_flags``). :meth:`flag_reason` returns the pair.
    """

    window: int = 32
    threshold: float = 2.0  # x median
    patience: int = 8  # consecutive slow steps before flagging

    def __post_init__(self):
        self._times: Deque[float] = deque(maxlen=self.window)
        self._slow_streak = 0
        self._span: Optional[obs_tracer.Span] = None
        self._step_idx = 0
        self._last_ratio = 0.0

    def start_step(self):
        # begin() hands back a timed Span even when tracing is disabled, so
        # the watchdog's arithmetic does not depend on the tracer being on.
        self._span = obs_tracer.get_tracer().begin(
            "train.step", cat="train", track="train", step=self._step_idx
        )

    def end_step(self) -> bool:
        """Record one step; True -> checkpoint + restart recommended."""
        assert self._span is not None, "end_step without start_step"
        obs_tracer.get_tracer().end(self._span)
        dt = self._span.duration
        self._span = None
        self._step_idx += 1
        median = sorted(self._times)[len(self._times) // 2] if self._times else dt
        self._times.append(dt)
        self._last_ratio = dt / median if median > 0 else 0.0
        if len(self._times) >= self.window // 2 and dt > self.threshold * median:
            self._slow_streak += 1
        else:
            self._slow_streak = 0
        mx = obs_metrics.get_metrics()
        mx.gauge("elastic.step_over_median").set(self._last_ratio)
        mx.gauge("elastic.slow_streak").set(self._slow_streak)
        flagged = self._slow_streak >= self.patience
        if flagged:
            mx.counter("elastic.straggler_flags").inc()
            obs_tracer.get_tracer().event(
                "elastic.straggler_flag", cat="train", track="train",
                median=self._last_ratio, streak=self._slow_streak,
            )
        return flagged

    def flag_reason(self) -> dict:
        """The flag's evidence: {'median': last step / rolling median,
        'streak': consecutive slow steps}."""
        return {"median": self._last_ratio, "streak": self._slow_streak}

    @property
    def median_step_time(self) -> float:
        return sorted(self._times)[len(self._times) // 2] if self._times else 0.0
