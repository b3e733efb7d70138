"""Synthetic, deterministic, host-sharded token pipeline: the port of
``repro.data.pipeline``.

Each host generates only its shard of the global batch (:func:`shard_for_host`),
batches are reproducible functions of (seed, step), so an elastic restart at
step k regenerates the identical stream, and the iterator can start at any
step for a checkpoint resume. The token distribution is a mixture of Zipfian
unigrams and a repeated n-gram process, so cross-entropy actually decreases
(pure-uniform tokens would pin the loss at log V).

The tokens come from numpy exactly as the JAX package draws them, so they
are the same values, int32, put on ``device``. An audio config's stub frames
are drawn by the port's ``make_stub_frames`` on a ``torch.Generator`` seeded
with the step: they are not ``jax.random``'s (tests feed both packages the
same frames instead).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import make_stub_frames, make_stub_positions

__all__ = ["DataConfig", "SyntheticLM", "shard_for_host"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int  # per-host batch
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram: int = 8  # motif length for learnable structure


class SyntheticLM:
    """batch = pipeline(step): deterministic per (seed, step), on ``device``."""

    def __init__(self, cfg: ModelConfig, data: DataConfig, *, device="cuda"):
        self.cfg = cfg
        self.data = data
        self.device = torch.device(device)
        rng = np.random.default_rng(data.seed)
        # Fixed motif table: 256 motifs of length ngram over a Zipf vocab.
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-data.zipf_a)
        self._probs = probs / probs.sum()
        self._motifs = rng.integers(0, cfg.vocab, size=(256, data.ngram), dtype=np.int64)

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        d = self.data
        rng = np.random.default_rng((d.seed << 32) ^ step)
        n_tokens = d.batch * (d.seq_len + 1)
        # mixture: 50% zipf unigrams, 50% motif continuations
        flat = rng.choice(self.cfg.vocab, size=n_tokens, p=self._probs)
        seq = flat.reshape(d.batch, d.seq_len + 1)
        n_mot = d.seq_len // (2 * d.ngram)
        for b in range(d.batch):
            ids = rng.integers(0, 256, size=n_mot)
            starts = rng.integers(0, d.seq_len - d.ngram, size=n_mot)
            for m, s in zip(ids, starts):
                seq[b, s : s + d.ngram] = self._motifs[m]
        tokens = torch.from_numpy(seq[:, :-1].astype(np.int32)).to(self.device)
        labels = torch.from_numpy(seq[:, 1:].astype(np.int32)).to(self.device)
        batch = {"tokens": tokens, "labels": labels}
        if self.cfg.frontend == "audio_stub":
            gen = torch.Generator(device=self.device).manual_seed(step)
            batch["frames"] = make_stub_frames(self.cfg, d.batch, gen, device=self.device)
        if self.cfg.mrope:
            batch["positions"] = make_stub_positions(d.batch, d.seq_len, device=self.device)
        return batch

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        step = start_step
        while True:
            yield self(step)
            step += 1


def shard_for_host(
    global_batch: int, host_index: Optional[int] = None, host_count: Optional[int] = None
) -> int:
    """Per-host batch size for multi-host data loading. The host index and
    count default to ``torch.distributed``'s rank and world size where a
    process group is initialized, else to 0 and 1."""
    dist = torch.distributed
    up = dist.is_available() and dist.is_initialized()
    if host_index is None:
        host_index = dist.get_rank() if up else 0
    if host_count is None:
        host_count = dist.get_world_size() if up else 1
    base = global_batch // host_count
    extra = 1 if host_index < global_batch % host_count else 0
    return base + extra
