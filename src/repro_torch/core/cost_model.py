"""Paper §IV stage-wise cost model for Stark, Marlin, and MLLib.

A copy of :mod:`repro.core.cost_model`, which the port may not import
(``repro.core`` pulls in JAX). It is numpy-free arithmetic on Python floats,
and the tests hold every function to the reference with ``==``.

Reproduces the paper's analytical wall-clock model: each Spark stage has a
computation cost, a communication cost, and a parallelization factor (PF);
stage wall-clock ~ (comp * t_flop + comm * t_elem) / PF, and total
wall-clock is the sum over serially executed stages.

Notation (paper §IV):
    n = 2**p      matrix dimension
    b = 2**(p-q)  number of splits per side (partition count)
    n/b = 2**q    block size
    cores         physical cores in the cluster

The model is used by benchmarks/fig9..fig11 to reproduce the paper's
theory-vs-experiment comparison, with per-environment constants calibrated
from two micro-measurements (a block matmul and a block add) — the same
procedure the paper uses implicitly by plotting both curves in arbitrary
units.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

__all__ = [
    "StageCost",
    "CostModel",
    "stark_stages",
    "marlin_stages",
    "mllib_stages",
    "total_cost",
]


@dataclasses.dataclass(frozen=True)
class StageCost:
    """One Spark stage: the paper's (Computation, Communication, PF) triple."""

    name: str
    section: str  # divide | leaf | combine | shuffle | preprocess
    computation: float  # scalar op count
    communication: float  # elements moved
    parallelization: float  # PF (before min with cores)

    def wall_clock(
        self, cores: int, t_flop: float, t_elem: float, *, overlap: bool = False
    ) -> float:
        pf = min(self.parallelization, cores)
        pf = max(pf, 1.0)
        comp_s = self.computation * t_flop
        comm_s = self.communication * t_elem
        if overlap:
            # Latency-hidden regime: the engine issues a stage's transfers
            # while its compute runs (the oot scheduler's async wave
            # pipeline / an overlapped Spark shuffle), so the stage costs
            # the longer of the two streams instead of their sum.
            return max(comp_s, comm_s) / pf
        return (comp_s + comm_s) / pf


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Calibrated environment constants.

    t_flop: seconds per scalar multiply-add in the leaf matmul.
    t_elem: seconds per element moved through a shuffle/collective.
    """

    t_flop: float = 1.0e-9
    t_elem: float = 4.0e-9

    def total(
        self, stages: List[StageCost], cores: int, *, overlap: bool = False
    ) -> float:
        return sum(
            s.wall_clock(cores, self.t_flop, self.t_elem, overlap=overlap)
            for s in stages
        )

    def by_section(
        self, stages: List[StageCost], cores: int, *, overlap: bool = False
    ) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in stages:
            out[s.section] = out.get(s.section, 0.0) + s.wall_clock(
                cores, self.t_flop, self.t_elem, overlap=overlap
            )
        return out


def _check(n: int, b: int) -> int:
    if n & (n - 1) or b & (b - 1) or b < 1 or b > n:
        raise ValueError(f"need powers of two with b<=n, got n={n} b={b}")
    return int(math.log2(b))  # = p - q


def stark_stages(n: int, b: int) -> List[StageCost]:
    """Stark (paper Table III). b = 2**(p-q) splits; depth l = p - q levels.

    Stage count = 2(p-q) + 2 (paper eq. 25).
    """
    l = _check(n, b)
    stages: List[StageCost] = []
    blk = n // b  # leaf block side
    # Divide section: levels i = 0 .. l-1. At level i there are 7^i groups,
    # each holding matrices of side n/2^i made of (b/2^i)^2 blocks.
    for i in range(l):
        elems = (7.0 / 4.0) ** i * 2 * n * n  # elements processed this level
        blocks = (7.0 / 4.0) ** i * 2 * b * b
        # flatMap replicate (comp ~ blocks touched) + groupByKey shuffle
        stages.append(
            StageCost(
                name=f"divide[{i}].flatMap",
                section="divide",
                computation=blocks,
                communication=3.0 * elems,  # paper eq. 28: factor-3 replication
                parallelization=min(blocks, 7.0 ** (i + 1) * (b / 2**i) ** 2),
            )
        )
        stages.append(
            StageCost(
                name=f"divide[{i}].add",
                section="divide",
                computation=3.0 * elems,  # 12 adds of quarter-size blocks ~ 3 n_i^2
                communication=0.0,
                parallelization=7.0 ** (i + 1) * (b / 2 ** (i + 1)) ** 2,
            )
        )
    # Leaf section (paper eq. 31-33): 7^l block pairs shuffled then multiplied.
    leaves = 7.0**l
    stages.append(
        StageCost(
            name="leaf.shuffle",
            section="leaf",
            computation=0.0,
            communication=2.0 * leaves * blk * blk,
            parallelization=leaves,
        )
    )
    stages.append(
        StageCost(
            name="leaf.matmul",
            section="leaf",
            computation=leaves * float(blk) ** 3,  # b^2.807 * (n/b)^3
            communication=0.0,
            parallelization=leaves,
        )
    )
    # Combine section: levels i = l-1 .. 0 (paper eq. 34-37).
    for i in reversed(range(l)):
        groups = 7.0**i
        elems = (7.0 / 4.0) ** (i + 1) * n * n
        stages.append(
            StageCost(
                name=f"combine[{i}].shuffle",
                section="combine",
                computation=(7.0 / 4.0) ** (i + 1) * b * b,
                communication=elems,
                parallelization=max(groups, 1.0) * (b / 2 ** (i + 1)) ** 2,
            )
        )
        stages.append(
            StageCost(
                name=f"combine[{i}].add",
                section="combine",
                computation=groups * 12.0 * (n / b) ** 2 * 4.0 ** (l - 1 - i),
                communication=0.0,
                parallelization=max(groups, 1.0) * (b / 2 ** (i + 1)) ** 2,
            )
        )
    return stages


def marlin_stages(n: int, b: int) -> List[StageCost]:
    """Marlin (paper Table II / Lemma IV.1)."""
    _check(n, b)
    blk = n // b
    return [
        StageCost(
            "stage1.flatMapA", "divide", 2.0 * b**3, 2.0 * b * n * n, 2.0 * b * b
        ),
        StageCost(
            "stage1.flatMapB", "divide", 2.0 * b**3, 2.0 * b * n * n, 2.0 * b * b
        ),
        StageCost("stage3.join", "shuffle", 0.0, float(b) * n * n, float(b) ** 3),
        StageCost(
            "stage3.mapPartition",
            "leaf",
            float(b) ** 3 * float(blk) ** 3,
            0.0,
            float(b) ** 3,
        ),
        StageCost(
            "stage4.reduceByKey", "combine", float(b) * n * n, float(b) * n * n, float(b) ** 2
        ),
    ]


def mllib_stages(n: int, b: int) -> List[StageCost]:
    """MLLib BlockMatrix.multiply (paper Table I / eq. 9)."""
    _check(n, b)
    blk = n // b
    return [
        StageCost("simulate", "preprocess", 0.0, 2.0 * (n / b) ** 2, 1.0),
        StageCost("stage1.flatMapA", "divide", float(b) ** 3, 0.0, float(b) ** 2),
        StageCost("stage1.flatMapB", "divide", float(b) ** 3, 0.0, float(b) ** 2),
        StageCost(
            "stage3.coGroup", "shuffle", 0.0, 2.0 * b * n * n, float(b) ** 2
        ),
        StageCost(
            "stage3.flatMap", "leaf", float(b) ** 3 * float(blk) ** 3, 0.0, float(b) ** 2
        ),
        StageCost(
            "stage4.reduceByKey", "combine", float(b) * n * n, 0.0, float(b) ** 2
        ),
    ]


_SYSTEMS = {
    "stark": stark_stages,
    "marlin": marlin_stages,
    "mllib": mllib_stages,
}


def total_cost(
    system: str,
    n: int,
    b: int,
    cores: int,
    model: CostModel | None = None,
    *,
    overlap: bool = False,
) -> float:
    """Predicted wall-clock seconds for one distributed multiply.

    ``overlap=True`` prices each stage at max(compute, communication)
    instead of their sum — the latency-hidden regime an async pipeline
    (or an overlapped shuffle) achieves.
    """
    model = model or CostModel()
    return model.total(_SYSTEMS[system](n, b), cores, overlap=overlap)


def stage_count(system: str, n: int, b: int) -> int:
    """Number of StageCost entries (steps — finer than Spark stages)."""
    return len(_SYSTEMS[system](n, b))


def paper_stage_count(n: int, b: int) -> int:
    """Stark's Spark-stage count, paper eq. 25: 2(p-q) + 2."""
    return 2 * _check(n, b) + 2
