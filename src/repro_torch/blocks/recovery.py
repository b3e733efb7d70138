"""Lineage-based fault tolerance for the tagged block runtime.

The port of :mod:`repro.blocks.recovery`. Stark inherits resilience from
Spark: every RDD block is recomputable from its lineage, so a lost partition
never kills the job. The runtime gets the same property because **the tag
algebra IS the lineage graph**: a block's tag (``"A:3,0"``, ``"C:5"``, ...)
names its node in the recursion tree, and the plan's ``operand_terms`` /
``combine_terms`` are closed forms for how that node derives from its
parents. Any block — a divided operand, a leaf product ``M_t``, a combine
partial — can therefore be rebuilt on demand:

* ``A:``/``B:`` root blocks re-ingest from the retained dense operands;
* deeper divide blocks are one signed quadrant sum of the parent node;
* leaf products re-run the leaf multiply over recomputed operands;
* combine partials re-run the single-level combine sum over the
  (recursively recovered) child products.

Recompute replays the **same computation path** the scheduler took — the
same :func:`~repro_torch.blocks.blockmatrix.signed_block_sum` accumulation
order, the same staging casts, the same leaf kernel on the same device — so
a recovered block is bit-identical to the lost one, and the stored put-time
checksum proves it.

Three layers build on :func:`recompute_block`:

:class:`RecoveringStore`
    Transparent wrapper over any block store: crc32 checksum metadata on
    put, verify-on-get, and lineage recompute on loss (``KeyError``) or
    corruption (checksum mismatch), surfaced through ``fault.*`` counters
    and ``fault.recompute`` spans.

:class:`ChaosStore` / :class:`FlakyLeaf`
    The deterministic fault-injection harness: a seeded store wrapper that
    drops or bit-flips blocks on read, and a leaf-multiply shim that fails
    chosen (or randomly sampled) dispatch calls. Their draws come from the
    same numpy generators as the reference's, so a seed replays the
    reference's fault schedule.

:class:`ChaosConfig`
    One bundle of injection knobs shared by the scheduler's ``chaos=``
    parameter and the launchers' ``--fault-rate``.

:class:`FaultError` is also what the serving engine isolates: it evicts the
request a fault is attributed to and keeps serving.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.blocks import tags
from repro_torch.blocks.blockmatrix import BlockKey, BlockStore, signed_block_sum
from repro_torch.blocks.plan import BilinearPlan, matmul_plan
from repro_torch.core.coefficients import Scheme
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracer as obs_tracer

__all__ = [
    "FaultError",
    "InjectedFault",
    "BlockLossError",
    "ChaosConfig",
    "ChaosStore",
    "FlakyLeaf",
    "Lineage",
    "RecoveringStore",
    "block_checksum",
    "recompute_block",
]


class FaultError(RuntimeError):
    """Base of the runtime's recoverable fault family.

    The scheduler's degradation ladder steps down on this (and on
    device-OOM); anything else propagates as a plain bug.
    """


class InjectedFault(FaultError):
    """Raised by the chaos harness (FlakyLeaf / poisoned requests)."""


class BlockLossError(FaultError):
    """A block is gone/corrupt and lineage cannot rebuild it."""


def block_checksum(block) -> int:
    """crc32 of the block's raw row-major bytes (dtype-agnostic, bf16 included)."""
    if not isinstance(block, torch.Tensor):
        return zlib.crc32(np.ascontiguousarray(block).tobytes())
    return zlib.crc32(block.contiguous().reshape(-1).view(torch.uint8).numpy())


# --------------------------------------------------------------- injection
@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Deterministic fault-injection knobs for one scheduler run.

    ``drop``/``corrupt`` are per-``get`` probabilities applied by
    :class:`ChaosStore`; ``leaf_fail_rate`` / ``fail_leaf_calls`` drive
    :class:`FlakyLeaf` (the Nth-leaf-multiply failure shim). All draws
    come from generators seeded off ``seed``, so a fixed access sequence
    replays the identical fault schedule.
    """

    drop: float = 0.0
    corrupt: float = 0.0
    leaf_fail_rate: float = 0.0
    fail_leaf_calls: Tuple[int, ...] = ()
    seed: int = 0

    def __post_init__(self):
        for name in ("drop", "corrupt", "leaf_fail_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} must be a probability in [0, 1]")

    @property
    def injects_store_faults(self) -> bool:
        return self.drop > 0.0 or self.corrupt > 0.0

    @property
    def injects_leaf_faults(self) -> bool:
        return self.leaf_fail_rate > 0.0 or bool(self.fail_leaf_calls)


class ChaosStore(BlockStore):
    """Seeded block drop/corrupt injector between the runtime and a store.

    Sits *beneath* :class:`RecoveringStore` (faults must hit the raw bytes
    the checksums guard). On ``get`` it may first delete the block (a loss
    the reader sees as ``KeyError``) or flip one byte of a copy of the
    stored block and put the copy back (a corruption only a checksum can
    catch). Pure injection: every injection is counted here and on the
    ``fault.injected_*`` counters so gates can demand injected ==
    detected + healed.
    """

    def __init__(
        self,
        inner: BlockStore,
        *,
        drop: float = 0.0,
        corrupt: float = 0.0,
        seed: int = 0,
    ) -> None:
        self.inner = inner
        self.drop = float(drop)
        self.corrupt = float(corrupt)
        self._rng = np.random.default_rng(seed)
        self.injected_drops = 0
        self.injected_corruptions = 0

    def put(self, key: BlockKey, block: torch.Tensor) -> None:
        self.inner.put(key, block)

    def get(self, key: BlockKey) -> torch.Tensor:
        mx = obs_metrics.get_metrics()
        if self.drop and key in self.inner and self._rng.random() < self.drop:
            self.inner.delete(key)
            self.injected_drops += 1
            mx.counter("fault.injected_drops").inc()
        elif self.corrupt and key in self.inner and self._rng.random() < self.corrupt:
            # A copy: the stored tensor may alias other blocks or a mapped file.
            blk = self.inner.get(key).clone()
            flat = blk.reshape(-1).view(torch.uint8)
            i = int(self._rng.integers(flat.numel()))
            flat[i] = flat[i] ^ 0xFF
            self.inner.put(key, blk)
            self.injected_corruptions += 1
            mx.counter("fault.injected_corruptions").inc()
        return self.inner.get(key)

    def delete(self, key: BlockKey) -> None:
        self.inner.delete(key)

    def __contains__(self, key: BlockKey) -> bool:
        return key in self.inner

    def keys(self) -> List[BlockKey]:
        return self.inner.keys()

    def nbytes(self) -> int:
        return self.inner.nbytes()

    def close(self) -> None:
        self.inner.close()


class FlakyLeaf:
    """Flaky-backend shim: fail selected leaf-multiply dispatch calls.

    The scheduler calls :meth:`check` once per leaf dispatch (and per
    retry — a retry is a new call, so transient faults clear and
    ``fail_leaf_calls`` can model persistent ones by listing consecutive
    indices). Counts land on ``fault.injected_leaf_failures``.
    """

    def __init__(
        self,
        *,
        fail_calls: Tuple[int, ...] = (),
        fail_rate: float = 0.0,
        seed: int = 0,
    ) -> None:
        self.fail_calls = frozenset(fail_calls)
        self.fail_rate = float(fail_rate)
        self._rng = np.random.default_rng(seed)
        self.calls = 0
        self.injected = 0

    def check(self) -> None:
        idx = self.calls
        self.calls += 1
        if idx in self.fail_calls or (
            self.fail_rate and self._rng.random() < self.fail_rate
        ):
            self.injected += 1
            obs_metrics.get_metrics().counter("fault.injected_leaf_failures").inc()
            raise InjectedFault(f"injected leaf failure at dispatch call {idx}")


# ----------------------------------------------------------------- lineage
@dataclasses.dataclass
class Lineage:
    """Everything :func:`recompute_block` needs to rebuild any run block.

    Built by the scheduler at the top of a run: the retained dense host
    operands (the lineage roots — the caller's tensors, not copies), the
    run's padded geometry, its dtype discipline, and a callable replaying
    one leaf multiply through the same device, backend and staging path the
    waves used. With these, every tag in the run's ``A:``/``B:``/``C:`` space
    is recomputable — and bit-identical to the original, because each
    derivation step replays the scheduler's own accumulation loop.
    """

    scheme: Scheme
    depth: int
    a: torch.Tensor
    b: torch.Tensor
    pm: int
    pk: int
    pn: int
    bam: int
    bak: int
    bbn: int
    acc_dtype: torch.dtype
    stage_dtype: torch.dtype
    leaf_matmul: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None
    # The recursive plan whose schemas key the recompute derivations;
    # ``None`` means the scheme's matmul plan.
    plan: Optional[BilinearPlan] = None

    def get_plan(self) -> BilinearPlan:
        if self.plan is None:
            self.plan = matmul_plan(self.scheme)
        return self.plan

    def geometry(self, op: str) -> Tuple[int, int, int, int, Optional[torch.Tensor]]:
        """(root rows, root cols, block rows, block cols, dense-or-None)."""
        plan = self.get_plan()
        a_name, b_name = plan.operands
        if op == a_name:
            return self.pm, self.pk, self.bam, self.bak, self.a
        if op == b_name:
            return self.pk, self.pn, self.bak, self.bbn, self.b
        if op == plan.result:
            return self.pm, self.pn, self.bam, self.bbn, None
        raise BlockLossError(f"tag operand {op!r} is not lineage-addressable")


def _parse_tag(
    tag: str, plan: Optional[BilinearPlan] = None
) -> Tuple[str, tags.TagPath]:
    names = (
        plan.operands + (plan.result,) if plan is not None else ("A", "B", "C")
    )
    op, sep, path_s = tag.partition(":")
    if not sep or op not in names:
        raise BlockLossError(f"tag {tag!r} is not a lineage-addressable node tag")
    try:
        return op, tags.from_string(path_s)
    except ValueError as e:
        raise BlockLossError(f"tag {tag!r}: malformed path ({e})") from e


def _node_dense(
    op: str,
    path: tags.TagPath,
    lineage: Lineage,
    fetch: Callable[[BlockKey], torch.Tensor],
    dtype: torch.dtype,
) -> torch.Tensor:
    """Assemble a node's dense padded matrix from its (fetched) blocks, cast
    to ``dtype`` (the staging cast, at the host->device boundary)."""
    rows, cols, bm, bn, _ = lineage.geometry(op)
    level = len(path)
    rows, cols = rows >> level, cols >> level
    tag = f"{op}:{tags.to_string(path)}"
    out = torch.empty((rows, cols), dtype=dtype)
    for i in range(rows // bm):
        for j in range(cols // bn):
            out[i * bm : (i + 1) * bm, j * bn : (j + 1) * bn].copy_(fetch((i, j, tag)))
    return out


def recompute_block(
    key: BlockKey,
    lineage: Lineage,
    fetch: Callable[[BlockKey], torch.Tensor],
    _depth: int = 0,
) -> torch.Tensor:
    """Rebuild one block from its lineage, bit-identical to the original.

    ``fetch`` resolves any *other* block key the derivation needs — a
    :class:`RecoveringStore` passes a memoized reader that falls back to
    this function recursively, so a recompute whose parents are also gone
    walks the lineage all the way to the dense roots. The recursion is
    well-founded (divide ascends to the roots, combine descends to the
    leaves whose operands ascend), but a malformed tag space could loop,
    hence the explicit depth guard.
    """
    if _depth > 2 * lineage.depth + 8:
        raise BlockLossError(f"lineage recursion too deep recomputing {key}")
    plan = lineage.get_plan()
    a_name, b_name = plan.operands
    i, j, tag = key
    op, path = _parse_tag(tag, plan)
    level = len(path)
    rows, cols, bm, bn, dense = lineage.geometry(op)
    gr, gc = (rows >> level) // bm, (cols >> level) // bn
    if not (0 <= i < gr and 0 <= j < gc):
        raise BlockLossError(f"{key} outside the level-{level} grid {(gr, gc)}")

    if op in (a_name, b_name):
        if level == 0:
            # Root re-ingest: the same slice/zero-pad as from_dense.
            chunk = dense[i * bm : (i + 1) * bm, j * bn : (j + 1) * bn]
            if tuple(chunk.shape) != (bm, bn):
                full = torch.zeros((bm, bn), dtype=dense.dtype)
                full[: chunk.shape[0], : chunk.shape[1]] = chunk
                chunk = full
            return chunk.contiguous()
        # One divide level: the single-digit operand_terms row is exactly
        # the plan's divide-coefficient row the scheduler applied; parent
        # blocks are read through fetch (recovering recursively if gone).
        parent_tag = f"{op}:{tags.to_string(path[:-1])}"
        row = np.zeros(tags.Q_BASE)
        for (q,), c in plan.operand_terms((path[-1],), op):
            row[q] = c
        acc = signed_block_sum(
            lambda q: fetch(((q // 2) * gr + i, (q % 2) * gc + j, parent_tag)),
            row,
            lineage.acc_dtype,
        )
        return acc.contiguous()

    # op == the plan's result
    if level == lineage.depth:
        # Leaf product: re-run the leaf multiply over recomputed operands,
        # through the same staging cast and device path the wave used.
        if lineage.leaf_matmul is None:
            raise BlockLossError(
                f"cannot recompute leaf product {key}: lineage has no leaf_matmul"
            )
        a_host = _node_dense(a_name, path, lineage, fetch, lineage.stage_dtype)
        b_host = _node_dense(b_name, path, lineage, fetch, lineage.stage_dtype)
        host = lineage.leaf_matmul(a_host, b_host).to(lineage.acc_dtype)
        return host[i * bm : (i + 1) * bm, j * bn : (j + 1) * bn].contiguous()

    # Combine partial: one combine level over the rank child products. The
    # block's quadrant inside the parent picks the combine-coefficient row.
    cgr, cgc = gr // 2, gc // 2
    kq = 2 * (i // cgr) + (j // cgc)
    ci, cj = i % cgr, j % cgc
    rank = plan.rank
    row = np.zeros(rank)
    for p in range(rank):
        for (q,), c in plan.combine_terms((p,)):
            if q == kq:
                row[p] = c
    child_tags = [
        f"{op}:{tags.to_string(tags.child(path, p, rank))}" for p in range(rank)
    ]
    acc = signed_block_sum(
        lambda p: fetch((ci, cj, child_tags[p])), row, lineage.acc_dtype
    )
    return acc.contiguous()


# ---------------------------------------------------------------- recovery
class RecoveringStore(BlockStore):
    """Checksum-verified store wrapper with transparent lineage recompute.

    ``put`` records crc32 metadata; ``get`` verifies it and, on a missing
    (``KeyError``) or corrupt (checksum-mismatch) block, rebuilds the block
    from lineage, re-puts it, and returns it as if nothing happened. A
    recovered block must reproduce the put-time checksum — the
    bit-exactness proof — or it counts as ``fault.recompute_mismatch``
    (surfaced as ``unrecovered_faults`` in the scheduler's stats).

    Counters: ``fault.lost_blocks``, ``fault.corrupt_blocks``,
    ``fault.recomputed_blocks``, ``fault.recompute_mismatch``,
    ``fault.unrecoverable``; every recompute is a ``fault.recompute`` span
    tagged with the block's tag.
    """

    def __init__(
        self,
        inner: BlockStore,
        lineage: Optional[Lineage] = None,
        *,
        verify: bool = True,
    ) -> None:
        self.inner = inner
        self.lineage = lineage
        self.verify = verify
        self._meta: Dict[BlockKey, int] = {}
        self.lost_blocks = 0
        self.corrupt_blocks = 0
        self.recovered_blocks = 0
        self.recompute_mismatches = 0

    def put(self, key: BlockKey, block: torch.Tensor) -> None:
        block = block.contiguous()
        self._meta[key] = block_checksum(block)
        self.inner.put(key, block)

    def get(self, key: BlockKey) -> torch.Tensor:
        try:
            blk = self.inner.get(key)
        except KeyError:
            return self._recover(key, "lost")
        if (
            self.verify
            and key in self._meta
            and block_checksum(blk) != self._meta[key]
        ):
            return self._recover(key, "corrupt")
        return blk

    def delete(self, key: BlockKey) -> None:
        self.inner.delete(key)
        self._meta.pop(key, None)

    def __contains__(self, key: BlockKey) -> bool:
        return key in self.inner

    def keys(self) -> List[BlockKey]:
        return self.inner.keys()

    def nbytes(self) -> int:
        return self.inner.nbytes()

    def close(self) -> None:
        self._meta.clear()
        self.inner.close()

    # ------------------------------------------------------------ internals
    def _recover(self, key: BlockKey, reason: str) -> torch.Tensor:
        mx = obs_metrics.get_metrics()
        if reason == "lost":
            self.lost_blocks += 1
            mx.counter("fault.lost_blocks").inc()
        else:
            self.corrupt_blocks += 1
            mx.counter("fault.corrupt_blocks").inc()
        if self.lineage is None:
            mx.counter("fault.unrecoverable").inc()
            raise BlockLossError(
                f"block {key} {reason} and no lineage is attached to recover it"
            )
        tr = obs_tracer.get_tracer()
        i, j, tag = key
        with tr.span(
            "fault.recompute", cat="fault", tag=f"{tag}[{i},{j}]", reason=reason
        ):
            # Memoized lineage reader: intermediate parents rebuilt along the
            # way serve this one recovery without being re-persisted — only
            # the requested key is re-put, so a healed store holds exactly
            # the blocks the run would have held anyway. The counter guards
            # the recompute<->fetch mutual recursion.
            memo: Dict[BlockKey, torch.Tensor] = {}
            nested = [0]

            def fetch(k: BlockKey) -> torch.Tensor:
                got = memo.get(k)
                if got is not None:
                    return got
                try:
                    blk = self.inner.get(k)
                    ok = (
                        not self.verify
                        or k not in self._meta
                        or block_checksum(blk) == self._meta[k]
                    )
                except KeyError:
                    blk, ok = None, False
                if not ok:
                    nested[0] += 1
                    try:
                        blk = recompute_block(k, self.lineage, fetch, nested[0])
                    finally:
                        nested[0] -= 1
                memo[k] = blk
                return blk

            try:
                blk = recompute_block(key, self.lineage, fetch)
            except BlockLossError:
                mx.counter("fault.unrecoverable").inc()
                raise
        want = self._meta.get(key)
        got = block_checksum(blk)
        if want is not None and got != want:
            # Recovered, but not bit-identical to what was stored: surfaced
            # so the chaos gate can hold recompute to exact replay.
            self.recompute_mismatches += 1
            mx.counter("fault.recompute_mismatch").inc()
        self.recovered_blocks += 1
        mx.counter("fault.recomputed_blocks").inc()
        self.inner.put(key, blk)
        self._meta[key] = got
        return blk
