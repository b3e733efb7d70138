"""Level-order out-of-core Strassen executor over tagged block stores.

The port of :mod:`repro.blocks.scheduler`: the paper's level-parallel
recursion (Fig. 2) re-targeted at the host/device memory hierarchy instead
of a Spark cluster:

* **divide** — for each level, every tree node's seven children are formed
  by signed sums of the parent's quadrant blocks (Stark's
  flatMapToPair/groupByKey/flatMap stage). These are host-side tensor adds
  streaming block-by-block through the :class:`~repro_torch.blocks.
  blockmatrix.BlockStore`, so host working set is O(block), not O(matrix).
* **leaf** — the 7^q leaf products are batched into *waves* sized so that
  the current wave's working set, the previous wave's still-in-flight
  working set and the prefetched next-wave operands fit a configurable
  device-memory budget (:func:`pipelined_leaf_bytes`). The wave loop is a
  2-deep asynchronous pipeline. On a CUDA device wave k+1's operands are
  filled into a ring of pinned host buffers and copied with
  ``copy_(non_blocking=True)`` on a dedicated H2D stream, each leaf's copies
  followed by an event that the compute stream waits on before the leaf
  multiply; the products come back on a D2H stream into pinned buffers.
  The only blocking fence is each product's D2H event, waited on while the
  next wave computes — so H2D staging, leaf compute and D2H drain of
  adjacent waves overlap. Device tensors allocated on one stream and read
  on another are ``record_stream``-ed, so the caching allocator cannot hand
  their memory to the next wave's prefetch early. The leaf multiplies run
  on one stream (the caller's current stream) in pipelined and synchronous
  mode alike, so the two give the same bits. Per-wave spans land in
  :class:`OotStats.wave_events` and derive ``overlap_efficiency``.
* **combine** — level-order bottom-up signed sums of the seven child
  products into each parent's quadrants (Stark's combine stage), host-side
  and block-streaming; child nodes are freed as soon as their parent is
  built.

On the CPU (``device="cpu"``, as the tests run it) a transfer is a tensor
copy and the pipeline's order of operations is the same, with nothing to
overlap. Peak device bytes are bounded by the budget rather than the
problem size — the paper's "matrices far larger than memory" regime with
device HBM playing the executor and the host store playing HDFS.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.blocks import tags
from repro_torch.blocks.blockmatrix import (
    BlockMatrix,
    BlockStore,
    as_dtype,
    as_host_tensor,
    make_store,
    signed_block_sum,
)
from repro_torch.blocks.plan import BilinearPlan, as_bilinear_plan
from repro_torch.blocks.recovery import (
    ChaosConfig,
    ChaosStore,
    FaultError,
    FlakyLeaf,
    Lineage,
    RecoveringStore,
)
from repro_torch.core.coefficients import Scheme
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracer as obs_tracer

__all__ = [
    "OotStats",
    "OotStatsRing",
    "PlanScheduler",
    "StrassenScheduler",
    "strassen_oot_matmul",
    "leaf_bytes",
    "pipelined_leaf_bytes",
    "min_depth_for_budget",
    "attach_stats_ring",
    "recent_oot_stats",
    "reset_oot_stats",
    "resolve_device",
]


def resolve_device(device) -> torch.device:
    """The device a run stages its leaves to; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the out-of-core runtime stages its leaves to a CUDA device and none is "
            "available; pass device='cpu' to run it on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no out-of-core runtime for device {device}")
    return device


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _leaf_dims(m: int, k: int, n: int, depth: int) -> Tuple[int, int, int]:
    step = 2**depth
    return _ceil_div(m, step), _ceil_div(k, step), _ceil_div(n, step)


def _acc_dtype(dtype) -> torch.dtype:
    return torch.promote_types(as_dtype(dtype), torch.float32)


def _dtype_name(dtype) -> str:
    return str(as_dtype(dtype)).removeprefix("torch.")


def _leaf_inout_bytes(m: int, k: int, n: int, depth: int, dtype) -> Tuple[int, int]:
    """(operand bytes A + B, product bytes C) of one leaf multiply.

    Sized at the scheduler's default *staging* dtype — the accumulation
    dtype of ``dtype`` (f32 for bf16 inputs; see :class:`PlanScheduler`) —
    so budget planning is conservative for callers that narrow staging to
    the compute dtype.
    """
    lm, lk, ln = _leaf_dims(m, k, n, depth)
    item = _acc_dtype(dtype).itemsize
    return (lm * lk + lk * ln) * item, lm * ln * item


def leaf_bytes(m: int, k: int, n: int, depth: int, dtype) -> int:
    """Device bytes one leaf multiply needs: A + B operands + C product.

    See :func:`_leaf_inout_bytes` for the staging-dtype sizing convention;
    :func:`pipelined_leaf_bytes` for the async pipeline's per-slot peak.
    """
    i, o = _leaf_inout_bytes(m, k, n, depth, dtype)
    return i + o


def pipelined_leaf_bytes(m: int, k: int, n: int, depth: int, dtype) -> int:
    """Device bytes one leaf *slot* occupies at the async pipeline's peak.

    While wave k computes, the 2-deep pipeline concurrently holds, per
    slot: wave k's full working set (A + B + C), wave k-1's full working
    set — its products are not yet fetched and its operands may still be
    read by its leaf multiplies until the D2H fence — and wave k+1's
    prefetched operands (A + B). That is ``2 * leaf_bytes`` plus one more
    set of operand bytes; sizing waves (and picking depths) at this slot
    makes the device budget a bound on actual residency, not just the
    quiescent single-wave state.
    """
    i, o = _leaf_inout_bytes(m, k, n, depth, dtype)
    return 2 * (i + o) + i


def min_depth_for_budget(
    m: int,
    k: int,
    n: int,
    budget_bytes: int,
    dtype,
    max_depth: int = 12,
    *,
    pipelined: bool = False,
) -> int:
    """Smallest recursion depth whose leaf working set fits the budget.

    ``pipelined=False`` (feasibility): one leaf's (A, B, C) resident — the
    scheduler can always run, degrading to un-prefetched single-leaf waves.
    ``pipelined=True`` (the async wave pipeline's peak): a leaf slot plus
    its in-flight neighbours, i.e. :func:`pipelined_leaf_bytes`; depths
    chosen this way keep the 2-deep pipeline enabled instead of silently
    falling back to synchronous staging.
    """
    size = pipelined_leaf_bytes if pipelined else leaf_bytes
    for depth in range(1, max_depth + 1):
        if size(m, k, n, depth, dtype) <= budget_bytes:
            return depth
    raise ValueError(
        f"no depth <= {max_depth} fits ({m}x{k}x{n}, {_dtype_name(dtype)}) "
        f"leaves into {budget_bytes} bytes"
        + (" with pipeline headroom" if pipelined else "")
    )


@dataclasses.dataclass
class OotStats:
    """Execution telemetry for one out-of-core multiply.

    ``wave_events`` holds one record per staging wave with timestamps
    (seconds since the run started, on the host clock) for the pipeline's
    three phases: ``issue_start``/``issue_end`` (operands filled into the
    pinned ring and their H2D copies issued), ``dispatch_end`` (leaf
    multiplies issued, not fenced), and ``fetch_start``/``fetch_end`` (the
    D2H fence + host combine write). ``overlap_efficiency`` derives from
    them: the fraction of total transfer time (staging + fetch) issued while
    another wave's compute was in flight — with the 2-deep pipeline only
    the first wave's staging and the last wave's fetch are exposed, so any
    forced multi-wave run reports a strictly positive value; a synchronous
    run (``prefetch=False``) reports 0.0.
    """

    m: int
    k: int
    n: int
    depth: int
    scheme: str
    leaves: int
    waves: int
    wave_size: int
    prefetch: bool
    stage_dtype: str
    budget_bytes: int
    per_leaf_bytes: int
    peak_device_bytes: int
    # The plan's operator ("matmul" | "inverse" | "solve"): rings mix runs
    # from every recursive plan, so consumers filter/attribute by op.
    op: str = "matmul"
    # Nested out-of-core multiplies a solver run spawned (0 for matmul runs).
    oot_runs: int = 0
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    host_store_peak_bytes: int = 0
    divide_s: float = 0.0
    leaf_s: float = 0.0
    combine_s: float = 0.0
    total_s: float = 0.0
    stage_s: float = 0.0
    fetch_s: float = 0.0
    overlap_efficiency: float = 0.0
    wave_events: List[dict] = dataclasses.field(default_factory=list)
    # Fault-tolerance telemetry. ``rung`` is the degradation-ladder rung the
    # run finally completed on; ``degrade_events`` records each transition.
    # ``unrecovered_faults`` counts lineage recomputes that failed the
    # put-time checksum replay. ``injected_faults`` is cumulative across
    # ladder rungs (the flaky-leaf shim's call counter spans attempts).
    rung: str = "pipeline"
    degrades: int = 0
    degrade_events: List[dict] = dataclasses.field(default_factory=list)
    leaf_retries: int = 0
    recovered_blocks: int = 0
    lost_blocks: int = 0
    corrupt_blocks: int = 0
    injected_faults: int = 0
    unrecovered_faults: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def assert_within_budget(self) -> None:
        """Raise if the modeled pipelined peak exceeded the device budget."""
        if self.peak_device_bytes > self.budget_bytes:
            raise AssertionError(
                f"peak device bytes {self.peak_device_bytes} exceeded the "
                f"budget {self.budget_bytes} (waves={self.waves}, "
                f"wave_size={self.wave_size}, prefetch={self.prefetch})"
            )

    def finalize_overlap(self) -> None:
        """Derive ``overlap_efficiency`` from the per-wave timestamps."""
        total = sum(
            (e["issue_end"] - e["issue_start"]) + (e["fetch_end"] - e["fetch_start"])
            for e in self.wave_events
        )
        if not self.prefetch or len(self.wave_events) < 2 or total <= 0.0:
            self.overlap_efficiency = 0.0
            return
        first, last = self.wave_events[0], self.wave_events[-1]
        exposed = (first["issue_end"] - first["issue_start"]) + (
            last["fetch_end"] - last["fetch_start"]
        )
        self.overlap_efficiency = max(0.0, min(1.0, 1.0 - exposed / total))


class OotStatsRing:
    """Bounded, thread-safe ring of recent OotStats dicts (oldest first).

    Every completed out-of-core run is appended to **all** registered
    rings. The module keeps one default ring behind ``recent_oot_stats()``
    / ``reset_oot_stats()``; consumers that must not observe (or clobber)
    each other — two serving Engines — attach their own via
    :func:`attach_stats_ring` and read/clear only that.
    """

    def __init__(self, maxlen: int = 64) -> None:
        self.maxlen = maxlen
        self._lock = threading.Lock()
        self._items: List[dict] = []

    def append(self, item: dict) -> None:
        with self._lock:
            self._items.append(item)
            if len(self._items) > self.maxlen:
                del self._items[: len(self._items) - self.maxlen]

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._items)

    def clear(self) -> None:
        with self._lock:
            self._items.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


# The default ring plus any attached consumer rings. WeakSet: an Engine's
# ring unregisters when the engine is collected.
_DEFAULT_RING = OotStatsRing()
_RINGS: "weakref.WeakSet[OotStatsRing]" = weakref.WeakSet([_DEFAULT_RING])
_RINGS_LOCK = threading.Lock()


def attach_stats_ring(maxlen: int = 64) -> OotStatsRing:
    """New consumer-owned ring, subscribed to every future run's stats.

    The caller must hold the returned ring (registration is weak);
    clearing it does not disturb the default ring or other consumers.
    """
    ring = OotStatsRing(maxlen)
    with _RINGS_LOCK:
        _RINGS.add(ring)
    return ring


def recent_oot_stats() -> List[dict]:
    """Stats dicts of this process's recent out-of-core runs (oldest first)."""
    return _DEFAULT_RING.snapshot()


def reset_oot_stats() -> None:
    """Clear the **default** ring only; attached rings are unaffected."""
    _DEFAULT_RING.clear()


def _record_run(stats: OotStats) -> None:
    d = stats.to_dict()
    with _RINGS_LOCK:
        rings = list(_RINGS)
    for ring in rings:
        ring.append(d)


class _RunTrackingStore(BlockStore):
    """Forwards to a caller-provided store, recording the keys this run put.

    Tags are not run-scoped, so a failing run must delete exactly the
    blocks *it* created — a tag-prefix sweep would also destroy the blocks
    of other (interleaved or earlier) scheduler runs sharing the store.
    """

    def __init__(self, inner: BlockStore) -> None:
        self.inner = inner
        self.created: set = set()

    def put(self, key, block) -> None:
        self.inner.put(key, block)
        self.created.add(key)

    def get(self, key):
        return self.inner.get(key)

    def delete(self, key) -> None:
        self.inner.delete(key)
        self.created.discard(key)

    def __contains__(self, key) -> bool:
        return key in self.inner

    def keys(self):
        return self.inner.keys()

    def nbytes(self) -> int:
        return self.inner.nbytes()

    def drop_created(self) -> None:
        """Delete every block this run created and has not already freed."""
        for key in list(self.created):
            self.inner.delete(key)
        self.created.clear()

    def close(self) -> None:  # the caller owns the inner store
        pass


class _Link:
    """The host<->device transfers of one scheduler attempt.

    On the CPU an operand is staged as a fresh tensor and a product fetched
    as itself. On a CUDA device:

    * **H2D**: each operand is filled into the next buffer of a ring of
      pinned host buffers (one per in-flight operand slot; a buffer is
      refilled only after its last copy's event has completed) and copied
      with ``copy_(non_blocking=True)`` on the H2D stream into a device
      tensor allocated there. An event recorded after a leaf's two copies
      is what the compute stream waits on before the leaf multiply, and the
      operands are ``record_stream``-ed on the compute stream.
    * **D2H**: a wave's products are copied on the D2H stream, after the
      event recorded behind that wave's multiplies (so the copies overlap
      the next wave's), into pinned buffers, each copy followed by an event; :meth:`fence` waits on that event (the
      pipeline's only blocking wait) and copies the product out of the
      pinned buffer before the buffer can be reused.

    :meth:`close` synchronizes all three streams before the pinned buffers
    and device tensors are released, on success and on failure alike.
    """

    def __init__(self, device: torch.device, *, in_slots: int, out_slots: int) -> None:
        self.device = device
        self.cuda = device.type == "cuda"
        self.in_slots = in_slots
        self.out_slots = out_slots
        self._in: List[torch.Tensor] = []
        self._in_events: List[Optional[torch.cuda.Event]] = []
        self._next_in = 0
        self._out: List[torch.Tensor] = []
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.h2d = torch.cuda.Stream(device)
            self.d2h = torch.cuda.Stream(device)

    @staticmethod
    def _pinned(pool: List[torch.Tensor], idx: int, nbytes: int) -> torch.Tensor:
        while len(pool) <= idx:
            pool.append(torch.empty(0, dtype=torch.uint8))
        if pool[idx].numel() < nbytes:
            pool[idx] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return pool[idx]

    def _take_in(self, shape: Tuple[int, int], dtype: torch.dtype) -> Tuple[int, torch.Tensor]:
        slot = self._next_in % self.in_slots
        self._next_in += 1
        while len(self._in_events) <= slot:
            self._in_events.append(None)
        if self._in_events[slot] is not None:
            self._in_events[slot].synchronize()  # its last copy has left the buffer
        nbytes = shape[0] * shape[1] * dtype.itemsize
        buf = self._pinned(self._in, slot, nbytes)
        return slot, buf[:nbytes].view(dtype).view(shape)

    def stage(self, na: BlockMatrix, nb: BlockMatrix, stage_dtype: torch.dtype):
        """(A, B, ready event) of one leaf on the device. Any rounding to a
        narrower staging dtype happens here, at the host->device boundary."""
        if not self.cuda:
            return na.to_dense().to(stage_dtype), nb.to_dense().to(stage_dtype), None
        slots, devs = [], []
        for node in (na, nb):
            slot, host = self._take_in(node.padded_shape, stage_dtype)
            node.to_dense(out=host)
            slots.append(slot)
            with torch.cuda.stream(self.h2d):
                dev = torch.empty(host.shape, dtype=stage_dtype, device=self.device)
                dev.copy_(host, non_blocking=True)
            devs.append(dev)
        ready = torch.cuda.Event()
        ready.record(self.h2d)
        for slot in slots:
            self._in_events[slot] = ready
        for dev in devs:
            dev.record_stream(self.compute)
        return devs[0], devs[1], ready

    def mul(self, fn, a_dev, b_dev, ready):
        """The leaf multiply on the compute stream, once its operands landed."""
        if ready is not None:
            self.compute.wait_event(ready)
        return fn(a_dev, b_dev)

    def computed(self) -> Optional[torch.cuda.Event]:
        """An event marking the leaf multiplies issued so far (one wave's)."""
        if not self.cuda:
            return None
        done = torch.cuda.Event()
        done.record(self.compute)
        return done

    def start_fetch(self, outs: List[torch.Tensor], done: Optional[torch.cuda.Event]) -> list:
        """Issue the D2H copies of one wave's products, which wait only on that
        wave's ``done`` event (not on later waves' multiplies); returns their
        handles."""
        if not self.cuda:
            return [(out, None) for out in outs]
        if len(outs) > self.out_slots:
            raise ValueError(f"{len(outs)} products for {self.out_slots} pinned buffers")
        handles = []
        with torch.cuda.stream(self.d2h):
            self.d2h.wait_event(done)
            for idx, out in enumerate(outs):
                nbytes = out.numel() * out.element_size()
                host = self._pinned(self._out, idx, nbytes)[:nbytes].view(out.dtype).view(out.shape)
                host.copy_(out, non_blocking=True)
                landed = torch.cuda.Event()
                landed.record(self.d2h)
                out.record_stream(self.d2h)
                handles.append((host, landed))
        return handles

    def fence(self, handle, acc_dtype: torch.dtype) -> torch.Tensor:
        """Wait until one product is on the host; returns a host tensor the
        caller owns, in ``acc_dtype``."""
        host, landed = handle
        if landed is None:
            return host.to(acc_dtype)
        landed.synchronize()
        return host.to(acc_dtype, copy=True)

    def roundtrip(self, fn, a_host: torch.Tensor, b_host: torch.Tensor, acc_dtype) -> torch.Tensor:
        """One leaf, synchronously: the lineage replay and the fence-time redo.

        The same kernel on the same (compute) stream as the waves, so the
        product is bit-identical to the wave's.
        """
        if not self.cuda:
            return fn(a_host, b_host).to(acc_dtype)
        out = fn(a_host.to(self.device), b_host.to(self.device))
        return out.to("cpu").to(acc_dtype)

    def close(self) -> None:
        """Wait for every copy and multiply of the attempt, then drop the buffers."""
        if self.cuda:
            self.h2d.synchronize()
            self.d2h.synchronize()
            self.compute.synchronize()
        self._in.clear()
        self._in_events.clear()
        self._out.clear()


class PlanScheduler:
    """Budgeted level-order executor for one bilinear recursive plan.

    The waves/budget/pipeline/degradation machinery below is operator
    agnostic: divide rows, combine rows, rank, tag prefixes, and the op
    label all come from a :class:`repro_torch.blocks.plan.BilinearPlan`.
    The Strassen base-7 and naive base-4 multiplies are the first
    registered plans.

    Args:
      depth: recursion depth q (rank^q leaves). Must make a leaf fit the
        budget — see :func:`min_depth_for_budget`.
      budget_bytes: peak device bytes the leaf waves may occupy.
      scheme: coefficient scheme (strassen | winograd | naive8) — the
        historical spelling of ``plan`` for matmul plans.
      plan: the :class:`~repro_torch.blocks.plan.BilinearPlan` to walk (or
        its registry name). Overrides ``scheme`` when given.
      backend: :class:`repro_torch.core.backend.MatmulBackend` routing for
        the leaf multiplies; defaults to ``kind="auto"`` so each leaf shape
        goes through the calibrated dispatcher. A kind-auto leaf is resolved
        (and the device calibrated, on first use) before the run's root
        span, never inside a wave.
      block: target block side for the store partition; ``None`` stores
        one block per leaf operand (the coarsest legal grain).
      prefetch: run the leaf waves as a 2-deep asynchronous pipeline —
        wave k+1's staging and dispatch are issued while wave k's products
        are still in flight, and the only blocking fence is each wave's D2H
        fetch. Automatically disabled (fully synchronous stage -> compute ->
        fetch per wave) when the budget cannot hold a pipelined slot
        (:func:`pipelined_leaf_bytes`).
      stage_dtype: dtype of the staged leaf operands (and so of the leaf
        multiply). ``None`` — the default — stages in the accumulation
        dtype (f32 for bf16 inputs): operand combos never round until the
        final output cast, which holds deep-recursion bf16 parity to ~1e-3.
        Pass the compute dtype explicitly to halve staging volume at the
        cost of one rounding per leaf operand.
      chaos: deterministic fault injection
        (:class:`repro_torch.blocks.recovery.ChaosConfig`): seeded block
        drop/corrupt probabilities on the store and flaky-leaf dispatch
        failures. Injection implies ``recovery`` unless explicitly disabled.
      recovery: wrap the run's store in a
        :class:`~repro_torch.blocks.recovery.RecoveringStore` (checksum on
        put, verify on get, transparent lineage recompute on loss or
        corruption). ``None`` (default) enables it exactly when ``chaos``
        is set.
      retries: bounded retry count per leaf multiply (exponential backoff
        from ``retry_backoff_s``). Device-OOM is never retried — it goes
        straight to the degradation ladder.
      retry_backoff_s: first retry's sleep; doubles per attempt.
      degrade: on an unrecovered fault or device-OOM, walk the degradation
        ladder instead of failing the multiply: async pipeline ->
        synchronous staging -> halved wave -> one level deeper recursion.
        Each transition is a ``fault.degrade`` span/counter and lands in
        ``OotStats.degrade_events``.
      device: where the leaves run: ``"cuda"`` (the default) or ``"cpu"``.
        A CUDA device with no card raises.
    """

    def __init__(
        self,
        *,
        depth: int,
        budget_bytes: int,
        scheme: Scheme | str = "strassen",
        plan: "BilinearPlan | str | None" = None,
        backend=None,
        block: Optional[int] = None,
        prefetch: bool = True,
        stage_dtype=None,
        chaos: Optional[ChaosConfig] = None,
        recovery: Optional[bool] = None,
        retries: int = 2,
        retry_backoff_s: float = 0.05,
        degrade: bool = True,
        device="cuda",
    ) -> None:
        if depth < 1:
            raise ValueError("out-of-core recursion needs depth >= 1")
        if budget_bytes <= 0:
            raise ValueError("budget_bytes must be positive")
        if retries < 0 or retry_backoff_s < 0:
            raise ValueError("retries and retry_backoff_s must be >= 0")
        self.depth = depth
        self.budget_bytes = int(budget_bytes)
        self.plan = as_bilinear_plan(plan if plan is not None else scheme)
        if self.plan.leaf_kind != "matmul":
            raise ValueError(
                f"plan {self.plan.name!r} has leaf kind "
                f"{self.plan.leaf_kind!r}; the wave scheduler executes "
                f"matmul-leaf bilinear plans (dataflow plans run on "
                f"repro_torch.blocks.solve)"
            )
        self.scheme = self.plan.scheme
        self.block = block
        self.prefetch = prefetch
        self.stage_dtype = None if stage_dtype is None else as_dtype(stage_dtype)
        self.chaos = chaos
        self.recovery = (chaos is not None) if recovery is None else bool(recovery)
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.degrade = degrade
        self.device = resolve_device(device)
        if backend is None:
            from repro_torch.core.backend import MatmulBackend

            backend = MatmulBackend(kind="auto", depth=2, min_dim=1024)
        self.backend = backend

    # ------------------------------------------------------------ internals
    @staticmethod
    def _node_tag(op: str, path: Tuple[int, ...]) -> str:
        return f"{op}:{tags.to_string(path)}"

    def _node(
        self,
        store: BlockStore,
        op: str,
        path: Tuple[int, ...],
        root_shape: Tuple[int, int],
        block_shape: Tuple[int, int],
        dtype,
    ) -> BlockMatrix:
        level = len(path)
        shape = (root_shape[0] >> level, root_shape[1] >> level)
        return BlockMatrix(store, shape, block_shape, dtype, self._node_tag(op, path))

    @staticmethod
    def _signed_sum(get_block, coefs, acc_dtype) -> torch.Tensor:
        """Delegates to :func:`repro_torch.blocks.blockmatrix.signed_block_sum`.

        Shared with lineage recompute (:mod:`repro_torch.blocks.recovery`):
        recovery is bit-exact precisely because both run the same loop.
        """
        return signed_block_sum(get_block, coefs, acc_dtype)

    def _retry_leaf(self, fn, stats: "OotStats", mx):
        """Run one leaf multiply with bounded retry + exponential backoff.

        Only fault-typed failures (:class:`FaultError` — the chaos shim, a
        flaky backend) retry, up to ``self.retries`` times. Device-OOM
        raises immediately — re-issuing the identical allocation cannot
        succeed, only the degradation ladder can. Unknown exceptions also
        propagate untouched.
        """
        from repro_torch.core.backend import is_oom_error

        delay = self.retry_backoff_s
        for attempt in range(self.retries + 1):
            try:
                return fn()
            except Exception as e:
                if (
                    is_oom_error(e)
                    or not isinstance(e, FaultError)
                    or attempt >= self.retries
                ):
                    raise
                stats.leaf_retries += 1
                mx.counter("fault.retries").inc()
                mx.counter(f"fault.retries.{self.plan.op}").inc()
                if delay > 0:
                    time.sleep(delay)
                delay = min(delay * 2, 2.0)

    def _divide_child(
        self,
        parent: BlockMatrix,
        child: BlockMatrix,
        coef_row,
        acc_dtype,
    ) -> None:
        """child = sum_q coef_row[q] * quadrant_q(parent), block-streamed."""
        gr, gc = child.grid
        for i in range(gr):
            for j in range(gc):
                acc = self._signed_sum(
                    lambda q: parent.block((q // 2) * gr + i, (q % 2) * gc + j),
                    coef_row, acc_dtype,
                )
                child.put_block(i, j, acc)

    def _combine_parent(
        self,
        children: Sequence[BlockMatrix],
        parent: BlockMatrix,
        acc_dtype,
    ) -> None:
        """parent quadrants = sum_p c_coef[k, p] * child_p, block-streamed."""
        gr, gc = children[0].grid
        c_coef = self.plan.combine_coef
        for kq in range(tags.Q_BASE):
            for i in range(gr):
                for j in range(gc):
                    acc = self._signed_sum(
                        lambda p: children[p].block(i, j), c_coef[kq], acc_dtype
                    )
                    parent.put_block((kq // 2) * gr + i, (kq % 2) * gc + j, acc)

    def _leaf_matmul(self, a_dev, b_dev):
        from repro_torch.core import backend as _backend

        return _backend.matmul(a_dev, b_dev, self.backend, site="blocks.leaf")

    def _fetch(self, link: _Link, handle, acc_dtype) -> torch.Tensor:
        """The D2H fence of one leaf product (the pipeline's only blocking wait)."""
        return link.fence(handle, acc_dtype)

    def _resolve_leaf(self, lm: int, lk: int, ln: int, stage_dtype: torch.dtype) -> None:
        """Resolve a kind-auto leaf backend for the leaf shape now, so that the
        device's calibration (on its first use) and the decision run before
        the waves, not inside the first timed, pipelined one."""
        if getattr(self.backend, "kind", None) != "auto":
            return
        from repro_torch.core import autotune
        from repro_torch.core import backend as _backend

        _backend.resolve_auto(
            lm, lk, ln, autotune.dtype_name(stage_dtype), self.backend, "blocks.leaf",
            self.device.type,
        )

    # -------------------------------------------------------------- the run
    def matmul(
        self,
        a,
        b,
        *,
        store: str | BlockStore = "dict",
        store_root: Optional[str] = None,
    ) -> Tuple[torch.Tensor, OotStats]:
        """``a @ b`` with device memory bounded by the budget.

        ``a``/``b`` are tensors on any device (brought to the host) or numpy
        arrays. ``store`` picks the block residency: 'dict' | 'arena' |
        'memmap' or a ready :class:`BlockStore`. Returns a CPU tensor.

        Runs the graceful-degradation ladder: the configured mode first,
        then — on an unrecovered fault (retries exhausted, lineage
        recompute impossible) or device-OOM — synchronous staging, a
        halved wave, and finally one level deeper recursion. Every rung
        transition is a ``fault.degrade`` counter + instant span; the
        returned stats carry the completed rung and the transition log.
        Anything that is not a fault/OOM propagates unchanged from the
        first attempt.
        """
        from repro_torch.core.backend import is_oom_error

        a = as_host_tensor(a)
        b = as_host_tensor(b)
        # One flaky-leaf shim across the whole ladder: its dispatch-call
        # counter spans attempts, so "fail the Nth leaf multiply" windows
        # pass and the ladder can make progress.
        flaky = None
        if self.chaos is not None and self.chaos.injects_leaf_faults:
            flaky = FlakyLeaf(
                fail_calls=self.chaos.fail_leaf_calls,
                fail_rate=self.chaos.leaf_fail_rate,
                seed=self.chaos.seed + 1,
            )
        rungs: List[Tuple[str, dict]] = []
        if self.prefetch:
            rungs.append(
                ("pipeline", dict(prefetch=True, wave_scale=1.0, depth=self.depth))
            )
        rungs.append(("sync", dict(prefetch=False, wave_scale=1.0, depth=self.depth)))
        rungs.append(
            ("halved-wave", dict(prefetch=False, wave_scale=0.5, depth=self.depth))
        )
        rungs.append(
            ("deeper", dict(prefetch=False, wave_scale=0.5, depth=self.depth + 1))
        )
        if not self.degrade:
            rungs = rungs[:1]
        tr = obs_tracer.get_tracer()
        mx = obs_metrics.get_metrics()
        degrade_log: List[dict] = []
        for idx, (name, overrides) in enumerate(rungs):
            try:
                result, stats = self._attempt(
                    a, b, store=store, store_root=store_root, flaky=flaky,
                    **overrides,
                )
            except Exception as e:
                recoverable = isinstance(e, FaultError) or is_oom_error(e)
                if idx == len(rungs) - 1 or not recoverable:
                    raise
                nxt = rungs[idx + 1][0]
                mx.counter("fault.degrade").inc()
                mx.counter(f"fault.degrade.{self.plan.op}").inc()
                tr.event(
                    "fault.degrade", cat="fault", op=self.plan.op,
                    rung_from=name, rung_to=nxt, cause=type(e).__name__,
                )
                degrade_log.append(
                    {"from": name, "to": nxt, "cause": f"{type(e).__name__}: {e}"[:200]}
                )
                continue
            stats.rung = name
            stats.degrades = len(degrade_log)
            stats.degrade_events = degrade_log
            _record_run(stats)
            return result, stats
        raise AssertionError("degradation ladder must return or raise")

    def _attempt(
        self,
        a: torch.Tensor,
        b: torch.Tensor,
        *,
        store: str | BlockStore,
        store_root: Optional[str],
        depth: int,
        prefetch: bool,
        wave_scale: float,
        flaky: Optional[FlakyLeaf],
    ) -> Tuple[torch.Tensor, OotStats]:
        """One run of the level-order executor at a fixed ladder rung."""
        # Spans are the run's single timing source: OotStats (wave_events,
        # phase splits, overlap_efficiency) is DERIVED from them. When the
        # process tracer is exporting, the spans land there; otherwise a
        # throwaway run-local tracer carries them just far enough to
        # populate the stats.
        tr = obs_tracer.get_tracer()
        if not tr.enabled:
            tr = obs_tracer.Tracer(enabled=True)
        mx = obs_metrics.get_metrics()
        if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(f"bad matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
        dtype = torch.promote_types(a.dtype, b.dtype)
        acc_dtype = _acc_dtype(dtype)
        m, k = a.shape
        n = b.shape[1]
        rank = self.plan.rank
        a_name, b_name = self.plan.operands
        c_name = self.plan.result
        a_rows = self.plan.divide_coef[a_name]
        b_rows = self.plan.divide_coef[b_name]

        # Recursion-aligned padded dims and the block partition. With an
        # explicit block grain each leaf dim rounds up to a whole number of
        # blocks so every level's grid halves exactly.
        lm, lk, ln = _leaf_dims(m, k, n, depth)
        if self.block is not None:
            bam = min(self.block, lm)
            bak = min(self.block, lk)
            bbn = min(self.block, ln)
            lm, lk, ln = (
                _ceil_div(lm, bam) * bam,
                _ceil_div(lk, bak) * bak,
                _ceil_div(ln, bbn) * bbn,
            )
        else:
            bam, bak, bbn = lm, lk, ln
        pm, pk, pn = lm << depth, lk << depth, ln << depth

        stage_dtype = self.stage_dtype if self.stage_dtype is not None else acc_dtype
        itemsize = stage_dtype.itemsize
        in_bytes = (lm * lk + lk * ln) * itemsize
        out_bytes = lm * ln * itemsize
        per_leaf = in_bytes + out_bytes
        # Pipelined wave slot: 2 * per_leaf + in_bytes (pipelined_leaf_bytes).
        wave_size = self.budget_bytes // (2 * per_leaf + in_bytes) if prefetch else 0
        if wave_size < 1:
            prefetch = False
            wave_size = self.budget_bytes // per_leaf
        if wave_size < 1:
            raise ValueError(
                f"device budget {self.budget_bytes} B cannot hold one "
                f"{lm}x{lk}x{ln} {_dtype_name(dtype)} leaf ({per_leaf} B); "
                f"use depth >= "
                f"{min_depth_for_budget(m, k, n, self.budget_bytes, dtype)}"
            )
        if wave_scale != 1.0:
            # Degradation rung: shrink waves below what the budget allows
            # (never below one leaf).
            wave_size = max(1, int(wave_size * wave_scale))

        # Divide/combine chains accumulate (and store) in acc_dtype; blocks
        # round at most once — operands at the staging cast, C at the final
        # cast. Leaf compute and H2D/D2H volume run at ``stage_dtype``.
        acc_item = acc_dtype.itemsize
        slot_bytes = max(bam * bak, bak * bbn, bam * bbn) * acc_item
        self._resolve_leaf(lm, lk, ln, stage_dtype)
        # Stores built here from a spec are owned (and closed) here;
        # caller-provided stores stay open and may be shared across runs, so
        # this run's puts are tracked and the failure path deletes only
        # those. Layering, bottom up: base store -> run tracking -> chaos
        # injection (faults must hit the raw bytes) -> recovering wrapper.
        owned_store = not isinstance(store, BlockStore)
        base = make_store(store, slot_bytes=slot_bytes, root=store_root)
        inner: BlockStore = base
        tracking: Optional[_RunTrackingStore] = None
        if not owned_store:
            tracking = _RunTrackingStore(inner)
            inner = tracking
        chaos_store: Optional[ChaosStore] = None
        if self.chaos is not None and self.chaos.injects_store_faults:
            chaos_store = ChaosStore(
                inner,
                drop=self.chaos.drop,
                corrupt=self.chaos.corrupt,
                seed=self.chaos.seed,
            )
            inner = chaos_store
        # Two waves of operands may be in their H2D copies at once (the one
        # computing and the prefetched one); one wave of products is fetched
        # at a time.
        link = _Link(
            self.device, in_slots=2 * wave_size * (2 if prefetch else 1), out_slots=wave_size
        )
        recovering: Optional[RecoveringStore] = None
        if self.recovery:

            def lineage_leaf(a_host: torch.Tensor, b_host: torch.Tensor) -> torch.Tensor:
                # Replays one leaf through the same device path the waves
                # use, so a recomputed leaf product is bit-identical. Runs
                # only while the device is otherwise idle (divide/combine).
                return link.roundtrip(self._leaf_matmul, a_host, b_host, stage_dtype)

            lineage = Lineage(
                scheme=self.scheme, plan=self.plan, depth=depth, a=a, b=b,
                pm=pm, pk=pk, pn=pn, bam=bam, bak=bak, bbn=bbn,
                acc_dtype=acc_dtype, stage_dtype=stage_dtype,
                leaf_matmul=lineage_leaf,
            )
            recovering = RecoveringStore(inner, lineage)
            inner = recovering
        store = inner
        root_span = tr.begin(
            f"oot.{self.plan.op}", cat="oot", op=self.plan.op,
            m=m, k=k, n=n, depth=depth, scheme=self.scheme.name,
            budget_bytes=self.budget_bytes,
        )
        t_start = root_span.t0
        # Device tensors in flight per wave index — defined out here so the
        # failure path can release them after the streams are synchronized.
        in_flight: dict = {}
        try:
            leaves = rank**depth
            stats = OotStats(
                m=m, k=k, n=n, depth=depth, scheme=self.scheme.name,
                op=self.plan.op,
                leaves=leaves, waves=0, wave_size=wave_size, prefetch=prefetch,
                stage_dtype=_dtype_name(stage_dtype),
                budget_bytes=self.budget_bytes, per_leaf_bytes=per_leaf,
                peak_device_bytes=0,
            )

            # --- ingest roots (edge/odd dims zero-extend to the padded grain).
            a_root = BlockMatrix.from_dense(
                a, (bam, bak), store, self._node_tag(a_name, ()), shape=(pm, pk)
            )
            b_root = BlockMatrix.from_dense(
                b, (bak, bbn), store, self._node_tag(b_name, ()), shape=(pk, pn)
            )

            # --- divide: level-order, all rank^level nodes per level. One
            # span per level, one tag-addressed span per tree node.
            div_span = tr.begin("oot.divide", cat="oot")
            for level in range(depth):
                p_dtype = dtype if level == 0 else acc_dtype
                with tr.span(
                    f"divide.L{level + 1}", cat="oot",
                    level=level + 1, nodes=rank ** (level + 1),
                ):
                    for path in tags.leaf_paths(level, rank):
                        with tr.span(
                            "divide.node", cat="oot",
                            tag=tags.to_string(path), level=level,
                        ):
                            pa = self._node(
                                store, a_name, path, (pm, pk), (bam, bak), p_dtype
                            )
                            pb = self._node(
                                store, b_name, path, (pk, pn), (bak, bbn), p_dtype
                            )
                            for p in range(rank):
                                ca = self._node(
                                    store, a_name, tags.child(path, p, rank),
                                    (pm, pk), (bam, bak), acc_dtype,
                                )
                                cb = self._node(
                                    store, b_name, tags.child(path, p, rank),
                                    (pk, pn), (bak, bbn), acc_dtype,
                                )
                                self._divide_child(pa, ca, a_rows[p], acc_dtype)
                                self._divide_child(pb, cb, b_rows[p], acc_dtype)
                    stats.host_store_peak_bytes = max(
                        stats.host_store_peak_bytes, store.nbytes()
                    )
                    # Parents are consumed: only the leaf level feeds the
                    # multiply.
                    for path in tags.leaf_paths(level, rank):
                        self._node(
                            store, a_name, path, (pm, pk), (bam, bak), p_dtype
                        ).free()
                        self._node(
                            store, b_name, path, (pk, pn), (bak, bbn), p_dtype
                        ).free()
            tr.end(div_span)
            stats.divide_s = div_span.duration
            stats.host_store_peak_bytes = max(stats.host_store_peak_bytes, store.nbytes())

            # --- leaf waves: a 2-deep async pipeline over stage -> dispatch
            # -> fetch. Iteration k issues wave k's leaf multiplies, stages
            # wave k+1's operands (pinned ring, H2D stream) while wave k
            # computes, and only THEN drains wave k-1 — so the pipeline's one
            # blocking fence (the D2H event) overlaps the in-flight compute
            # instead of serializing behind it.
            leaf_span = tr.begin(
                "oot.leaf_waves", cat="oot",
                waves=_ceil_div(leaves, wave_size), wave_size=wave_size,
                prefetch=prefetch,
            )
            leaf_list = list(tags.leaf_paths(depth, rank))
            waves: List[List[Tuple[int, ...]]] = [
                leaf_list[i : i + wave_size] for i in range(0, leaves, wave_size)
            ]
            # Per-wave phase spans on dedicated tracks, so the exported trace
            # shows the pipeline's overlap as concurrent lanes.
            wave_spans: Dict[int, Dict[str, obs_tracer.Span]] = {}

            def leaf_nodes(path):
                na = self._node(store, a_name, path, (pm, pk), (bam, bak), acc_dtype)
                nb = self._node(store, b_name, path, (pk, pn), (bak, bbn), acc_dtype)
                return na, nb

            def stage(w_idx: int):
                wsp = tr.begin(
                    "wave.stage", cat="oot", track="oot.stage",
                    wave=w_idx, size=len(waves[w_idx]),
                )
                staged = []
                refs = in_flight.setdefault(w_idx, [])
                for path in waves[w_idx]:
                    with tr.span(
                        "leaf.stage", cat="oot", tag=tags.to_string(path),
                        track="oot.stage", wave=w_idx, h2d_bytes=in_bytes,
                    ):
                        a_dev, b_dev, ready = link.stage(*leaf_nodes(path), stage_dtype)
                    refs.extend((a_dev, b_dev))
                    staged.append((path, a_dev, b_dev, ready))
                    stats.h2d_bytes += in_bytes
                tr.end(wsp)
                wave_spans.setdefault(w_idx, {})["stage"] = wsp
                mx.counter("oot.h2d_bytes").inc(len(waves[w_idx]) * in_bytes)
                mx.histogram("oot.wave_stage_s").record(wsp.duration)
                return staged

            def dispatch(w_idx: int, staged):
                wsp = tr.begin(
                    "wave.dispatch", cat="oot", track="oot.dispatch", wave=w_idx
                )
                refs = in_flight[w_idx]
                outs = []
                for path, a_dev, b_dev, ready in staged:
                    with tr.span(
                        "leaf.mul", cat="oot", tag=tags.to_string(path),
                        track="oot.dispatch", wave=w_idx,
                    ):

                        def call(a_dev=a_dev, b_dev=b_dev, ready=ready):
                            # The chaos shim fails the dispatch the way a
                            # flaky backend would — before issue, so a
                            # retry is a genuinely fresh dispatch.
                            if flaky is not None:
                                flaky.check()
                            return link.mul(self._leaf_matmul, a_dev, b_dev, ready)

                        out = self._retry_leaf(call, stats, mx)
                    refs.append(out)
                    outs.append((path, out))
                # Multiplies issued: drop this wave's operand references.
                # Their memory returns to the allocator once the compute
                # stream has passed the multiplies (record_stream). Only on
                # success — a failing leaf leaves the full list for the
                # failure path.
                in_flight[w_idx] = [out for _, out in outs]
                tr.end(wsp)
                wave_spans.setdefault(w_idx, {})["dispatch"] = wsp
                return outs, link.computed()

            def drain(w_idx: int, outs, handles):
                wsp = tr.begin(
                    "wave.fetch", cat="oot", track="oot.fetch", wave=w_idx
                )
                wave_d2h = 0
                for (path, _), handle in zip(outs, handles):
                    with tr.span(
                        "leaf.fetch", cat="oot", tag=tags.to_string(path),
                        track="oot.fetch", wave=w_idx,
                    ) as lsp:
                        try:
                            host = self._fetch(link, handle, acc_dtype)  # the only fence
                        except Exception as fence_exc:
                            from repro_torch.core.backend import is_oom_error

                            if is_oom_error(fence_exc) or not isinstance(
                                fence_exc, FaultError
                            ):
                                # OOM goes to the ladder; unknown errors
                                # propagate (same policy as _retry_leaf).
                                raise
                            # A fault-typed failure surfaced at the fence.
                            # Replay this one leaf synchronously from the host
                            # blocks (still in the store until free() below) —
                            # reaching here already cost one attempt, so it
                            # counts as a retry before the bounded loop.
                            stats.leaf_retries += 1
                            mx.counter("fault.retries").inc()
                            mx.counter(f"fault.retries.{self.plan.op}").inc()

                            def redo(path=path):
                                if flaky is not None:
                                    flaky.check()
                                na, nb = leaf_nodes(path)
                                return link.roundtrip(
                                    self._leaf_matmul,
                                    na.to_dense().to(stage_dtype),
                                    nb.to_dense().to(stage_dtype),
                                    acc_dtype,
                                )

                            host = self._retry_leaf(redo, stats, mx)
                        nbytes = host.numel() * stage_dtype.itemsize
                        stats.d2h_bytes += nbytes
                        wave_d2h += nbytes
                        lsp.set(d2h_bytes=nbytes)
                        cn = self._node(
                            store, c_name, path, (pm, pn), (bam, bbn), acc_dtype
                        )
                        for i in range(cn.grid[0]):
                            for j in range(cn.grid[1]):
                                cn.put_block(
                                    i, j,
                                    host[
                                        i * bam : (i + 1) * bam,
                                        j * bbn : (j + 1) * bbn,
                                    ],
                                )
                        na, nb = leaf_nodes(path)
                        na.free()
                        nb.free()
                # Drop the wave's device references (products are on host).
                in_flight.pop(w_idx, None)
                tr.end(wsp)
                ws = wave_spans.setdefault(w_idx, {})
                ws["fetch"] = wsp
                # In-flight window: multiply issue -> D2H fence completion.
                # Parity lanes keep consecutive (overlapping) windows from
                # sharing a track.
                if "dispatch" in ws:
                    tr.add_span(
                        "wave.compute", ws["dispatch"].t1, wsp.t1, cat="oot",
                        track=f"oot.compute/{w_idx % 2}", parent=leaf_span,
                        wave=w_idx, size=len(waves[w_idx]),
                    )
                mx.counter("oot.d2h_bytes").inc(wave_d2h)
                mx.histogram("oot.wave_fetch_s").record(wsp.duration)
                stats.waves += 1
                stats.host_store_peak_bytes = max(
                    stats.host_store_peak_bytes, store.nbytes()
                )

            def fetch(outs, done):
                return link.start_fetch([out for _, out in outs], done)

            # (wave index, products, multiplies-done event) of the wave whose
            # fetch is still to come.
            pending: Optional[Tuple[int, list, object]] = None
            staged = stage(0) if (prefetch and waves) else None
            for w_idx, wave in enumerate(waves):
                current, staged = staged, None
                if current is None:  # prefetch off: stage synchronously
                    current = stage(w_idx)
                outs, done = dispatch(w_idx, current)
                current = None
                # Modeled concurrent peak this iteration: wave k's working
                # set + the previous wave's whole working set + the next
                # wave's prefetched operands — matching the wave sizing.
                device_now = len(wave) * per_leaf
                if pending is not None:
                    device_now += len(pending[1]) * per_leaf
                if prefetch and w_idx + 1 < len(waves):
                    device_now += len(waves[w_idx + 1]) * in_bytes
                stats.peak_device_bytes = max(stats.peak_device_bytes, device_now)
                if pending is not None:
                    # Issue wave k-1's D2H copies now, behind its own
                    # multiplies only, so that they run under wave k's.
                    p_idx, p_outs, p_done = pending
                    p_handles = fetch(p_outs, p_done)
                if prefetch and w_idx + 1 < len(waves):
                    # Stage the next wave's H2D while this wave's multiplies
                    # run: the host fills the pinned ring while the card
                    # computes wave k, and the copies run on their stream.
                    staged = stage(w_idx + 1)
                if pending is not None:
                    # D2H fence for wave k-1 while wave k is still in flight.
                    drain(p_idx, p_outs, p_handles)
                    pending = p_outs = p_handles = None
                if prefetch:
                    pending = (w_idx, outs, done)
                else:
                    drain(w_idx, outs, fetch(outs, done))
                outs = None
            if pending is not None:
                p_idx, p_outs, p_done = pending
                drain(p_idx, p_outs, fetch(p_outs, p_done))
            tr.end(leaf_span)
            stats.leaf_s = leaf_span.duration
            # Wave telemetry is DERIVED from the recorded spans (seconds
            # since run start); finalize_overlap() reads these.
            stats.wave_events = [
                {
                    "wave": i,
                    "size": len(waves[i]),
                    "issue_start": ws["stage"].t0 - t_start,
                    "issue_end": ws["stage"].t1 - t_start,
                    "dispatch_end": ws["dispatch"].t1 - t_start,
                    "fetch_start": ws["fetch"].t0 - t_start,
                    "fetch_end": ws["fetch"].t1 - t_start,
                }
                for i, ws in sorted(wave_spans.items())
            ]
            stats.stage_s = sum(ws["stage"].duration for ws in wave_spans.values())
            stats.fetch_s = sum(ws["fetch"].duration for ws in wave_spans.values())

            # --- combine: level-order bottom-up, freeing children as we go.
            comb_span = tr.begin("oot.combine", cat="oot")
            for level in reversed(range(depth)):
                with tr.span(
                    f"combine.L{level + 1}", cat="oot",
                    level=level + 1, nodes=rank**level,
                ):
                    for path in tags.leaf_paths(level, rank):
                        with tr.span(
                            "combine.node", cat="oot",
                            tag=tags.to_string(path), level=level,
                        ):
                            children = [
                                self._node(
                                    store, c_name, tags.child(path, p, rank),
                                    (pm, pn), (bam, bbn), acc_dtype,
                                )
                                for p in range(rank)
                            ]
                            parent = self._node(
                                store, c_name, path, (pm, pn), (bam, bbn), acc_dtype
                            )
                            self._combine_parent(children, parent, acc_dtype)
                            for child in children:
                                child.free()
                    stats.host_store_peak_bytes = max(
                        stats.host_store_peak_bytes, store.nbytes()
                    )
            tr.end(comb_span)
            stats.combine_s = comb_span.duration

            c_root = self._node(store, c_name, (), (pm, pn), (bam, bbn), acc_dtype)
            result = c_root.to_dense()[:m, :n].to(dtype)
            a_root.free()
            b_root.free()
            c_root.free()
        except BaseException:
            # A failing leaf matmul (or store error) mid-pipeline must not
            # leak the run's artifacts. Wait for every copy and multiply of
            # the attempt before its pinned buffers and device tensors are
            # released, then drop the references — the raised exception's
            # traceback pins this frame — and, for caller-provided stores,
            # drop exactly the blocks this run put.
            link.close()
            in_flight.clear()
            if tracking is not None:
                tracking.drop_created()
            # Close the root span (end() pops any children the unwind left
            # open) so the tracer's per-thread stack stays consistent.
            tr.end(root_span, failed=True)
            raise
        finally:
            if owned_store:
                base.close()
        link.close()
        # Fault telemetry: what the wrappers detected/healed this attempt
        # (retries were counted in place; injected counts are cumulative
        # for the flaky shim, whose call counter spans ladder rungs).
        if recovering is not None:
            stats.recovered_blocks = recovering.recovered_blocks
            stats.lost_blocks = recovering.lost_blocks
            stats.corrupt_blocks = recovering.corrupt_blocks
            stats.unrecovered_faults = recovering.recompute_mismatches
        if chaos_store is not None:
            stats.injected_faults += (
                chaos_store.injected_drops + chaos_store.injected_corruptions
            )
        if flaky is not None:
            stats.injected_faults += flaky.injected
        stats.total_s = tr.end(root_span).duration
        stats.finalize_overlap()
        root_span.set(
            overlap_efficiency=stats.overlap_efficiency,
            peak_device_bytes=stats.peak_device_bytes,
            h2d_bytes=stats.h2d_bytes,
            d2h_bytes=stats.d2h_bytes,
        )
        return result, stats


# The historical name: Strassen is simply the first registered plan this
# executor walks.
StrassenScheduler = PlanScheduler


def strassen_oot_matmul(
    a,
    b,
    *,
    depth: int,
    budget_bytes: int,
    scheme: Scheme | str = "strassen",
    plan: "BilinearPlan | str | None" = None,
    backend=None,
    block: Optional[int] = None,
    prefetch: bool = True,
    stage_dtype=None,
    store: str | BlockStore = "dict",
    store_root: Optional[str] = None,
    chaos: Optional[ChaosConfig] = None,
    recovery: Optional[bool] = None,
    retries: int = 2,
    retry_backoff_s: float = 0.05,
    degrade: bool = True,
    device="cuda",
) -> Tuple[torch.Tensor, OotStats]:
    """Functional wrapper: one out-of-core Strassen multiply.

    See :class:`PlanScheduler` for the parameters; this is the entry point
    :mod:`repro_torch.core.backend` (kind='strassen_oot'), the autotuner's
    ``strassen_oot`` candidate family and ``launch/blocks_demo.py`` share.
    """
    sched = PlanScheduler(
        depth=depth, budget_bytes=budget_bytes, scheme=scheme, plan=plan,
        backend=backend, block=block, prefetch=prefetch, stage_dtype=stage_dtype,
        chaos=chaos, recovery=recovery, retries=retries,
        retry_backoff_s=retry_backoff_s, degrade=degrade, device=device,
    )
    return sched.matmul(a, b, store=store, store_root=store_root)
