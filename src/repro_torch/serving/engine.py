"""Continuous-batching serving engine: request-based API over a paged KV pool.

The port of ``repro.serving.engine``::

    engine = Engine(cfg, params, ServeConfig(slots=8, page_size=16), device="cuda")
    h = engine.submit([1, 2, 3], max_new_tokens=64, on_token=cb)
    for ev in engine.stream():          # or: engine.step() by hand
        ...                             # TokenEvent(request_id, index, token)
    h.tokens()

* ``submit()`` queues a request (admission control: reject or queue when
  the page budget / slots are exhausted); the scheduler admits and evicts
  requests *mid-decode*, so the decode step always runs a full
  ``slots``-wide bucket with per-slot position/eos state.
* KV memory is a paged pool (``kv_pool.py``): full-attention layers share a
  page-budgeted arena through per-slot page tables. Ring and recurrent
  (mLSTM, sLSTM) state stays slot-indexed; a model with no full-attention
  layer (xLSTM) needs no page, and its prefill runs at the exact prompt
  length, so no padded token enters the recurrence.
* End-of-sequence is checked **on the device** inside the step; the host
  fetches tokens and finish state every ``sync_interval`` steps.
* ``generate()`` remains as a thin compatibility shim on top of the loop
  (token-exact with ``_generate_static``, the legacy static-batch path).

On the card each forward runs the RMSNorm kernel in every norm, each
prefill the flash-attention kernel in every attention layer, and each
forward the sLSTM kernel in every sLSTM layer; decode attention and the
mLSTM recurrence are plain PyTorch, as in the JAX package. PyTorch runs
eagerly, so the JAX engine's jitted bodies are plain methods here, and the
pools and per-slot state are updated in place.

Sampling: each request owns a ``torch.Generator`` on the engine's device,
seeded from its seed (or, without one, from the engine seed 0 and its
request id), and temperature draws for that request consume it in order.
Draws are deterministic per seed and independent of batch composition,
like the JAX engine's per-slot keys, but not bit-equal to ``jax.random``.

A kind ``auto`` backend is warmed at construction (``warm_for_model``
resolves every projection shape of the prefill and decode buckets on the
engine's device) and ``autotune_stats()`` reports the process decision log,
the calibration it ran on, and under ``oot`` the stats of every out-of-core
run since the engine was built (an engine-owned ring of
:mod:`repro_torch.blocks.scheduler`). Not ported: encoder-decoder serving
(ROADMAP.md queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.blocks.recovery import FaultError, InjectedFault
from repro_torch.blocks.scheduler import attach_stats_ring
from repro_torch.core import autotune
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import make_stub_positions
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracer as obs_tracer
from repro_torch.serving.kv_pool import CacheLayout, PagePool
from repro_torch.serving.request import Request, RequestHandle, RequestState, TokenEvent

__all__ = ["ServeConfig", "Engine"]


def _fold_seed(seed: int, index: int) -> int:
    """A generator seed for stream ``index`` of ``seed`` (jax.random.fold_in's role)."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The single serving-surface config: sampling, memory, scheduling.

    ``apply_to(cfg)`` is the one place serving knobs rewrite the model
    config (tuning-cache warm start for ``kind='auto'`` backends).
    """

    max_seq: int = 2048
    temperature: float = 0.0  # 0 -> greedy
    eos_id: int = -1  # -1 -> never stop early
    # Persistent autotune cache for kind='auto' backends.
    tuning_cache: Optional[str] = None

    # --- continuous-batching surface
    slots: int = 4  # decode bucket width (requests resident at once)
    page_size: int = 16  # tokens per KV page
    page_budget: int = 0  # usable KV pages; 0 = slots * ceil(max_seq/page_size)
    admission: str = "queue"  # "queue" (wait for slots/pages) | "reject"
    max_queue: int = 0  # queue-policy cap; 0 = unbounded
    batching: str = "continuous"  # "continuous" | "static" (gang baseline)
    sync_interval: int = 4  # decode steps between host<->device token syncs
    decode_pages: int = 0  # gathered pages per step; 0 = pow2 bucketing
    # Per-request watchdog: a request still decoding this many seconds
    # after admission is evicted with finish_reason="timeout" and its
    # pages returned to the pool. 0 disables the watchdog.
    request_timeout_s: float = 0.0

    def __post_init__(self):
        if self.admission not in ("queue", "reject"):
            raise ValueError(f"admission must be queue|reject, got {self.admission!r}")
        if self.batching not in ("continuous", "static"):
            raise ValueError(
                f"batching must be continuous|static, got {self.batching!r}"
            )
        for name in ("max_seq", "slots", "page_size", "sync_interval"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.page_budget < 0 or self.decode_pages < 0 or self.max_queue < 0:
            raise ValueError("page_budget/decode_pages/max_queue must be >= 0")
        if self.request_timeout_s < 0:
            raise ValueError(
                f"request_timeout_s must be >= 0, got {self.request_timeout_s}"
            )

    @property
    def table_width(self) -> int:
        """Pages needed to cover max_seq — the per-slot page-table width."""
        return -(-self.max_seq // self.page_size)

    @property
    def pages_total(self) -> int:
        """Usable pages in the pool (scratch page excluded)."""
        return self.page_budget or self.slots * self.table_width

    def apply_to(self, cfg: ModelConfig) -> ModelConfig:
        """Resolve serving-surface knobs into the model config.

        Replaces the old ad-hoc ``dataclasses.replace`` splice in
        ``Engine.__init__``: any serving-layer rewrite of the model
        config happens here and nowhere else.
        """
        backend = cfg.matmul_backend
        if backend.kind == "auto" and self.tuning_cache and not backend.tuning_cache:
            cfg = dataclasses.replace(
                cfg,
                matmul_backend=dataclasses.replace(
                    backend, tuning_cache=self.tuning_cache
                ),
            )
        return cfg


@dataclasses.dataclass
class _ServeStats:
    submitted: int = 0
    admitted: int = 0
    finished: int = 0
    evicted: int = 0
    errors: int = 0
    timeouts: int = 0
    rejected: int = 0
    prefills: int = 0
    decode_steps: int = 0
    syncs: int = 0
    tokens_emitted: int = 0
    peak_pages_in_use: int = 0
    peak_queue_depth: int = 0
    prefill_s: float = 0.0
    decode_dispatch_s: float = 0.0
    drain_s: float = 0.0
    buckets: Dict[int, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Buffered:
    """One dispatched step whose tokens the host has not fetched yet."""

    arr: torch.Tensor  # () prefill token or (slots,) decode tokens, on the device
    # (slot, request) pairs live at dispatch; prefill entries carry one.
    snapshot: Tuple[Tuple[int, Request], ...]
    prefill: bool = False


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        serve_cfg: ServeConfig = ServeConfig(),
        *,
        device: str | torch.device = "cuda",
    ):
        """``params`` is the model (``models.model.init_params``), on ``device``."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda') needs a CUDA device; pass device='cpu' to run on the CPU")
        first = next(params.parameters())
        if first.device.type != self.device.type:
            raise ValueError(f"params lie on {first.device}, the engine runs on {self.device}")
        # Per-engine obs registry: request-latency histograms (TTFT /
        # TPOT), pool-page gauges, token counters; surfaced by stats()["obs"].
        self.metrics = obs_metrics.Metrics()
        # Telemetry is process-scoped, so each engine zeroes it up front:
        # autotune_stats()/generate() then report this engine's resolutions.
        autotune.reset_telemetry()
        # Out-of-core run stats, by contrast, are read through an
        # engine-OWNED ring: every run since this engine was built lands here
        # however many other engines run concurrently.
        self._oot_ring = attach_stats_ring()
        cfg = serve_cfg.apply_to(cfg)
        if cfg.matmul_backend.kind == "auto":
            # decode resolves at 1 token/seq; prefill at up to max_seq tokens
            autotune.warm_for_model(
                cfg, tokens=(1, min(128, serve_cfg.max_seq), serve_cfg.max_seq),
                device=self.device,
            )
        self.cfg = cfg
        self.params = params
        self.serve = serve_cfg

        # --- request-scheduler state (device state built lazily).
        self._layout: Optional[CacheLayout] = None
        self._pool: Optional[PagePool] = None
        self._kv = None
        self._table: Optional[torch.Tensor] = None
        self._meta: Optional[Dict[str, torch.Tensor]] = None
        self._next_id = 0
        self._queue: deque = deque()
        self._active: Dict[int, Request] = {}
        self._free_slots: List[int] = []
        self._requests: Dict[int, Request] = {}
        self._buffer: List[_Buffered] = []
        self._steps_since_sync = 0
        self._stats = _ServeStats()

    # ------------------------------------------------------ model bodies

    def _prefill(self, batch, cache):
        return M.apply_prefill(self.params, batch, cache, self.cfg)

    def _sample(self, logits: torch.Tensor, temperature: float, gen: torch.Generator) -> torch.Tensor:
        """One token id from (V,) logits: argmax, or a draw at ``temperature`` from ``gen``."""
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / max(temperature, 1e-6), dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[0]

    @torch.inference_mode()
    def _decode_step(self, active: torch.Tensor, live_reqs, bucket_pages: int) -> torch.Tensor:
        """One continuous-batching decode step over the full slot bucket.

        Per-slot positions, per-slot sampling, on-device eos: a slot is
        live iff the host marked it active AND the device hasn't flagged it
        done. Dead slots are frozen (state, pos, pages all unchanged; their
        KV write lands on the scratch page). Dead slots decode at position
        0 of the view, since a finished slot's position may lie past the
        bucket; their results are discarded.
        """
        cfg, layout, meta = self.cfg, self._layout, self._meta
        live = active & ~meta["done"]
        pos = meta["pos"]
        pos_view = torch.where(live, pos, 0)
        dense = layout.gather(self._kv, self._table, pos_view, bucket_pages)
        tokens = meta["last_tok"][:, None]
        if cfg.mrope:
            # Stub M-RoPE streams at pos+1: the legacy static loop's offset
            # (generate parity is token-exact).
            p3 = (pos_view + 1)[:, None, None].expand(pos.shape[0], 1, 3)
            logits, new_dense = M.apply_decode(self.params, tokens, dense, cfg, positions=p3)
        else:
            logits, new_dense = M.apply_decode(self.params, tokens, dense, cfg)

        nxt = torch.argmax(logits, dim=-1)
        for slot, req in live_reqs:
            if req.temperature > 0:
                nxt[slot] = self._sample(logits[slot], req.temperature, req._gen)
        nxt = torch.where(live, nxt, meta["last_tok"])

        layout.scatter_token(self._kv, new_dense, self._table, pos_view, live)
        step = live.long()
        n_gen = meta["n_gen"] + step
        hit_eos = live & (meta["eos"] >= 0) & (nxt == meta["eos"])
        meta["done"] = meta["done"] | hit_eos | (live & (n_gen >= meta["max_new"]))
        meta["last_tok"] = nxt.clone()  # admission writes meta in place; nxt is buffered
        meta["pos"] = pos + step
        meta["n_gen"] = n_gen
        return nxt

    @torch.inference_mode()
    def _insert(self, pre_cache, pre_logits, req: Request, page_row, prompt_pages) -> torch.Tensor:
        """Move a finished batch-1 prefill into ``req.slot``: pages scattered,
        slot state row-written, per-slot meta set, first token sampled from
        the prefill logits."""
        slot, meta = req.slot, self._meta
        self._layout.insert_request(self._kv, pre_cache, slot, prompt_pages)
        self._table[slot] = page_row
        tok = self._sample(pre_logits[0], req.temperature, req._gen)
        done = (tok == req.eos_id) if req.eos_id >= 0 else torch.zeros((), dtype=torch.bool, device=tok.device)
        meta["last_tok"][slot] = tok
        meta["pos"][slot] = pre_cache["pos"]
        meta["n_gen"][slot] = 1
        meta["done"][slot] = done | (req.max_new_tokens <= 1)
        meta["eos"][slot] = req.eos_id
        meta["temp"][slot] = req.temperature
        meta["max_new"][slot] = req.max_new_tokens
        return tok

    # ------------------------------------------------- serving state init

    def _ensure_serving(self) -> None:
        if self._layout is not None:
            return
        serve, dev = self.serve, self.device
        layout = CacheLayout(
            cfg=self.cfg,
            n_slots=serve.slots,
            page_size=serve.page_size,
            max_seq=serve.max_seq,
            device=str(dev),
        )
        self._layout = layout
        self._pool = PagePool(serve.pages_total if layout.has_paged else 0, serve.page_size)
        self._kv = layout.init_kv_state(self._pool.capacity)
        self._table = torch.zeros((serve.slots, layout.table_width), dtype=torch.long, device=dev)
        s = serve.slots
        self._meta = {
            "last_tok": torch.zeros((s,), dtype=torch.long, device=dev),
            "pos": torch.zeros((s,), dtype=torch.long, device=dev),
            "n_gen": torch.zeros((s,), dtype=torch.long, device=dev),
            "done": torch.ones((s,), dtype=torch.bool, device=dev),  # empty slots are dead
            "eos": torch.full((s,), -1, dtype=torch.long, device=dev),
            "temp": torch.zeros((s,), dtype=torch.float32, device=dev),
            "max_new": torch.zeros((s,), dtype=torch.long, device=dev),
        }
        self._free_slots = list(range(serve.slots))

    # ------------------------------------------------------- request API

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        temperature: Optional[float] = None,
        eos_id: Optional[int] = None,
        seed: Optional[int] = None,
        on_token: Optional[Callable] = None,
        _key: Optional[int] = None,
        _inject_fault_at: Optional[int] = None,
    ) -> RequestHandle:
        """Queue one request; returns immediately with a RequestHandle.

        Admission control: ``admission='queue'`` waits for slots/pages
        (bounded by ``max_queue``); ``'reject'`` marks the request
        REJECTED when it cannot start right now. Requests that can
        *never* fit (sequence beyond max_seq, pages beyond the pool
        capacity) raise ValueError.

        ``_key`` seeds the request's generator directly (``generate()``
        passes one per row). ``_inject_fault_at`` is the chaos-harness hook: the request's
        k-th decode dispatch raises :class:`InjectedFault` (k counts
        tokens already emitted, so ``1`` fails the first decode step
        after the prefill token; ``0`` fails the prefill itself). The
        engine's fault isolation evicts exactly that request with
        ``finish_reason='error'``; survivors are untouched.
        """
        self._ensure_serving()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = int(prompt.size) + max_new_tokens
        if total > self.serve.max_seq:
            raise ValueError(
                f"prompt+max_new_tokens={total} exceeds max_seq={self.serve.max_seq}"
            )
        need = self._pages_for_request(int(prompt.size), max_new_tokens)
        if need > self._pool.capacity:
            raise ValueError(
                f"request needs {need} pages, pool capacity is {self._pool.capacity}"
            )
        if _key is not None:
            key = int(_key)
        else:
            key = seed if seed is not None else _fold_seed(0, self._next_id)
        req = Request(
            id=self._next_id,
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            temperature=(
                self.serve.temperature if temperature is None else float(temperature)
            ),
            eos_id=self.serve.eos_id if eos_id is None else int(eos_id),
            seed=0 if seed is None else int(seed),
            on_token=on_token,
            t_submit=time.perf_counter(),
        )
        req._gen = torch.Generator(device=self.device).manual_seed(key)  # type: ignore[attr-defined]
        req._emitted_est = 0  # type: ignore[attr-defined]
        req._fault_at = _inject_fault_at  # type: ignore[attr-defined]
        self._next_id += 1
        self._requests[req.id] = req
        self._stats.submitted += 1
        obs_tracer.get_tracer().event(
            "request.submit", tag=f"req{req.id}", track=f"serve.req/{req.id}",
            prompt_len=req.prompt_len, max_new=req.max_new_tokens,
        )
        handle = RequestHandle(self, req)

        if self.serve.admission == "reject":
            startable = bool(self._free_slots) and need <= self._pool.available
            if self.serve.batching == "static" and self._active:
                startable = False
            if not startable:
                req.state = RequestState.REJECTED
                req.finish_reason = "rejected"
                self._stats.rejected += 1
                return handle
        elif self.serve.max_queue and len(self._queue) >= self.serve.max_queue:
            req.state = RequestState.REJECTED
            req.finish_reason = "rejected"
            self._stats.rejected += 1
            return handle

        self._queue.append(req)
        self._stats.peak_queue_depth = max(
            self._stats.peak_queue_depth, len(self._queue)
        )
        self._try_admit()
        return handle

    def step(self) -> List[TokenEvent]:
        """One scheduler iteration: sync if due, admit, dispatch decode.

        Returns the TokenEvents drained this iteration (possibly empty —
        tokens surface at sync boundaries, not every step).
        """
        events: List[TokenEvent] = []
        self._check_timeouts()
        if self._drain_due():
            events.extend(self._drain())
        self._try_admit()
        dispatched = self._dispatch_decode()
        if not dispatched and self._buffer:
            # nothing computable until the host learns what finished
            events.extend(self._drain())
            self._try_admit()
            self._dispatch_decode()
        return events

    def stream(
        self, handles: Optional[Sequence[RequestHandle]] = None
    ) -> Iterator[TokenEvent]:
        """Drive the engine, yielding TokenEvents in emission order
        (step-major, slot-minor; per-request order is guaranteed).
        With ``handles``, stops once those requests are terminal."""
        wanted = None if handles is None else {h.id for h in handles}
        while True:
            if wanted is not None and all(
                self._requests[i].done for i in wanted
            ):
                return
            if not (self._queue or self._active or self._buffer):
                return
            for ev in self.step():
                if wanted is None or ev.request_id in wanted:
                    yield ev

    def run(self, until: Optional[RequestHandle] = None) -> None:
        """Step until all work (or ``until``'s request) is complete."""
        while self._queue or self._active or self._buffer:
            if until is not None and until.done:
                return
            self.step()

    def evict(self, handle: RequestHandle) -> None:
        """Evict a request mid-decode (or drop it from the queue): its
        pages return to the pool and its slot frees immediately;
        delivered tokens (including any buffered on device) are kept."""
        req = self._requests[handle.id]
        if req.done:
            return
        if req.state == RequestState.QUEUED:
            try:
                self._queue.remove(req)
            except ValueError:
                pass
            self._finish(req, "evicted")
            return
        # flush dispatched-but-unfetched tokens so delivery stays exact
        self._drain()
        if req.done:
            return
        self._finish(req, "evicted")

    # ------------------------------------------------------- scheduling

    def _pages_for_request(self, prompt_len: int, max_new: int) -> int:
        if not self._layout.has_paged:
            return 0
        # positions written: [0, prompt) by prefill, then one per decode
        # step up to prompt + max_new - 2 (the last sampled token is
        # never written back) — max_new - 1 decode writes.
        return self._pool.pages_for_tokens(prompt_len + max_new - 1)

    def _try_admit(self) -> None:
        if self._layout is None:
            return
        if self.serve.batching == "static" and self._active:
            return  # gang-scheduled baseline: admit only into an idle engine
        while self._queue and self._free_slots:
            req = self._queue[0]
            need = self._pages_for_request(req.prompt_len, req.max_new_tokens)
            if need > self._pool.available:
                break  # FIFO head-of-line wait for pages
            self._queue.popleft()
            self._admit(req, need)

    def _admit(self, req: Request, need: int) -> None:
        span = obs_tracer.get_tracer().begin(
            "engine.prefill", cat="serve", track="serve.engine",
            request=req.id, prompt_len=req.prompt_len, pages=need,
        )
        t0 = span.t0
        serve = self.serve
        req.state = RequestState.PREFILL
        req.t_admit = t0
        req.page_ids = self._pool.alloc(need)
        req.slot = self._free_slots.pop()
        self._stats.admitted += 1
        self._stats.prefills += 1
        self._stats.peak_pages_in_use = max(
            self._stats.peak_pages_in_use, self._pool.in_use
        )

        s = req.prompt_len
        ps = serve.page_size
        capacity = -(-s // ps) * ps
        pre_cache = self._layout.init_prefill_cache(capacity)
        batch = {"tokens": torch.as_tensor(req.prompt[None, :], dtype=torch.long, device=self.device)}
        if self.cfg.mrope:
            batch["positions"] = make_stub_positions(1, s, device=self.device)
        try:
            if getattr(req, "_fault_at", None) == 0:
                err = InjectedFault(f"injected prefill failure (request {req.id})")
                err.request_id = req.id  # type: ignore[attr-defined]
                raise err
            logits, filled = self._prefill(batch, pre_cache)
        except FaultError as e:
            # Prefill is batch-1, so the culprit is exact: release its
            # pages and slot, mark it errored, and keep serving. Device
            # slot state was never touched (the insert never ran).
            if isinstance(e, InjectedFault):
                self.metrics.counter("fault.injected_faults").inc()
            self.metrics.counter("fault.evicted_requests").inc()
            obs_tracer.get_tracer().end(span, error=type(e).__name__)
            obs_tracer.get_tracer().event(
                "fault.evict", cat="fault", tag=f"req{req.id}",
                track=f"serve.req/{req.id}", cause=type(e).__name__,
                phase="prefill",
            )
            self._finish(req, "error")
            return

        n_prompt_pages = capacity // ps
        page_row = np.zeros((self._layout.table_width,), np.int64)
        page_row[: len(req.page_ids)] = req.page_ids
        page_row = torch.as_tensor(page_row, device=self.device)
        prompt_pages = torch.as_tensor(
            req.page_ids[:n_prompt_pages] if self._layout.has_paged else [],
            dtype=torch.long, device=self.device,
        )
        tok = self._insert(filled, logits, req, page_row, prompt_pages)
        req.state = RequestState.DECODING
        self._active[req.slot] = req
        # the prefill-sampled token is emission #1 for this request
        self._buffer.append(_Buffered(tok, ((req.slot, req),), prefill=True))
        req._emitted_est = 1  # type: ignore[attr-defined]
        obs_tracer.get_tracer().end(span)
        self._stats.prefill_s += span.duration
        # Decode phase starts here; _finish uses this to split the
        # request's lifecycle spans.
        req._t_decode = span.t1  # type: ignore[attr-defined]
        self.metrics.histogram("serve.prefill_s").record(span.duration)
        self.metrics.gauge("serve.pages_in_use").set(self._pool.in_use)

    def _host_live(self) -> List[Tuple[int, Request]]:
        return [
            (slot, req)
            for slot, req in sorted(self._active.items())
            if req._emitted_est < req.max_new_tokens  # type: ignore[attr-defined]
        ]

    def _bucket_pages(self) -> int:
        layout = self._layout
        if not layout.has_paged:
            return 1  # static placeholder; gather has no paged leaves
        if self.serve.decode_pages:
            return min(self.serve.decode_pages, layout.table_width)
        need = 1
        ps = self.serve.page_size
        for _, req in self._host_live():
            pos_est = req.prompt_len + req._emitted_est  # type: ignore[attr-defined]
            need = max(need, pos_est // ps + 1)
        bucket = 1
        while bucket < need:
            bucket *= 2
        return min(bucket, layout.table_width)

    def _dispatch_decode(self) -> bool:
        """Dispatch one decode step, isolating per-request faults.

        A fault-typed dispatch failure (injected or device-raised before
        any state is written) evicts only the culprit request, so a raise
        leaves ``_kv``/``_meta`` untouched and every surviving slot
        continues bit-identically. Bounded retry: each attempt can evict
        at most one request, so ``slots + 1`` attempts suffice.
        """
        for _ in range(self.serve.slots + 1):
            live = self._host_live()
            if not live:
                return False
            try:
                return self._dispatch_decode_once(live)
            except FaultError as e:
                self._isolate_decode_fault(e, live)
        return False

    def _isolate_decode_fault(self, exc: FaultError, live) -> None:
        """Evict the request a failed decode dispatch is attributed to.

        Attribution: an :class:`InjectedFault` carries ``request_id``;
        anonymous fault-typed failures blame the newest-admitted live
        request (the one whose admission most recently changed the
        batch composition). Buffered tokens are drained first so every
        already-computed token is delivered before the eviction.
        """
        self._drain()
        rid = getattr(exc, "request_id", None)
        culprit = self._requests.get(rid) if rid is not None else None
        if culprit is None or culprit.done:
            cands = [r for r in self._active.values() if not r.done]
            if not cands:
                return  # the failure's request finished at the drain
            culprit = max(cands, key=lambda r: (r.t_admit or 0.0, r.id))
        if isinstance(exc, InjectedFault):
            self.metrics.counter("fault.injected_faults").inc()
        self.metrics.counter("fault.evicted_requests").inc()
        obs_tracer.get_tracer().event(
            "fault.evict", cat="fault", tag=f"req{culprit.id}",
            track=f"serve.req/{culprit.id}", cause=type(exc).__name__,
            phase="decode",
        )
        self._finish(culprit, "error")

    def _check_timeouts(self) -> None:
        """Per-request watchdog: evict admitted requests that have been
        decoding longer than ``request_timeout_s`` (pages freed, reason
        ``'timeout'``); survivors and delivered tokens are unaffected."""
        limit = self.serve.request_timeout_s
        if not limit or not self._active:
            return
        now = time.perf_counter()
        expired = [
            r
            for r in self._active.values()
            if (now - (r.t_admit if r.t_admit is not None else r.t_submit)) > limit
        ]
        if not expired:
            return
        self._drain()  # deliver everything computed before the cut
        for req in expired:
            if req.done:
                continue
            self.metrics.counter("fault.timeouts").inc()
            self.metrics.counter("fault.evicted_requests").inc()
            obs_tracer.get_tracer().event(
                "fault.evict", cat="fault", tag=f"req{req.id}",
                track=f"serve.req/{req.id}", cause="timeout",
            )
            self._finish(req, "timeout")

    def _dispatch_decode_once(self, live) -> bool:
        span = obs_tracer.get_tracer().begin(
            "engine.decode_step", cat="serve", track="serve.engine",
            live=len(live),
        )
        for _, req in live:
            fa = getattr(req, "_fault_at", None)
            if fa is not None and req._emitted_est >= fa:  # type: ignore[attr-defined]
                obs_tracer.get_tracer().end(span, error="InjectedFault")
                err = InjectedFault(
                    f"injected decode failure (request {req.id}, "
                    f"emitted {req._emitted_est})"  # type: ignore[attr-defined]
                )
                err.request_id = req.id  # type: ignore[attr-defined]
                raise err
        mask = np.zeros((self.serve.slots,), bool)
        for slot, _ in live:
            mask[slot] = True
        bucket = self._bucket_pages()
        emitted = self._decode_step(torch.as_tensor(mask, device=self.device), live, bucket)
        self._buffer.append(_Buffered(emitted, tuple(live)))
        for _, req in live:
            req._emitted_est += 1  # type: ignore[attr-defined]
        self._steps_since_sync += 1
        self._stats.decode_steps += 1
        self._stats.buckets[bucket] = self._stats.buckets.get(bucket, 0) + 1
        obs_tracer.get_tracer().end(span, bucket_pages=bucket)
        self._stats.decode_dispatch_s += span.duration
        return True

    def _drain_due(self) -> bool:
        if not self._buffer:
            return False
        if self._steps_since_sync >= self.serve.sync_interval:
            return True
        # a request provably finished (length) -> sync to free its slot
        return any(
            req._emitted_est >= req.max_new_tokens  # type: ignore[attr-defined]
            for req in self._active.values()
        )

    def _drain(self) -> List[TokenEvent]:
        """Fetch buffered step outputs, distribute tokens to requests,
        fire streaming callbacks, and retire finished requests."""
        if not self._buffer:
            return []
        # The sync_interval host<->device boundary: the one place decode
        # tokens materialize on host, so its span IS the sync cadence.
        span = obs_tracer.get_tracer().begin(
            "engine.sync", cat="serve", track="serve.engine",
            buffered=len(self._buffer),
        )
        buffered, self._buffer = self._buffer, []
        flat = torch.cat([b.arr.reshape(-1) for b in buffered]).tolist()  # the one sync
        arrays, at = [], 0
        for b in buffered:
            n = b.arr.numel()
            arrays.append(flat[at] if b.prefill else flat[at:at + n])
            at += n
        now = time.perf_counter()
        events: List[TokenEvent] = []
        callbacks: List[Tuple[Request, TokenEvent]] = []
        for entry, arr in zip(buffered, arrays):
            for slot, req in entry.snapshot:
                if req.done:
                    continue  # frozen on device; later entries repeat last_tok
                tok = int(arr) if entry.prefill else int(arr[slot])
                ev = TokenEvent(req.id, len(req.tokens), tok)
                req.record_tokens([tok], now)
                self._stats.tokens_emitted += 1
                events.append(ev)
                if req.on_token is not None:
                    callbacks.append((req, ev))
                # mirror of the device's done rule (same order: the eos
                # token is delivered, then the request freezes)
                if req.eos_id >= 0 and tok == req.eos_id:
                    self._finish(req, "eos")
                elif len(req.tokens) >= req.max_new_tokens:
                    self._finish(req, "length")
        for req in self._active.values():
            req._emitted_est = len(req.tokens)  # type: ignore[attr-defined]
        self._steps_since_sync = 0
        self._stats.syncs += 1
        for req, ev in callbacks:
            req.on_token(RequestHandle(self, req), ev)
        obs_tracer.get_tracer().end(span, tokens=len(events))
        self._stats.drain_s += span.duration
        self.metrics.counter("serve.tokens_emitted").inc(len(events))
        return events

    def _finish(self, req: Request, reason: str) -> None:
        req.finish_reason = reason
        req.t_finish = time.perf_counter()
        if reason in ("evicted", "error", "timeout"):
            req.state = RequestState.EVICTED
            self._stats.evicted += 1
            if reason == "error":
                self._stats.errors += 1
            elif reason == "timeout":
                self._stats.timeouts += 1
        else:
            req.state = RequestState.FINISHED
            self._stats.finished += 1
        if req.page_ids:
            self._pool.free(req.page_ids)
            req.page_ids = []
        if req.slot is not None:
            self._active.pop(req.slot, None)
            self._free_slots.append(req.slot)
            req.slot = None
        self._record_request_obs(req)

    def _record_request_obs(self, req: Request) -> None:
        """Lifecycle spans (queued -> prefill -> decoding, one lane per
        request) + the TTFT/TPOT histograms. TTFT and the per-request
        mean inter-token gap are computed exactly as
        ``RequestHandle.latency_stats()`` consumers do, so histogram
        percentiles reconcile with the per-request records to float
        precision (the serve_load smoke gate)."""
        tr = obs_tracer.get_tracer()
        if tr.enabled:
            lane = f"serve.req/{req.id}"
            tag = f"req{req.id}"
            end = req.t_finish if req.t_finish is not None else req.t_submit
            if req.t_admit is not None:
                tr.add_span(
                    "request.queued", req.t_submit, req.t_admit,
                    cat="serve", tag=tag, track=lane,
                )
                t_decode = getattr(req, "_t_decode", req.t_admit)
                tr.add_span(
                    "request.prefill", req.t_admit, t_decode,
                    cat="serve", tag=tag, track=lane,
                )
                tr.add_span(
                    "request.decoding", t_decode, end,
                    cat="serve", tag=tag, track=lane,
                    tokens=len(req.tokens), finish=req.finish_reason,
                )
            else:  # never admitted (rejected / evicted from queue)
                tr.add_span(
                    "request.queued", req.t_submit, end,
                    cat="serve", tag=tag, track=lane, finish=req.finish_reason,
                )
        if self._pool is not None:
            self.metrics.gauge("serve.pages_in_use").set(self._pool.in_use)
        self.metrics.counter(f"serve.requests_{req.finish_reason}").inc()
        if req.t_first_token is not None:
            self.metrics.histogram("serve.ttft_s").record(
                req.t_first_token - req.t_submit
            )
        gaps = [
            req.token_times[i] - req.token_times[i - 1]
            for i in range(1, len(req.token_times))
        ]
        if gaps:
            self.metrics.histogram("serve.tpot_s").record(float(np.mean(gaps)))

    # ------------------------------------------------------- generate API

    def generate(
        self,
        prompts,  # (B, S_prompt) int
        max_new_tokens: int,
        *,
        seed: int = 0,
    ) -> Tuple[torch.Tensor, Dict[str, float]]:
        """Compatibility shim: batched equal-length generation on top of
        the request loop. Token-exact with the static path for greedy
        decoding (the parity test pins this). Frame inputs come with the
        encoder-decoder family (ROADMAP.md queue 1 item 9).
        """
        serve = self.serve
        prompts_np = np.asarray(torch.as_tensor(prompts).cpu())
        b, s = prompts_np.shape
        eos = serve.eos_id

        def legacy_len(handle_rows: List[List[int]]) -> Optional[int]:
            # Legacy truncation rule: the prefill token (index 0) is never
            # eos-checked; the loop stopped one step after the LAST row hit
            # eos, so output length = max over rows of (first eos index)+1.
            # None while some row hasn't hit eos yet.
            if eos < 0:
                return None
            firsts = []
            for toks in handle_rows:
                hit = next((i for i in range(1, len(toks)) if toks[i] == eos), None)
                if hit is None:
                    return None
                firsts.append(hit)
            return min(max_new_tokens, max(firsts) + 1)

        # Requests carry eos disabled (the host applies the legacy
        # stop-when-ALL-done rule above); rows must always queue, whatever
        # the engine's admission policy, or the shim would drop rows.
        saved_serve = self.serve
        if saved_serve.admission != "queue" or saved_serve.max_queue:
            self.serve = dataclasses.replace(
                saved_serve, admission="queue", max_queue=0
            )
        try:
            handles = [
                self.submit(
                    prompts_np[i],
                    max_new_tokens,
                    temperature=serve.temperature,
                    eos_id=-1,
                    _key=_fold_seed(seed, i),
                )
                for i in range(b)
            ]
            while not all(h.done for h in handles):
                self.step()
                t = legacy_len([h.tokens() for h in handles])
                if t is not None and all(len(h.tokens()) >= t for h in handles):
                    break
            for h in handles:
                if not h.done:
                    self.evict(h)
        finally:
            self.serve = saved_serve
        rows = [h.tokens() for h in handles]
        target_len = legacy_len(rows) or max_new_tokens
        tokens = torch.as_tensor(np.asarray([r[:target_len] for r in rows], np.int64))
        stats = {
            "prompt_len": float(s),
            "generated": float(tokens.shape[1]),
            "cache_pos": float(s + tokens.shape[1] - 1),
        }
        # Autotune decision telemetry: how many matmul resolutions this
        # process served from the cache vs decided fresh.
        tel = autotune.get_telemetry()
        stats["autotune_cache_hits"] = float(tel.cache_hits)
        stats["autotune_cache_misses"] = float(tel.cache_misses)
        return tokens, stats

    @torch.inference_mode()
    def _generate_static(
        self,
        prompts,  # (B, S_prompt) int
        max_new_tokens: int,
        *,
        seed: int = 0,
    ) -> Tuple[torch.Tensor, Dict[str, float]]:
        """The lockstep loop: one static equal-length batch on a dense
        cache, per-token host sync on eos. The parity anchor for the shim."""
        cfg, serve = self.cfg, self.serve
        prompts = torch.as_tensor(prompts, dtype=torch.long, device=self.device)
        b, s = prompts.shape
        total = s + max_new_tokens
        if total > serve.max_seq:
            raise ValueError(f"prompt+max_new_tokens={total} exceeds max_seq={serve.max_seq}")
        cache = M.init_cache(cfg, b, serve.max_seq, device=self.device)
        batch = {"tokens": prompts}
        if cfg.mrope:
            batch["positions"] = make_stub_positions(b, s, device=self.device)
        logits, cache = self._prefill(batch, cache)

        gen = torch.Generator(device=self.device).manual_seed(seed)

        def sample(lg):
            return torch.stack([self._sample(row, serve.temperature, gen) for row in lg])[:, None]

        nxt = sample(logits)
        out: List[torch.Tensor] = [nxt]
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        for i in range(max_new_tokens - 1):
            positions = (
                make_stub_positions(b, 1, offset=s + i + 1, device=self.device) if cfg.mrope else None
            )
            logits, cache = M.apply_decode(self.params, nxt, cache, cfg, positions=positions)
            nxt = sample(logits)
            if serve.eos_id >= 0:
                done = done | (nxt[:, 0] == serve.eos_id)
                if bool(torch.all(done)):
                    out.append(nxt)
                    break
            out.append(nxt)
        tokens = torch.cat(out, dim=1).cpu()
        stats = {
            "prompt_len": float(s),
            "generated": float(tokens.shape[1]),
            "cache_pos": float(cache["pos"]),
        }
        tel = autotune.get_telemetry()
        stats["autotune_cache_hits"] = float(tel.cache_hits)
        stats["autotune_cache_misses"] = float(tel.cache_misses)
        return tokens, stats

    # -------------------------------------------------------- telemetry

    def serve_stats(self) -> Dict[str, Any]:
        """Scheduler/pool snapshot, autotune_stats()-style: queue depth,
        slot occupancy, pages in use, prefill/decode split."""
        st = self._stats
        out: Dict[str, Any] = {
            "slots": self.serve.slots,
            "slots_active": len(self._active),
            "queue_depth": len(self._queue),
            "page_size": self.serve.page_size,
            "requests": {
                "submitted": st.submitted,
                "admitted": st.admitted,
                "finished": st.finished,
                "evicted": st.evicted,
                "errors": st.errors,
                "timeouts": st.timeouts,
                "rejected": st.rejected,
            },
            "prefills": st.prefills,
            "decode_steps": st.decode_steps,
            "syncs": st.syncs,
            "tokens_emitted": st.tokens_emitted,
            "peak_queue_depth": st.peak_queue_depth,
            "prefill_s": st.prefill_s,
            "decode_dispatch_s": st.decode_dispatch_s,
            "drain_s": st.drain_s,
            "decode_buckets": dict(st.buckets),
        }
        if self._pool is not None:
            out.update(
                page_budget=self._pool.capacity,
                pages_in_use=self._pool.in_use,
                pages_free=self._pool.available,
                peak_pages_in_use=st.peak_pages_in_use,
            )
        return out

    def autotune_stats(self) -> Dict:
        """Full autotune telemetry snapshot plus the calibration it ran on.

        Each fresh decision carries its per-constant cost split under
        ``terms``; ``calibration`` reports the constants that cost this
        engine's misses: the tuning cache's own where they were fitted on the
        engine's platform, else the process calibration of its device (None
        when every decision came from a warm cache and no calibration ran).
        ``oot`` carries the out-of-core scheduler's recent run stats (waves,
        peak device bytes, overlap telemetry) for every ``strassen_oot`` or
        solver run this process executed since the engine was built.
        """
        return {
            **autotune.get_telemetry().snapshot(),
            "calibration": autotune.costing_calibration(
                autotune.process_cache(self.cfg.matmul_backend.tuning_cache), self.device
            ),
            "oot": self._oot_ring.snapshot(),
        }

    def stats(self) -> Dict[str, Any]:
        """One roll-up of every telemetry surface this engine owns:
        ``serve`` (scheduler/pool counters), ``autotune`` (decision log +
        calibration + out-of-core runs), and ``obs`` — the engine's
        metrics registry snapshot (TTFT/TPOT histograms, pages-in-use
        gauge, token counters) plus the process tracer's state."""
        tracer = obs_tracer.get_tracer()
        return {
            "serve": self.serve_stats(),
            "autotune": self.autotune_stats(),
            "obs": {
                "metrics": self.metrics.snapshot(),
                "tracer": {
                    "enabled": tracer.enabled,
                    "spans": len(tracer.spans),
                    "dropped": tracer.dropped,
                },
            },
        }
