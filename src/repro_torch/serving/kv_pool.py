"""Paged KV-cache pool for the continuous-batching serving engine.

The port of ``repro.serving.kv_pool``. Two layers:

* :class:`PagePool` — host-side page accounting, copied as is: a fixed
  budget of interchangeable pages with a free list. Page id 0 is a reserved
  scratch page: dead decode slots and padding writes are routed there so
  the decode step never needs a branch.
* :class:`CacheLayout` — the bridge between the model's dense serving cache
  (``transformer.init_cache``: one {k, v} per layer) and pooled device
  storage. Each layer is classified by its kind:

  - full-attention KV (``attn``, or ``local_attn`` with window 0) is
    **paged**: one pool tensor of shape ``(P, Hkv, page_size, hd)`` per
    layer, shared by all slots, addressed through a per-slot page table;
  - ring-buffer local attention and recurrent state (``mlstm``, ``slstm``)
    are **slot-indexed**: O(window) and O(1) per slot, so they stay dense at
    ``batch == n_slots``. Recurrent state is fp32 whatever the cache dtype.
    A layout with no paged layer (xLSTM) runs with a pool of 0 pages.

  The decode step gathers each slot's pages into a contiguous bucketed
  view, runs the ordinary model decode on it, then scatters the one
  written column back. The JAX layout is per scan group; the port's model
  has no scan groups, so its layout is per layer. Pools are updated in
  place. An fp8 pool (``cfg.cache_dtype``) is gathered, scattered and
  filled through uint8 views of its storage (``attention.as_bits``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models.attention import as_bits
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _init_layer_cache

__all__ = ["PoolExhausted", "PagePool", "CacheLayout", "SCRATCH_PAGE"]

# Page id 0 never holds request state: dead slots scatter into it and
# unwritten page-table entries gather from it (masked out by position).
SCRATCH_PAGE = 0


class PoolExhausted(RuntimeError):
    """Raised by PagePool.alloc when the request cannot be satisfied."""


class PagePool:
    """Host-side free-list over a fixed budget of interchangeable pages.

    Pages are plain ints in ``[1, capacity]`` (0 is the scratch page).
    Same discipline as the blocks arena allocator: O(1) alloc/free, a
    double-free guard, and exact accounting so eviction leaks surface
    immediately in tests.
    """

    def __init__(self, capacity: int, page_size: int):
        if capacity < 0:
            raise ValueError(f"page capacity must be >= 0, got {capacity}")
        if page_size <= 0:
            raise ValueError(f"page_size must be > 0, got {page_size}")
        self.capacity = int(capacity)
        self.page_size = int(page_size)
        self._free = deque(range(1, capacity + 1))
        self._in_use: set = set()

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._in_use)

    def pages_for_tokens(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 0) // self.page_size)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free of {self.capacity}"
            )
        pages = [self._free.popleft() for _ in range(n)]
        self._in_use.update(pages)
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p == SCRATCH_PAGE:
                raise ValueError("scratch page cannot be freed")
            if p not in self._in_use:
                raise ValueError(f"double free / foreign page {p}")
            self._in_use.remove(p)
            self._free.append(p)


# --------------------------------------------------------------- layout


@dataclasses.dataclass(frozen=True)
class _Node:
    """One layer's cache: its index, kind and how it is stored."""

    index: int  # layer index
    kind: str  # layer kind from cfg.block_pattern
    paged: bool  # True -> attn KV routed through the page pool


def _is_paged(cfg: ModelConfig, kind: str) -> bool:
    # local_attn with window 0 degenerates to full attention (see
    # transformer._apply_layer); a real window is a fixed-size ring.
    return kind == "attn" or (kind == "local_attn" and not cfg.local_window)


@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """Static description of how a config's serving cache maps to pools."""

    cfg: ModelConfig
    n_slots: int
    page_size: int
    max_seq: int
    device: str = "cuda"

    @property
    def table_width(self) -> int:
        """Max pages a single slot can reference (covers max_seq)."""
        return -(-self.max_seq // self.page_size)

    @property
    def nodes(self) -> Tuple[_Node, ...]:
        cfg = self.cfg
        return tuple(
            _Node(i, cfg.block_kind(i), _is_paged(cfg, cfg.block_kind(i)))
            for i in range(cfg.n_layers)
        )

    @property
    def has_paged(self) -> bool:
        return any(n.paged for n in self.nodes)

    def _cache_dtype(self) -> torch.dtype:
        cfg = self.cfg
        return getattr(torch, cfg.cache_dtype or cfg.dtype)

    # ------------------------------------------------------------ init

    def init_kv_state(self, n_pages: int) -> List[Dict[str, torch.Tensor]]:
        """Persistent device state, one entry per layer: pools for paged KV,
        slot arrays else. ``n_pages`` is the usable page budget; each pool
        holds one extra scratch page at index 0."""
        cfg, dtype = self.cfg, self._cache_dtype()
        kv_shape = (n_pages + 1, cfg.n_kv_heads, self.page_size, cfg.head_dim)
        state = []
        for node in self.nodes:
            if node.paged:
                state.append({
                    "k": torch.zeros(kv_shape, dtype=dtype, device=self.device),
                    "v": torch.zeros(kv_shape, dtype=dtype, device=self.device),
                })
            else:
                state.append(_init_layer_cache(
                    cfg, node.kind, self.n_slots, self.max_seq, dtype, self.device))
        return state

    def init_prefill_cache(self, capacity: int) -> Dict[str, Any]:
        """Batch-1 dense cache for one request's prefill.

        Paged entries are sized to the bucketed prompt ``capacity`` (a
        multiple of page_size, so they reshape exactly into pages); ring
        entries match the persistent slot layout so the insert is a row write.
        """
        if capacity % self.page_size:
            raise ValueError(f"capacity {capacity} is not a multiple of page_size {self.page_size}")
        dtype = self._cache_dtype()
        layers = [
            _init_layer_cache(self.cfg, node.kind, 1, capacity if node.paged else self.max_seq,
                              dtype, self.device)
            for node in self.nodes
        ]
        return {"pos": torch.zeros((), dtype=torch.long, device=self.device), "layers": layers}

    # ---------------------------------------------------------- gather

    def gather(
        self,
        kv_state: List[Dict[str, torch.Tensor]],
        page_table: torch.Tensor,  # (n_slots, table_width) int
        pos: torch.Tensor,  # (n_slots,) int
        bucket_pages: int,
    ) -> Dict[str, Any]:
        """Materialize the dense decode view (the model's cache layout): each
        slot's first ``bucket_pages`` pages, contiguous along the seq axis.
        Ring buffers are copied, since decode attention writes its cache in
        place; recurrent state is handed over as is, since the xLSTM blocks
        return new state and never write the state they are given."""
        table_b = page_table[:, :bucket_pages]
        layers = []
        for node, sub in zip(self.nodes, kv_state):
            if node.paged:
                layers.append({name: self._gather_leaf(pool, table_b) for name, pool in sub.items()})
            elif node.kind == "local_attn":
                layers.append({name: t.clone() for name, t in sub.items()})
            else:
                layers.append(dict(sub))
        return {"pos": pos, "layers": layers}

    @staticmethod
    def _gather_leaf(pool: torch.Tensor, table_b: torch.Tensor) -> torch.Tensor:
        b, bp = table_b.shape
        g = as_bits(pool)[table_b]  # (B, bp, H, ps, d)
        _, _, h, ps, d = g.shape
        return g.transpose(1, 2).reshape(b, h, bp * ps, d).view(pool.dtype)

    # --------------------------------------------------------- scatter

    def scatter_token(
        self,
        kv_state: List[Dict[str, torch.Tensor]],
        new_dense: Dict[str, Any],
        page_table: torch.Tensor,
        pos: torch.Tensor,  # (n_slots,) position written this step
        live: torch.Tensor,  # (n_slots,) bool
    ) -> List[Dict[str, torch.Tensor]]:
        """Commit one decode step, in place: write each live slot's new KV
        column into its page (dead slots write the scratch page), and copy
        the slot-indexed state of live slots only: a dead slot's ring buffer
        and recurrent state stay as they were, so a finished request's
        state never advances."""
        ps = self.page_size
        pos = pos.long()
        page_idx = torch.gather(page_table, 1, (pos // ps)[:, None])[:, 0].long()
        page_idx = torch.where(live, page_idx, SCRATCH_PAGE)
        off = pos % ps
        rows = torch.arange(pos.shape[0], device=pos.device)
        for node, old, new in zip(self.nodes, kv_state, new_dense["layers"]):
            for name in old:
                dst, src = as_bits(old[name]), as_bits(new[name])
                if node.paged:
                    # pages were gathered from the table prefix in order, so the
                    # column written this step sits at ``pos`` of the view
                    dst[page_idx, :, off, :] = src[rows, :, pos, :]
                else:
                    keep = live.reshape(-1, *([1] * (dst.ndim - 1)))
                    dst.copy_(torch.where(keep, src, dst))
        return kv_state

    # ---------------------------------------------------------- insert

    def insert_request(
        self,
        kv_state: List[Dict[str, torch.Tensor]],
        prefill_cache: Dict[str, Any],
        slot: int,
        page_ids: torch.Tensor,  # (capacity // page_size,) int
    ) -> List[Dict[str, torch.Tensor]]:
        """Move a finished prefill (batch-1 dense cache) into the pool, in
        place: KV pages to their allocated ids, slot state row-written."""
        nb = page_ids.shape[0]
        for node, old, new in zip(self.nodes, kv_state, prefill_cache["layers"]):
            for name in old:
                dst, src = as_bits(old[name]), as_bits(new[name])
                if node.paged:
                    _, h, _, d = src.shape
                    vals = src[0].reshape(h, nb, self.page_size, d).transpose(0, 1)
                    dst[page_ids.long()] = vals
                else:
                    dst[slot] = src[0]
        return kv_state
