"""(row, col, tag)-addressed block matrices over pluggable host stores.

The port of :mod:`repro.blocks.blockmatrix`. The MLlib/Marlin ``BlockMatrix``
layout (Zadeh et al.) as a host-resident runtime structure: a matrix is a
uniform grid of (bm, bn) blocks, each addressed by ``(row, col, tag)`` where
``tag`` is a recursion tag-path string (:mod:`repro_torch.blocks.tags`) naming
the node of the Strassen tree the block belongs to: ``""`` for a root
operand, ``"A:3,0"`` for the level-2 divide product of A that took M-branches
3 then 0, and so on.

Blocks are CPU ``torch`` tensors, bf16 included (the reference keeps numpy
arrays, bf16 as ml_dtypes; the port imports no ml_dtypes). They live in a
:class:`BlockStore`, which is deliberately dumb (put / get / delete tensors
by key), so the same :class:`BlockMatrix` code runs over three residencies:

* :class:`DictStore`   — plain in-memory dict (tests, small problems);
* :class:`ArenaStore`  — one preallocated host-RAM arena of fixed-size
  slots with a free list, so a long multiply churns zero allocations and
  the host footprint is a hard, visible number;
* :class:`MemmapStore` — one ``.npy`` memmap file per block under a spill
  directory, for operands larger than host RAM (the paper's "data far
  larger than memory" regime, with the filesystem playing HDFS). bf16
  blocks are written as their int16 bits; the index keeps the dtype.

Edge blocks are zero-padded to the full block shape in storage; the
logical shape is metadata, so ``to_dense`` round-trips odd shapes exactly.
"""
from __future__ import annotations

import abc
import os
import shutil
import tempfile
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "BlockKey",
    "BlockStore",
    "DictStore",
    "ArenaStore",
    "MemmapStore",
    "make_store",
    "BlockMatrix",
    "signed_block_sum",
    "as_dtype",
    "as_host_tensor",
]

BlockKey = Tuple[int, int, str]  # (block row, block col, tag string)


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ('float32', 'bfloat16')."""
    if isinstance(dtype, torch.dtype):
        return dtype
    got = getattr(torch, str(dtype), None)
    if not isinstance(got, torch.dtype):
        raise TypeError(f"need a torch dtype or a dtype name, got {dtype!r}")
    return got


def as_host_tensor(x) -> torch.Tensor:
    """A CPU tensor holding ``x``'s values: a tensor on any device, or a numpy
    array (an ml_dtypes bfloat16 array crosses through its int16 bits)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    arr = np.ascontiguousarray(x)
    if not arr.flags.writeable:  # torch tensors are writable; keep the caller's array intact
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def signed_block_sum(get_block, coefs, acc_dtype: torch.dtype) -> torch.Tensor:
    """sum_i coefs[i] * get_block(i) with zero-skip and +/-1 fast paths.

    The one accumulation discipline divide, combine, AND lineage recompute
    (:mod:`repro_torch.blocks.recovery`) share: terms are cast to
    ``acc_dtype`` and summed in ascending index order. Recompute replays a
    block bit-for-bit only because it runs this exact loop: keep any change
    to the ordering or fast paths here. Every step is out of place: the
    first term may BE a stored block (the cast is a no-op when the dtypes
    agree), so an in-place accumulate would corrupt the store.
    """
    acc = None
    for idx in range(len(coefs)):
        c = float(coefs[idx])
        if c == 0.0:
            continue
        blk = get_block(idx).to(acc_dtype)
        term = blk if c == 1.0 else (-blk if c == -1.0 else c * blk)
        acc = term if acc is None else acc + term
    if acc is None:
        raise ValueError("coefficient row is all zero")
    return acc


class BlockStore(abc.ABC):
    """Minimal key -> CPU tensor block storage contract."""

    @abc.abstractmethod
    def put(self, key: BlockKey, block: torch.Tensor) -> None: ...

    @abc.abstractmethod
    def get(self, key: BlockKey) -> torch.Tensor: ...

    @abc.abstractmethod
    def delete(self, key: BlockKey) -> None: ...

    @abc.abstractmethod
    def __contains__(self, key: BlockKey) -> bool: ...

    @abc.abstractmethod
    def keys(self) -> List[BlockKey]: ...

    @abc.abstractmethod
    def nbytes(self) -> int:
        """Bytes currently held (logical block bytes, not slack)."""

    def delete_tag(self, tag: str) -> None:
        """Drop every block of one tree node (combine frees its children)."""
        for key in [k for k in self.keys() if k[2] == tag]:
            self.delete(key)

    def clear(self) -> None:
        for key in list(self.keys()):
            self.delete(key)

    def close(self) -> None:  # releases files/arenas; default no-op
        self.clear()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DictStore(BlockStore):
    """In-memory dict of blocks — the reference store."""

    def __init__(self) -> None:
        self._blocks: Dict[BlockKey, torch.Tensor] = {}

    def put(self, key: BlockKey, block: torch.Tensor) -> None:
        self._blocks[key] = block.contiguous()

    def get(self, key: BlockKey) -> torch.Tensor:
        return self._blocks[key]

    def delete(self, key: BlockKey) -> None:
        self._blocks.pop(key, None)

    def __contains__(self, key: BlockKey) -> bool:
        return key in self._blocks

    def keys(self) -> List[BlockKey]:
        return list(self._blocks)

    def nbytes(self) -> int:
        return sum(_nbytes(b) for b in self._blocks.values())


class ArenaStore(BlockStore):
    """Preallocated host-RAM arena: fixed-size byte slots + a free list.

    ``slot_bytes`` must cover the largest block the caller will put (the
    scheduler sizes it as max over the A/B/C block shapes and dtypes —
    slots are raw bytes, so bf16 operands and f32 accumulators share one
    arena). The arena grows by whole segments of ``capacity`` slots when
    full, so steady state churns zero allocations and peak host bytes are
    ``segments * capacity * slot stride`` (the stride is ``slot_bytes``
    rounded up to 8, so every slot can be viewed as any element type).
    """

    def __init__(self, slot_bytes: int, capacity: int = 64) -> None:
        if slot_bytes <= 0 or capacity <= 0:
            raise ValueError("slot_bytes and capacity must be positive")
        self.slot_bytes = int(slot_bytes)
        self.capacity = int(capacity)
        self._stride = -(-self.slot_bytes // 8) * 8
        self._segments: List[torch.Tensor] = []
        self._free: List[int] = []
        # key -> (global slot index, block shape, block dtype)
        self._index: Dict[BlockKey, Tuple[int, Tuple[int, ...], torch.dtype]] = {}

    def _grow(self) -> None:
        base = len(self._segments) * self.capacity
        self._segments.append(torch.empty((self.capacity, self._stride), dtype=torch.uint8))
        self._free.extend(reversed(range(base, base + self.capacity)))

    def _slot(self, idx: int) -> torch.Tensor:
        return self._segments[idx // self.capacity][idx % self.capacity]

    def put(self, key: BlockKey, block: torch.Tensor) -> None:
        block = block.contiguous()
        n = _nbytes(block)
        if n > self.slot_bytes:
            raise ValueError(f"block of {n} B exceeds slot_bytes={self.slot_bytes}")
        if key in self._index:
            idx = self._index[key][0]
        else:
            if not self._free:
                self._grow()
            idx = self._free.pop()
        self._slot(idx)[:n].copy_(block.reshape(-1).view(torch.uint8))
        self._index[key] = (idx, tuple(block.shape), block.dtype)

    def get(self, key: BlockKey) -> torch.Tensor:
        idx, shape, dtype = self._index[key]
        n = int(np.prod(shape)) * dtype.itemsize
        return self._slot(idx)[:n].view(dtype).reshape(shape)

    def delete(self, key: BlockKey) -> None:
        entry = self._index.pop(key, None)
        if entry is not None:
            self._free.append(entry[0])

    def __contains__(self, key: BlockKey) -> bool:
        return key in self._index

    def keys(self) -> List[BlockKey]:
        return list(self._index)

    def nbytes(self) -> int:
        return sum(int(np.prod(shape)) * dtype.itemsize for _, shape, dtype in self._index.values())

    def arena_bytes(self) -> int:
        """Allocated host footprint (all segments, used or free)."""
        return sum(_nbytes(seg) for seg in self._segments)

    def close(self) -> None:
        self._index.clear()
        self._free.clear()
        self._segments.clear()


# How a block's dtype is written to an .npy file, and read back.
_NPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
               torch.bfloat16: np.int16, torch.float16: np.float16}


class MemmapStore(BlockStore):
    """npy/memmap spill backend: one ``.npy`` file per block.

    Blocks are written with :func:`numpy.lib.format.open_memmap` (plain
    ``np.load``-able files; bf16 blocks as their int16 bits) under ``root`` —
    a caller-owned spill directory, or a self-created temp dir removed on
    :meth:`close`. ``get`` maps the file copy-on-write, so a combine touching
    7 children pages in only the bytes it reads and no write reaches disk.
    """

    def __init__(self, root: Optional[str] = None) -> None:
        self._owned = root is None
        self.root = root or tempfile.mkdtemp(prefix="repro_blocks_")
        os.makedirs(self.root, exist_ok=True)
        # key -> (path, dtype): the index keeps the true dtype (bf16 is stored
        # as int16) and get() re-views the mapped bytes.
        self._index: Dict[BlockKey, Tuple[str, torch.dtype]] = {}
        self._counter = 0

    def _path(self, key: BlockKey) -> str:
        entry = self._index.get(key)
        if entry is not None:
            return entry[0]
        # filenames are opaque ids: tags contain ':' and ',' which are
        # legal but ugly on some filesystems; the index owns the map.
        path = os.path.join(self.root, f"blk{self._counter:08d}.npy")
        self._counter += 1
        return path

    def put(self, key: BlockKey, block: torch.Tensor) -> None:
        block = block.contiguous()
        if block.dtype not in _NPY_DTYPES:
            raise TypeError(f"MemmapStore cannot spill {block.dtype} blocks")
        bits = block.view(torch.int16) if block.dtype == torch.bfloat16 else block
        path = self._path(key)
        mm = np.lib.format.open_memmap(
            path, mode="w+", dtype=_NPY_DTYPES[block.dtype], shape=tuple(block.shape)
        )
        mm[...] = bits.numpy()
        mm.flush()
        del mm
        self._index[key] = (path, block.dtype)

    def get(self, key: BlockKey) -> torch.Tensor:
        path, dtype = self._index[key]
        t = torch.from_numpy(np.lib.format.open_memmap(path, mode="c"))
        return t.view(dtype) if dtype == torch.bfloat16 else t

    def delete(self, key: BlockKey) -> None:
        entry = self._index.pop(key, None)
        if entry is not None and os.path.exists(entry[0]):
            os.remove(entry[0])

    def __contains__(self, key: BlockKey) -> bool:
        return key in self._index

    def keys(self) -> List[BlockKey]:
        return list(self._index)

    def nbytes(self) -> int:
        return sum(os.path.getsize(p) for p, _ in self._index.values() if os.path.exists(p))

    def close(self) -> None:
        self._index.clear()
        if self._owned and os.path.isdir(self.root):
            shutil.rmtree(self.root, ignore_errors=True)


def make_store(
    spec: str | BlockStore,
    *,
    slot_bytes: int = 0,
    capacity: int = 64,
    root: Optional[str] = None,
) -> BlockStore:
    """Store factory for CLI/benchmark surfaces: 'dict' | 'arena' | 'memmap'."""
    if isinstance(spec, BlockStore):
        return spec
    if spec == "dict":
        return DictStore()
    if spec == "arena":
        if slot_bytes <= 0:
            raise ValueError("arena store needs slot_bytes > 0")
        return ArenaStore(slot_bytes, capacity=capacity)
    if spec == "memmap":
        return MemmapStore(root)
    raise ValueError(f"unknown store {spec!r}; have 'dict', 'arena', 'memmap'")


class BlockMatrix:
    """A logical (m, n) matrix stored as a tagged grid of uniform blocks.

    ``shape`` is the logical shape; the stored grid covers
    ``grid = (ceil(m / bm), ceil(n / bn))`` blocks of exactly
    ``block_shape``, edge blocks zero-padded. ``tag`` names the recursion
    node every block of this matrix belongs to and is part of each block's
    store key, so many tree nodes share one store.
    """

    def __init__(
        self,
        store: BlockStore,
        shape: Tuple[int, int],
        block_shape: Tuple[int, int],
        dtype,
        tag: str = "",
    ) -> None:
        m, n = shape
        bm, bn = block_shape
        if m <= 0 or n <= 0 or bm <= 0 or bn <= 0:
            raise ValueError(f"bad shape {shape} / block_shape {block_shape}")
        self.store = store
        self.shape = (int(m), int(n))
        self.block_shape = (int(bm), int(bn))
        self.dtype = as_dtype(dtype)
        self.tag = tag
        self.grid = (-(-m // bm), -(-n // bn))

    # ------------------------------------------------------------- metadata
    @property
    def padded_shape(self) -> Tuple[int, int]:
        return (
            self.grid[0] * self.block_shape[0],
            self.grid[1] * self.block_shape[1],
        )

    @property
    def nbytes(self) -> int:
        """Stored bytes of this matrix (full padded grid)."""
        return (
            self.grid[0]
            * self.grid[1]
            * self.block_shape[0]
            * self.block_shape[1]
            * self.dtype.itemsize
        )

    def meta(self) -> Dict:
        """dtype/layout metadata travelling with the blocks."""
        return {
            "shape": self.shape,
            "padded_shape": self.padded_shape,
            "block_shape": self.block_shape,
            "grid": self.grid,
            "dtype": str(self.dtype).removeprefix("torch."),
            "tag": self.tag,
            "layout": "row-major",
        }

    def key(self, i: int, j: int) -> BlockKey:
        return (i, j, self.tag)

    def block_keys(self) -> Iterator[BlockKey]:
        for i in range(self.grid[0]):
            for j in range(self.grid[1]):
                yield self.key(i, j)

    # ---------------------------------------------------------- block access
    def block(self, i: int, j: int) -> torch.Tensor:
        """The stored (bm, bn) block at grid position (i, j)."""
        if not (0 <= i < self.grid[0] and 0 <= j < self.grid[1]):
            raise IndexError(f"block ({i}, {j}) outside grid {self.grid}")
        return self.store.get(self.key(i, j))

    def put_block(self, i: int, j: int, block: torch.Tensor) -> None:
        if tuple(block.shape) != self.block_shape:
            raise ValueError(
                f"block shape {tuple(block.shape)} != {self.block_shape} (store padded)"
            )
        self.store.put(self.key(i, j), block.to(self.dtype))

    def free(self) -> None:
        """Delete every block of this matrix from the store."""
        for key in self.block_keys():
            self.store.delete(key)

    # ------------------------------------------------------- dense interop
    @classmethod
    def from_dense(
        cls,
        arr,
        block_shape: Tuple[int, int],
        store: Optional[BlockStore] = None,
        tag: str = "",
        shape: Optional[Tuple[int, int]] = None,
    ) -> "BlockMatrix":
        """Ingest a dense matrix block by block.

        ``shape`` (>= ``arr.shape``) zero-extends the matrix to a larger
        logical shape without materializing the padded dense copy — the
        scheduler uses it to align operands to the recursion grain.
        """
        arr = as_host_tensor(arr)
        if arr.ndim != 2:
            raise ValueError(f"need a 2-D array, got shape {tuple(arr.shape)}")
        shape = tuple(shape) if shape is not None else tuple(arr.shape)
        if shape[0] < arr.shape[0] or shape[1] < arr.shape[1]:
            raise ValueError(f"shape {shape} smaller than data {tuple(arr.shape)}")
        store = store if store is not None else DictStore()
        bm_mat = cls(store, shape, block_shape, arr.dtype, tag)
        bm, bn = bm_mat.block_shape
        for i in range(bm_mat.grid[0]):
            for j in range(bm_mat.grid[1]):
                chunk = arr[i * bm : (i + 1) * bm, j * bn : (j + 1) * bn]
                if tuple(chunk.shape) != (bm, bn):
                    full = torch.zeros((bm, bn), dtype=bm_mat.dtype)
                    full[: chunk.shape[0], : chunk.shape[1]] = chunk
                    chunk = full
                bm_mat.put_block(i, j, chunk)
        return bm_mat

    @classmethod
    def zeros(
        cls,
        shape: Tuple[int, int],
        block_shape: Tuple[int, int],
        store: BlockStore,
        dtype,
        tag: str = "",
    ) -> "BlockMatrix":
        out = cls(store, shape, block_shape, dtype, tag)
        zero = torch.zeros(out.block_shape, dtype=out.dtype)
        for i in range(out.grid[0]):
            for j in range(out.grid[1]):
                out.put_block(i, j, zero)
        return out

    def to_dense(self, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The logical (m, n) matrix as one tensor.

        ``out`` (a padded-shape tensor of any dtype, e.g. a pinned staging
        buffer) receives the blocks, cast to its dtype; without it a new
        tensor of the matrix's dtype is allocated.
        """
        m, n = self.shape
        bm, bn = self.block_shape
        if out is None:
            out = torch.empty(self.padded_shape, dtype=self.dtype)
        elif tuple(out.shape) != self.padded_shape:
            raise ValueError(f"out has shape {tuple(out.shape)}, want {self.padded_shape}")
        for i in range(self.grid[0]):
            for j in range(self.grid[1]):
                out[i * bm : (i + 1) * bm, j * bn : (j + 1) * bn].copy_(self.block(i, j))
        return out[:m, :n]

    def __repr__(self) -> str:
        return (
            f"BlockMatrix(shape={self.shape}, block={self.block_shape}, "
            f"grid={self.grid}, dtype={str(self.dtype).removeprefix('torch.')}, "
            f"tag={self.tag!r}, store={type(self.store).__name__})"
        )
