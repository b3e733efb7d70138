"""A mesh of positions in one process: the port's counterpart of a JAX device mesh.

The JAX package runs its distributed strategies single-controller: one
Python process drives every device of a ``jax.sharding.Mesh`` (its tests
force 8 host devices). This module keeps that model in PyTorch idiom:

* :class:`Mesh` is an object ndarray of ``torch.device``s, one per
  *position*, with ``axis_names``; ``mesh.shape`` maps each name to its size
  in order, as JAX's does. :func:`make_mesh` places the positions
  round-robin on the visible devices of one type: on one H100 every
  position is ``cuda:0`` (the counterpart of XLA's forced host devices).
  On a host with several cards the copies between positions on different
  cards are peer copies; no run has tested that path yet.
* :class:`P` is the partition spec: per dim ``None``, an axis name or a
  tuple of names (the first name major).
* :class:`Sharded` holds one local tensor per position under a spec.
  :func:`shard`, :func:`gather`, :func:`reshard` and :func:`fetch` move data
  between the global tensor and the positions. A dim of size n over k
  shards is cut as JAX cuts it: shards of ceil(n / k), the last ones short
  or empty (343 leaves over 4 are 86, 86, 86, 85).
* :meth:`Mesh.psum`, :meth:`Mesh.all_gather` and :meth:`Mesh.psum_scatter`
  are the explicit collectives over a named axis (or a tuple of axes).

There is no SPMD ``shard_map`` emulation: a strategy is written as local
phases per position (:meth:`Mesh.run`, :meth:`Mesh.map`) with collectives
and fetches between them, which is Stark's divide, shuffle, leaf, shuffle
and combine.

Replicas on one device alias: every position on a tensor's device that
holds the same slab of it gets the same view, and :meth:`Mesh.map` runs a
function once per distinct set of inputs. Seven positions of a replicated
16384^2 operand on ``cuda:0`` share one storage.

An observer (:func:`set_observer`; ``launch/op_analysis.py`` installs one
while it traces a step on fake tensors) is told which positions the work of
each local phase belongs to (:meth:`Mesh.run`, :meth:`Mesh.map` and a
fetch's ``then``: every position that shares a call), which work is a
movement (the copies and adds inside the collectives, :func:`shard`,
:func:`gather` and a fetch's assembly) and, per position, the operand
bytes of every collective. With no observer nothing is told.

Every movement adds to the mesh's totals (:attr:`Mesh.traffic`, one
:class:`Traffic` per kind of movement and axes, so they stay small however
many calls a mesh serves): a count and two byte counts. *Logical* bytes move between positions: what a cluster of that
many devices would send, the counterpart of the HLO collective bytes the
JAX package reads (``shard`` and ``gather`` move data between the caller
and the positions and count none, as jit's argument placement is no HLO
collective). *Physical* bytes are copied between distinct devices: 0 on
one card. A psum over k positions of B bytes each counts 2 (k - 1) B, an
all-gather of chunks of B bytes k (k - 1) B, a psum-scatter of B bytes
(k - 1) B (ring algorithms), a fetch the bytes a position did not hold.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "P",
    "Mesh",
    "Traffic",
    "Sharded",
    "make_mesh",
    "shard",
    "gather",
    "reshard",
    "fetch",
    "dim_parts",
    "slab",
    "spec_axes",
    "distinct_slabs",
    "set_observer",
]

Pos = Tuple[int, ...]
Box = Tuple[slice, ...]


class P(tuple):
    """Partition spec: one entry per dim, ``None``, an axis name or a tuple of names.

    Dims past the spec's length are not sharded; ``P()`` replicates.
    """

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Traffic:
    """The movements of one kind over one set of axes: how many, and their bytes."""

    count: int = 0
    logical_bytes: int = 0
    physical_bytes: int = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# The observer of local phases and movements, or None (see the module docstring).
_observer = None


def set_observer(observer):
    """Install ``observer`` (None removes it); returns the one it replaces.

    An observer has ``pinned(positions)`` and ``moving(positions)``, context
    managers around a local phase's work and a movement's work (``moving(None)``
    for a movement between the caller and the positions), and
    ``collective(kind, sizes, group_size)``, ``sizes`` the operand bytes per
    position of one ``psum``, ``all_gather`` or ``psum_scatter`` over groups
    of ``group_size`` positions, or of one ``reshard`` (``group_size`` None).
    """
    global _observer
    previous, _observer = _observer, observer
    return previous


def _pinned(positions):
    return _observer.pinned(positions) if _observer is not None else contextlib.nullcontext()


def _moving(positions):
    return _observer.moving(positions) if _observer is not None else contextlib.nullcontext()


def _tell(kind: str, mesh: "Mesh", size_of: Callable[[Tuple[int, ...]], int],
          group_size: Optional[int] = None) -> None:
    if _observer is not None:
        _observer.collective(kind, {pos: size_of(pos) for pos in mesh.positions()}, group_size)


def _axes(axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Mesh:
    """An ndarray of devices, one per position, with named axes."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if devices.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"axis names {names} do not fit devices of shape {devices.shape}")
        self.devices = devices
        self.axis_names = names
        self.shape: Dict[str, int] = collections.OrderedDict(zip(names, devices.shape))
        # (op, axes) -> totals; op is psum | all_gather | psum_scatter |
        # reshard | shard | gather.
        self.traffic: Dict[Tuple[str, Tuple[str, ...]], Traffic] = {}
        # the holders of each slab index, per tuple of spec dims (_holder_index)
        self._holders: Dict[Tuple, Dict] = {}

    def __repr__(self) -> str:
        kinds = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({dict(self.shape)}, devices={kinds})"

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """The device of position 0: where a gathered result lands."""
        return self.devices.flat[0]

    def positions(self) -> Iterator[Pos]:
        return np.ndindex(self.devices.shape)

    def device_of(self, pos: Pos) -> torch.device:
        return self.devices[pos]

    def physical_count(self) -> int:
        """Distinct devices behind the positions."""
        return len({str(d) for d in self.devices.flat})

    def axis_index(self, pos: Pos, axis) -> int:
        """The position's index along an axis or a tuple of axes (first major)."""
        idx = 0
        for name in _axes(axis):
            i = self.axis_names.index(name)
            idx = idx * self.devices.shape[i] + pos[i]
        return idx

    def axis_size(self, axis) -> int:
        return math.prod(self.shape[name] for name in _axes(axis))

    # ------------------------------------------------------------ records
    def record(self, op: str, axes, logical: int, physical: int) -> None:
        key = (op, _axes(axes))
        t = self.traffic.get(key, Traffic())
        self.traffic[key] = Traffic(t.count + 1, t.logical_bytes + int(logical),
                                    t.physical_bytes + int(physical))

    def count(self, op: Optional[str] = None, axis=None) -> int:
        """Movements of kind ``op`` (all kinds if None), over ``axis`` if given."""
        want = _axes(axis) if axis is not None else None
        return sum(t.count for (o, axes), t in self.traffic.items()
                   if (op is None or o == op) and (want is None or axes == want))

    @property
    def logical_bytes(self) -> int:
        return sum(t.logical_bytes for t in self.traffic.values())

    @property
    def physical_bytes(self) -> int:
        return sum(t.physical_bytes for t in self.traffic.values())

    def reset(self) -> None:
        """Zero the totals."""
        self.traffic = {}

    # ------------------------------------------------------- local phases
    def _empty(self) -> np.ndarray:
        return np.empty(self.devices.shape, dtype=object)

    def run(self, fn: Callable[[Pos], torch.Tensor]) -> np.ndarray:
        """One local phase: ``fn(pos)`` on every position; an ndarray of results."""
        out = self._empty()
        for pos in self.positions():
            with _pinned([pos]):
                out[pos] = fn(pos)
        return out

    def map(self, fn: Callable[..., torch.Tensor], *locals_: np.ndarray) -> np.ndarray:
        """``fn`` on each position's local tensors, once per distinct set of
        inputs (in the order the positions first hold them): replicas that
        alias on one device share one result."""
        out, groups = self._empty(), {}
        for pos in self.positions():
            args = tuple(x[pos] for x in locals_)
            groups.setdefault(tuple(id(a) for a in args), (args, []))[1].append(pos)
        for args, members in groups.values():
            with _pinned(members):
                result = fn(*args)
            for pos in members:
                out[pos] = result
        return out

    # --------------------------------------------------------- collectives
    def groups(self, axis) -> Iterator[List[Pos]]:
        """Positions that differ only along ``axis``, ordered by their index on it."""
        names = _axes(axis)
        dims = [self.axis_names.index(n) for n in names]
        rest = [i for i in range(len(self.axis_names)) if i not in dims]
        shape = self.devices.shape
        for other in np.ndindex(*[shape[i] for i in rest]):
            members = []
            for along in np.ndindex(*[shape[i] for i in dims]):
                pos = [0] * len(shape)
                for i, v in zip(rest, other):
                    pos[i] = v
                for i, v in zip(dims, along):
                    pos[i] = v
                members.append(tuple(pos))
            yield members

    def _spread(self, out: np.ndarray, members: List[Pos], value: torch.Tensor,
                moved: List[int]) -> None:
        """Give every member ``value``: the same tensor on its device, one copy per other device."""
        copies = {str(value.device): value}
        for pos in members:
            dev = self.device_of(pos)
            if str(dev) not in copies:
                copies[str(dev)] = value.to(dev)
                moved[0] += _nbytes(value)
            out[pos] = copies[str(dev)]

    def _sum(self, xs: np.ndarray, members: List[Pos], moved: List[int]) -> torch.Tensor:
        """The members' sum on the first member's device, added in member order."""
        dev = self.device_of(members[0])
        acc = xs[members[0]]
        for i, pos in enumerate(members[1:]):
            x = xs[pos]
            if x.device != dev:
                x = x.to(dev)
                moved[0] += _nbytes(x)
            acc = acc + x if i == 0 else acc.add_(x)
        return acc

    def psum(self, xs: np.ndarray, axis) -> np.ndarray:
        """All-reduce over ``axis``: every member gets the group's sum.

        The sum is formed on the first member's device in the order of the
        members' index along the axis, each add in the tensors' dtype (so
        bf16 rounds after each add), then handed to the members.
        """
        out, logical, moved = self._empty(), 0, [0]
        for members in self.groups(axis):
            with _moving(members):
                total = self._sum(xs, members, moved)
                self._spread(out, members, total, moved)
            logical += 2 * (len(members) - 1) * _nbytes(total)
        self.record("psum", axis, logical, moved[0])
        _tell("psum", self, lambda pos: _nbytes(xs[pos]), self.axis_size(axis))
        return out

    def all_gather(self, xs: np.ndarray, axis) -> np.ndarray:
        """Tiled all-gather over ``axis``: the members' tensors concatenated along dim 0."""
        out, logical, moved = self._empty(), 0, [0]
        for members in self.groups(axis):
            dev = self.device_of(members[0])
            parts = []
            with _moving(members):
                for pos in members:
                    x = xs[pos]
                    if x.device != dev:
                        x = x.to(dev)
                        moved[0] += _nbytes(x)
                    parts.append(x)
                whole = torch.cat(parts)
                self._spread(out, members, whole, moved)
            logical += (len(members) - 1) * sum(_nbytes(xs[p]) for p in members)
        self.record("all_gather", axis, logical, moved[0])
        _tell("all_gather", self, lambda pos: _nbytes(xs[pos]), self.axis_size(axis))
        return out

    def psum_scatter(self, xs: np.ndarray, axis) -> np.ndarray:
        """Tiled reduce-scatter over ``axis``: member i gets chunk i of the sum along dim 0."""
        out, logical, moved = self._empty(), 0, [0]
        for members in self.groups(axis):
            with _moving(members):
                total = self._sum(xs, members, moved)
                k = len(members)
                if total.shape[0] % k:
                    raise ValueError(f"dim 0 of size {total.shape[0]} does not split {k} ways")
                for pos, chunk in zip(members, total.chunk(k)):
                    dev = self.device_of(pos)
                    if chunk.device != dev:
                        chunk = chunk.to(dev)
                        moved[0] += _nbytes(chunk)
                    out[pos] = chunk
            logical += (k - 1) * _nbytes(total)
        self.record("psum_scatter", axis, logical, moved[0])
        _tell("psum_scatter", self, lambda pos: _nbytes(xs[pos]), self.axis_size(axis))
        return out


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              device: str | torch.device = "cuda") -> Mesh:
    """A mesh of ``prod(axis_shapes)`` positions, placed round-robin (in
    row-major order) on the visible devices of ``device``'s type, or all on
    ``device`` when it names an index (``"cuda:1"``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is not None:
            pool = [dev]
        else:
            count = torch.cuda.device_count()
            if count == 0:
                raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' for a CPU mesh")
            pool = [torch.device("cuda", i) for i in range(count)]
    elif dev.type == "cpu":
        pool = [dev]
    else:
        raise ValueError(f"make_mesh: no mesh on {dev}")
    shape = tuple(int(s) for s in axis_shapes)
    flat = np.empty(math.prod(shape), dtype=object)
    for i in range(flat.size):
        flat[i] = pool[i % len(pool)]
    return Mesh(flat.reshape(shape), axis_names)


# ---------------------------------------------------------------- layouts
def dim_parts(size: int, n: int) -> List[Tuple[int, int]]:
    """JAX's cut of a dim of ``size`` into ``n`` shards: ceil-sized, the last short or empty."""
    chunk = -(-size // n) if n else size
    return [(min(i * chunk, size), min((i + 1) * chunk, size)) for i in range(n)]


def spec_axes(spec: P) -> Tuple[str, ...]:
    """Every mesh axis a spec names, in order."""
    return tuple(a for d in spec for a in _axes(d))


def _spec_dims(mesh: Mesh, spec: P, ndim: int) -> List[Tuple[str, ...]]:
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the {ndim} dims")
    dims = [_axes(s) for s in spec] + [()] * (ndim - len(spec))
    used = [a for d in dims for a in d]
    unknown = [a for a in used if a not in mesh.shape]
    if unknown or len(set(used)) != len(used):
        raise ValueError(f"spec {spec} does not fit mesh axes {tuple(mesh.shape)}")
    return dims


def slab(mesh: Mesh, spec: P, shape: Sequence[int], pos: Pos) -> List[Tuple[int, int]]:
    """The (start, stop) per dim of the slab that ``pos`` holds under ``spec``."""
    out = []
    for size, axes in zip(shape, _spec_dims(mesh, spec, len(shape))):
        parts = dim_parts(size, mesh.axis_size(axes))
        out.append(parts[mesh.axis_index(pos, axes)])
    return out


def distinct_slabs(mesh: Mesh, *layouts: Tuple[P, Sequence[int]]) -> int:
    """How many distinct tuples of slabs the positions hold of tensors laid
    out as ``(spec, shape)`` each, leaving out tuples with an empty slab: the
    calls a local phase over them makes (:meth:`Mesh.map` on one device)."""
    seen = set()
    for pos in mesh.positions():
        key = tuple(tuple(slab(mesh, spec, shape, pos)) for spec, shape in layouts)
        if all(a < b for bounds in key for a, b in bounds):
            seen.add(key)
    return len(seen)


def _region(t: torch.Tensor, bounds: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The view of ``t`` within ``bounds``: one ``slice`` per dim it cuts,
    called directly (Python indexing and ``narrow`` cost the dry-run's fake
    tensors several times more a view)."""
    for d, ((a, b), size) in enumerate(zip(bounds, t.shape)):
        if (a, b) != (0, size):
            t = torch.ops.aten.slice.Tensor(t, d, a, b)
    return t


def _as_box(bounds: Sequence[Tuple[int, int]]) -> Box:
    return tuple(slice(a, b) for a, b in bounds)


def _bounds(box: Box, shape: Sequence[int]) -> List[Tuple[int, int]]:
    box = tuple(box) + (slice(None),) * (len(shape) - len(box))
    out = []
    for s, size in zip(box, shape):
        start, stop, step = s.indices(size)
        if step != 1:
            raise ValueError("boxes take unit steps")
        out.append((start, max(start, stop)))
    return out


@dataclasses.dataclass
class Sharded:
    """One local tensor per position of ``mesh``: the slabs of a global
    tensor of ``shape`` under ``spec``."""

    mesh: Mesh
    spec: P
    shape: Tuple[int, ...]
    locals: np.ndarray
    dtype: torch.dtype

    def slab(self, pos: Pos) -> List[Tuple[int, int]]:
        return slab(self.mesh, self.spec, self.shape, pos)

    def __getitem__(self, pos: Pos) -> torch.Tensor:
        return self.locals[pos]


def shard(x: torch.Tensor, mesh: Mesh, spec: P) -> Sharded:
    """Place ``x`` on the positions under ``spec``: one local tensor each.

    On ``x``'s device each local is a view of ``x``; on another device one
    copy per distinct slab, shared by the positions there that hold it.
    """
    locals_ = mesh._empty()
    copies: Dict[Tuple, torch.Tensor] = {}
    full = tuple((0, n) for n in x.shape)
    moved = 0
    x_dev = x.device
    with _moving(None):
        for pos in mesh.positions():
            bounds = tuple(slab(mesh, spec, x.shape, pos))
            dev = mesh.device_of(pos)
            key = (bounds, str(dev))
            if key not in copies:
                view = x if bounds == full else _region(x, bounds)
                if x_dev != dev:
                    view = view.to(dev)
                    moved += _nbytes(view)
                copies[key] = view
            locals_[pos] = copies[key]
    mesh.record("shard", (), 0, moved)
    return Sharded(mesh, P(*spec), tuple(x.shape), locals_, x.dtype)


def gather(s: Sharded) -> torch.Tensor:
    """The global tensor, on the device of the mesh's position 0.

    A replicated layout returns the local of a position on that device as
    it is (no copy); otherwise each distinct slab is copied in once.
    """
    mesh = s.mesh
    device = mesh.device
    full = [(0, n) for n in s.shape]
    moved = 0
    for pos in mesh.positions():
        if s.slab(pos) == full and mesh.device_of(pos) == device:
            mesh.record("gather", (), 0, 0)
            return s.locals[pos]
    done = set()
    with _moving(None):
        out = torch.empty(s.shape, dtype=s.dtype, device=device)
        for pos in mesh.positions():
            bounds = tuple(s.slab(pos))
            if bounds in done or any(a == b for a, b in bounds):
                continue
            done.add(bounds)
            local = s.locals[pos]
            if local.device != device:
                moved += _nbytes(local)
            _region(out, bounds).copy_(local)
    mesh.record("gather", (), 0, moved)
    return out


def _holder_index(mesh: Mesh, dims: Sequence[Tuple[str, ...]]) -> Dict[Tuple[int, ...], Dict]:
    """For each tuple of shard indices (one per dim cut over ``dims``), the
    positions that hold that slab: the first of them (key None) and the
    first on each device (key ``str(device)``), in ``mesh.positions()``
    order. Built once per mesh and tuple of dims."""
    key = tuple(dims)
    index = mesh._holders.get(key)
    if index is None:
        index = {}
        for q in mesh.positions():
            entry = index.setdefault(tuple(mesh.axis_index(q, axes) for axes in dims), {})
            entry.setdefault(None, q)
            entry.setdefault(str(mesh.device_of(q)), q)
        mesh._holders[key] = index
    return index


def _pieces(s: Sharded, bounds: Sequence[Tuple[int, int]], pos: Pos):
    """Cut a box of the global tensor into the source slabs that hold it:
    (piece bounds, holder position) pairs, the holder ``pos`` itself where
    it holds the piece, else the first one on its device, else the first."""
    mesh = s.mesh
    dims = _spec_dims(mesh, s.spec, len(s.shape))
    per_dim = []
    for (a, b), size, axes in zip(bounds, s.shape, dims):
        opts = []
        for i, (p0, p1) in enumerate(dim_parts(size, mesh.axis_size(axes))):
            lo, hi = max(a, p0), min(b, p1)
            if lo < hi:
                opts.append((i, (lo, hi)))
        per_dim.append(opts)
    index = _holder_index(mesh, dims)
    own = tuple(mesh.axis_index(pos, axes) for axes in dims)
    want_dev = str(mesh.device_of(pos))
    out = []
    for combo in itertools.product(*per_dim):
        idx = tuple(i for i, _ in combo)
        if idx == own:
            holder = pos
        else:
            entry = index[idx]
            holder = entry.get(want_dev, entry[None])
        out.append(([b for _, b in combo], holder))
    return out


def fetch(s: Sharded, boxes_of: Callable[[Pos], Sequence[Box]],
          then: Callable[[Pos, List[torch.Tensor]], object],
          key: Optional[Callable[[Pos], object]] = None, axes=()) -> np.ndarray:
    """Each position fetches the boxes of the global tensor it needs.

    ``boxes_of(pos)`` lists the boxes (tuples of unit-step slices of the
    global shape). A box that one slab holds on the position's device is a
    view of it; otherwise it is assembled from the slabs that hold it. The
    result holds, per position, ``then(pos, tensors)``. Positions of one
    device with equal ``key(pos)`` (default: their boxes) share one result:
    ``then`` is called for the first of them as soon as its boxes are
    assembled, so at most one result's copies are alive at a time. It
    counts as one ``reshard`` over ``axes``: the bytes each position did
    not hold (logical) and those copied between devices (physical), counted
    for every position, replicas included.
    """
    mesh = s.mesh
    out = mesh._empty()
    logical = physical = 0
    itemsize = s.dtype.itemsize
    fetched: Dict[Pos, int] = {}
    # the positions of one device with equal keys, in order, and the first one's plan
    groups: Dict[Tuple, Tuple[list, List[Pos]]] = {}
    for pos in mesh.positions():
        dev = mesh.device_of(pos)
        plan = []
        fetched[pos] = 0
        for box in boxes_of(pos):
            bounds = _bounds(box, s.shape)
            pieces = _pieces(s, bounds, pos)
            for pb, holder in pieces:
                n = math.prod(b - a for a, b in pb) * itemsize
                if holder != pos:
                    fetched[pos] += n
                if mesh.device_of(holder) != dev:
                    physical += n
            plan.append((bounds, pieces))
        logical += fetched[pos]
        k = (key(pos) if key is not None else tuple(tuple(b) for b, _ in plan), str(dev))
        groups.setdefault(k, (plan, []))[1].append(pos)
    for plan, members in groups.values():
        dev = mesh.device_of(members[0])
        once: Dict[Tuple, torch.Tensor] = {}  # a box asked for twice is assembled once
        with _moving(members):
            for bounds, pieces in plan:
                if tuple(bounds) not in once:
                    once[tuple(bounds)] = _assemble(s, bounds, pieces, dev)
        got = [once[tuple(bounds)] for bounds, _ in plan]
        with _pinned(members):
            made = then(members[0], got)
        del got, once
        for pos in members:
            out[pos] = made
    mesh.record("reshard", axes, logical, physical)
    _tell("reshard", mesh, fetched.__getitem__)
    return out


def _held(s: Sharded, holder: Pos, bounds) -> torch.Tensor:
    """The part of ``holder``'s local within global ``bounds``."""
    start = s.slab(holder)
    return _region(s.locals[holder], [(a - s0, b - s0) for (a, b), (s0, _) in zip(bounds, start)])


def _assemble(s: Sharded, bounds, pieces, dev: torch.device) -> torch.Tensor:
    if len(pieces) == 1:
        pb, holder = pieces[0]
        src = _held(s, holder, pb)
        if src.device == dev and pb == list(bounds):
            return src
    out = torch.empty([b - a for a, b in bounds], dtype=s.dtype, device=dev)
    for pb, holder in pieces:
        _region(out, [(a - o, b - o) for (a, b), (o, _) in zip(pb, bounds)]).copy_(_held(s, holder, pb))
    return out


def reshard(s: Sharded, spec: P) -> Sharded:
    """The same global tensor under another spec (one fetch)."""
    locals_ = fetch(s, lambda pos: [_as_box(slab(s.mesh, spec, s.shape, pos))],
                    then=lambda pos, got: got[0], axes=spec_axes(spec))
    return Sharded(s.mesh, P(*spec), s.shape, locals_, s.dtype)
