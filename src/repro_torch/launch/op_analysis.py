"""What one step dispatches, counted on fake tensors: the counterpart of ``repro.launch.hlo_analysis``.

The JAX package compiles a step for a mesh of placeholder devices and
parses the partitioned HLO, weighting each instruction by its loops' trip
counts. The port runs eagerly, one process driving a mesh of positions
(``core/mesh.py``), so it runs the step itself, on
``torch._subclasses.FakeTensorMode`` tensors on ``cuda:0`` (shapes, dtypes
and devices, no data, no allocation), under :class:`OpAnalysis`, a
``TorchDispatchMode`` that sees every aten op. Python loops run in full, so
no trip count needs inferring. It counts, into :class:`OpCosts`:

* dot FLOPs by dtype: ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``addbmm``,
  ``mv``, ``addmv``, ``dot`` (2 per multiply-add), plus each hand-written
  kernel's operations, which its wrapper records through
  ``kernels.common.traced`` from ``kernels/cost.py`` in place of launching;
* HBM bytes: operand plus result bytes of every aten op that is not a view
  or an allocation, and each kernel's bytes. Eager PyTorch writes every
  result to device memory, so, unlike the reference's ``_TRAFFIC_OPS``, no
  fusion rule applies; an in-place op counts the tensor it writes as read
  and written;
* collective operand bytes per device, by the mesh's kinds (``psum``,
  ``all_gather``, ``psum_scatter``, ``reshard``; ``roofline.collective_bytes``
  names them as XLA does): a psum, all-gather or psum-scatter counts each
  position's local operand, a fetch (``reshard``) the bytes each position
  did not hold;
* launches by kernel name, and peak live bytes.

Summed over the positions, a collective's operand bytes convert to the
mesh's logical bytes (``Mesh.traffic``) by its ring algorithm, over groups
of k positions: a fetch's are its logical bytes, a psum's 2 (k - 1) / k of
them, an all-gather's (k - 1) times, a psum-scatter's (k - 1) / k
(:attr:`OpCosts.collective_logical`).

Attribution. The mesh tells the analysis (``core.mesh.set_observer``)
which positions each local phase belongs to. Work inside a position's phase
(``Mesh.run``, ``Mesh.map``, a fetch's ``then``) counts on that position,
and a call that replicas share counts on each of them; its backward, run by
autograd later, counts where the forward's nodes were made. Work on
global tensors between phases is *unpinned*, reported apart and taken as
divided evenly over the positions. The copies and adds inside a movement
are the collective's and count no FLOPs or HBM bytes, nor do their
gradients; the mesh sees only the forward's movements, so a backward's
collectives are not counted. Per device:

    per device = the busiest position's pinned work + unpinned / chips

the busiest position being the one whose pinned work has the largest
roofline bound. Temporary memory per device is the peak over the trace of
the busiest live position's pinned bytes plus the unpinned live bytes over
chips; argument bytes per position are exact, from the slabs of each
input's layout (:func:`argument_bytes`).

A build of PyTorch without CUDA has no device guard for ``cuda:0``, which
Python indexing of a fake CUDA tensor opens: :func:`fake_mode` then builds
and loads a no-op one (``csrc/host/fake_cuda_guard.cpp``) with the host's
C++ compiler, once per checkout. Autograd's engine still asks such a build
for a CUDA stream, so a train cell's backward traces only on the card's
host, whose PyTorch has CUDA.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import weakref
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import mesh as mesh_mod
from repro_torch.kernels import common
from repro_torch.kernels._build import BUILD_ROOT
from repro_torch.launch.roofline import HW, Hardware, collective_bytes, roofline_terms

__all__ = [
    "OpAnalysis",
    "OpCosts",
    "analyze",
    "fake_mode",
    "to_device",
    "argument_bytes",
    "dot_flops",
]

aten = torch.ops.aten
Pos = Tuple[int, ...]
Group = Optional[Tuple[Pos, ...]]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _mm(a, b):
    return 2 * a.shape[0] * a.shape[1] * b.shape[-1]


def _bmm(a, b):
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


# op -> (index of the left operand, FLOPs of (left, right))
_DOTS = {
    aten.mm: (0, _mm), aten.addmm: (1, _mm),
    aten.bmm: (0, _bmm), aten.baddbmm: (1, _bmm), aten.addbmm: (1, _bmm),
    aten.mv: (0, lambda a, x: 2 * a.shape[0] * a.shape[1]),
    aten.addmv: (1, lambda a, x: 2 * a.shape[0] * a.shape[1]),
    aten.dot: (0, lambda a, b: 2 * a.shape[0]), aten.vdot: (0, lambda a, b: 2 * a.shape[0]),
}

# Ops besides the views that touch no device memory: allocations and metadata.
_FREE = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
    aten._unsafe_view, aten.lift_fresh_copy, aten._local_scalar_dense,
}


def dot_flops(func, args) -> Optional[Tuple[float, torch.dtype]]:
    """(FLOPs, dtype of the left operand) of a dot-type aten op, else None."""
    entry = _DOTS.get(func.overloadpacket)
    if entry is None:
        return None
    i, flops = entry
    return float(flops(args[i], args[i + 1])), args[i].dtype


_DEVICE = torch.ops.prim.device.default
_COMPOSITE: Dict[object, bool] = {}
_VIEW: Dict[object, bool] = {}


def _is_view(func) -> bool:
    hit = _VIEW.get(func)
    if hit is None:
        hit = _VIEW[func] = func.is_view
    return hit


def _composite(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd kernel (it decomposes)."""
    hit = _COMPOSITE.get(func)
    if hit is None:
        hit = _COMPOSITE[func] = func.namespace == "aten" and torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
    return hit


# ---------------------------------------------------------------- fake CUDA
_FAKE_MODE: Optional[FakeTensorMode] = None
_GUARD_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "fake_cuda_guard.cpp"
_guard_lib = None


def _ensure_cuda_guard() -> None:
    """On a build of PyTorch without CUDA, build and load the no-op CUDA guard."""
    global _guard_lib
    if torch.version.cuda is not None or _guard_lib is not None:
        return
    torch_dir = Path(torch.__file__).resolve().parent
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("the dry-run on a PyTorch without CUDA needs a C++ compiler (g++) "
                           "for its fake CUDA device guard")
    flags = ["-std=c++17", "-O1", "-shared", "-fPIC", f"-I{torch_dir / 'include'}",
             f"-L{torch_dir / 'lib'}", "-lc10", f"-Wl,-rpath,{torch_dir / 'lib'}"]
    digest = hashlib.sha256(_GUARD_SOURCE.read_bytes() + " ".join([torch.__version__, *flags]).encode())
    lib = BUILD_ROOT / f"host-{digest.hexdigest()[:16]}" / "libfake_cuda_guard.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
            out = Path(tmp) / lib.name
            done = subprocess.run([cxx, str(_GUARD_SOURCE), *flags, "-o", str(out)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"building the fake CUDA guard failed:\n{done.stdout}")
            os.replace(out, lib)
    _guard_lib = ctypes.CDLL(str(lib))
    _guard_lib.repro_register_fake_cuda_guard()


def fake_mode() -> FakeTensorMode:
    """The process's fake tensor mode: every dry-run tensor is made under it.
    Real tensors that meet fake ones (a constant) are converted."""
    global _FAKE_MODE
    if _FAKE_MODE is None:
        _ensure_cuda_guard()
        _FAKE_MODE = FakeTensorMode(allow_non_fake_inputs=True)
    return _FAKE_MODE


def to_device(module: nn.Module, device) -> nn.Module:
    """Give every parameter of ``module`` a fake tensor of its shape, dtype
    and ``requires_grad`` on ``device``, in place (``nn.Module.to`` cannot
    swap fake tensors). Call under :func:`fake_mode`."""
    for sub in module.modules():
        for name, p in sub._parameters.items():
            if p is not None:
                fresh = torch.empty_strided(p.shape, p.stride(), dtype=p.dtype, device=device)
                sub._parameters[name] = nn.Parameter(fresh, requires_grad=p.requires_grad)
    return module


# ---------------------------------------------------------------- results
@dataclasses.dataclass
class OpCosts:
    """One traced step's counts. Per device unless named otherwise."""

    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)
    hbm_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)  # the whole trace
    peak_live_bytes: int = 0  # the whole trace, every position
    temp_bytes: float = 0.0
    chips: int = 1
    busiest: Optional[Pos] = None
    pinned: Dict[str, object] = dataclasses.field(default_factory=dict)  # the busiest position's
    unpinned: Dict[str, object] = dataclasses.field(default_factory=dict)  # global, undivided
    ops: int = 0  # aten ops dispatched
    collective_logical: Dict[str, int] = dataclasses.field(default_factory=dict)  # mesh.traffic's

    @property
    def dot_flops(self) -> float:
        return sum(self.flops_by_dtype.values())

    @property
    def collective_bytes(self) -> float:
        return sum(self.collective_by_kind.values())

    def roofline(self, hw: Hardware = HW) -> Dict[str, float]:
        return roofline_terms(hlo_flops=self.flops_by_dtype, hlo_bytes=self.hbm_bytes,
                              coll_bytes=self.collective_bytes, chips=self.chips,
                              per_device=True, hw=hw)

    def collectives(self) -> Dict[str, float]:
        """Per-device operand bytes under XLA's kind names, and their total."""
        return collective_bytes(self.collective_by_kind)


class _Work:
    __slots__ = ("flops", "bytes")

    def __init__(self):
        self.flops: Dict[str, float] = collections.defaultdict(float)
        self.bytes = 0


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------- analysis
class OpAnalysis(TorchDispatchMode):
    """Counts what runs inside it; use as a context manager around one step
    on fake tensors (it enters :func:`fake_mode` itself), then read
    :meth:`costs`. ``chips``: the positions the step's mesh has (1 with no
    mesh)."""

    def __init__(self, chips: int = 1, hw: Hardware = HW):
        super().__init__()
        self.chips, self.hw = chips, hw
        self._where: str = "unpinned"  # | "pinned" | "moving"
        self._group: Group = None
        self._work: Dict[Group, _Work] = collections.defaultdict(_Work)
        self._coll: Dict[Pos, Dict[str, int]] = collections.defaultdict(lambda: collections.defaultdict(int))
        self._launches: Dict[str, int] = collections.Counter()
        self._logical: Dict[str, int] = collections.Counter()
        self._ops = 0
        # autograd sequence numbers [start, stop) of each phase and movement, for the backward
        self._seq_starts: List[int] = []
        self._seq_spans: List[Tuple[int, int, str, Group]] = []
        # live allocations: storage id -> (bytes, group)
        self._lock = threading.RLock()
        self._live: Dict[int, Tuple[int, Group]] = {}
        self._live_total = self._live_unpinned = 0
        self._live_pos: Dict[Pos, int] = {}
        self._max_pos, self._dirty = 0, False
        self._peak_total, self._peak_device = 0, 0.0
        self._stack = contextlib.ExitStack()

    # ---------------------------------------------------- context
    def __enter__(self):
        # The trace makes many short-lived objects that reference counting
        # frees; the cyclic collector's passes over them cost a quarter of it.
        self._gc = gc.isenabled()
        gc.disable()
        self._stack.enter_context(fake_mode())
        self._prev_observer = mesh_mod.set_observer(self)
        self._prev_analysis = common.set_analysis(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            common.set_analysis(self._prev_analysis)
            mesh_mod.set_observer(self._prev_observer)
            self._stack.close()
            if self._gc:
                gc.enable()

    # ---------------------------------------------------- mesh observer
    @contextlib.contextmanager
    def _within(self, where: str, group: Group):
        prev = self._where, self._group
        self._where, self._group = where, group
        start = torch._C._autograd._get_sequence_nr()
        try:
            yield
        finally:
            stop = torch._C._autograd._get_sequence_nr()
            if stop > start:  # kept in order of start, for the lookup's bisection
                i = bisect.bisect_right(self._seq_starts, start)
                self._seq_starts.insert(i, start)
                self._seq_spans.insert(i, (start, stop, where, group))
            self._where, self._group = prev

    def pinned(self, positions: Iterable[Pos]):
        return self._within("pinned", tuple(positions))

    def moving(self, positions: Optional[Iterable[Pos]]):
        return self._within("moving", None if positions is None else tuple(positions))

    def collective(self, kind: str, sizes: Mapping[Pos, int], group_size: Optional[int] = None) -> None:
        total = 0
        for pos, n in sizes.items():
            self._coll[pos][kind] += n
            total += n
        k = group_size or 1
        self._logical[kind] += {"psum": total * 2 * (k - 1) // k, "all_gather": total * (k - 1),
                                "psum_scatter": total * (k - 1) // k}.get(kind, total)

    # ---------------------------------------------------- kernels
    def kernel(self, name: str, cost) -> None:
        """A hand-written kernel's call, recorded by its wrapper in place of a launch."""
        self._launches[name] += 1
        work = self._work[self._attribution()[1]]
        work.flops[_name(cost.dtype)] += float(cost.ops)
        work.bytes += cost.bytes

    def _attribution(self) -> Tuple[str, Group]:
        """(where, group) of the op running now; in the backward, those of
        the forward phase or movement that made the autograd node running it."""
        if self._where != "unpinned":
            return self._where, self._group
        node = torch._C._current_autograd_node()
        if node is None or not self._seq_spans:
            return "unpinned", None
        seq = node._sequence_nr()
        i = bisect.bisect_right(self._seq_starts, seq) - 1
        if i >= 0:
            start, stop, where, group = self._seq_spans[i]
            if start <= seq < stop:
                return where, group
        return "unpinned", None

    # ---------------------------------------------------- aten ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is _DEVICE:
            return func(*args)
        kwargs = kwargs or {}
        view = _is_view(func)
        if not view and _composite(func):
            # Under inference mode a composite op (matmul, einsum, linear)
            # arrives whole: run its decomposition through this mode, so its
            # parts (mm, bmm, ...) are counted as autograd mode would see them.
            TorchDispatchMode.__enter__(self)
            try:
                out = func.decompose(*args, **kwargs)
            finally:
                TorchDispatchMode.__exit__(self, None, None, None)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._ops += 1
        if view:
            return out
        flat_out = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not flat_out:
            return out
        flat_in = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        where, group = self._attribution()
        if where != "moving" and func.overloadpacket not in _FREE:
            work = self._work[group]
            dot = dot_flops(func, args)
            if dot is not None:
                work.flops[_name(dot[1])] += dot[0]
            work.bytes += sum(_nbytes(t) for t in flat_in) + sum(_nbytes(t) for t in flat_out)
        self._track(flat_in, flat_out, group)
        return out

    # ---------------------------------------------------- memory
    def _track(self, flat_in, flat_out, group: Group) -> None:
        held = {id(t.untyped_storage()) for t in flat_in}
        for t in flat_out:
            st = t.untyped_storage()
            key = id(st)
            if key in held or key in self._live:
                continue
            self._alloc(key, st.nbytes(), group)
            weakref.finalize(st, self._free, key)

    def _alloc(self, key: int, n: int, group: Group) -> None:
        with self._lock:
            if self._dirty:
                self._max_pos = max(self._live_pos.values(), default=0)
                self._dirty = False
            self._live[key] = (n, group)
            self._live_total += n
            self._peak_total = max(self._peak_total, self._live_total)
            if group is None:
                self._live_unpinned += n
            else:
                for pos in group:
                    v = self._live_pos.get(pos, 0) + n
                    self._live_pos[pos] = v
                    if v > self._max_pos:
                        self._max_pos = v
            self._peak_device = max(self._peak_device, self._max_pos + self._live_unpinned / self.chips)

    def _free(self, key: int) -> None:
        with self._lock:
            n, group = self._live.pop(key, (0, None))
            self._live_total -= n
            if group is None:
                self._live_unpinned -= n
                return
            for pos in group:
                v = self._live_pos[pos]
                if v == self._max_pos:
                    self._dirty = True
                self._live_pos[pos] = v - n

    # ---------------------------------------------------- result
    def costs(self) -> OpCosts:
        per_pos: Dict[Pos, _Work] = collections.defaultdict(_Work)
        for group, work in self._work.items():
            for pos in group or ():
                mine = per_pos[pos]
                mine.bytes += work.bytes
                for dt, f in work.flops.items():
                    mine.flops[dt] += f
        unpinned = self._work.get(None, _Work())
        busiest, best = None, -1.0
        for pos in sorted(set(per_pos) | set(self._coll)):
            w = per_pos.get(pos, _Work())
            t = roofline_terms(hlo_flops=dict(w.flops), hlo_bytes=w.bytes,
                               coll_bytes=sum(self._coll.get(pos, {}).values()),
                               chips=self.chips, per_device=True, hw=self.hw)["bound_s"]
            if t > best:
                busiest, best = pos, t
        mine = per_pos.get(busiest, _Work()) if busiest is not None else _Work()
        flops: Dict[str, float] = collections.defaultdict(float)
        for dt, f in mine.flops.items():
            flops[dt] += f
        for dt, f in unpinned.flops.items():
            flops[dt] += f / self.chips
        coll = dict(self._coll.get(busiest, {})) if busiest is not None else {}
        return OpCosts(
            flops_by_dtype=dict(flops),
            hbm_bytes=mine.bytes + unpinned.bytes / self.chips,
            collective_by_kind=coll,
            launches=dict(self._launches),
            peak_live_bytes=self._peak_total,
            temp_bytes=self._peak_device,
            chips=self.chips,
            busiest=busiest,
            pinned={"flops_by_dtype": dict(mine.flops), "hbm_bytes": mine.bytes},
            unpinned={"flops_by_dtype": dict(unpinned.flops), "hbm_bytes": unpinned.bytes},
            ops=self._ops,
            collective_logical=dict(self._logical),
        )


def analyze(fn, *args, chips: int = 1, **kwargs) -> Tuple[object, OpCosts]:
    """``fn(*args, **kwargs)`` under a fresh :class:`OpAnalysis`: (its result, the costs)."""
    with OpAnalysis(chips=chips) as analysis:
        out = fn(*args, **kwargs)
    return out, analysis.costs()


# ---------------------------------------------------------------- arguments
def argument_bytes(leaves: Mapping[str, torch.Tensor], shardings: Mapping[str, object]) -> int:
    """The largest bytes any position holds of ``leaves`` laid out as
    ``shardings`` (``launch.specs.sharding_tree``'s ``NamedSharding`` by
    path): per position the product of its slab's extents, JAX's cut
    (``core.mesh.dim_parts``), summed over the leaves."""
    total = None
    for path, leaf in leaves.items():
        sh = shardings[path]
        mesh = sh.mesh
        if total is None:
            positions = list(mesh.positions())
            total = np.zeros(len(positions))
        per_pos = np.full(len(positions), float(leaf.element_size()))
        dims = list(sh.spec) + [None] * (leaf.ndim - len(sh.spec))
        for size, axes in zip(leaf.shape, dims):
            axes = () if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))
            parts = mesh_mod.dim_parts(size, mesh.axis_size(axes))
            extent = np.array([b - a for a, b in parts], dtype=float)
            idx = np.array([mesh.axis_index(p, axes) for p in positions])
            per_pos *= extent[idx]
        total += per_pos
    return 0 if total is None else int(total.max())
