"""Logical-axis sharding rules (MaxText-style) with divisibility fallback.

The port of ``repro.models.sharding``. Model code never names mesh axes: it
tags tensor dims with logical names ("batch", "heads", "d_ff", ...), and a
:class:`ShardingRules` maps each name to a tuple of mesh axes.
:meth:`ShardingRules.spec` drops a mapping whose dim the axes' product does
not divide (with ``allow_uneven``, only where the dim is at most half of
it), exactly as the JAX package does, and returns the port's
:class:`repro_torch.core.mesh.P`. It reads only ``mesh.shape``.

The active mesh and rules are held in a context variable set by the
launcher (:func:`use_sharding`). The JAX package runs one controller under
GSPMD: the model sees global arrays and :func:`constrain` pins a layout
that XLA partitions. The port has no partitioner. Its tensors stay global
between ops, and :func:`constrain` computes the same spec (raising where
the JAX one raises), records the layout on the mesh (a ``constrain`` entry
of zero bytes in ``mesh.traffic``) and returns ``x`` itself. The ops the
JAX package pins run as one local phase per position of the mesh on the
slabs the spec gives, with their collectives counted: the projections that
carry ``w_logical`` (``core/backend.py``), the attention core
(``models/attention.py``) and the expert FFN (``models/moe.py``). With no
context every function here is the identity, and every model path runs as
it does on one device.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.mesh import Mesh, P, spec_axes

__all__ = [
    "ShardingRules",
    "DEFAULT_RULES",
    "NamedSharding",
    "use_sharding",
    "constrain",
    "current",
    "current_mesh",
    "note",
    "bind",
    "make_named_sharding",
]

Axes = Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Map logical dim names -> mesh axis tuples.

    Defaults implement DP over (pod, data), TP over model:
      batch    -> (pod, data)   data parallel / FSDP batch axis
      fsdp     -> (data,)       parameter dim sharded ZeRO-style
      heads    -> (model,)      attention-head tensor parallelism
      kv_heads -> (model,)      falls back when kv heads do not divide
      d_ff     -> (model,)      MLP tensor parallelism
      vocab    -> (model,)      embedding/logits TP
      experts  -> (model,)      expert parallelism for MoE
      seq      -> ()            sequence kept local by default
      seq_sp   -> (pod, data)   sequence parallelism for batch=1 cells
    """

    rules: Dict[str, Axes] = dataclasses.field(
        default_factory=lambda: {
            "batch": ("pod", "data"),
            "fsdp": ("data",),
            "heads": ("model",),
            "kv_heads": ("model",),
            "d_ff": ("model",),
            "vocab": ("model",),
            "experts": ("model",),
            "d_model": (),
            "head_dim": (),
            "seq": (),
            "seq_sp": ("pod", "data"),
            "cache_seq": ("model",),  # KV-cache fallback when kv_heads won't divide
            "ep_flat": ("pod", "data", "model"),  # flattened (group, expert) dim
            "layers": (),
            "state": ("model",),
        }
    )

    def axes_for(
        self, mesh: Mesh, logical: Optional[str], dim: int, *, allow_uneven: bool = False
    ) -> Optional[Axes]:
        """Mesh axes for one logical dim, or None when not shardable.

        allow_uneven: parameter layouts must divide evenly; activations pass
        True so that, e.g., 24 heads shard over 16 (the last shards short).
        """
        if logical is None:
            return None
        axes = tuple(a for a in self.rules.get(logical, ()) if a in mesh.shape)
        if not axes:
            return None
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if dim % size != 0:
            if not (allow_uneven and dim > size // 2):
                return None  # replicate instead of (heavy) padding
        return axes

    def spec(
        self,
        mesh: Mesh,
        logical_axes: Sequence[Optional[str]],
        shape: Sequence[int],
        *,
        allow_uneven: bool = False,
    ) -> P:
        if len(logical_axes) != len(shape):
            raise ValueError(f"logical axes {tuple(logical_axes)} do not fit shape {tuple(shape)}")
        parts = []
        used: set = set()
        for name, dim in zip(logical_axes, shape):
            axes = self.axes_for(mesh, name, dim, allow_uneven=allow_uneven)
            if axes is None or any(a in used for a in axes):
                parts.append(None)
            else:
                used.update(axes)
                parts.append(axes if len(axes) > 1 else axes[0])
        return P(*parts)


DEFAULT_RULES = ShardingRules()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the port's counterpart of ``jax.sharding.NamedSharding``."""

    mesh: Mesh
    spec: P


_CTX: contextvars.ContextVar[Optional[Tuple[Mesh, ShardingRules]]] = contextvars.ContextVar(
    "repro_torch_sharding_ctx", default=None
)


@contextlib.contextmanager
def use_sharding(mesh: Optional[Mesh], rules: ShardingRules = DEFAULT_RULES):
    """Activate mesh+rules for the model code in the block; ``None`` turns sharding off."""
    token = _CTX.set((mesh, rules) if mesh is not None else None)
    try:
        yield
    finally:
        _CTX.reset(token)


def current() -> Optional[Tuple[Mesh, ShardingRules]]:
    """The active (mesh, rules), or None outside :func:`use_sharding`."""
    return _CTX.get()


def current_mesh() -> Optional[Mesh]:
    ctx = _CTX.get()
    return ctx[0] if ctx else None


def bind(fn):
    """``fn``, run under the context that is current now wherever it is called.

    Remat's recompute runs ``fn`` again inside the backward, which autograd
    runs on a thread of its own for a CUDA device: a context variable set on
    the caller's thread is not seen there, and the recompute would take
    another route than the forward did.
    """
    ctx = _CTX.get()

    def bound(*args, **kwargs):
        token = _CTX.set(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            _CTX.reset(token)

    return bound


def note(mesh: Mesh, spec: P) -> None:
    """Record a layout on the mesh: one zero-byte ``constrain`` entry over its axes."""
    mesh.record("constrain", spec_axes(spec), 0, 0)


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Pin ``x``'s layout by logical names; the identity with no context.

    Under a context the spec is the JAX one (activations allow uneven
    shardings); it is recorded on the mesh and ``x`` itself is returned:
    tensors stay global between ops.
    """
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, rules = ctx
    note(mesh, rules.spec(mesh, logical_axes, tuple(x.shape), allow_uneven=True))
    return x


def make_named_sharding(
    mesh: Mesh, logical_axes: Sequence[Optional[str]], shape: Sequence[int],
    rules: ShardingRules = DEFAULT_RULES,
) -> NamedSharding:
    """The layout of a parameter or an input (divisible shardings only)."""
    return NamedSharding(mesh, rules.spec(mesh, logical_axes, shape))
