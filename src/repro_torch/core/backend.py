"""Pluggable matmul backend: routes matmuls through Strassen on the card.

The port of :mod:`repro.core.backend` for the on-device kinds. :func:`matmul`
runs ``x @ w`` as the configured :class:`MatmulBackend` says: the plain
``torch.matmul`` (kind ``naive``, the MLLib/Marlin regime), the batched-BFS
Strassen or Winograd pipeline (the Stark regime), or the pipeline whose last
level runs inside the fused CUDA kernel (``strassen_fused``). Below
``min_dim`` the call falls back to the plain matmul, like Stark's leaf
threshold.

Kind ``auto`` resolves each (M, K, N, dtype, call site) on the operands'
device through :mod:`repro_torch.core.autotune` (:func:`resolve_auto`) to
one of those kinds at a depth. Kind ``strassen_oot`` is not ported yet: it
raises :class:`NotImplementedError` naming the ROADMAP item that ports it,
and never routes elsewhere. The sharding hook ``w_logical`` is accepted and
ignored: the port has no sharding context yet (ROADMAP.md queue 1 item 8),
and with none the JAX package's ``constrain`` is the identity too.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import autotune
from repro_torch.core.precision import PRECISIONS, matmul_precision
from repro_torch.core.strassen import strassen_matmul
from repro_torch.kernels.strassen.ops import strassen_matmul_fused
from repro_torch.obs import tracer as obs_tracer

__all__ = [
    "MatmulBackend",
    "matmul",
    "NAIVE_BACKEND",
    "AUTO_BACKEND",
    "resolve_auto",
    "VALID_KINDS",
    "EAGER_ONLY_KINDS",
    "JIT_SAFE_KINDS",
    "set_default_matmul_precision",
    "default_matmul_precision",
    "resolve_precision",
]

# The registered routing kinds, the same six names as the JAX package.
VALID_KINDS: Tuple[str, ...] = (
    "naive",
    "strassen",
    "winograd",
    "strassen_fused",
    "strassen_oot",
    "auto",
)

# Kinds whose pipelines run on the host (the JAX package cannot trace them
# under jit); kept as the JAX package defines them.
EAGER_ONLY_KINDS: Tuple[str, ...] = ("strassen_oot",)
JIT_SAFE_KINDS: Tuple[str, ...] = tuple(k for k in VALID_KINDS if k not in EAGER_ONLY_KINDS)

# Where each kind or option that this slice does not run gets ported.
_NOT_PORTED = {
    "strassen_oot": "ROADMAP.md queue 1 item 6 (blocks/, the out-of-core runtime)",
}

# Process-default matmul precision: a backend knob set once, not threaded
# per call site. A MatmulBackend with precision=None inherits it.
_DEFAULT_PRECISION: Optional[str] = None


def set_default_matmul_precision(precision: Optional[str]) -> Optional[str]:
    """Set the process default for backends with ``precision=None``.

    Accepts the JAX precision names ('default' | 'fastest' | 'high' |
    'highest' | 'bfloat16' | 'float32' | 'tensorfloat32') or None to clear.
    Returns the previous default.
    """
    global _DEFAULT_PRECISION
    if precision is not None and precision not in PRECISIONS:
        raise ValueError(f"unknown matmul precision {precision!r}")
    prev, _DEFAULT_PRECISION = _DEFAULT_PRECISION, precision
    return prev


def default_matmul_precision() -> Optional[str]:
    return _DEFAULT_PRECISION


def resolve_precision(backend: "MatmulBackend") -> Optional[str]:
    """The precision a backend's matmuls run at: its own, else the default."""
    return backend.precision if backend.precision is not None else _DEFAULT_PRECISION


@dataclasses.dataclass(frozen=True)
class MatmulBackend:
    """Configuration for routing matmuls; the fields of the JAX class.

    Attributes:
      kind: one of :data:`VALID_KINDS`.
      depth: Strassen recursion depth (paper's p - q). Ignored for naive.
      min_dim: minimum of (M, K, N) below which the call falls back to the
        plain matmul (the paper's leaf threshold / crossover point).
      precision: precision name of the leaf matmuls; None inherits the
        process default (:func:`set_default_matmul_precision`). "high" and
        "tensorfloat32" allow TF32; every other name runs full fp32.
      tuning_cache: path of the persistent autotune cache of kind 'auto'.
      measure: kind 'auto' times its top candidates instead of trusting
        the cost model.
      schemes: the schemes kind 'auto' enumerates; a resolved
        ``strassen_fused`` backend carries its decision's scheme here.
      device_budget, latency_hiding: the settings of kind 'strassen_oot',
        carried so that a JAX backend converts field for field. A
        ``device_budget`` on kind 'auto' raises: the out-of-core family is
        not ported.
    """

    kind: str = "naive"
    depth: int = 1
    min_dim: int = 1024
    precision: Optional[str] = None
    tuning_cache: Optional[str] = None
    measure: bool = False
    schemes: Tuple[str, ...] = ("strassen", "winograd")
    device_budget: Optional[int] = None
    latency_hiding: bool = False

    def __post_init__(self):
        if self.kind not in VALID_KINDS:
            raise ValueError(
                f"unknown matmul backend kind {self.kind!r}; "
                f"valid kinds: {', '.join(VALID_KINDS)}"
            )

    @property
    def scheme_name(self) -> str:
        if self.kind == "strassen_oot":
            return self.schemes[0] if self.schemes else "strassen"
        if self.kind in ("strassen", "strassen_fused"):
            return "strassen"
        if self.kind == "winograd":
            return "winograd"
        raise ValueError(f"no scheme for backend kind {self.kind!r}")

    def effective_depth(self, m: int, k: int, n: int) -> int:
        """Largest usable depth: dims must stay divisible and above min_dim."""
        if self.kind == "naive" or self.depth <= 0:
            return 0
        depth = 0
        while (
            depth < self.depth
            and m % 2 == 0
            and k % 2 == 0
            and n % 2 == 0
            and min(m, k, n) >= self.min_dim
        ):
            m, k, n = m // 2, k // 2, n // 2
            depth += 1
        return depth


NAIVE_BACKEND = MatmulBackend(kind="naive")
AUTO_BACKEND = MatmulBackend(kind="auto", depth=3)


@functools.lru_cache(maxsize=4096)
def resolve_auto(
    m: int,
    k: int,
    n: int,
    dtype_name: str,
    backend: MatmulBackend,
    site: Optional[str] = None,
    device_type: str = "cuda",
) -> MatmulBackend:
    """Resolve kind='auto' to a concrete backend for one (M, K, N, dtype) on a device type.

    The lru_cache makes every later call with the same shape, site and
    device type free; decisions differ between the CPU and the card, so the
    device type is part of the key. A persistent ``backend.tuning_cache``
    survives process restarts. ``site`` keys the decision per call site
    (e.g. "attn.wq" vs "mlp.up"), so equal-shape projections can diverge
    under measured mode.
    """
    cache = autotune.process_cache(backend.tuning_cache)
    decision = autotune.autotune(
        m,
        k,
        n,
        dtype_name,
        min_dim=backend.min_dim,
        max_depth=max(backend.depth, 1),
        schemes=backend.schemes,
        cache=cache,
        measure=backend.measure,
        site=site,
        oot_budget=backend.device_budget,
        device=device_type,
    )
    if decision.kind == "naive":
        return dataclasses.replace(backend, kind="naive", measure=False)
    if decision.kind == "strassen_fused":
        # schemes pins scheme_name to the decision's scheme.
        return dataclasses.replace(
            backend,
            kind=decision.kind,
            depth=decision.depth,
            schemes=(decision.scheme,),
            measure=False,
        )
    return dataclasses.replace(
        backend, kind=decision.scheme, depth=decision.depth, measure=False
    )


def matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    backend: MatmulBackend = NAIVE_BACKEND,
    w_logical=None,
    site: Optional[str] = None,
) -> torch.Tensor:
    """``x @ w`` routed through the configured backend.

    Args:
      x: (..., K) activations; leading dims are flattened into M.
      w: (K, N) weights.
      backend: routing config.
      w_logical: sharding names of w's dims, as the JAX package takes them.
        Ignored: with no sharding context (the port has none until ROADMAP.md
        queue 1 item 8) the JAX package ignores them too.
      site: optional call-site tag ("attn.wq", "mlp.up", ...), recorded on
        the span; for kind 'auto' it keys the decision (and its persistent
        cache entry) per call site.

    Returns:
      (..., N) on x's device, in the promoted dtype of x and w.
    """
    if w.ndim != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"bad shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    # Mixed inputs (the sLSTM's fp32 activations against bf16 weights) are
    # promoted first, as jnp.matmul promotes them; torch.matmul refuses them.
    dtype = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dtype), w.to(dtype)
    *lead, k = x.shape
    n = w.shape[1]
    m = 1
    for d in lead:
        m *= d

    with obs_tracer.get_tracer().span(
        "backend.matmul", cat="matmul", m=m, k=k, n=n,
        kind=backend.kind, site=site,
        traced=torch.compiler.is_compiling(),
    ):
        return _matmul_routed(x, w, backend, lead, m, k, n, site)


def _matmul_routed(x, w, backend, lead, m, k, n, site):
    if backend.kind == "auto":
        backend = resolve_auto(
            m, k, n, autotune.dtype_name(x.dtype), backend, site, x.device.type
        )
    if backend.kind in _NOT_PORTED:
        raise NotImplementedError(
            f"kind {backend.kind!r} is not ported to repro_torch yet: "
            f"see {_NOT_PORTED[backend.kind]}"
        )
    precision = resolve_precision(backend)
    depth = backend.effective_depth(m, k, n)
    if depth == 0:
        with matmul_precision(precision):
            return torch.matmul(x, w)

    x2 = x.reshape(m, k)
    if backend.kind == "strassen_fused":
        out = strassen_matmul_fused(x2, w, depth=depth, precision=precision)
    else:
        out = strassen_matmul(
            x2, w, depth=depth, scheme=backend.scheme_name, precision=precision
        )
    return out.reshape(*lead, n)
