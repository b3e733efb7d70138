"""Pluggable matmul backend: routes matmuls through Strassen on the card.

The port of :mod:`repro.core.backend` for the on-device kinds. :func:`matmul`
runs ``x @ w`` as the configured :class:`MatmulBackend` says: the plain
``torch.matmul`` (kind ``naive``, the MLLib/Marlin regime), the batched-BFS
Strassen or Winograd pipeline (the Stark regime), or the pipeline whose last
level runs inside the fused CUDA kernel (``strassen_fused``). Below
``min_dim`` the call falls back to the plain matmul, like Stark's leaf
threshold.

Kinds ``strassen_oot`` and ``auto``, and the sharding hook ``w_logical``, are
not ported yet: they raise :class:`NotImplementedError` naming the ROADMAP
item that ports them, and never route elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.precision import PRECISIONS, matmul_precision
from repro_torch.core.strassen import strassen_matmul
from repro_torch.kernels.strassen.ops import strassen_matmul_fused
from repro_torch.obs import tracer as obs_tracer

__all__ = [
    "MatmulBackend",
    "matmul",
    "NAIVE_BACKEND",
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
    "auto": "ROADMAP.md queue 1 item 5 (core/cost_model.py and core/autotune.py)",
    "strassen_oot": "ROADMAP.md queue 1 item 6 (blocks/, the out-of-core runtime)",
    "w_logical": "ROADMAP.md queue 1 item 8 (core/distributed.py, the mesh strategies)",
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
      tuning_cache, measure, schemes, device_budget, latency_hiding: the
        settings of kinds 'auto' and 'strassen_oot', carried so that a JAX
        backend converts field for field; nothing in this slice reads them
        except ``schemes`` in :attr:`scheme_name`.
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
      w_logical: sharding names of w's dims in the JAX package; not ported
        (raises NotImplementedError when set).
      site: optional call-site tag, recorded on the span.

    Returns:
      (..., N) on x's device, in the dtype the plain matmul gives.
    """
    if w.ndim != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"bad shapes {tuple(x.shape)} @ {tuple(w.shape)}")
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
        return _matmul_routed(x, w, backend, w_logical, lead, m, k, n)


def _matmul_routed(x, w, backend, w_logical, lead, m, k, n):
    if backend.kind in _NOT_PORTED:
        raise NotImplementedError(
            f"kind {backend.kind!r} is not ported to repro_torch yet: "
            f"see {_NOT_PORTED[backend.kind]}"
        )
    if w_logical is not None:
        raise NotImplementedError(
            f"w_logical is not ported to repro_torch yet: see {_NOT_PORTED['w_logical']}"
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
