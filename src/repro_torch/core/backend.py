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
one of those kinds at a depth, and with a ``device_budget`` possibly to kind
``strassen_oot``: the out-of-core tagged-block runtime
(:mod:`repro_torch.blocks`), which pulls the operands to the host and stages
its leaf multiplies through the budget on the operands' device.
:func:`inverse` and :func:`solve_triangular` route the solver ops: one dense
library call, or the SPIN block-recursive pipeline over the same runtime.
The sharding hook ``w_logical`` is accepted and ignored: the port has no
sharding context yet (ROADMAP.md queue 1 item 8), and with none the JAX
package's ``constrain`` is the identity too.
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
    "inverse",
    "solve_triangular",
    "is_oom_error",
    "NAIVE_BACKEND",
    "AUTO_BACKEND",
    "resolve_auto",
    "VALID_KINDS",
    "EAGER_ONLY_KINDS",
    "JIT_SAFE_KINDS",
    "SOLVER_KINDS",
    "SOLVER_EAGER_ONLY_KINDS",
    "SOLVER_JIT_SAFE_KINDS",
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

# Routing kinds of the solver ops (:func:`inverse` / :func:`solve_triangular`):
# 'dense' is one device library call, 'spin_oot' the SPIN block-recursive
# pipeline over the tagged block runtime, 'auto' picks per shape against
# ``device_budget``. Error messages enumerate these tuples.
SOLVER_KINDS: Tuple[str, ...] = ("dense", "spin_oot", "auto")
SOLVER_EAGER_ONLY_KINDS: Tuple[str, ...] = ("spin_oot",)
SOLVER_JIT_SAFE_KINDS: Tuple[str, ...] = tuple(
    k for k in SOLVER_KINDS if k not in SOLVER_EAGER_ONLY_KINDS
)

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


def is_oom_error(exc: BaseException) -> bool:
    """Classify a device (or host) out-of-memory failure.

    ``torch.cuda.OutOfMemoryError`` (the caching allocator's) and
    ``MemoryError`` by type; otherwise a RuntimeError carrying an allocator
    message (cuBLAS failing to allocate its workspace, the reference's
    RESOURCE_EXHAUSTED). The out-of-core scheduler treats OOM differently
    from transient faults: retrying the same dispatch cannot succeed, so it
    skips straight to the degradation ladder (smaller waves, deeper
    recursion).
    """
    if isinstance(exc, (torch.cuda.OutOfMemoryError, MemoryError)):
        return True
    markers = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory", "OOM", "ALLOC_FAILED")
    return isinstance(exc, RuntimeError) and any(m in str(exc) for m in markers)


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
      device_budget: peak device bytes the out-of-core pipeline may use
        ('strassen_oot', and the gate that lets 'auto' enumerate the
        strassen_oot candidate family). None: 'strassen_oot' budgets one
        single-leaf pipelined wave slot; 'auto' never picks out-of-core.
      latency_hiding: the JAX package's XLA flag switch, carried so that a
        JAX backend converts field for field; it has no effect here.
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
    if decision.kind in ("strassen_fused", "strassen_oot"):
        # schemes pins scheme_name to the decision's scheme (the oot
        # family enumerates winograd too).
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


def _matmul_oot(x, w, backend: MatmulBackend, lead, m: int, k: int, n: int):
    """Route one matmul through the out-of-core tagged-block runtime.

    Host-resident by construction: the operands are pulled to the host, the
    scheduler stages leaf waves through the memory of x's device under
    ``backend.device_budget``, and the result returns on x's device. A
    compiled (traced) caller cannot run it — the pipeline IS the staging
    loop — so that fails with the fix rather than a deep trace error.
    """
    from repro_torch.blocks.scheduler import (
        leaf_bytes,
        min_depth_for_budget,
        pipelined_leaf_bytes,
        strassen_oot_matmul,
    )

    if torch.compiler.is_compiling():
        raise ValueError(
            "kind='strassen_oot' is a host-resident out-of-core pipeline and "
            "cannot run under torch.compile; call it eagerly "
            "(launch/blocks_demo.py) or use kind='auto' without device_budget"
        )
    dtype = x.dtype
    depth = max(backend.depth, 1)
    budget = backend.device_budget or pipelined_leaf_bytes(m, k, n, depth, dtype)
    # Deepen until the async pipeline's wave slot fits the budget — a depth
    # that only fits one bare leaf silently degrades the scheduler to
    # synchronous staging, which the autotuner's overlap-discounted
    # prediction did not price. Fall back to the merely-feasible depth when
    # no depth leaves pipeline headroom.
    if pipelined_leaf_bytes(m, k, n, depth, dtype) > budget:
        try:
            depth = min_depth_for_budget(m, k, n, budget, dtype, pipelined=True)
        except ValueError:
            if leaf_bytes(m, k, n, depth, dtype) > budget:
                depth = min_depth_for_budget(m, k, n, budget, dtype)
    leaf_backend = MatmulBackend(
        kind="auto", depth=2, min_dim=backend.min_dim,
        precision=resolve_precision(backend),
    )
    out, _ = strassen_oot_matmul(
        x.reshape(m, k),
        w,
        depth=depth,
        budget_bytes=budget,
        scheme=backend.scheme_name,
        backend=leaf_backend,
        device=x.device,
    )
    return out.to(x.device).reshape(*lead, n)


def _matmul_routed(x, w, backend, lead, m, k, n, site):
    if backend.kind == "auto":
        if backend.device_budget is not None and torch.compiler.is_compiling():
            # A compiled caller cannot run the eager-only out-of-core
            # family: resolve without the budget so the decision (which
            # caches per shape) never names a plan this call site cannot run.
            backend = dataclasses.replace(backend, device_budget=None)
        backend = resolve_auto(
            m, k, n, autotune.dtype_name(x.dtype), backend, site, x.device.type
        )
    if backend.kind == "strassen_oot":
        return _matmul_oot(x, w, backend, lead, m, k, n)
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


# --------------------------------------------------------------- solver ops
def _check_solver_kind(kind: str) -> None:
    if kind not in SOLVER_KINDS:
        raise ValueError(
            f"unknown solver kind {kind!r}; "
            f"valid kinds: {', '.join(SOLVER_KINDS)}"
        )


def _solver_compile_guard(op: str) -> None:
    if torch.compiler.is_compiling():
        raise ValueError(
            f"solver kind 'spin_oot' is a host-resident out-of-core "
            f"pipeline and cannot run {op} under torch.compile; compilable "
            f"solver kinds: {', '.join(SOLVER_JIT_SAFE_KINDS)}"
        )


def _solver_backend_scheme(backend: MatmulBackend) -> str:
    """Scheme for the solver's nested multiplies (any backend kind)."""
    return backend.schemes[0] if backend.schemes else "strassen"


def _solver_leaf_backend(backend: MatmulBackend) -> MatmulBackend:
    """The nested multiplies' routing: kind 'auto' at the caller's precision."""
    return MatmulBackend(
        kind="auto", depth=2, min_dim=backend.min_dim, precision=resolve_precision(backend),
    )


def _solver_oot_depth(
    op: str, n: int, nrhs: int, dtype, backend: MatmulBackend, budget: int,
    site: Optional[str], device: torch.device,
) -> int:
    """Autotuned solver depth (cost-modeled, cached, telemetry-recorded)."""
    decision = autotune.autotune_solver(
        op,
        n,
        dtype,
        nrhs=nrhs,
        oot_budget=budget,
        max_depth=max(backend.depth, 1) + 8,
        scheme=_solver_backend_scheme(backend),
        cache=autotune.process_cache(backend.tuning_cache),
        site=site,
        device=device,
    )
    return decision.depth


def inverse(
    a: torch.Tensor,
    backend: MatmulBackend = NAIVE_BACKEND,
    *,
    kind: str = "auto",
    depth: Optional[int] = None,
    site: Optional[str] = None,
) -> torch.Tensor:
    """Matrix inverse routed through the configured backend, on a's device.

    ``kind='dense'`` is one ``torch.linalg.inv``; ``kind='spin_oot'`` runs
    SPIN block-recursive inversion over the tagged block runtime
    (host-resident, device bytes capped by ``backend.device_budget``);
    ``kind='auto'`` picks dense unless the dense op's working set exceeds
    the budget. The recursion's block multiplies route through kind 'auto'
    at the backend's precision.
    """
    from repro_torch.blocks.solve import solver_min_depth_for_budget, spin_inverse_oot

    _check_solver_kind(kind)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"inverse needs a square matrix, got {tuple(a.shape)}")
    n = a.shape[0]
    traced = torch.compiler.is_compiling()
    if kind == "auto":
        item = torch.promote_types(a.dtype, torch.float32).itemsize
        over = (
            backend.device_budget is not None
            and 2 * n * n * item > backend.device_budget
        )
        kind = "spin_oot" if (over and not traced) else "dense"
    with obs_tracer.get_tracer().span(
        "backend.inverse", cat="matmul", n=n, kind=kind, site=site,
        traced=traced,
    ):
        if kind == "dense":
            with matmul_precision(resolve_precision(backend)):
                return torch.linalg.inv(a)
        _solver_compile_guard("inverse")
        budget = backend.device_budget or _leaf_budget_fallback(n, n, a.dtype)
        if depth is None:
            depth = max(
                _solver_oot_depth("inverse", n, n, a.dtype, backend, budget, site, a.device),
                solver_min_depth_for_budget(n, budget, a.dtype, leaf_kind="inv"),
            )
        out, _ = spin_inverse_oot(
            a,
            depth=depth,
            budget_bytes=budget,
            scheme=_solver_backend_scheme(backend),
            backend=_solver_leaf_backend(backend),
            device=a.device,
        )
        return out.to(a.device)


def solve_triangular(
    l: torch.Tensor,
    b: torch.Tensor,
    backend: MatmulBackend = NAIVE_BACKEND,
    *,
    lower: bool = True,
    kind: str = "auto",
    depth: Optional[int] = None,
    site: Optional[str] = None,
) -> torch.Tensor:
    """Triangular solve ``T @ X = B`` routed through the configured backend.

    Same routing contract as :func:`inverse`: 'dense' is one
    ``torch.linalg.solve_triangular``, 'spin_oot' the block-recursive
    forward/backward substitution whose multiplies re-enter the matmul
    scheduler, 'auto' picks against ``backend.device_budget``.
    """
    from repro_torch.blocks.solve import solver_min_depth_for_budget, triangular_solve_oot

    _check_solver_kind(kind)
    if l.ndim != 2 or l.shape[0] != l.shape[1] or b.ndim != 2:
        raise ValueError(f"bad solve_triangular shapes {tuple(l.shape)} / {tuple(b.shape)}")
    if l.shape[1] != b.shape[0]:
        raise ValueError(f"bad solve_triangular shapes {tuple(l.shape)} @ {tuple(b.shape)}")
    n, nrhs = l.shape[0], b.shape[1]
    traced = torch.compiler.is_compiling()
    dtype = torch.promote_types(l.dtype, b.dtype)
    if kind == "auto":
        item = torch.promote_types(dtype, torch.float32).itemsize
        over = (
            backend.device_budget is not None
            and (n * n + 2 * n * nrhs) * item > backend.device_budget
        )
        kind = "spin_oot" if (over and not traced) else "dense"
    with obs_tracer.get_tracer().span(
        "backend.solve", cat="matmul", n=n, nrhs=nrhs, kind=kind,
        lower=lower, site=site, traced=traced,
    ):
        if kind == "dense":
            with matmul_precision(resolve_precision(backend)):
                return torch.linalg.solve_triangular(l, b, upper=not lower)
        _solver_compile_guard("solve_triangular")
        budget = backend.device_budget or _leaf_budget_fallback(n, nrhs, dtype)
        if depth is None:
            depth = max(
                _solver_oot_depth("solve", n, nrhs, dtype, backend, budget, site, l.device),
                solver_min_depth_for_budget(
                    n, budget, dtype, nrhs=nrhs, leaf_kind="trsm_lower"
                ),
            )
        out, _ = triangular_solve_oot(
            l,
            b,
            lower=lower,
            depth=depth,
            budget_bytes=budget,
            scheme=_solver_backend_scheme(backend),
            backend=_solver_leaf_backend(backend),
            device=l.device,
        )
        return out.to(l.device)


def _leaf_budget_fallback(n: int, nrhs: int, dtype) -> int:
    """Budget when a solver is forced out-of-core without device_budget:
    one depth-1 dense leaf's working set (mirrors _matmul_oot's single
    pipelined-slot default)."""
    item = torch.promote_types(dtype, torch.float32).itemsize
    half = -(-n // 2)
    return max(2 * half * half, half * half + 2 * half * nrhs) * item
