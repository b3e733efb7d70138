"""Shape-aware autotuning dispatcher behind ``MatmulBackend(kind="auto")``.

The port of :mod:`repro.core.autotune` for one device. The paper's core
empirical result (§V-C) is a *crossover*: Strassen's 7-multiplication scheme
only beats the naive path once matrix dims are large relative to the leaf
block, and the §IV stage-wise model predicts where. This module turns that
calibration and prediction loop into a dispatcher:

1. :func:`calibrate` runs two micro-benchmarks on the device, a rank-7 leaf
   ``bmm`` and one :func:`~repro_torch.core.strassen.divide_level`, and fits
   ``t_flop`` (seconds per scalar multiply-add) and ``t_elem`` (seconds per
   element through a divide/combine level); :func:`calibrate_h2d` fits
   ``t_h2d`` from a host->device->host round trip.
2. :func:`enumerate_candidates` lists every strategy that can legally run a
   given (M, K, N): naive ``torch.matmul``, batched-BFS Strassen/Winograd at
   each usable depth, and ``strassen_fused`` (the ``strassen1`` kernel)
   where :func:`repro_torch.core.compat.fused_leaf_mode` says it runs.
3. :func:`predict_seconds` costs each candidate with the calibrated stage
   model; :func:`autotune` picks the argmin, or with ``measure=True`` times
   the top-k candidates on the device and records the measured winner.
4. :class:`TuningCache` persists decisions as JSON in the JAX package's
   schema and under its keys, so a cache written by either package answers
   the other's lookups on the same platform.

The model, its constants' meaning and every decision rule are the
reference's, the out-of-core ``strassen_oot`` family under ``oot_budget``
(priced with ``t_h2d``, discounted for the wave pipeline's overlap) and the
solver families (:func:`autotune_solver`) included. Not ported yet, and
refused with :class:`NotImplementedError` rather than answered by another
candidate: the mesh strategies and ``calibrate_collective`` (``mesh=``;
ROADMAP.md queue 1 item 8). On one device the reference's ``t_coll`` is 0.0
and its device count 1, and so are the port's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import compat
from repro_torch.core.coefficients import get_scheme
from repro_torch.core.precision import matmul_precision
from repro_torch.core.strassen import divide_level, strassen_matmul
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracer as obs_tracer

__all__ = [
    "Candidate",
    "Decision",
    "Calibration",
    "TuningCache",
    "Telemetry",
    "TelemetryEvent",
    "calibrate",
    "calibrate_h2d",
    "get_calibration",
    "calibration_snapshot",
    "costing_calibration",
    "get_telemetry",
    "reset_telemetry",
    "enumerate_candidates",
    "predict_seconds",
    "predict_cost_terms",
    "measure_seconds",
    "execute",
    "autotune",
    "cache_key",
    "device_platform",
    "dtype_name",
    "process_cache",
    "model_call_sites",
    "warm_for_model",
    "autotune_solver",
    "predict_solver_terms",
    "predict_solver_seconds",
]

# Local (single-program) strategies the backend can dispatch without a mesh.
LOCAL_SCHEMES: Tuple[str, ...] = ("strassen", "winograd")
# The fused-kernel pipeline: local, but gated on the kernel running
# (compat.fused_leaf_mode) rather than always-legal like the einsum BFS.
FUSED_KIND = "strassen_fused"
# The out-of-core tagged-block pipeline (repro_torch.blocks): host-resident
# operands staged through device memory in budgeted waves. Enumerated only
# when the caller supplies a device-memory budget (``oot_budget``).
OOT_KIND = "strassen_oot"

# Fraction of the overlappable h2d traffic the async wave pipeline still
# exposes: the pipeline fill (first wave's stage has nothing to hide
# behind) and drain (last fetch) bubbles, roughly one wave each way out of
# the ~8 the scheduler needs before fill/drain amortizes. Used by
# predict_cost_terms when ``oot_overlap`` is on.
OOT_OVERLAP_EXPOSED_FRACTION = 0.125
_MESH_ITEM = "ROADMAP.md queue 1 item 8 (core/distributed.py, the mesh strategies)"


def _oot_pipeline_fits(
    m: int, k: int, n: int, depth: int, dtype, oot_budget: Optional[int]
) -> bool:
    """Whether the oot scheduler can actually run its async pipeline.

    The 2-deep wave pipeline needs one pipelined wave slot
    (:func:`repro_torch.blocks.scheduler.pipelined_leaf_bytes`) inside the
    budget at this depth; with less room the scheduler silently degrades
    to synchronous staging, so predictions must not take the overlap
    discount. A ``None``/0 budget means :func:`execute` will default the
    budget to exactly one pipelined slot, so the pipeline runs.
    """
    if not oot_budget:
        return True
    from repro_torch.blocks.scheduler import pipelined_leaf_bytes

    return pipelined_leaf_bytes(m, k, n, depth, dtype_name(dtype)) <= oot_budget


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(f"autotune over a mesh is not ported to repro_torch yet: see {_MESH_ITEM}")


def _refuse_kind(cand: "Candidate") -> None:
    """The mesh kinds are neither priced nor run here."""
    if not cand.is_local and cand.kind != OOT_KIND:
        raise NotImplementedError(
            f"candidate kind {cand.kind!r} is not ported to repro_torch yet: see {_MESH_ITEM}"
        )


def device_platform(device: str | torch.device) -> str:
    """The name JAX's ``Device.platform`` gives the same device: 'cpu' or 'gpu'."""
    kind = torch.device(device).type
    return "gpu" if kind == "cuda" else kind


def dtype_name(dtype) -> str:
    """The numpy/JAX name of a dtype ('float32', 'bfloat16'), from a torch dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None), torch.dtype):
        return dtype
    raise TypeError(f"need a torch dtype or a dtype name, got {dtype!r}")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One executable strategy instance for a fixed (M, K, N)."""

    kind: str  # 'naive' | scheme name (local BFS) | 'strassen_fused' | 'strassen_oot'
    scheme: str = "strassen"
    depth: int = 0

    @property
    def is_naive(self) -> bool:
        return self.kind == "naive"

    @property
    def is_local(self) -> bool:
        return self.kind in ("naive", FUSED_KIND) + LOCAL_SCHEMES


@dataclasses.dataclass(frozen=True)
class Decision:
    """A routing decision plus the evidence it was made on."""

    kind: str
    scheme: str
    depth: int
    predicted_s: float
    measured_s: Optional[float] = None
    source: str = "predicted"  # predicted | measured | cache

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict) -> "Decision":
        return Decision(**d)

    @property
    def candidate(self) -> Candidate:
        return Candidate(kind=self.kind, scheme=self.scheme, depth=self.depth)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Per-environment constants, the analogue of the paper's §IV fit."""

    t_flop: float  # seconds per scalar multiply-add in the leaf matmul
    t_elem: float  # seconds per element through a divide/combine einsum
    device_kind: str = "cpu"
    device_count: int = 1
    # seconds per element through an interconnect collective; 0.0 means "not
    # calibrated" (one device) and predictions fall back to t_elem.
    t_coll: float = 0.0
    # seconds per element through host<->device staging; 0.0 means "not
    # calibrated" and falls back to t_elem.
    t_h2d: float = 0.0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict) -> "Calibration":
        return Calibration(**d)


def _time_best(fn, repeats: int = 3, device: str | torch.device = "cpu") -> float:
    """Best-of-N seconds of one call of ``fn``, after one warm-up call.

    On a CUDA device each call is timed by CUDA events after a synchronize;
    on the CPU by the host clock.
    """
    fn()  # warm-up: builds kernels, fills allocator caches
    best = float("inf")
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def calibrate_h2d(
    sample_dim: int = 1024, repeats: int = 3, device: str | torch.device = "cuda"
) -> float:
    """Fit ``t_h2d`` from a host->device + device->host staging round trip.

    One copy of a host (sample_dim, sample_dim) fp32 tensor to ``device`` and
    back. The fit is seconds per element through the host<->device boundary.
    On the CPU the copies are no-ops, so the constant is correctly tiny.
    """
    x = torch.ones((sample_dim, sample_dim), dtype=torch.float32)
    t = _time_best(lambda: x.to(device).to("cpu"), repeats, device)
    # One pass up, one pass down.
    return t / (2.0 * sample_dim * sample_dim)


def calibrate(
    sample_dim: int = 256, repeats: int = 3, device: str | torch.device = "cuda"
) -> Calibration:
    """Fit (t_flop, t_elem, t_h2d) from micro-benchmarks on ``device``.

    Leaf benchmark: a rank-7 ``bmm``, the shape of the BFS leaf stage.
    Divide benchmark: one :func:`divide_level`, the divide/combine stage.
    Both mirror the paper's implicit calibration. ``t_coll`` is 0.0 and the
    device count 1, as the reference computes them on one device.
    """
    d = sample_dim
    scheme = get_scheme("strassen")
    rank = scheme.n_mults
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((rank, d, d), generator=gen, device=device)
    b = torch.randn((rank, d, d), generator=gen, device=device)

    def leaf():
        with matmul_precision(None):
            return torch.bmm(a, b)

    t_flop = _time_best(leaf, repeats, device) / (rank * 2.0 * d**3)
    t_div = _time_best(lambda: divide_level(a, scheme.a_coef), repeats, device)
    # divide_level: (rank, d, d) -> (rank*rank, d/2, d/2) output elements.
    t_elem = t_div / (rank * rank * (d // 2) * (d // 2))
    return Calibration(
        t_flop=float(t_flop),
        t_elem=float(t_elem),
        device_kind=device_platform(device),
        device_count=1,
        t_coll=0.0,
        t_h2d=float(calibrate_h2d(repeats=repeats, device=device)),
    )


# One calibration per device type ('cpu', 'cuda'): decisions differ between them.
_CALIBRATIONS: Dict[str, Calibration] = {}


def get_calibration(device: str | torch.device = "cuda") -> Calibration:
    """Process-cached calibration of ``device`` (one micro-benchmark set per device type)."""
    kind = torch.device(device).type
    if kind not in _CALIBRATIONS:
        _CALIBRATIONS[kind] = calibrate(device=device)
    return _CALIBRATIONS[kind]


def calibration_snapshot(device: str | torch.device = "cuda") -> Optional[Dict]:
    """The calibration of ``device`` as a dict, or None if none has run yet.

    Never triggers the micro-benchmarks: stats surfaces (``Engine.autotune_stats``)
    report the constants without paying device time on an engine that
    resolved every decision from a warm cache.
    """
    calib = _CALIBRATIONS.get(torch.device(device).type)
    return calib.to_dict() if calib is not None else None


def _stored_calibration(cache: Optional["TuningCache"], device) -> Optional[Calibration]:
    """The cache's calibration if it was fitted on ``device``'s platform.

    A cache file holds one calibration and may be shared by the CPU and the
    card (or written on the CPU by the JAX package): constants of another
    platform never cost this device's decisions.
    """
    calib = cache.calibration if cache is not None else None
    if calib is not None and calib.device_kind == device_platform(device):
        return calib
    return None


def costing_calibration(cache: Optional["TuningCache"], device) -> Optional[Dict]:
    """The constants that cost :func:`autotune`'s misses on ``device`` with
    ``cache``, as a dict, or None if none is known without calibrating.

    The cache's own calibration where it is ``device``'s platform's, else
    the process calibration of ``device`` (:func:`calibration_snapshot`).
    """
    calib = _stored_calibration(cache, device)
    return calib.to_dict() if calib is not None else calibration_snapshot(device)


# --------------------------------------------------------------------------
# Candidate enumeration
# --------------------------------------------------------------------------


def _usable_depth(m: int, k: int, n: int, depth: int, min_dim: int) -> bool:
    """depth levels are usable iff dims stay even and above the crossover floor
    at every level: the same rule as MatmulBackend.effective_depth."""
    for _ in range(depth):
        if m % 2 or k % 2 or n % 2 or min(m, k, n) < min_dim:
            return False
        m, k, n = m // 2, k // 2, n // 2
    return depth > 0


def enumerate_candidates(
    m: int,
    k: int,
    n: int,
    *,
    schemes: Sequence[str] = LOCAL_SCHEMES,
    max_depth: int = 3,
    min_dim: int = 1024,
    mesh=None,
    oot_budget: Optional[int] = None,
    dtype=torch.float32,
    device: str | torch.device = "cuda",
) -> List[Candidate]:
    """All strategies that can legally run this shape (naive always can).

    ``strassen_fused`` enumerates whenever the fused kernel runs on
    ``device``, per :func:`repro_torch.core.compat.fused_leaf_mode` (which
    raises if the kernel fails to build or launch on the card). ``mesh``
    raises :class:`NotImplementedError`.

    ``oot_budget`` (device bytes) enables the ``strassen_oot`` out-of-core
    family: one candidate per scheme at every depth whose single leaf fits
    the budget — including depths the in-core rules reject (odd dims: the
    block runtime pads), which is the whole point of the pipeline.
    """
    _refuse_mesh(mesh)
    cands = [Candidate(kind="naive")]
    depths = [d for d in range(1, max_depth + 1) if _usable_depth(m, k, n, d, min_dim)]
    for scheme in schemes:
        for d in depths:
            cands.append(Candidate(kind=scheme, scheme=scheme, depth=d))
    if depths and "strassen" in schemes and compat.fused_leaf_mode(device) != "none":
        for d in depths:
            cands.append(Candidate(kind=FUSED_KIND, scheme="strassen", depth=d))
    if oot_budget:
        from repro_torch.blocks.scheduler import leaf_bytes, min_depth_for_budget

        name = dtype_name(dtype)
        # A dense on-device multiply needs A + B + C resident at once.
        dense_bytes = (m * k + k * n + m * n) * getattr(torch, name).itemsize
        dense_fits = dense_bytes <= oot_budget
        try:
            d0 = min_depth_for_budget(m, k, n, oot_budget, name)
        except ValueError:
            d0 = None
        # Crossover guard: below min_dim the divide/combine + staging
        # overhead dominates exactly as it does for the in-core pipelines —
        # unless the dense working set cannot fit the budget, where
        # out-of-core is feasibility, not preference.
        if d0 is not None and (min(m, k, n) >= min_dim or not dense_fits):
            # Depths run from the shallowest that fits to max_depth — or
            # deeper when the budget demands it.
            for scheme in schemes:
                for d in range(d0, max(max_depth, d0) + 1):
                    if leaf_bytes(m, k, n, d, name) <= oot_budget and min(
                        m, k, n
                    ) >= 2**d:
                        cands.append(Candidate(kind=OOT_KIND, scheme=scheme, depth=d))
        # When the dense working set exceeds the budget every on-device
        # candidate is infeasible, not merely slow — drop them so the
        # planner cannot pick an impossible plan. (Falls back to the
        # unfiltered list if no oot depth fits either, so callers still
        # get a best-effort decision.)
        if not dense_fits:
            oot_only = [c for c in cands if c.kind == OOT_KIND]
            cands = oot_only or cands
    return cands


# --------------------------------------------------------------------------
# Stage-wise prediction (paper §IV generalized to rectangular stages)
# --------------------------------------------------------------------------


def predict_cost_terms(
    cand: Candidate,
    m: int,
    k: int,
    n: int,
    calib: Calibration,
    *,
    oot_overlap: bool = True,
) -> Dict[str, float]:
    """Per-constant cost decomposition of one candidate's predicted seconds.

    Returns ``{"t_flop": ..., "t_elem": ..., "t_coll": ..., "t_h2d": ...}``,
    the seconds attributed to each calibrated constant, summing to
    :func:`predict_seconds`. The reference's arithmetic on one device,
    operation for operation; the mesh kinds raise
    :class:`NotImplementedError`. On one device no local kind touches the
    interconnect or the host link, so their ``t_coll`` and ``t_h2d`` stay
    0.0; the out-of-core kind prices its staging at ``t_h2d``.

    ``oot_overlap`` models the scheduler's async wave pipeline (its
    default): staging traffic that fits under the leaf compute is hidden,
    so the ``t_h2d`` term only charges the *exposed* part — the traffic
    exceeding compute plus the fill/drain bubble
    (:data:`OOT_OVERLAP_EXPOSED_FRACTION` of the hidden portion). Pass
    ``oot_overlap=False`` to price the synchronous loop (``prefetch=False``).
    """
    _refuse_kind(cand)
    flops_naive = 2.0 * m * k * n
    terms = {"t_flop": 0.0, "t_elem": 0.0, "t_coll": 0.0, "t_h2d": 0.0}
    if cand.is_naive:
        terms["t_flop"] = flops_naive * calib.t_flop
        return terms

    rank = get_scheme(cand.scheme).n_mults
    l = cand.depth
    fused = cand.kind == FUSED_KIND
    # Levels whose intermediates are materialized: all l for the einsum
    # pipelines, l-1 when the last level runs inside the fused kernel.
    lm = l - 1 if fused else l
    elem_cost = 0.0
    # Divide levels i = 0..lm-1: outputs rank^(i+1) quarter-blocks of A and B.
    for i in range(lm):
        e_a = rank ** (i + 1) * (m * k) / 4.0 ** (i + 1)
        e_b = rank ** (i + 1) * (k * n) / 4.0 ** (i + 1)
        elem_cost += e_a + e_b
    # Combine levels i = lm-1..0: outputs rank^i blocks of C at level i.
    for i in range(lm):
        elem_cost += rank**i * (m * n) / 4.0**i
    if fused:
        # The fused level reads its operands once and writes C once; the
        # 7/4x M-term blowup never touches device memory.
        elem_cost += rank ** (l - 1) * (m * k + k * n + m * n) / 4.0 ** (l - 1)
    leaf_flops = flops_naive * (rank / 8.0) ** l

    if cand.kind == OOT_KIND:
        # Out-of-core: divide/combine adds are host-side element traffic;
        # leaf waves run sequentially on one device and every leaf's
        # operands cross the host<->device boundary once each way.
        t_h2d = calib.t_h2d if calib.t_h2d > 0.0 else calib.t_elem
        flop_s = leaf_flops * calib.t_flop
        h2d_s = rank**l * (m * k + k * n + m * n) / 4.0**l * t_h2d
        if oot_overlap:
            # Async pipeline: staging overlaps leaf compute, so only the
            # traffic exceeding compute is on the critical path — plus the
            # fill/drain bubble, a fixed fraction of the hidden portion.
            hidden = min(h2d_s, flop_s)
            h2d_s = max(h2d_s - flop_s, 0.0) + OOT_OVERLAP_EXPOSED_FRACTION * hidden
        terms["t_flop"] = flop_s
        terms["t_elem"] = elem_cost * calib.t_elem
        terms["t_h2d"] = h2d_s
        return terms

    terms["t_flop"] = leaf_flops * calib.t_flop
    terms["t_elem"] = elem_cost * calib.t_elem
    return terms


def predict_seconds(
    cand: Candidate, m: int, k: int, n: int, calib: Calibration, *, oot_overlap: bool = True
) -> float:
    """Predicted seconds of one multiply under the calibrated model.

    Each divide/combine level costs its output-element traffic times a
    per-element constant; the leaf stage costs its flops times t_flop over
    the leaf parallelization factor, 1 on one device (where the library
    matmul already uses the whole device, which is what t_flop measures).
    Fused candidates skip the last level's materialized traffic.
    Out-of-core candidates add the host<->device staging term priced at
    ``t_h2d`` — discounted to the exposed traffic when ``oot_overlap`` is
    on. See :func:`predict_cost_terms` for the per-constant decomposition.
    """
    return sum(predict_cost_terms(cand, m, k, n, calib, oot_overlap=oot_overlap).values())


# --------------------------------------------------------------------------
# Execution + measurement
# --------------------------------------------------------------------------


def execute(
    cand: Candidate,
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    precision=None,
    mesh=None,
    oot_budget: Optional[int] = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Run one candidate on a's device.

    ``strassen_fused`` runs the port's fused pipeline, whose last level is
    the ``strassen1`` kernel on the card. ``strassen_oot`` candidates run
    the host-resident block pipeline with their leaves on ``device``
    (default: a's device) and return the product there; ``oot_budget`` caps
    their device bytes, defaulting to one single-leaf pipelined wave slot.
    The mesh kinds raise :class:`NotImplementedError`.
    """
    _refuse_mesh(mesh)
    if cand.is_naive:
        with matmul_precision(precision):
            return torch.matmul(a, b)
    if cand.kind == OOT_KIND:
        from repro_torch.blocks.scheduler import pipelined_leaf_bytes, strassen_oot_matmul
        from repro_torch.core.backend import MatmulBackend

        device = a.device if device is None else torch.device(device)
        m, k = a.shape
        n = b.shape[1]
        dtype = torch.promote_types(a.dtype, b.dtype)
        budget = oot_budget or pipelined_leaf_bytes(m, k, n, cand.depth, dtype)
        leaf_backend = None
        if precision is not None:
            # Thread the caller's precision into the leaf waves — measured
            # comparisons must price every candidate at the same precision.
            leaf_backend = MatmulBackend(kind="auto", depth=2, precision=precision)
        out, _ = strassen_oot_matmul(
            a, b, depth=cand.depth, budget_bytes=budget, scheme=cand.scheme,
            backend=leaf_backend, device=device,
        )
        return out.to(device)
    if cand.kind == FUSED_KIND:
        from repro_torch.kernels.strassen.ops import strassen_matmul_fused

        return strassen_matmul_fused(
            a, b, depth=cand.depth, scheme_name=cand.scheme, precision=precision
        )
    _refuse_kind(cand)
    return strassen_matmul(
        a, b, depth=cand.depth, scheme=cand.scheme, precision=precision
    )


def measure_seconds(
    cand: Candidate,
    m: int,
    k: int,
    n: int,
    dtype=torch.float32,
    *,
    mesh=None,
    precision=None,
    repeats: int = 2,
    oot_budget: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> float:
    """Time one candidate end to end on ``device`` (warm-up excluded).

    An out-of-core candidate's operands start on the host, as the
    reference's do, and its leaves run on ``device``.
    """
    _refuse_mesh(mesh)
    gen = torch.Generator(device=device).manual_seed(0)
    dt = getattr(torch, dtype_name(dtype))
    a = torch.randn((m, k), generator=gen, device=device).to(dt)
    b = torch.randn((k, n), generator=gen, device=device).to(dt)
    if cand.kind == OOT_KIND:
        a, b = a.cpu(), b.cpu()
    return _time_best(
        lambda: execute(cand, a, b, precision=precision, oot_budget=oot_budget, device=device),
        repeats, device,
    )


# --------------------------------------------------------------------------
# Persistent tuning cache
# --------------------------------------------------------------------------


def cache_key(
    m: int,
    k: int,
    n: int,
    dtype,
    *,
    device_kind: str,
    device_count: int,
    schemes: Sequence[str],
    min_dim: int,
    max_depth: int,
    topo: str = "local",
    site: Optional[str] = None,
    oot_budget: Optional[int] = None,
) -> str:
    """The reference's key, string for string: ``dtype`` by its numpy/JAX
    name and ``device_kind`` as JAX's platform name (:func:`device_platform`).

    ``topo`` separates local from mesh resolutions; ``site`` is an optional
    call-site tag (e.g. ``"attn.wq"``) whose entries are keyed per call site,
    with ``site=None`` giving the shape-only key; ``oot_budget`` keys
    budget-gated resolutions apart.
    """
    key = (
        f"{m}x{k}x{n}|{dtype_name(dtype)}|{device_kind}:{device_count}|{topo}"
        f"|{','.join(schemes)}|min{min_dim}|d{max_depth}"
    )
    if oot_budget:
        key += f"|oot{oot_budget}"
    if site:
        key += f"|site:{site}"
    return key


class TuningCache:
    """JSON-backed decision store: key -> Decision (+ the calibration used).

    The reference's file format: a cache written by the JAX package loads
    here and the reverse. Load-then-lookup is the startup path for serving.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.entries: Dict[str, Decision] = {}
        self.calibration: Optional[Calibration] = None
        self._suspended = False
        if path and os.path.exists(path):
            self.load(path)

    @contextlib.contextmanager
    def deferred(self):
        """Batch many put/save cycles into one file write (warm-up loops)."""
        self._suspended = True
        try:
            yield self
        finally:
            self._suspended = False
            self.save()

    def load(self, path: str) -> "TuningCache":
        with open(path) as f:
            raw = json.load(f)
        self.entries = {
            k: Decision.from_dict(v) for k, v in raw.get("decisions", {}).items()
        }
        if raw.get("calibration"):
            self.calibration = Calibration.from_dict(raw["calibration"])
        return self

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if not path or self._suspended:
            return
        payload = {
            "decisions": {k: d.to_dict() for k, d in self.entries.items()},
            "calibration": self.calibration.to_dict() if self.calibration else None,
        }
        # atomic: decisions may be read by a concurrently starting engine
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def get(self, key: str) -> Optional[Decision]:
        return self.entries.get(key)

    def put(self, key: str, decision: Decision) -> None:
        self.entries[key] = decision


# --------------------------------------------------------------------------
# Decision telemetry
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TelemetryEvent:
    """One autotune resolution: where it came from and what it chose."""

    key: str
    site: Optional[str]
    kind: str
    scheme: str
    depth: int
    source: str  # predicted | measured | cache
    cache_hit: bool
    predicted_s: float
    measured_s: Optional[float] = None
    # Per-constant decomposition of predicted_s (see predict_cost_terms).
    # None on cache hits: the stored decision predates this resolution.
    terms: Optional[Dict[str, float]] = None

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class Telemetry:
    """Process-wide autotune decision log.

    Every :func:`autotune` call records one event: cache hit or miss, the
    chosen kind, and the predicted (and, under measure mode, measured)
    seconds. The event log is a ring buffer (``max_events``); the hit/miss
    counters stay exact totals.
    """

    def __init__(self, max_events: int = 4096) -> None:
        self.max_events = max_events
        self.cache_hits = 0
        self.cache_misses = 0
        self.events: List[TelemetryEvent] = []

    def record(self, event: TelemetryEvent) -> None:
        if event.cache_hit:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
        self.events.append(event)
        if len(self.events) > self.max_events:
            del self.events[: len(self.events) - self.max_events]

    def kind_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def snapshot(self) -> Dict:
        return {
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "kinds": self.kind_counts(),
            "decisions": [e.to_dict() for e in self.events],
        }

    def reset(self) -> None:
        self.cache_hits = 0
        self.cache_misses = 0
        self.events = []


_TELEMETRY = Telemetry()


def get_telemetry() -> Telemetry:
    """The process telemetry instance (reset() it between experiments)."""
    return _TELEMETRY


def reset_telemetry() -> Telemetry:
    """Zero the process telemetry and return it.

    Every surface that owns a run (``Engine.__init__``) resets the process
    log up front, so its snapshot reflects only its own resolutions.
    """
    _TELEMETRY.reset()
    return _TELEMETRY


_PROCESS_CACHES: Dict[str, TuningCache] = {}


def process_cache(path: Optional[str]) -> TuningCache:
    """One shared TuningCache per path (or one anonymous in-memory cache)."""
    key = path or ""
    if key not in _PROCESS_CACHES:
        _PROCESS_CACHES[key] = TuningCache(path)
    return _PROCESS_CACHES[key]


# --------------------------------------------------------------------------
# The dispatcher
# --------------------------------------------------------------------------


def autotune(
    m: int,
    k: int,
    n: int,
    dtype=torch.float32,
    *,
    min_dim: int = 1024,
    max_depth: int = 3,
    schemes: Sequence[str] = LOCAL_SCHEMES,
    cache: Optional[TuningCache] = None,
    calibration: Optional[Calibration] = None,
    measure: bool = False,
    top_k: int = 3,
    mesh=None,
    precision=None,
    site: Optional[str] = None,
    oot_budget: Optional[int] = None,
    telemetry: Optional[Telemetry] = None,
    device: str | torch.device = "cuda",
) -> Decision:
    """Pick the predicted- (or measured-) fastest strategy for this shape on ``device``.

    Cache hits return immediately (source='cache'), before calibration, so a
    warm cache costs no device time. ``measure=True`` times the top-k
    predicted candidates and records the measured winner.

    ``site`` keys the decision per call site (see :func:`cache_key`). In
    predicted mode a tagged miss falls back to the shape-only entry, but
    measured mode never does. ``telemetry`` records the resolution to a
    caller-owned log instead of the process one. ``oot_budget`` (device
    bytes) adds the out-of-core family (:func:`enumerate_candidates`);
    ``mesh`` raises :class:`NotImplementedError`.
    """
    _refuse_mesh(mesh)
    tel = telemetry if telemetry is not None else _TELEMETRY
    # Every resolution is a span: cache hits close immediately with
    # cache_hit=True; fresh decisions carry the predicted cost-term
    # breakdown next to any measured time.
    tr = obs_tracer.get_tracer()
    res_span = tr.begin(
        "autotune.resolve", cat="autotune", site=site, m=m, k=k, n=n,
    )
    key_kwargs = dict(
        device_kind=device_platform(device),
        device_count=1,
        schemes=schemes,
        min_dim=min_dim,
        max_depth=max_depth,
        topo="local",
        oot_budget=oot_budget,
    )
    key = cache_key(m, k, n, dtype, site=site, **key_kwargs)
    if cache is not None:
        hit = cache.get(key)
        if hit is None and site and not measure:
            hit = cache.get(cache_key(m, k, n, dtype, **key_kwargs))
        if hit is not None and hit.kind == FUSED_KIND:
            # Re-validate fused decisions against THIS device: a cache warmed
            # where the kernel ran must not route to it where it cannot.
            if compat.fused_leaf_mode(device) == "none":
                hit = None
        if hit is not None:
            decision = dataclasses.replace(hit, source="cache")
            tel.record(
                TelemetryEvent(
                    key=key,
                    site=site,
                    kind=decision.kind,
                    scheme=decision.scheme,
                    depth=decision.depth,
                    source="cache",
                    cache_hit=True,
                    predicted_s=decision.predicted_s,
                    measured_s=decision.measured_s,
                )
            )
            obs_metrics.get_metrics().counter("autotune.cache_hit").inc()
            tr.end(
                res_span, cache_hit=True, kind=decision.kind,
                scheme=decision.scheme, depth=decision.depth, source="cache",
                predicted_s=decision.predicted_s,
                measured_s=decision.measured_s,
            )
            return decision

    calib = calibration or _stored_calibration(cache, device) or get_calibration(device)
    cands = enumerate_candidates(
        m, k, n, schemes=schemes, max_depth=max_depth, min_dim=min_dim,
        oot_budget=oot_budget, dtype=dtype, device=device,
    )

    def _overlap(c: Candidate) -> bool:
        # Price an oot candidate's overlap discount only when the budget
        # actually leaves the scheduler its pipelined wave slot at that
        # depth — otherwise it silently degrades to synchronous staging
        # and every staged byte is on the critical path.
        return c.kind != OOT_KIND or _oot_pipeline_fits(
            m, k, n, c.depth, dtype, oot_budget
        )

    scored = sorted(
        cands, key=lambda c: predict_seconds(c, m, k, n, calib, oot_overlap=_overlap(c))
    )
    best = scored[0]
    predicted = predict_seconds(best, m, k, n, calib, oot_overlap=_overlap(best))
    measured = None
    if measure:
        timed = [
            (
                measure_seconds(
                    c, m, k, n, dtype, precision=precision, oot_budget=oot_budget,
                    device=device,
                ),
                c,
            )
            for c in scored[: max(top_k, 1)]
        ]
        measured, best = min(timed, key=lambda t: t[0])
        predicted = predict_seconds(best, m, k, n, calib, oot_overlap=_overlap(best))

    decision = Decision(
        kind=best.kind,
        scheme=best.scheme,
        depth=best.depth,
        predicted_s=float(predicted),
        measured_s=None if measured is None else float(measured),
        source="measured" if measure else "predicted",
    )
    if cache is not None:
        cache.calibration = cache.calibration or calib
        # Predicted decisions are shape-only by construction, so a tagged
        # resolution stores under the shape-only key; only measured
        # decisions are site-specific.
        store_key = (
            key if (measure or not site) else cache_key(m, k, n, dtype, **key_kwargs)
        )
        cache.put(store_key, decision)
        cache.save()
    terms = predict_cost_terms(best, m, k, n, calib, oot_overlap=_overlap(best))
    tel.record(
        TelemetryEvent(
            key=key,
            site=site,
            kind=decision.kind,
            scheme=decision.scheme,
            depth=decision.depth,
            source=decision.source,
            cache_hit=False,
            predicted_s=decision.predicted_s,
            measured_s=decision.measured_s,
            terms=terms,
        )
    )
    obs_metrics.get_metrics().counter("autotune.cache_miss").inc()
    tr.end(
        res_span, cache_hit=False, kind=decision.kind,
        scheme=decision.scheme, depth=decision.depth, source=decision.source,
        predicted_s=decision.predicted_s, measured_s=decision.measured_s,
        **{f"terms.{t}": v for t, v in terms.items()},
    )
    return decision


# --------------------------------------------------------------------------
# Solver families (SPIN block-recursive inversion / triangular solve)
# --------------------------------------------------------------------------

# Candidate families of the solver ops. Priced with the same calibrated
# constants as the matmul families: t_flop for dense-leaf and recursive
# multiply flops, t_h2d for every staged byte (with the wave pipeline's
# overlap discount), t_elem for the host-side axpy chains.
INVERSE_OOT_KIND = "inverse_oot"
SOLVE_OOT_KIND = "solve_oot"
_SOLVER_FAMILIES = {"inverse": INVERSE_OOT_KIND, "solve": SOLVE_OOT_KIND}


def predict_solver_terms(
    op: str,
    n: int,
    depth: int,
    calib: Calibration,
    *,
    nrhs: Optional[int] = None,
    oot_budget: Optional[int] = None,
    oot_overlap: bool = True,
) -> Dict[str, float]:
    """Per-constant cost decomposition of one solver run at a given depth.

    The recursion does, per node at level i (2^i nodes, half-size h =
    n / 2^(i+1)): for ``inverse`` six h-sized multiplies and two axpys
    (SPIN's Schur-complement program); for ``solve`` one (h x h) @
    (h x nrhs) multiply and one axpy. The 2^depth dense leaves run one
    device inv (~2 s^3 flops) or trsm (~s^2 nrhs flops). Multiply staging
    is priced at t_h2d with the wave pipeline's exposed-fraction discount
    (:data:`OOT_OVERLAP_EXPOSED_FRACTION`) when ``oot_overlap``.
    """
    if op not in _SOLVER_FAMILIES:
        raise ValueError(
            f"unknown solver op {op!r}; have {sorted(_SOLVER_FAMILIES)}"
        )
    r = n if nrhs is None else nrhs
    t_h2d = calib.t_h2d or calib.t_elem
    flop_s = 0.0
    h2d_elems = 0.0
    elem_s = 0.0
    s = max(1, n >> depth)
    leaves = 1 << depth
    if op == "inverse":
        flop_s += leaves * 2.0 * s**3 * calib.t_flop
        h2d_elems += leaves * 2.0 * s * s
    else:
        flop_s += leaves * float(s) * s * r * calib.t_flop
        h2d_elems += leaves * (s * s + 2.0 * s * r)
    mul_flop_s = 0.0
    for level in range(depth):
        nodes = 1 << level
        h = max(1, n >> (level + 1))
        if op == "inverse":
            mul_flop_s += nodes * 6 * 2.0 * h**3 * calib.t_flop
            h2d_elems += nodes * 6 * 3.0 * h * h
            elem_s += nodes * 2.0 * h * h * calib.t_elem
        else:
            mul_flop_s += nodes * 2.0 * h * h * r * calib.t_flop
            h2d_elems += nodes * (h * h + 2.0 * h * r)
            elem_s += nodes * float(h) * r * calib.t_elem
    flop_s += mul_flop_s
    h2d_s = h2d_elems * t_h2d
    if oot_overlap:
        # The staged traffic rides the scheduler's async pipeline: only the
        # non-overlappable remainder plus the fill/drain bubbles stay on
        # the critical path (same shape as the strassen_oot discount).
        h2d_s = max(h2d_s - mul_flop_s, 0.0) + OOT_OVERLAP_EXPOSED_FRACTION * min(
            h2d_s, mul_flop_s
        )
    return {"flop_s": flop_s, "elem_s": elem_s, "h2d_s": h2d_s}


def predict_solver_seconds(
    op: str,
    n: int,
    depth: int,
    calib: Calibration,
    *,
    nrhs: Optional[int] = None,
    oot_budget: Optional[int] = None,
    oot_overlap: bool = True,
) -> float:
    terms = predict_solver_terms(
        op, n, depth, calib, nrhs=nrhs, oot_budget=oot_budget,
        oot_overlap=oot_overlap,
    )
    return sum(terms.values())


def autotune_solver(
    op: str,
    n: int,
    dtype=torch.float32,
    *,
    nrhs: Optional[int] = None,
    oot_budget: Optional[int] = None,
    max_depth: int = 10,
    scheme: str = "strassen",
    cache: Optional[TuningCache] = None,
    calibration: Optional[Calibration] = None,
    site: Optional[str] = None,
    telemetry: Optional[Telemetry] = None,
    device: str | torch.device = "cuda",
) -> Decision:
    """Pick the predicted-fastest recursion depth for one solver shape on ``device``.

    ``op`` is 'inverse' or 'solve'. Candidate depths run from the
    smallest whose dense leaf fits ``oot_budget`` (every level halves the
    leaf side) up a few levels — deeper trades dense-leaf cubic work for
    more recursive-multiply traffic, and the calibrated terms arbitrate.
    Decisions cache and telemetry exactly like matmul resolutions, with
    ``topo`` set to the solver family so a solver entry can never answer
    a matmul lookup.
    """
    from repro_torch.blocks.solve import solver_min_depth_for_budget

    family = _SOLVER_FAMILIES.get(op)
    if family is None:
        raise ValueError(
            f"unknown solver op {op!r}; have {sorted(_SOLVER_FAMILIES)}"
        )
    tel = telemetry if telemetry is not None else _TELEMETRY
    tr = obs_tracer.get_tracer()
    res_span = tr.begin(
        "autotune.resolve", cat="autotune", site=site, family=family, n=n,
    )
    leaf_kind = "inv" if op == "inverse" else "trsm_lower"
    key = cache_key(
        n, n, n if nrhs is None else nrhs, dtype,
        device_kind=device_platform(device), device_count=1,
        schemes=(scheme,), min_dim=0, max_depth=max_depth,
        topo=family, site=site, oot_budget=oot_budget,
    )
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            decision = dataclasses.replace(hit, source="cache")
            tel.record(
                TelemetryEvent(
                    key=key, site=site, kind=decision.kind,
                    scheme=decision.scheme, depth=decision.depth,
                    source="cache", cache_hit=True,
                    predicted_s=decision.predicted_s,
                    measured_s=decision.measured_s,
                )
            )
            obs_metrics.get_metrics().counter("autotune.cache_hit").inc()
            tr.end(
                res_span, cache_hit=True, kind=decision.kind,
                depth=decision.depth, source="cache",
            )
            return decision

    calib = calibration or _stored_calibration(cache, device) or get_calibration(device)
    if oot_budget:
        d_min = solver_min_depth_for_budget(
            n, oot_budget, dtype_name(dtype), nrhs=nrhs, leaf_kind=leaf_kind,
            max_depth=max_depth,
        )
    else:
        d_min = 0
    depths = range(d_min, min(d_min + 3, max_depth) + 1)
    best_depth = min(
        depths,
        key=lambda d: predict_solver_seconds(
            op, n, d, calib, nrhs=nrhs, oot_budget=oot_budget
        ),
    )
    predicted = predict_solver_seconds(
        op, n, best_depth, calib, nrhs=nrhs, oot_budget=oot_budget
    )
    decision = Decision(
        kind=family, scheme=scheme, depth=best_depth,
        predicted_s=float(predicted), source="predicted",
    )
    if cache is not None:
        cache.calibration = cache.calibration or calib
        cache.put(key, decision)
        cache.save()
    terms = predict_solver_terms(
        op, n, best_depth, calib, nrhs=nrhs, oot_budget=oot_budget
    )
    tel.record(
        TelemetryEvent(
            key=key, site=site, kind=family, scheme=scheme, depth=best_depth,
            source="predicted", cache_hit=False,
            predicted_s=decision.predicted_s, terms=terms,
        )
    )
    obs_metrics.get_metrics().counter("autotune.cache_miss").inc()
    tr.end(
        res_span, cache_hit=False, kind=family, depth=best_depth,
        source="predicted", predicted_s=decision.predicted_s,
        **{f"terms.{t}": v for t, v in terms.items()},
    )
    return decision


def model_call_sites(cfg) -> List[Tuple[str, int, int]]:
    """(site, d_in, d_out) for every tagged dense projection of a model.

    These are exactly the tags :mod:`repro_torch.models.attention` /
    :mod:`repro_torch.models.mlp` thread through ``linear``; keep the two
    lists in sync so warmed cache keys match runtime lookups.
    """
    hd = cfg.head_dim or (cfg.d_model // max(cfg.n_heads, 1))
    sites = [
        ("attn.wq", cfg.d_model, cfg.n_heads * hd),
        ("attn.wk", cfg.d_model, cfg.n_kv_heads * hd),
        ("attn.wv", cfg.d_model, cfg.n_kv_heads * hd),
        ("attn.wo", cfg.n_heads * hd, cfg.d_model),
        ("mlp.up", cfg.d_model, cfg.d_ff),
        ("mlp.down", cfg.d_ff, cfg.d_model),
    ]
    if cfg.glu:
        sites.append(("mlp.gate", cfg.d_model, cfg.d_ff))
    return [(s, i, o) for s, i, o in sites if i > 0 and o > 0]


def warm_for_model(
    cfg,
    *,
    tokens: Sequence[int] = (1, 128, 2048),
    batches: Sequence[int] = (1, 8),
    device: str | torch.device = "cuda",
) -> int:
    """Pre-resolve decisions for a model's dense-projection call sites on ``device``.

    Serving startup path: the flattened M a projection sees is batch*seq at
    prefill and batch at decode, so every (batch * tokens) x call-site
    combination is resolved up front, under the site tags the layers pass.
    Shapes outside this grid still resolve lazily. Returns the number of
    resolutions performed.
    """
    from repro_torch.core import backend as _backend

    be = cfg.matmul_backend
    if be.kind != "auto":
        return 0
    ms = sorted({b * t for b in batches for t in tokens} | set(batches))
    kind = torch.device(device).type
    count = 0
    with process_cache(be.tuning_cache).deferred():
        for m in ms:
            for site, d_in, d_out in model_call_sites(cfg):
                _backend.resolve_auto(m, d_in, d_out, cfg.dtype, be, site, kind)
                count += 1
    return count
