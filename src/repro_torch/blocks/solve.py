"""SPIN-style block-recursive solvers over dataflow plans.

The port of :mod:`repro.blocks.solve`. Executes the
:class:`repro_torch.blocks.plan.DataflowPlan` family — SPIN's
Schur-complement inversion (arxiv 1801.04723) and the lower/upper
triangular solves — on the same host/device machinery the matmul waves
use. Each node of the recursion:

* **divide** — slices the plan's named sub-blocks (quadrants / row
  halves) from its host-resident operands;
* **program** — runs the plan's step list: recursions descend, ``axpy``
  steps are host signed block sums in the accumulation dtype (the same
  one-rounding-per-value discipline as the matmul divide/combine), and
  every ``matmul`` step *re-enters the matmul scheduler* — direct device
  dispatch through ``backend.matmul`` when the product's working set fits
  the device budget, the full out-of-core wave pipeline
  (:func:`repro_torch.blocks.scheduler.strassen_oot_matmul`, with chaos
  injection + lineage recovery threaded through) when it does not;
* **leaf** — at the recursion floor, one small dense device op
  (``torch.linalg.inv`` / ``torch.linalg.solve_triangular``), staged in
  the accumulation dtype. The reference computes these with the library's
  dense solvers as well, outside any kernel of its own.

Because all heavy arithmetic happens inside scheduler runs, the solver
inherits their guarantees: device residency stays under ``budget_bytes``
(asserted per sub-run and reported as the aggregate peak), and seeded
``ChaosStore`` faults during an out-of-core inversion heal bit-identically
through the sub-runs' lineage recompute.

Telemetry mirrors the matmul path: one ``oot.{inverse,solve}`` root span
per run (wave lanes come from the nested scheduler runs), solver node spans
tagged with their base-2 recursion path, and one *aggregate*
:class:`~repro_torch.blocks.scheduler.OotStats` (``op`` set from the plan)
appended to the stats rings alongside the per-multiply entries.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.blocks.blockmatrix import BlockStore, as_host_tensor
from repro_torch.blocks.plan import (
    SPIN_INVERSE,
    TRSM_LOWER,
    TRSM_UPPER,
    DataflowPlan,
    Step,
    get_plan,
    select_part,
)
from repro_torch.blocks.recovery import ChaosConfig
from repro_torch.blocks.scheduler import (
    OotStats,
    _acc_dtype,
    _dtype_name,
    _record_run,
    min_depth_for_budget,
    resolve_device,
    strassen_oot_matmul,
)
from repro_torch.core.precision import matmul_precision
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracer as obs_tracer

__all__ = [
    "SolveScheduler",
    "spin_inverse_oot",
    "triangular_solve_oot",
    "solver_min_depth_for_budget",
]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _leaf_device_bytes(n: int, nrhs: int, dtype, leaf_kind: str) -> int:
    """Device bytes one dense leaf op needs (operands + result)."""
    item = _acc_dtype(dtype).itemsize
    if leaf_kind == "inv":
        return 2 * n * n * item
    # trsm: triangular factor + RHS + solution
    return (n * n + 2 * n * nrhs) * item


def solver_min_depth_for_budget(
    n: int,
    budget_bytes: int,
    dtype,
    *,
    nrhs: Optional[int] = None,
    leaf_kind: str = "inv",
    max_depth: int = 12,
) -> int:
    """Smallest solver recursion depth whose dense leaf fits the budget.

    Depth 0 is legal (the whole problem runs as one dense device op);
    every added level halves the leaf side. The inner block multiplies
    pick their own (matmul) depths against the same budget.
    """
    if budget_bytes <= 0:
        raise ValueError("budget_bytes must be positive")
    # The RHS panel splits by rows only, so its column count survives to
    # the leaves untouched.
    nrhs = n if nrhs is None else nrhs
    for depth in range(max_depth + 1):
        s = -(-n // (1 << depth))
        if _leaf_device_bytes(s, nrhs, dtype, leaf_kind) <= budget_bytes:
            return depth
    raise ValueError(
        f"no depth <= {max_depth} fits a {n}x{n} {_dtype_name(dtype)} "
        f"{leaf_kind} leaf into {budget_bytes} bytes"
    )


class SolveScheduler:
    """Budgeted executor for one dataflow plan (inversion / trsm).

    Args:
      plan: a :class:`~repro_torch.blocks.plan.DataflowPlan` or its registry
        name (``spin_inverse`` | ``spin_trsm_lower`` | ``spin_trsm_upper``).
      depth: solver recursion depth (2^depth dense leaves down the
        Schur/forward chain). The dense leaf must fit ``budget_bytes``;
        see :func:`solver_min_depth_for_budget`.
      budget_bytes: peak device bytes — bounds the dense leaves, the
        direct device multiplies, and every nested out-of-core run.
      scheme: coefficient scheme for the nested out-of-core multiplies.
      backend: leaf-multiply routing for the program multiplies and nested
        runs (default ``kind="auto"`` as in the matmul scheduler); its
        precision also sets TF32 for the dense leaves.
      store / store_root: block residency spec for nested out-of-core
        runs (each run owns and clears its own tag space).
      chaos / recovery / retries / retry_backoff_s / degrade: threaded
        into every nested out-of-core multiply. Each multiply derives a
        distinct deterministic chaos seed (``seed + 7919 * call_index``)
        so a fixed input replays the identical fault schedule.
      device: where the leaves and multiplies run: ``"cuda"`` (the default)
        or ``"cpu"``.
    """

    def __init__(
        self,
        *,
        plan: "DataflowPlan | str",
        depth: int,
        budget_bytes: int,
        scheme: str = "strassen",
        backend=None,
        block: Optional[int] = None,
        prefetch: bool = True,
        stage_dtype=None,
        store: "str | BlockStore" = "dict",
        store_root: Optional[str] = None,
        chaos: Optional[ChaosConfig] = None,
        recovery: Optional[bool] = None,
        retries: int = 2,
        retry_backoff_s: float = 0.05,
        degrade: bool = True,
        device="cuda",
    ) -> None:
        plan = get_plan(plan) if isinstance(plan, str) else plan
        if not isinstance(plan, DataflowPlan):
            raise ValueError(
                f"plan {getattr(plan, 'name', plan)!r} is not a dataflow plan; "
                f"bilinear plans run on the wave scheduler"
            )
        if depth < 0:
            raise ValueError("solver depth must be >= 0")
        if budget_bytes <= 0:
            raise ValueError("budget_bytes must be positive")
        self.plan = plan
        self.depth = int(depth)
        self.budget_bytes = int(budget_bytes)
        self.scheme = scheme
        self.block = block
        self.prefetch = prefetch
        self.stage_dtype = stage_dtype
        self.store = store
        self.store_root = store_root
        self.chaos = chaos
        self.recovery = recovery
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.degrade = degrade
        self.device = resolve_device(device)
        if backend is None:
            from repro_torch.core.backend import MatmulBackend

            backend = MatmulBackend(kind="auto", depth=2, min_dim=1024)
        self.backend = backend

    # ------------------------------------------------------------ execution
    def run(self, *operands) -> Tuple[torch.Tensor, OotStats]:
        """Execute the plan; returns (result on the host, aggregate OotStats)."""
        plan = self.plan
        if len(operands) != len(plan.operands):
            raise ValueError(
                f"plan {plan.name!r} takes operands "
                f"{', '.join(plan.operands)}; got {len(operands)}"
            )
        tr = obs_tracer.get_tracer()
        if not tr.enabled:
            tr = obs_tracer.Tracer(enabled=True)
        mx = obs_metrics.get_metrics()

        arrays = [as_host_tensor(x) for x in operands]
        primary = arrays[0]
        if primary.ndim != 2 or primary.shape[0] != primary.shape[1]:
            raise ValueError(
                f"plan {plan.name!r} needs a square primary operand, got "
                f"{tuple(primary.shape)}"
            )
        n = primary.shape[0]
        nrhs = arrays[1].shape[1] if len(arrays) > 1 else n
        if len(arrays) > 1 and arrays[1].shape[0] != n:
            raise ValueError(
                f"operand shapes {tuple(primary.shape)} vs {tuple(arrays[1].shape)} disagree"
            )
        dtype = arrays[0].dtype
        for x in arrays[1:]:
            dtype = torch.promote_types(dtype, x.dtype)
        acc_dtype = _acc_dtype(dtype)

        # Pad to a multiple of 2^depth with an identity extension on the
        # square operand (inv([[A,0],[0,I]]) = [[inv(A),0],[0,I]], and a
        # unit-diagonal extension keeps triangular factors invertible)
        # and zero rows on the RHS; the extension columns never couple
        # back into the result slice.
        step = 1 << self.depth
        pn = -(-n // step) * step
        if pn != n:
            ext = torch.eye(pn, dtype=acc_dtype)
            ext[:n, :n] = primary.to(acc_dtype)
            arrays[0] = ext
            if len(arrays) > 1:
                rhs = torch.zeros((pn, nrhs), dtype=acc_dtype)
                rhs[:n] = arrays[1].to(acc_dtype)
                arrays[1] = rhs
        # All host-side solver math runs in acc_dtype (one final rounding
        # at the output cast), matching the matmul divide/combine chains.
        arrays = [x.to(acc_dtype) for x in arrays]

        leaf_need = _leaf_device_bytes(
            pn >> self.depth, nrhs, dtype, plan.leaf_kind
        )
        if leaf_need > self.budget_bytes:
            raise ValueError(
                f"device budget {self.budget_bytes} B cannot hold one "
                f"{pn >> self.depth}-sized {plan.leaf_kind} leaf "
                f"({leaf_need} B); use depth >= "
                f"{solver_min_depth_for_budget(n, self.budget_bytes, dtype, nrhs=nrhs, leaf_kind=plan.leaf_kind)}"
            )

        stats = OotStats(
            m=n, k=n, n=nrhs if len(arrays) > 1 else n,
            depth=self.depth, scheme=plan.name, op=plan.op,
            leaves=0, waves=0, wave_size=0, prefetch=self.prefetch,
            stage_dtype=_dtype_name(acc_dtype),
            budget_bytes=self.budget_bytes, per_leaf_bytes=leaf_need,
            peak_device_bytes=0,
        )
        # Mutable run state the recursion threads through: the nested
        # multiply counter (distinct chaos seeds), aggregated sub-run
        # stats, and transfer/overlap accounting.
        run = {"mul_calls": 0, "oot_runs": 0, "overlap_num": 0.0, "overlap_den": 0.0}

        root_span = tr.begin(
            f"oot.{plan.op}", cat="oot", op=plan.op, plan=plan.name,
            n=n, nrhs=stats.n, depth=self.depth,
            budget_bytes=self.budget_bytes,
        )
        try:
            result = self._run_node(
                plan, dict(zip(plan.operands, arrays)), self.depth, (),
                tr, mx, stats, run, acc_dtype,
            )
        except BaseException:
            tr.end(root_span, failed=True)
            raise
        result = result[:n, : stats.n].to(dtype)
        stats.total_s = tr.end(root_span).duration
        stats.oot_runs = run["oot_runs"]
        if run["overlap_den"] > 0.0:
            stats.overlap_efficiency = run["overlap_num"] / run["overlap_den"]
        root_span.set(
            overlap_efficiency=stats.overlap_efficiency,
            peak_device_bytes=stats.peak_device_bytes,
            h2d_bytes=stats.h2d_bytes,
            d2h_bytes=stats.d2h_bytes,
            oot_runs=run["oot_runs"],
        )
        _record_run(stats)
        return result, stats

    # ------------------------------------------------------------ internals
    def _run_node(
        self,
        plan: DataflowPlan,
        ops: Dict[str, torch.Tensor],
        depth: int,
        path: Tuple[int, ...],
        tr,
        mx,
        stats: OotStats,
        run: dict,
        acc_dtype,
    ) -> torch.Tensor:
        tag = ",".join(str(d) for d in path)
        if depth == 0:
            return self._leaf(plan, ops, tag, tr, mx, stats, acc_dtype)
        with tr.span(
            "solve.node", cat="oot", op=plan.op, tag=tag, level=len(path)
        ):
            syms: Dict[str, torch.Tensor] = {
                sym: select_part(ops[op_name], sel)
                for sym, (op_name, sel) in plan.divide
            }
            branch = 0
            for step in plan.program:
                if step.kind == "recurse":
                    child = (
                        plan if step.plan is None else get_plan(step.plan)
                    )
                    child_ops = dict(
                        zip(child.operands, (syms[s] for s in step.args))
                    )
                    syms[step.out] = self._run_node(
                        child, child_ops, depth - 1, path + (branch,),
                        tr, mx, stats, run, acc_dtype,
                    )
                    branch += 1
                elif step.kind == "matmul":
                    syms[step.out] = self._mul(
                        syms[step.args[0]], syms[step.args[1]], step.alpha,
                        tr, mx, stats, run, acc_dtype,
                    )
                elif step.kind == "axpy":
                    syms[step.out] = self._axpy(step, syms, acc_dtype)
                else:
                    raise ValueError(
                        f"plan {plan.name!r}: unknown step kind {step.kind!r}"
                    )
            return self._assemble(plan, syms, acc_dtype)

    @staticmethod
    def _axpy(step: Step, syms: Dict[str, torch.Tensor], acc_dtype) -> torch.Tensor:
        # Same accumulation discipline as signed_block_sum: ascending term
        # order, acc dtype throughout, so replays are bit-exact. The
        # accumulator is a fresh tensor, so the in-place adds touch no symbol.
        names = [s for s, _ in step.terms]
        coefs = [c for _, c in step.terms]
        acc = torch.zeros(syms[names[0]].shape, dtype=acc_dtype)
        for s, c in zip(names, coefs):
            if c == 1.0:
                acc += syms[s]
            elif c == -1.0:
                acc -= syms[s]
            elif c != 0.0:
                acc += c * syms[s]
        return acc

    @staticmethod
    def _assemble(
        plan: DataflowPlan,
        syms: Dict[str, torch.Tensor],
        acc_dtype,
    ) -> torch.Tensor:
        sel0, sym0 = plan.combine[0]
        part = syms[sym0]
        if sel0.startswith("q"):
            h, w = part.shape
            out = torch.zeros((2 * h, 2 * w), dtype=acc_dtype)
            for sel, sym in plan.combine:
                q = int(sel[1])
                blk = syms[sym] if sym is not None else 0.0
                out[(q // 2) * h : (q // 2 + 1) * h, (q % 2) * w : (q % 2 + 1) * w] = blk
            return out
        # row halves
        h, w = part.shape
        out = torch.zeros((2 * h, w), dtype=acc_dtype)
        for sel, sym in plan.combine:
            r = int(sel[1])
            out[r * h : (r + 1) * h] = syms[sym] if sym is not None else 0.0
        return out

    def _leaf(
        self, plan, ops, tag, tr, mx, stats: OotStats, acc_dtype
    ) -> torch.Tensor:
        """One dense leaf op on the device, staged in the accumulation dtype."""
        arrays = [ops[name] for name in plan.operands]
        in_bytes = sum(_nbytes(x) for x in arrays)
        with tr.span(
            f"leaf.{plan.leaf_kind}", cat="oot", op=plan.op, tag=tag,
            h2d_bytes=in_bytes,
        ) as lsp:
            devs = [x.to(self.device) for x in arrays]
            with matmul_precision(getattr(self.backend, "precision", None)):
                if plan.leaf_kind == "inv":
                    out = torch.linalg.inv(devs[0])
                elif plan.leaf_kind == "trsm_lower":
                    out = torch.linalg.solve_triangular(devs[0], devs[1], upper=False)
                elif plan.leaf_kind == "trsm_upper":
                    out = torch.linalg.solve_triangular(devs[0], devs[1], upper=True)
                else:
                    raise ValueError(f"unknown leaf kind {plan.leaf_kind!r}")
            host = out.to("cpu").to(acc_dtype)  # a synchronous fetch: the fence
            lsp.set(d2h_bytes=_nbytes(host))
        stats.leaves += 1
        stats.h2d_bytes += in_bytes
        stats.d2h_bytes += _nbytes(host)
        stats.peak_device_bytes = max(
            stats.peak_device_bytes, in_bytes + _nbytes(host)
        )
        mx.counter("oot.h2d_bytes").inc(in_bytes)
        mx.counter("oot.d2h_bytes").inc(_nbytes(host))
        return host

    def _mul(
        self, x: torch.Tensor, y: torch.Tensor, alpha: float,
        tr, mx, stats: OotStats, run: dict, acc_dtype,
    ) -> torch.Tensor:
        """One program multiply: device direct if it fits, else out-of-core."""
        call_idx = run["mul_calls"]
        run["mul_calls"] = call_idx + 1
        need = _nbytes(x) + _nbytes(y) + x.shape[0] * y.shape[1] * x.element_size()
        if need <= self.budget_bytes:
            from repro_torch.core import backend as _backend

            with tr.span(
                "solve.mul", cat="oot", op=self.plan.op, mode="device",
                h2d_bytes=_nbytes(x) + _nbytes(y),
            ):
                out = _backend.matmul(
                    x.to(self.device), y.to(self.device), self.backend, site="blocks.solve",
                )
                host = out.to("cpu").to(acc_dtype)
            stats.h2d_bytes += _nbytes(x) + _nbytes(y)
            stats.d2h_bytes += _nbytes(host)
            stats.peak_device_bytes = max(stats.peak_device_bytes, need)
            mx.counter("oot.h2d_bytes").inc(_nbytes(x) + _nbytes(y))
            mx.counter("oot.d2h_bytes").inc(_nbytes(host))
        else:
            # Out-of-core: the full wave pipeline, with this run's chaos /
            # recovery / degradation policy and a per-call deterministic
            # chaos seed so fault schedules replay.
            chaos = self.chaos
            if chaos is not None:
                chaos = dataclasses.replace(
                    chaos, seed=chaos.seed + 7919 * (call_idx + 1)
                )
            mm_depth = min_depth_for_budget(
                x.shape[0], x.shape[1], y.shape[1], self.budget_bytes,
                x.dtype, pipelined=self.prefetch,
            )
            host, sub = strassen_oot_matmul(
                x, y,
                depth=mm_depth, budget_bytes=self.budget_bytes,
                scheme=self.scheme, backend=self.backend, block=self.block,
                prefetch=self.prefetch, stage_dtype=self.stage_dtype,
                store=self.store, store_root=self.store_root,
                chaos=chaos, recovery=self.recovery, retries=self.retries,
                retry_backoff_s=self.retry_backoff_s, degrade=self.degrade,
                device=self.device,
            )
            host = host.to(acc_dtype)
            self._fold_substats(stats, sub, run)
        if alpha == -1.0:
            host = -host
        elif alpha != 1.0:
            host = alpha * host
        return host

    @staticmethod
    def _fold_substats(stats: OotStats, sub: OotStats, run: dict) -> None:
        """Aggregate a nested out-of-core run into the solver's stats."""
        run["oot_runs"] += 1
        stats.leaves += sub.leaves
        stats.waves += sub.waves
        stats.wave_size = max(stats.wave_size, sub.wave_size)
        stats.h2d_bytes += sub.h2d_bytes
        stats.d2h_bytes += sub.d2h_bytes
        stats.peak_device_bytes = max(
            stats.peak_device_bytes, sub.peak_device_bytes
        )
        stats.host_store_peak_bytes = max(
            stats.host_store_peak_bytes, sub.host_store_peak_bytes
        )
        stats.divide_s += sub.divide_s
        stats.leaf_s += sub.leaf_s
        stats.combine_s += sub.combine_s
        stats.stage_s += sub.stage_s
        stats.fetch_s += sub.fetch_s
        stats.leaf_retries += sub.leaf_retries
        stats.recovered_blocks += sub.recovered_blocks
        stats.lost_blocks += sub.lost_blocks
        stats.corrupt_blocks += sub.corrupt_blocks
        stats.injected_faults += sub.injected_faults
        stats.unrecovered_faults += sub.unrecovered_faults
        stats.degrades += sub.degrades
        stats.degrade_events.extend(sub.degrade_events)
        # Keep the *worst* rung any sub-run completed on.
        order = ["pipeline", "sync", "halved-wave", "deeper"]
        if order.index(sub.rung) > order.index(stats.rung):
            stats.rung = sub.rung
        # Transfer-time-weighted overlap aggregate across sub-runs.
        w = sub.stage_s + sub.fetch_s
        run["overlap_num"] += sub.overlap_efficiency * w
        run["overlap_den"] += w


def spin_inverse_oot(
    a,
    *,
    depth: Optional[int] = None,
    budget_bytes: int,
    scheme: str = "strassen",
    backend=None,
    block: Optional[int] = None,
    prefetch: bool = True,
    stage_dtype=None,
    store: "str | BlockStore" = "dict",
    store_root: Optional[str] = None,
    chaos: Optional[ChaosConfig] = None,
    recovery: Optional[bool] = None,
    retries: int = 2,
    retry_backoff_s: float = 0.05,
    degrade: bool = True,
    device="cuda",
) -> Tuple[torch.Tensor, OotStats]:
    """Block-recursive inverse of a square matrix under a device budget.

    ``depth=None`` picks the smallest depth whose dense leaf inverse fits
    the budget (the nested multiplies size themselves independently).
    The leading principal blocks must be invertible — guaranteed for the
    SPD inputs this path targets (whitening / solver workloads).
    """
    a = as_host_tensor(a)
    if depth is None:
        depth = solver_min_depth_for_budget(
            a.shape[0], budget_bytes, a.dtype, leaf_kind="inv"
        )
    sched = SolveScheduler(
        plan=SPIN_INVERSE, depth=depth, budget_bytes=budget_bytes,
        scheme=scheme, backend=backend, block=block, prefetch=prefetch,
        stage_dtype=stage_dtype, store=store, store_root=store_root,
        chaos=chaos, recovery=recovery, retries=retries,
        retry_backoff_s=retry_backoff_s, degrade=degrade, device=device,
    )
    return sched.run(a)


def triangular_solve_oot(
    l,
    b,
    *,
    lower: bool = True,
    depth: Optional[int] = None,
    budget_bytes: int,
    scheme: str = "strassen",
    backend=None,
    block: Optional[int] = None,
    prefetch: bool = True,
    stage_dtype=None,
    store: "str | BlockStore" = "dict",
    store_root: Optional[str] = None,
    chaos: Optional[ChaosConfig] = None,
    recovery: Optional[bool] = None,
    retries: int = 2,
    retry_backoff_s: float = 0.05,
    degrade: bool = True,
    device="cuda",
) -> Tuple[torch.Tensor, OotStats]:
    """Solve ``T @ X = B`` for triangular ``T`` under a device budget."""
    l = as_host_tensor(l)
    b = as_host_tensor(b)
    plan = TRSM_LOWER if lower else TRSM_UPPER
    if depth is None:
        depth = solver_min_depth_for_budget(
            l.shape[0], budget_bytes, torch.promote_types(l.dtype, b.dtype),
            nrhs=b.shape[1], leaf_kind=plan.leaf_kind,
        )
    sched = SolveScheduler(
        plan=plan, depth=depth, budget_bytes=budget_bytes,
        scheme=scheme, backend=backend, block=block, prefetch=prefetch,
        stage_dtype=stage_dtype, store=store, store_root=store_root,
        chaos=chaos, recovery=recovery, retries=retries,
        retry_backoff_s=retry_backoff_s, degrade=degrade, device=device,
    )
    return sched.run(l, b)
