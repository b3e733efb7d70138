"""Out-of-core Strassen demo: multiply matrices bigger than the device budget.

The port of ``repro.launch.blocks_demo``, with its flags plus ``--device``
(default ``cuda``). Drives :mod:`repro_torch.blocks` end to end — ingest
dense operands into a host block store (dict / RAM arena / npy memmap
spill), walk the tagged recursion tree level by level, stage the 7^depth
leaf products through device memory in budgeted async-pipelined waves, and
verify the result against the dense matmul on the device.

Usage:
  python -m repro_torch.launch.blocks_demo --n 16384 --budget-mb 1024 \\
      --leaf-backend strassen_fused --check
  python -m repro_torch.launch.blocks_demo --device cpu --n 1024 \\
      --budget-mb 1 --depth 3 --store memmap --check
  python -m repro_torch.launch.blocks_demo --device cpu --m 2048 --k 1024 \\
      --n 1536 --budget-mb 2 --dtype bfloat16 --store arena

``--depth 0`` picks the shallowest depth whose leaf fits the budget.
Prints the scheduler's execution stats: staging waves, H2D/D2H bytes,
peak device bytes vs the budget, host store peak, and per-phase seconds.
Without a GPU it exits non-zero unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch import obs
from repro_torch.blocks.plan import BilinearPlan, get_plan, plan_names
from repro_torch.blocks.recovery import ChaosConfig
from repro_torch.blocks.scheduler import min_depth_for_budget, strassen_oot_matmul
from repro_torch.core.backend import VALID_KINDS, MatmulBackend
from repro_torch.core.precision import matmul_precision
from repro_torch.obs import export


def chaos_config(fault_rate: float, seed: int):
    """The launchers' ``--fault-rate`` mix: drops at the rate, corruption and
    leaf failures at proportional rates; None when the rate is 0."""
    if fault_rate <= 0:
        return None
    chaos = ChaosConfig(
        drop=fault_rate, corrupt=fault_rate * 0.4, leaf_fail_rate=fault_rate * 0.5, seed=seed,
    )
    print(
        f"chaos: drop {chaos.drop:.3f} / corrupt {chaos.corrupt:.3f} / "
        f"leaf-fail {chaos.leaf_fail_rate:.3f} (seed {chaos.seed}) — "
        "lineage recovery on"
    )
    return chaos


def print_faults(stats) -> None:
    print(
        f"faults: {stats.injected_faults} injected "
        f"({stats.lost_blocks} lost, {stats.corrupt_blocks} corrupt) | "
        f"{stats.recovered_blocks} recomputed from lineage, "
        f"{stats.leaf_retries} leaf retries, "
        f"{stats.unrecovered_faults} unrecovered | "
        f"rung {stats.rung} ({stats.degrades} degrades)"
    )


def device_or_exit(name: str, prog: str):
    """The run's device; None (after saying why) when CUDA is asked for and absent."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return None
    return device


def build_parser() -> argparse.ArgumentParser:
    # Scheme choices come from the plan registry, so a newly registered
    # bilinear plan is immediately drivable from this CLI.
    schemes = [n for n in plan_names() if isinstance(get_plan(n), BilinearPlan)]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024, help="matrix side (square)")
    ap.add_argument("--m", type=int, default=0, help="rows of A (default --n)")
    ap.add_argument("--k", type=int, default=0, help="cols of A (default --n)")
    ap.add_argument("--depth", type=int, default=0,
                    help="recursion depth; 0 = shallowest that fits the budget")
    ap.add_argument("--budget-mb", type=float, default=64.0,
                    help="peak device bytes the leaf waves may occupy")
    ap.add_argument("--block", type=int, default=0,
                    help="store block side; 0 = one block per leaf")
    ap.add_argument("--store", choices=["dict", "arena", "memmap"], default="dict")
    ap.add_argument("--store-root", default=None,
                    help="spill directory for --store memmap")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--scheme", choices=schemes, default="strassen")
    ap.add_argument("--leaf-backend", choices=list(VALID_KINDS), default="auto",
                    help="matmul routing kind for the leaf waves")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable the async 2-deep staging pipeline")
    ap.add_argument("--check", action="store_true",
                    help="verify against the dense torch.matmul on the device")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="chaos injection: per-get block drop probability "
                    "(corruption and leaf failures are injected at "
                    "proportional rates); recovery recomputes from lineage")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for the deterministic chaos harness")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None, help="write stats JSON here")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace of the run here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = device_or_exit(args.device, "repro_torch.launch.blocks_demo")
    if device is None:
        return 2
    if args.trace_out:
        obs.configure(enabled=True)

    m = args.m or args.n
    k = args.k or args.n
    n = args.n
    budget = int(args.budget_mb * 2**20)
    dtype = getattr(torch, args.dtype)
    depth = args.depth or min_depth_for_budget(
        m, k, n, budget, dtype, pipelined=not args.no_prefetch
    )

    rng = np.random.default_rng(args.seed)
    a = torch.from_numpy(rng.standard_normal((m, k))).to(dtype)
    b = torch.from_numpy(rng.standard_normal((k, n))).to(dtype)
    op_bytes = max(t.numel() * t.element_size() for t in (a, b))
    print(
        f"A {tuple(a.shape)} @ B {tuple(b.shape)} {args.dtype} on {device}: operands "
        f"{op_bytes / 2**20:.1f} MiB each, device budget "
        f"{budget / 2**20:.1f} MiB "
        f"({'smaller than an operand — out-of-core' if budget < op_bytes else 'fits'}), "
        f"depth {depth} -> {7**depth} leaves",
        flush=True,
    )
    chaos = chaos_config(args.fault_rate, args.chaos_seed)

    backend = MatmulBackend(kind=args.leaf_backend, depth=2)
    out, stats = strassen_oot_matmul(
        a, b,
        depth=depth, budget_bytes=budget, scheme=args.scheme, backend=backend,
        block=args.block or None, prefetch=not args.no_prefetch,
        store=args.store, store_root=args.store_root,
        chaos=chaos, device=device,
    )

    print(
        f"done in {stats.total_s:.2f}s  "
        f"(divide {stats.divide_s:.2f}s, leaf {stats.leaf_s:.2f}s "
        f"[{stats.waves} waves x {stats.wave_size}], combine {stats.combine_s:.2f}s)"
    )
    print(
        f"pipeline: {'async 2-deep' if stats.prefetch else 'synchronous'} | "
        f"stage {stats.stage_s:.2f}s, fetch {stats.fetch_s:.2f}s, "
        f"overlap efficiency {stats.overlap_efficiency:.2f}"
    )
    print(
        f"device: peak {stats.peak_device_bytes / 2**20:.2f} / "
        f"{stats.budget_bytes / 2**20:.2f} MiB budget | staged "
        f"H2D {stats.h2d_bytes / 2**20:.1f} MiB, D2H {stats.d2h_bytes / 2**20:.1f} MiB "
        f"({stats.stage_dtype} staging)"
    )
    print(f"host store peak: {stats.host_store_peak_bytes / 2**20:.1f} MiB ({args.store})")
    if chaos is not None:
        print_faults(stats)

    if args.check:
        with matmul_precision(None):
            want = torch.matmul(a.to(device), b.to(device)).float().cpu()
        scale = float(want.abs().max()) or 1.0
        err = float((out.float() - want).abs().max()) / scale
        tol = 1e-2 if dtype.itemsize < 4 else 2e-3
        print(f"parity vs dense: rel err {err:.2e} ({'OK' if err < tol else 'FAIL'})")
        if err >= tol:
            return 1

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(stats.to_dict(), f, indent=1)
        print(f"wrote {args.json_out}")

    if args.trace_out:
        export.write_trace(args.trace_out, metrics=obs.get_metrics())
        print(f"wrote {args.trace_out} ({len(obs.get_tracer().spans)} spans)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
