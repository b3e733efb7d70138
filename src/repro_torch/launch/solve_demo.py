"""Out-of-core SPIN solver demo: invert / triangular-solve under a budget.

The port of ``repro.launch.solve_demo``, with its flags plus ``--device``
(default ``cuda``). Drives :mod:`repro_torch.blocks.solve` end to end —
build a well-conditioned SPD (or triangular) input, walk the SPIN
block-recursive dataflow plan, run the dense leaves on the device, and route
every recursive multiply back through the tagged out-of-core scheduler
whenever its working set exceeds the device budget. Verifies against
``torch.linalg.inv`` / ``torch.linalg.solve_triangular`` on the device.

Usage:
  python -m repro_torch.launch.solve_demo --n 8192 --budget-mb 128 --check
  python -m repro_torch.launch.solve_demo --device cpu --n 1024 \\
      --budget-mb 1 --op inverse --store memmap --check
  python -m repro_torch.launch.solve_demo --device cpu --n 2048 --op trsm \\
      --nrhs 512 --budget-mb 2 --dtype bfloat16 --check

``--depth 0`` picks the shallowest depth whose dense leaf fits the
budget. Prints the solver's execution stats: nested out-of-core matmul
runs, staging waves, H2D/D2H bytes, peak device bytes vs the budget, and
(with ``--fault-rate``) the chaos/recovery tallies. Without a GPU it exits
non-zero unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch import obs
from repro_torch.blocks.solve import (
    solver_min_depth_for_budget,
    spin_inverse_oot,
    triangular_solve_oot,
)
from repro_torch.core.precision import matmul_precision
from repro_torch.launch.blocks_demo import chaos_config, device_or_exit, print_faults
from repro_torch.obs import export


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024, help="matrix side (square)")
    ap.add_argument("--op", choices=["inverse", "trsm"], default="inverse")
    ap.add_argument("--nrhs", type=int, default=0,
                    help="RHS columns for --op trsm (default --n)")
    ap.add_argument("--upper", action="store_true",
                    help="solve an upper-triangular system (--op trsm)")
    ap.add_argument("--depth", type=int, default=0,
                    help="solver recursion depth; 0 = shallowest whose "
                    "dense leaf fits the budget")
    ap.add_argument("--budget-mb", type=float, default=64.0,
                    help="peak device bytes any wave may occupy")
    ap.add_argument("--store", choices=["dict", "arena", "memmap"], default="dict")
    ap.add_argument("--store-root", default=None,
                    help="spill directory for --store memmap")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--scheme", choices=["strassen", "winograd"], default="strassen",
                    help="matmul scheme for the nested out-of-core multiplies")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable the async staging pipeline in nested multiplies")
    ap.add_argument("--check", action="store_true",
                    help="verify against the dense device solver")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="chaos injection: per-get block drop probability in "
                    "the nested out-of-core multiplies (corruption and leaf "
                    "failures at proportional rates); lineage recovery heals")
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
    device = device_or_exit(args.device, "repro_torch.launch.solve_demo")
    if device is None:
        return 2
    if args.trace_out:
        obs.configure(enabled=True)

    n = args.n
    nrhs = (args.nrhs or n) if args.op == "trsm" else n
    budget = int(args.budget_mb * 2**20)
    dtype = getattr(torch, args.dtype)
    leaf_kind = "inv" if args.op == "inverse" else (
        "trsm_upper" if args.upper else "trsm_lower"
    )
    depth = args.depth or solver_min_depth_for_budget(
        n, budget, torch.float32,
        nrhs=nrhs if args.op == "trsm" else None, leaf_kind=leaf_kind,
    )

    rng = np.random.default_rng(args.seed)
    g = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    eye = torch.eye(n, dtype=torch.float32)
    if args.op == "inverse":
        # Well-conditioned SPD: every leading principal block invertible,
        # which the SPIN recursion requires.
        a = (g @ g.T / n + eye * 2.0).to(dtype)
        operands = (a,)
    else:
        t = torch.triu(g) if args.upper else torch.tril(g)
        t = (t / np.sqrt(n) + eye * 2.0).to(dtype)
        b = torch.from_numpy(rng.standard_normal((n, nrhs))).to(dtype)
        operands = (t, b)
    op_bytes = max(x.numel() * x.element_size() for x in operands)
    print(
        f"{args.op} {n}x{n}" + (f" rhs {n}x{nrhs}" if args.op == "trsm" else "")
        + f" {args.dtype} on {device}: largest operand {op_bytes / 2**20:.1f} MiB, "
        f"device budget {budget / 2**20:.1f} MiB "
        f"({'smaller than an operand — out-of-core' if budget < op_bytes else 'fits'}), "
        f"solver depth {depth}",
        flush=True,
    )
    chaos = chaos_config(args.fault_rate, args.chaos_seed)

    common = dict(
        depth=depth, budget_bytes=budget, scheme=args.scheme,
        prefetch=not args.no_prefetch, store=args.store,
        store_root=args.store_root, chaos=chaos, device=device,
    )
    if args.op == "inverse":
        out, stats = spin_inverse_oot(operands[0], **common)
    else:
        out, stats = triangular_solve_oot(
            operands[0], operands[1], lower=not args.upper, **common
        )

    print(
        f"done in {stats.total_s:.2f}s  "
        f"({stats.oot_runs} nested out-of-core multiplies, "
        f"{stats.leaves} matmul leaves in {stats.waves} waves; "
        f"leaf {stats.leaf_s:.2f}s)"
    )
    print(
        f"device: peak {stats.peak_device_bytes / 2**20:.2f} / "
        f"{stats.budget_bytes / 2**20:.2f} MiB budget | staged "
        f"H2D {stats.h2d_bytes / 2**20:.1f} MiB, D2H {stats.d2h_bytes / 2**20:.1f} MiB "
        f"({stats.stage_dtype} staging) | overlap efficiency "
        f"{stats.overlap_efficiency:.2f}"
    )
    if chaos is not None:
        print_faults(stats)

    if args.check:
        devs = [x.to(device) for x in operands]
        with matmul_precision(None):
            if args.op == "inverse":
                want = torch.linalg.inv(devs[0].float())
            else:
                want = torch.linalg.solve_triangular(
                    devs[0].float(), devs[1].float(), upper=args.upper
                )
        want = want.to(dtype).float().cpu()
        scale = float(want.abs().max()) or 1.0
        err = float((out.float() - want).abs().max()) / scale
        tol = 1e-2 if dtype.itemsize < 4 else 1e-5
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
