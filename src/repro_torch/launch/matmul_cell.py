"""Dry-run cells for the paper's own workload, the standalone distributed
matmul: the port of ``repro.launch.matmul_cell``.

Traces naive / Strassen-BFS / Strassen-2D / the explicit 7-way grids on
the production mesh of positions (all on a fake ``cuda:0``, nothing
allocated) with ``launch/op_analysis.py`` and reckons the roofline terms
against one H100 (``launch/roofline.py``): the direct analogue of the
paper's Fig 8/9 at 256 devices. Every strategy is the port's own
``core/distributed.py`` code, or, for naive and bfsrep (which the JAX
package writes here with sharding constraints), the same layouts as
explicit phases on ``core/mesh.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.matmul_cell --n 16384 \\
      --strategies naive bfs_d1 bfs_d2 bfs_d3 2d_d1 --mesh single
"""
from __future__ import annotations

import argparse
import functools
import json
import os

import torch

from repro_torch import obs
from repro_torch.core.coefficients import STRASSEN
from repro_torch.core.distributed import (
    strassen_2d,
    strassen_bfs_sharded,
    strassen_shardmap_2d,
    strassen_shardmap_3d,
)
from repro_torch.core.mesh import P, Sharded, gather, make_mesh, reshard, shard
from repro_torch.core.strassen import combine_level, divide_level
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import OpAnalysis, argument_bytes, fake_mode
from repro_torch.models.sharding import NamedSharding

__all__ = ["strategy_fn", "strategy_mesh", "run_cell", "main"]


def _naive(a, b, mesh):
    """MLLib/Marlin-analogue: classic sharded matmul (8 mults per 2x2). A's
    rows over data, B's columns over model (B arrives row-sharded over data
    and is fetched), C tiled (data, model)."""
    n, m = a.shape[0], b.shape[1]
    a_s = shard(a, mesh, P("data", None))
    b_s = reshard(shard(b, mesh, P(("data",), None)), P(None, "model"))
    out = mesh.map(torch.matmul, a_s.locals, b_s.locals)
    return gather(Sharded(mesh, P("data", "model"), (n, m), out, a.dtype))


def _bfs_replicated(a, b, mesh, depth):
    """CAPS 'unlimited memory' scheme: replicate inputs (n^2 fits easily),
    run all divide levels locally (zero comm), shard the 7^depth leaf batch
    over the WHOLE mesh, all-gather the products and combine locally."""
    scheme = STRASSEN
    axes = tuple(ax for ax in ("pod", "data", "model") if ax in mesh.shape)
    batch = P(axes, None, None)

    def divide(x, coef):
        t = x[None]
        for _ in range(depth):
            t = divide_level(t, coef)
        return t

    def combine(prod):
        for _ in range(depth):
            prod = combine_level(prod, scheme.c_coef)
        return prod[0]

    ta = mesh.map(lambda x: divide(x, scheme.a_coef), shard(a, mesh, P()).locals)
    tb = mesh.map(lambda x: divide(x, scheme.b_coef), shard(b, mesh, P()).locals)
    first = next(iter(mesh.positions()))
    la = reshard(Sharded(mesh, P(), tuple(ta[first].shape), ta, a.dtype), batch)
    lb = reshard(Sharded(mesh, P(), tuple(tb[first].shape), tb, b.dtype), batch)
    prod = mesh.all_gather(mesh.map(torch.bmm, la.locals, lb.locals), axes)
    out = mesh.map(combine, prod)
    shape = (a.shape[0], b.shape[1])
    return gather(reshard(Sharded(mesh, P(), shape, out, a.dtype), P("data", "model")))


def _fit(limit: int, n: int) -> int:
    """The largest divisor of n / 2 (a quadrant's side) not above ``limit``."""
    return max(d for d in range(1, limit + 1) if (n // 2) % d == 0)


def strategy_mesh(name: str, mesh, n: int):
    """The mesh a strategy runs on at size ``n``: the explicit 7-way grids
    take rows x 7 (shardmap1) or side x side x 7 (shardmap3d) of the mesh's
    positions, as many rows (sides) as divide a quadrant, which the port's
    strategies cut into whole blocks. The reference takes 36 rows and a
    6 x 6 grid of 256 devices, which do not divide n = 16384's 8192-row
    quadrants; the port takes 32 rows and 4 x 4 there."""
    n_pos = mesh.size
    if name == "shardmap1":
        return make_mesh((_fit(n_pos // 7, n), 7), ("rows", "mult"), device=mesh.device)
    if name == "shardmap3d":
        side = _fit(int((n_pos // 7) ** 0.5), n)
        return make_mesh((side, side, 7), ("rb", "cb", "mult"), device=mesh.device)
    return mesh


def strategy_fn(name: str, mesh):
    if name == "naive":
        return functools.partial(_naive, mesh=mesh)
    if name == "shardmap1":
        return functools.partial(strassen_shardmap_2d, mesh=mesh)
    if name == "shardmap3d":
        # block (quadrant) output layout: the paper's Block data structure
        return functools.partial(strassen_shardmap_3d, mesh=mesh, merge=False)
    kind, _, d = name.partition("_d")
    depth = int(d)
    if kind == "bfs":
        return functools.partial(strassen_bfs_sharded, mesh=mesh, depth=depth)
    if kind == "bfsrep":
        return functools.partial(_bfs_replicated, mesh=mesh, depth=depth)
    if kind == "2d":
        return functools.partial(strassen_2d, mesh=mesh, depth=depth)
    raise ValueError(name)


def run_cell(n: int, strategy: str, mesh_kind: str, dtype=torch.bfloat16):
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device=dryrun.DEVICE)
    mesh = strategy_mesh(strategy, mesh, n)
    chips = mesh.size
    fn = strategy_fn(strategy, mesh)
    with fake_mode():
        a = torch.empty((n, n), dtype=dtype, device=mesh.device)
        b = torch.empty((n, n), dtype=dtype, device=mesh.device)
    # the inputs' layout: replicated on the explicit grids, else rows over data
    spec = P() if strategy in ("shardmap1", "shardmap3d") else P(("data",), None)
    args = argument_bytes({"a": a, "b": b}, {k: NamedSharding(mesh, spec) for k in "ab"})
    span = obs.get_tracer().begin(
        "matmul_cell.trace", cat="launch", n=n, strategy=strategy, mesh=mesh_kind
    )
    with OpAnalysis(chips=chips) as analysis:
        fn(a, b)
    obs.get_tracer().end(span)
    costs = analysis.costs()
    terms = costs.roofline()
    ideal = 2.0 * n**3 / chips  # useful flops per device
    coll = costs.collectives()
    result = {
        "workload": "paper_matmul",
        "n": n,
        "strategy": strategy,
        "mesh": mesh_kind,
        "chips": chips,
        "trace_seconds": round(span.duration, 1),
        "roofline": terms,
        "flops_per_device": costs.dot_flops,
        "flops_by_dtype": costs.flops_by_dtype,
        "useful_fraction": ideal / costs.dot_flops if costs.dot_flops else None,
        "collectives_by_kind": {k: v for k, v in coll.items() if k != "total"},
        "collective_bytes": coll["total"],
        "hbm_bytes": costs.hbm_bytes,
        "launches": costs.launches,
        "memory": {
            "argument_size_in_bytes": args,
            "temp_size_in_bytes": int(costs.temp_bytes),
        },
    }
    os.makedirs(dryrun.OUT_DIR, exist_ok=True)
    path = os.path.join(dryrun.OUT_DIR, f"matmul__n{n}__{strategy}__{mesh_kind}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument(
        "--strategies", nargs="+",
        default=["naive", "bfs_d1", "bfs_d2", "bfs_d3", "2d_d1", "2d_d2"],
    )
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    args = ap.parse_args(argv)
    base = None
    for s in args.strategies:
        r = run_cell(args.n, s, args.mesh)
        t = r["roofline"]
        if s == "naive":
            base = t
        rel = f"  bound vs naive {t['bound_s'] / base['bound_s']:.3f}x" if base else ""
        print(
            f"{s:8s} compute {t['compute_s']:.3e}  memory {t['memory_s']:.3e}  "
            f"collective {t['collective_s']:.3e} -> {t['bottleneck']}{rel}  "
            f"(useful {r['useful_fraction']:.2f}, traced in {r['trace_seconds']} s)"
        )


if __name__ == "__main__":
    main()
