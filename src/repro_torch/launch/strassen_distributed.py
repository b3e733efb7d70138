"""Distributed Strassen on a mesh of positions (the paper's cluster demo).

The port of ``examples/strassen_distributed.py``: builds a (4 data x 2
model) mesh and a 7-way ``mult`` mesh of positions on ``--device`` and runs

  * strassen_bfs_sharded (depth 2): Stark/CAPS BFS leaf-batch sharding
  * strassen_2d (depth 1): Luo & Drake Strassen-2D (2D-parallel leaves)
  * strassen_shardmap: the explicit-collective 7-way level

on ``--n`` x ``--n`` fp32 operands from ``--seed``. For each it prints
max|err| against ``torch.matmul`` and the mesh's logical collective bytes
(what a cluster of that many devices would move) beside its physical bytes
(copied between distinct cards; 0 on one card, whose positions all share
it).

Usage:
  python -m repro_torch.launch.strassen_distributed --device cpu
  python -m repro_torch.launch.strassen_distributed --n 4096

Without a GPU it exits non-zero unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core.distributed import strassen_2d, strassen_bfs_sharded, strassen_shardmap
from repro_torch.core.mesh import make_mesh
from repro_torch.core.precision import matmul_precision


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=512, help="N of the N x N operands")
    ap.add_argument("--seed", type=int, default=1)
    return ap


def run_strategies(n: int, seed: int, device: torch.device) -> list:
    """The three strategies on n x n fp32 operands from ``seed``: for each
    (name, max|err| against ``torch.matmul``, max|want|, the mesh's traffic
    {(movement, axes): Traffic} of that run)."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32)).to(device)
    b = torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32)).to(device)
    with matmul_precision(None):
        want = torch.matmul(a, b)

    mesh = make_mesh((4, 2), ("data", "model"), device=device)
    mesh7 = make_mesh((7,), ("mult",), device=device)
    print(f"positions: {mesh.size} on {mesh.physical_count()} device(s), "
          f"{mesh7.size} on {mesh7.physical_count()}")
    runs = [
        ("bfs_sharded", mesh, lambda: strassen_bfs_sharded(a, b, mesh=mesh, depth=2)),
        ("strassen_2d", mesh, lambda: strassen_2d(a, b, mesh=mesh, depth=1)),
        ("shardmap(7)", mesh7, lambda: strassen_shardmap(a, b, mesh=mesh7)),
    ]
    out = []
    for name, m, run in runs:
        m.reset()
        got = run()
        out.append((name, (got - want).abs().max().item(), want.abs().max().item(), dict(m.traffic)))
        m.reset()
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("repro_torch.launch.strassen_distributed: no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 2
    for name, err, _, traffic in run_strategies(args.n, args.seed, device):
        logical = sum(t.logical_bytes for t in traffic.values())
        physical = sum(t.physical_bytes for t in traffic.values())
        count = sum(t.count for t in traffic.values())
        print(f"{name:<13} max|err| = {err:.3e}  collective bytes: logical "
              f"{logical}, physical {physical} ({count} movements)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
