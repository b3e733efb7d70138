"""Distributed Strassen on a mesh of positions (the paper's cluster demo).

The port of ``examples/strassen_distributed.py``, over
:func:`repro_torch.launch.strassen_distributed.run_strategies`: a (4 data x 2
model) mesh and a 7-way ``mult`` mesh of positions on ``--device``, and the
three strategies on N x N fp32 operands (N = 512 from seed 1, as the JAX
example):

  * strassen_bfs_sharded (depth 2): Stark/CAPS BFS leaf-batch sharding
  * strassen_2d (depth 1): Luo & Drake Strassen-2D (2D-parallel leaves)
  * strassen_shardmap: the explicit-collective 7-way level

For each it prints max|err| against ``torch.matmul``, which must stay
within 1e-4 of max|torch.matmul| (fp32, TF32 off), and the collective
footprint from ``mesh.traffic``: each kind of movement over its axes, its
count and logical bytes (what a cluster of that many devices would move; the
JAX example reads the HLO's collective bytes) beside the physical bytes
copied between distinct cards (0 on one card, whose positions all share it).

Run: ``python -m repro_torch.examples.strassen_distributed [--device cpu] [--n N]``.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.launch.strassen_distributed import build_parser, run_strategies


LIMIT = 1e-4


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("repro_torch.examples.strassen_distributed: no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 2
    bad = []
    for name, err, peak, traffic in run_strategies(args.n, args.seed, torch.device(args.device)):
        print(f"{name:<13} max|err| = {err:.3e}")
        if not err <= LIMIT * peak:
            bad.append(name)
        for (op, axes), t in sorted(traffic.items()):
            print(f"  {op:<13} over {','.join(axes) or '-':<12} {t.count:3d} x: logical "
                  f"{t.logical_bytes} bytes, physical {t.physical_bytes}")
        print(f"  collective bytes ({name}): logical {sum(t.logical_bytes for t in traffic.values())}")
    if bad:
        print(f"strassen_distributed: max|err| of {bad} above {LIMIT} x max|torch.matmul|", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
