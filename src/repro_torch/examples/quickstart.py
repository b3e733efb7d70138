"""Quickstart: the paper's algorithm in a few lines, then the full menu.

The port of ``examples/quickstart.py``: four routes to the product of two
1024 x 1024 fp32 operands from seed 0, each held to max|err| < 2e-2
against ``torch.matmul`` (TF32 off):

  1. the paper's Algorithm 1, the serial recursion with a BLAS leaf;
  2. Stark's flattened form: 2 BFS levels, 49 leaf products in one batched stage;
  3. a framework feature: any model matmul routed through ``MatmulBackend``;
  4. the Winograd variant (7 products, 15 additions).

Run: ``python -m repro_torch.examples.quickstart [--device cpu]``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core.backend import MatmulBackend, matmul
from repro_torch.core.precision import matmul_precision
from repro_torch.core.strassen import strassen_matmul, strassen_recursive

LIMIT = 2e-2


def routes(n: int, device) -> dict:
    """{route: max|err|} of the four routes on n x n operands from seed 0."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32)).to(device)
    b = torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32)).to(device)
    got = {
        "serial": strassen_recursive(a, b, threshold=128),
        "bfs": strassen_matmul(a, b, depth=2),
        "backend": matmul(a, b, MatmulBackend(kind="strassen", depth=2, min_dim=512)),
        "winograd": strassen_matmul(a, b, depth=2, scheme="winograd"),
    }
    with matmul_precision(None):
        want = a @ b
    return {name: (c - want).abs().max().item() for name, c in got.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=1024, help="N of the N x N operands")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("repro_torch.examples.quickstart: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    errs = routes(args.n, torch.device(args.device))
    for name, err in errs.items():
        print(f"{name:9s} max|err| = {err:.3e}")
    bad = [name for name, err in errs.items() if not err < LIMIT]
    if bad:
        print(f"quickstart: max|err| of {bad} not below {LIMIT}", file=sys.stderr)
        return 1
    print("quickstart OK: see repro_torch.examples.strassen_distributed for the sharded version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
