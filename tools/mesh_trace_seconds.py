#!/usr/bin/env python3
"""Host seconds to trace one sharded decode step on fake tensors.

Usage, from the root of a checkout (no GPU needed)::

    PYTHONPATH=src python3 tools/mesh_trace_seconds.py [--arch whisper_tiny] [--reps 2]

Runs ``models.model.apply_decode`` of the full ``--arch`` config at
decode_32k (batch 128, a 32768-token cache) once per rep on
``FakeTensorMode`` tensors on the CPU, under ``models.sharding.use_sharding``
of the 16 x 16 production mesh of positions, with no analysis: what the
mesh's own bookkeeping (slab layouts, fetches, per-position phases) costs a
trace. It uses only modules that predate the dry-run, so it runs on older
checkouts too and compares them on one host. Prints each rep's seconds.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.sharding import use_sharding


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="whisper_tiny")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    cfg, shape = get_config(args.arch), SHAPES["decode_32k"]
    mesh = make_production_mesh(device="cpu")
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = M.init_params(cfg, torch.Generator().manual_seed(0))
        cache = M.init_cache(cfg, shape.global_batch, shape.seq_len, device="cpu")
        tokens = torch.zeros((shape.global_batch, 1), dtype=torch.long)
        for rep in range(args.reps):
            t0 = time.perf_counter()
            with use_sharding(mesh):
                M.apply_decode(params, tokens, cache, cfg)
            print(f"{args.arch} decode_32k on {dict(mesh.shape)} positions, rep {rep}: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
