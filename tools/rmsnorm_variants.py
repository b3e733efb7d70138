#!/usr/bin/env python3
"""A/B timing of design variants of the RMSNorm kernel on one GPU.

Usage, from the root of a checkout on a machine with a Hopper GPU and nvcc::

    python3 tools/rmsnorm_variants.py [--reps R]

Builds ``src/repro_torch/csrc/rmsnorm.cu`` and each variant in ``VARIANTS``
(a few lines replaced) into libraries under ``build/rmsnorm_variants/``, one
``nvcc`` each, all started together, checks each against the plain version,
and times them with CUDA events in turns (shipped, variants, variants
reversed, shipped) beside ``F.rms_norm``, in bf16 with w in fp32: at the
serving models' prefill rows (1024 of 3072, 2048 and 8192) with x in L2 (the
same x each call) and cold (x and out rotating past the 50 MB L2, as
``chip_smoke.py`` times them), and at a decode step's 4 rows. Exits non-zero
if a build or a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

from chip_smoke import cold_inputs, rotating  # noqa: E402
from matmul_variants import compile_all, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "rmsnorm_variants"

# name -> (what it changes, [(shipped text, replacement)])
VARIANTS = {
    "warp_rows": ("a warp a row up to 16 vectors a lane (4096 bf16)", [
        ("constexpr int MAXV = 4; ", "constexpr int MAXV = 16;"),
    ]),
    "maxv_8": ("up to 8 vectors a thread (64 threads a row at 3072 bf16)", [
        ("constexpr int MAXV = 4; ", "constexpr int MAXV = 8; "),
    ]),
    "maxv_2": ("up to 2 vectors a thread (256 threads a row at 3072 bf16)", [
        ("constexpr int MAXV = 4; ", "constexpr int MAXV = 2; "),
    ]),
}
SHAPES = [(1024, 3072), (1024, 2048), (1024, 8192), (4, 3072)]


def variant_source(name: str) -> str:
    text = (CSRC / "rmsnorm.cu").read_text()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: the shipped rmsnorm.cu no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    return text


def run(lib: ctypes.CDLL, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    err = lib.repro_rmsnorm(x.data_ptr(), w.data_ptr(), out.data_ptr(), _build.dtype_code(x),
                            _build.dtype_code(w), *x.shape, 1e-6, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"repro_rmsnorm: CUDA error {err}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=9)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("rmsnorm_variants: no CUDA device", file=sys.stderr)
        return 2
    names = ["shipped", *VARIANTS]
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {"shipped": (CSRC / "rmsnorm.cu", OUT / "shipped.so")}
    for name in names[1:]:
        src = OUT / f"{name}.cu"
        src.write_text(variant_source(name))
        jobs[name] = (src, OUT / f"{name}.so")
    for name, log in compile_all(jobs, shared=True).items():
        spills = [line.strip() for line in log.splitlines() if "spill stores" in line and " 0 bytes spill" not in line]
        print(f"ptxas {name}: {len(spills)} instances spill {spills[:2]}")
    libs = {}
    for name in names:
        lib = ctypes.CDLL(str(jobs[name][1]))
        lib.repro_rmsnorm.argtypes = _build._SIGNATURES["repro_rmsnorm"]
        lib.repro_rmsnorm.restype = ctypes.c_int
        libs[name] = lib

    gen = np.random.default_rng(0)
    failed = 0
    print(f"card: {torch.cuda.get_device_name(0)}; " + ", ".join(f"{n}: {VARIANTS[n][0]}" for n in names[1:]))
    for rows, d in SHAPES:
        w = torch.from_numpy(1.0 + gen.standard_normal(d, dtype=np.float32)).cuda()
        w16 = w.bfloat16()
        xs = cold_inputs(gen, (rows, d), torch.bfloat16) if rows > 4 else []
        x = torch.from_numpy(gen.standard_normal((rows, d), dtype=np.float32)).cuda().bfloat16()
        want = rmsnorm_ref(x, w).float()
        limit = 2**-7 * (want.abs() + want.square().mean().sqrt())
        for name in names:
            if not bool(((run(libs[name], x, w).float() - want).abs() <= limit).all()):
                failed += 1
                print(f"FAIL {name} {(rows, d)}: an element exceeds 2^-7 x (|plain| + rms(plain))")
        cases = [("warm", {n: (lambda n=n: run(libs[n], x, w)) for n in names},
                  lambda: torch.nn.functional.rms_norm(x, (d,), w16, 1e-6))]
        if xs:
            cases.append(("cold", {n: rotating(lambda xi, n=n: run(libs[n], xi, w), xs) for n in names},
                          rotating(lambda xi: torch.nn.functional.rms_norm(xi, (d,), w16, 1e-6), xs)))
        for tag, fns, lib_fn in cases:
            times = {name: [] for name in names}
            for name in names + names[::-1]:
                times[name].append(time_ms(fns[name], args.reps))
            cells = ", ".join(f"{n} {' / '.join(f'{t:.4f}' for t in ts)}" for n, ts in times.items())
            print(f"time bf16 {(rows, d)} {tag} ms: {cells}; F.rms_norm {time_ms(lib_fn, args.reps):.4f}",
                  flush=True)
        del xs
    print(f"checks: {failed} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
