#!/usr/bin/env python3
"""A/B timing of variants of the divide/combine (signed-sum) kernel on one GPU.

Usage, from the root of a checkout on a machine with a Hopper GPU and nvcc::

    python3 tools/signed_sum_variants.py [--reps R]

Builds ``src/repro_torch/csrc/signed_sum.cu`` and each variant in
``VARIANTS`` (a few lines replaced) into libraries under
``build/signed_sum_variants/``, one ``nvcc`` each, all started together,
checks each bit for bit against the sums it computes, and times them with
CUDA events in turns (shipped, variants, variants reversed, shipped) at the
staged pipeline's first level, 16384^2 operands: divide (1, 4, 8192, 8192)
and combine (1, 7, 8192, 8192), for the Strassen and Winograd coefficients,
in fp32 and bf16, beside the HBM bound (each input read once, each output
written once, at 3.35 TB/s). ``float_per_add`` runs bf16 through the fp32
path with the same per-add rounding as the shipped packed path, and
``round_once`` with the arithmetic the kernel had before it rounded each bf16
add as the reference does: they show what the rounding costs in each form.
Exits non-zero if a build or a check fails.
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

from matmul_variants import compile_all, time_ms  # noqa: E402
from repro_torch.core.coefficients import get_scheme  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.strassen.ref import signed_sum_ref  # noqa: E402
from repro_torch.kernels.strassen.strassen import _floats  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "signed_sum_variants"
PEAK_BYTES = 3.35e12

# The shipped source sends 16-byte bf16 chunks to the packed bf16x2 kernel;
# the variants send them to the fp32 path, 16 bytes a thread, instead.
_NO_PACKED = (
    "      const int64_t nvec = plane / 8;\n"
    "      signed_sum_bf16x2_kernel<<<grid_for(m * nvec), THREADS, 0, s>>>(\n"
    "          static_cast<const uint4*>(x), static_cast<uint4*>(out), m, q, p, nvec, c);\n",
    "      launch<__nv_bfloat16, 8>(x, out, m, q, p, plane, c, s);\n")
# name -> (what it changes, [(shipped text, replacement)])
VARIANTS = {
    "float_per_add": ("bf16 unpacked to fp32, each add rounded to bf16 (the same results)",
                      [_NO_PACKED]),
    "round_once": ("bf16 unpacked to fp32, summed and rounded once (the arithmetic before the "
                   "reference's per-add rounding)", [
        _NO_PACKED,
        ("            const float term = round_to<T>(__fmul_rn(cf, in[qi][v]));\n"
         "            acc = any ? round_to<T>(__fadd_rn(acc, term)) : term;\n",
         "            const float term = __fmul_rn(cf, in[qi][v]);\n"
         "            acc = any ? __fadd_rn(acc, term) : term;\n"),
    ]),
}
CHECK_SHAPES = [(1, 64, 64), (3, 5, 7), (2, 16, 24)]
TIME_PLANE = (8192, 8192)


def variant_source(name: str) -> str:
    text = (CSRC / "signed_sum.cu").read_text()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: the shipped signed_sum.cu no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    return text


def expected(name: str, x: torch.Tensor, coef: np.ndarray) -> torch.Tensor:
    """What variant ``name`` computes: the plain version, or for round_once
    the fp32 sums of the same terms rounded once."""
    if name == "round_once":
        return signed_sum_ref(x.float(), coef).to(x.dtype)
    return signed_sum_ref(x, coef).to(x.dtype)


def run(lib: ctypes.CDLL, x: torch.Tensor, coef: np.ndarray) -> torch.Tensor:
    m, q, h, w = x.shape
    out = torch.empty((m, coef.shape[0], h, w), dtype=x.dtype, device=x.device)
    c = _floats(coef)
    err = lib.repro_signed_sum(x.data_ptr(), out.data_ptr(), _build.dtype_code(x), m, q, coef.shape[0],
                               h * w, ctypes.addressof(c), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"repro_signed_sum: CUDA error {err}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=9)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("signed_sum_variants: no CUDA device", file=sys.stderr)
        return 2
    names = ["shipped", *VARIANTS]
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {"shipped": (CSRC / "signed_sum.cu", OUT / "shipped.so")}
    for name in names[1:]:
        src = OUT / f"{name}.cu"
        src.write_text(variant_source(name))
        jobs[name] = (src, OUT / f"{name}.so")
    for name, log in compile_all(jobs, shared=True).items():
        for line in log.splitlines():
            if "registers" in line or "spill stores" in line:
                print(f"ptxas {name}: {line.strip()}")
    libs = {}
    for name in names:
        lib = ctypes.CDLL(str(jobs[name][1]))
        lib.repro_signed_sum.argtypes = _build._SIGNATURES["repro_signed_sum"]
        lib.repro_signed_sum.restype = ctypes.c_int
        libs[name] = lib

    gen = np.random.default_rng(0)
    failed = 0
    levels = []
    for scheme_name in ("strassen", "winograd"):
        s = get_scheme(scheme_name)
        levels += [(f"{scheme_name} divide", 4, s.a_coef), (f"{scheme_name} combine", s.rank, s.c_coef)]
    # coefficients other than 0 and +-1 take the fp32 path in every variant
    scaled = [("strassen divide x 0.3", 4, get_scheme("strassen").a_coef * 0.3),
              ("strassen divide x 2", 4, get_scheme("strassen").a_coef * 2.0)]
    for dtype in (torch.float32, torch.bfloat16):
        for what, q, coef in levels + scaled:
            for m, h, w in CHECK_SHAPES:
                x = torch.from_numpy(gen.standard_normal((m, q, h, w), dtype=np.float32)).cuda().to(dtype)
                for name in names:
                    if not torch.equal(run(libs[name], x, coef), expected(name, x, coef).cuda()):
                        failed += 1
                        print(f"FAIL {name} {what} {str(dtype)[6:]} {(m, q, h, w)}: not bit-exact")
    print(f"checks: {failed} failed")
    print(f"card: {torch.cuda.get_device_name(0)}; " + ", ".join(
        f"{n}: {VARIANTS[n][0]}" for n in names[1:]))
    for dtype in (torch.float32, torch.bfloat16):
        for what, q, coef in levels:
            x = torch.from_numpy(gen.standard_normal((1, q, *TIME_PLANE), dtype=np.float32)).cuda().to(dtype)
            moved = (q + coef.shape[0]) * TIME_PLANE[0] * TIME_PLANE[1] * x.element_size()
            times = {name: [] for name in names}
            for name in names + names[::-1]:
                times[name].append(time_ms(lambda: run(libs[name], x, coef), args.reps))
            cells = ", ".join(f"{n} {' / '.join(f'{t:.4f}' for t in ts)}" for n, ts in times.items())
            print(f"time {str(dtype)[6:]} {what} {tuple(x.shape)} ms: {cells}; bound "
                  f"{moved / PEAK_BYTES * 1e3:.4f} (bytes)", flush=True)
            del x
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
