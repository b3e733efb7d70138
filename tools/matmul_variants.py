#!/usr/bin/env python3
"""A/B timing of design variants of the tiled matmul kernel on one GPU.

Usage, from the root of a checkout on a machine with a Hopper GPU and nvcc::

    python3 tools/matmul_variants.py [--variants a,b] [--reps R]
    python3 tools/matmul_variants.py --sass-against DIR

Each variant is ``src/repro_torch/csrc/matmul.cu`` with a few lines replaced
(``VARIANTS`` below: the alternatives its design comment says were measured).
The shipped source and every variant are compiled by their own ``nvcc``, all
started together, into libraries under ``build/variants/``, checked against
the plain version on ragged shapes in fp32 and bf16, and timed with CUDA
events in turns (shipped, variants, variants reversed, shipped) at the staged
pipeline's leaf shape (49, 4096, 4096, 4096) and at 8192^3, beside
``torch.bmm``. Exits non-zero if a build or a check fails.

``--sass-against DIR`` instead compiles every CUDA source of DIR's
``src/repro_torch/csrc`` (for example a ``git archive`` of the parent commit)
and of this tree, and says for each whether the SASS is the same.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.matmul.ref import batched_matmul_ref  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "variants"


def _wgmma_64x128() -> str:
    """The m64n128k16 wrapper the 128 x 128 bf16 variants need."""
    outs = ", ".join(f"%{i}" for i in range(64))
    regs = ", ".join(f'"+f"(d[{i}])' for i in range(64))
    return (
        "__device__ __forceinline__ void wgmma_64x128x16(float (&d)[64], uint64_t da, uint64_t db, "
        "int accumulate) {\n  asm volatile(\n"
        '      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"\n'
        '      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "\n'
        f'      "{{{outs}}}, %64, %65, p, 1, 1, 0, 1;\\n}}\\n"\n'
        f"      : {regs}\n"
        '      : "l"(da), "l"(db), "r"(accumulate));\n}\n'
    )


_SETMAXNREG = (
    '    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(PRODUCER_REGS) : "memory");\n',
    '  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(CONSUMER_REGS) : "memory");\n',
)
_TILE_128 = [
    ("constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;",
     "constexpr int BM = 128, BN = 128, BK = 64, STAGES = 6;"),
    ("namespace repro {\nnamespace {\n", "namespace repro {\nnamespace {\n" + _wgmma_64x128()),
    ("      wgmma_64x256x16(acc,", "      wgmma_64x128x16(acc,"),
]
# name -> (what it changes, [(shipped text, replacement)])
VARIANTS = {
    "row_order": ("output tiles in plain row order, not groups of 8 tile rows",
                  [("constexpr int GROUP_M = 8;", "constexpr int GROUP_M = 1;")]),
    "bf16_tile_128x128": ("bf16: a 128 x 128 tile (m64n128k16) and a ring of 6 stages", _TILE_128),
    "bf16_two_blocks": ("bf16: 128 x 128 tiles, two blocks an SM, a one-warp producer, 3 stages", [
        *_TILE_128[1:],
        ("constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;",
         "constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;"),
        ("THREADS = CONSUMERS + 128;", "THREADS = CONSUMERS + 32;"),
        ("__launch_bounds__(b16::THREADS, 1)", "__launch_bounds__(b16::THREADS, 2)"),
        (_SETMAXNREG[0], ""), (_SETMAXNREG[1], ""),
    ]),
    "fp32_mbarrier_release": ("fp32: each warp releases a stage on an mbarrier, no __syncthreads", [
        ("  __shared__ __align__(8) uint64_t full[STAGES];  // a stage's tiles have landed\n"
         "  extern __shared__ uint8_t smem_raw[];\n  // Swizzled tiles must start on 1024 bytes.\n"
         "  float* ring",
         "  __shared__ __align__(8) uint64_t full[STAGES];  // a stage's tiles have landed\n"
         "  __shared__ __align__(8) uint64_t empty[STAGES];\n  extern __shared__ uint8_t smem_raw[];\n"
         "  // Swizzled tiles must start on 1024 bytes.\n  float* ring"),
        ("    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i]);\n",
         "    for (int i = 0; i < STAGES; ++i) {\n      mbar_init(&full[i]);\n"
         "      mbar_init<THREADS / 32>(&empty[i]);\n    }\n"),
        ("  int ld_step = 0, ld_slot = 0;\n", "  int ld_step = 0, ld_slot = 0, ld_phase = 0;\n"),
        ("      if (tid == 0) {\n        mbar_expect_tx(&full[ld_slot], STAGE * 4);",
         "      if (tid == 0) {\n"
         "        if (ld_step >= STAGES) mbar_wait(&empty[ld_slot], ld_phase ^ 1);\n"
         "        mbar_expect_tx(&full[ld_slot], STAGE * 4);"),
        ("    ++ld_step;\n    if (++ld_slot == STAGES) ld_slot = 0;\n",
         "    ++ld_step;\n    if (++ld_slot == STAGES) {\n"
         "      ld_slot = 0;\n      ld_phase ^= 1;\n    }\n"),
        ("    if (TMA) fence_proxy_async();  // this stage is refilled by the TMA later\n"
         "    __syncthreads();\n",
         "    if constexpr (TMA) {\n      fence_proxy_async();\n      __syncwarp();\n"
         "      if (lane == 0) mbar_arrive(&empty[slot]);\n"
         "    } else {\n      __syncthreads();\n    }\n"),
    ]),
}
CHECK_SHAPES = [(2, 130, 72, 200), (1, 257, 520, 136), (3, 33, 65, 17), (2, 64, 8, 64),
                (2, 256, 1024, 384), (1, 200, 1000, 260), (2, 136, 96, 264)]
TIME_SHAPES = [(49, 4096, 4096, 4096), (1, 8192, 8192, 8192)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 8e-3}  # chip_smoke.py's "mm" limits


def variant_source(name: str) -> str:
    text = (CSRC / "matmul.cu").read_text()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: the shipped matmul.cu no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    return text


def compile_all(jobs: dict, shared: bool) -> dict:
    """{name: (source, output)} -> {name: ptxas log}; raises on a failed build."""
    flags = [*_build.NVCC_FLAGS, "-shared" if shared else "-c"]
    procs = {name: subprocess.Popen([_build._nvcc(), *flags, "-I", str(CSRC), str(src), "-o", str(out)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, (src, out) in jobs.items()}
    logs = {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{logs[name][-4000:]}")
    return logs


def sass_against(other: Path) -> int:
    other_csrc = other / "src" / "repro_torch" / "csrc"
    OUT.mkdir(parents=True, exist_ok=True)
    names = sorted(p.name for p in CSRC.glob("*.cu") if (other_csrc / p.name).exists())
    jobs = {}
    for name in names:
        jobs[f"this/{name}"] = (CSRC / name, OUT / f"this_{name}.o")
        jobs[f"other/{name}"] = (other_csrc / name, OUT / f"other_{name}.o")
    compile_all(jobs, shared=False)
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    for name in names:
        sass = []
        for side in ("this", "other"):
            text = subprocess.run([str(cuobjdump), "-sass", str(OUT / f"{side}_{name}.o")],
                                  capture_output=True, text=True, check=True).stdout
            # anonymous namespaces carry a per-file hash in their mangled names
            sass.append(re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "ANON", text))
        same = "the same" if sass[0] == sass[1] else "DIFFERENT"
        print(f"sass {name}: {same} ({len(sass[0].splitlines())} and {len(sass[1].splitlines())} lines)")
    return 0


def time_ms(fn, reps: int) -> float:
    """Median device ms of one call, queued behind a held stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated names")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--sass-against", type=Path, help="compare every source's SASS with DIR's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("matmul_variants: no CUDA device", file=sys.stderr)
        return 2
    if args.sass_against is not None:
        return sass_against(args.sass_against)
    names = ["shipped", *args.variants.split(",")]
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {"shipped": (CSRC / "matmul.cu", OUT / "shipped.so")}
    for name in names[1:]:
        src = OUT / f"{name}.cu"
        src.write_text(variant_source(name))
        jobs[name] = (src, OUT / f"{name}.so")
    for name, log in compile_all(jobs, shared=True).items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    libs = {}
    for name in names:
        lib = ctypes.CDLL(str(jobs[name][1]))
        lib.repro_batched_matmul.argtypes = _build._SIGNATURES["repro_batched_matmul"]
        lib.repro_batched_matmul.restype = ctypes.c_int
        libs[name] = lib

    def run(name, a, b):
        out = torch.empty((a.shape[0], a.shape[1], b.shape[2]), dtype=a.dtype, device=a.device)
        err = libs[name].repro_batched_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), _build.dtype_code(a, b), _build.dtype_code(out),
            *a.shape, b.shape[2],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return out

    failed = 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for mb, m, k, n in CHECK_SHAPES:
            a = torch.randn((mb, m, k), device="cuda", generator=gen).to(dtype)
            b = torch.randn((mb, k, n), device="cuda", generator=gen).to(dtype)
            want = batched_matmul_ref(a, b).float()
            limit = TOL[dtype] * max(1.0, want.abs().max().item())
            for name in names:
                err = (run(name, a, b).float() - want).abs().max().item()
                if not err <= limit:
                    failed += 1
                    print(f"FAIL {name} {dtype} {(mb, m, k, n)}: max_abs_err {err:.3e} > {limit:.3e}")
    print(f"checks: {failed} failed")
    print(f"card: {torch.cuda.get_device_name(0)}; " + ", ".join(
        f"{n}: {VARIANTS[n][0]}" for n in names[1:]))
    for dtype in (torch.float32, torch.bfloat16):
        for mb, m, k, n in TIME_SHAPES:
            a = torch.randn((mb, m, k), device="cuda", generator=gen).to(dtype)
            b = torch.randn((mb, k, n), device="cuda", generator=gen).to(dtype)
            ms = {name: [] for name in names}
            for name in names + names[::-1]:
                ms[name].append(time_ms(lambda: run(name, a, b), args.reps))
            lib = time_ms(lambda: torch.bmm(a, b), args.reps)
            cells = ", ".join(f"{name} {' / '.join(f'{t:.3f}' for t in ts)}" for name, ts in ms.items())
            print(f"time {str(dtype)[6:]} {(mb, m, k, n)}: {cells}; torch.bmm {lib:.3f} ms", flush=True)
            del a, b
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
