#!/usr/bin/env python3
"""Builds the port's CUDA kernels and runs Stark's Strassen multiply on one GPU.

Usage: ``python3 chip_smoke.py [--seed S] [--size N] [--reps R]`` from the root
of a checkout, on a machine with an NVIDIA Hopper GPU (sm_90a) and the CUDA
toolkit. It uses ``repro_torch`` only, never JAX or ``repro``, and:

1. builds every kernel in ``src/repro_torch/csrc`` (into ``build/``);
2. holds each kernel against its plain PyTorch version, in fp32 and bf16,
   for the three schemes, on aligned and ragged shapes;
3. drives the main path, ``repro_torch.core.backend.matmul`` on two N x N
   fp32 operands made from ``--seed`` with numpy (N = 16384, the paper's
   headline size, by default), for kinds strassen_fused (depth 1 and 2),
   strassen and winograd (depth 2) and naive, plus the staged pipeline at
   depth 2 and strassen_fused at depth 2 in bf16. Each result is checked
   against an fp32 ``torch.matmul`` of the same operands by normwise
   relative error, and every kernel of the path must have been launched;
4. times each kernel at the main path's shapes with CUDA events, beside its
   plain version, the matching PyTorch call and the card's bound.

It exits non-zero, before printing a result, on any failure or when no CUDA
device is present. The last lines are the card's name and power limit, a
JSON line with one entry per kernel, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core.backend import MatmulBackend, matmul  # noqa: E402
from repro_torch.core.coefficients import get_scheme  # noqa: E402
from repro_torch.core.strassen import (  # noqa: E402
    combine_level,
    divide_level,
    merge_quadrants,
    split_quadrants,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.matmul.matmul import batched_matmul_cuda, matmul_cuda  # noqa: E402
from repro_torch.kernels.matmul.ref import batched_matmul_ref, matmul_ref  # noqa: E402
from repro_torch.kernels.strassen.ops import strassen_matmul_stages  # noqa: E402
from repro_torch.kernels.strassen.ref import combine_ref, divide_ref, strassen1_matmul_ref  # noqa: E402
from repro_torch.kernels.strassen.strassen import (  # noqa: E402
    combine_cuda,
    divide_cuda,
    strassen1_matmul_cuda,
)

# Dense peaks of one H100 SXM at its full 700 W (NVIDIA data sheet): fp32 on
# the CUDA cores (the kernels' fp32 path; TF32 would change the result), bf16
# on the tensor cores, and HBM3 bandwidth.
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12

# Kernel against plain version: max|kernel - plain| <= TOL * max(1, max|plain|).
# divide/combine sum in the same order in fp32 and round once, so they must
# match bit for bit. The products accumulate in another order than cuBLAS:
# about sqrt(K) * 2^-24 relative in fp32, and at most a bf16 ulp or two of
# the output (2^-8 relative) in bf16.
TOL = {
    ("sum", torch.float32): 0.0, ("sum", torch.bfloat16): 0.0,
    ("mm", torch.float32): 2e-5, ("mm", torch.bfloat16): 8e-3,
}
# Main path against fp32 torch.matmul, normwise relative error ||C - C_ref|| / ||C_ref||.
MAIN_LIMIT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

SCHEMES = ("strassen", "winograd", "naive8")
COUNTED = (strassen1_matmul_cuda, batched_matmul_cuda, divide_cuda, combine_cuda)
REPLACES = {
    "strassen1_matmul_cuda": "src/repro/kernels/strassen/strassen.py:155",
    "batched_matmul_cuda": "src/repro/kernels/matmul/matmul.py:95",
    "divide_cuda": "src/repro/kernels/strassen/strassen.py:68",
    "combine_cuda": "src/repro/kernels/strassen/strassen.py:105",
}
SOURCES = {
    "strassen1_matmul_cuda": "src/repro_torch/csrc/strassen1.cu",
    "batched_matmul_cuda": "src/repro_torch/csrc/matmul.cu",
    "divide_cuda": "src/repro_torch/csrc/signed_sum.cu",
    "combine_cuda": "src/repro_torch/csrc/signed_sum.cu",
}

FAILURES: list = []


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    FAILURES.append(msg)
    log(f"FAIL {msg}")


def randn(gen: np.random.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
    x = gen.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).cuda().to(dtype)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, kind: str) -> float:
    """Checks a kernel's output against its plain version; returns max|error|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: got {tuple(got.shape)} {got.dtype}, want {tuple(want.shape)} {want.dtype}")
        return float("inf")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item() if diff.numel() else 0.0
    peak = want.float().abs().max().item() if want.numel() else 0.0
    limit = TOL[(kind, want.dtype)] * max(1.0, peak)
    ok = bool(torch.isfinite(got.float()).all()) and err <= limit
    log(f"check {name}: max_abs_err={err:.3e} limit={limit:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: max_abs_err {err:.3e} > {limit:.3e} or not finite")
    return err


def time_ms(fn, reps: int) -> float:
    """Median milliseconds of one call, from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(ops: float, nbytes: float, dtype: torch.dtype) -> tuple:
    t_ops, t_bytes = ops / PEAK_OPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def sum_ops(coef: np.ndarray, m: int, plane: int) -> int:
    """Additions of one signed-sum level: (nonzeros - 1) per output row and element."""
    return int(sum(max(int(np.count_nonzero(row)) - 1, 0) for row in coef)) * m * plane


# ----------------------------------------------------------------- phases
def phase_build() -> None:
    path = _build.library_path()
    fresh = not path.exists()
    _build.build()
    how = "compiled" if fresh else "cached"
    log(f"kernel build: {_build.build_seconds():.1f} s ({how}) -> {path}")
    build_log = path.parent / "build.log"
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                log(f"  ptxas {line.strip()}")


def phase_kernels(gen: np.random.Generator) -> None:
    """Every kernel against its plain version on small aligned and ragged shapes."""
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for mb, m, k, n in [(7, 64, 64, 64), (49, 32, 32, 32), (1, 128, 64, 128),
                            (3, 100, 70, 130), (2, 8, 16, 8), (1, 64, 192, 128)]:
            a, b = randn(gen, (mb, m, k), dtype), randn(gen, (mb, k, n), dtype)
            compare(f"batched_matmul {tag} {(mb, m, k, n)}", batched_matmul_cuda(a, b),
                    batched_matmul_ref(a, b), "mm")
        for m, k, n in [(128, 128, 128), (256, 128, 64), (64, 192, 128), (8, 16, 8),
                        (96, 80, 112), (33, 65, 17)]:
            a, b = randn(gen, (m, k), dtype), randn(gen, (k, n), dtype)
            compare(f"matmul {tag} {(m, k, n)}", matmul_cuda(a, b), matmul_ref(a, b), "mm")
        for name in SCHEMES:
            s = get_scheme(name)
            for shape in [(1, 4, 64, 64), (7, 4, 32, 64), (4, 4, 128, 128), (3, 4, 5, 7),
                          (2, 4, 16, 24)]:
                x = randn(gen, shape, dtype)
                for coef_name in ("a_coef", "b_coef"):
                    coef = getattr(s, coef_name)
                    compare(f"divide {tag} {name}.{coef_name} {shape}", divide_cuda(x, coef),
                            divide_ref(x, coef), "sum")
            for m, h, w in [(1, 64, 64), (7, 32, 32), (3, 5, 7), (2, 16, 24)]:
                x = randn(gen, (m, s.n_mults, h, w), dtype)
                compare(f"combine {tag} {name} {(m, s.n_mults, h, w)}",
                        combine_cuda(x, s.c_coef), combine_ref(x, s.c_coef), "sum")
            for mb, m2, k2, n2 in [(1, 64, 64, 64), (7, 32, 64, 32), (2, 128, 128, 128),
                                   (3, 33, 65, 17), (1, 8, 192, 8)]:
                aq, bq = randn(gen, (mb, 4, m2, k2), dtype), randn(gen, (mb, 4, k2, n2), dtype)
                compare(f"strassen1 {tag} {name} {(mb, m2, k2, n2)}",
                        strassen1_matmul_cuda(aq, bq, scheme=s),
                        strassen1_matmul_ref(aq, bq, s), "mm")


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return (torch.linalg.vector_norm(out.float() - ref) / torch.linalg.vector_norm(ref)).item()


def main_path_runs(a, b, a16, b16) -> list:
    """(name, call, fp32 or bf16 operands) of every main-path configuration."""
    def backend(kind, depth=1):
        return lambda x, w: matmul(x, w, MatmulBackend(kind=kind, depth=depth))

    return [
        ("strassen_fused depth=1 fp32", backend("strassen_fused", 1), a, b),
        ("strassen_fused depth=2 fp32", backend("strassen_fused", 2), a, b),
        ("strassen depth=2 fp32", backend("strassen", 2), a, b),
        ("winograd depth=2 fp32", backend("winograd", 2), a, b),
        ("naive fp32", backend("naive"), a, b),
        ("stages depth=2 fp32", lambda x, w: strassen_matmul_stages(x, w, depth=2), a, b),
        ("strassen_fused depth=2 bf16", backend("strassen_fused", 2), a16, b16),
    ]


def phase_main_path(runs: list, refs: dict) -> dict:
    """Each configuration once at full size, checked; returns the launch counts."""
    for fn in COUNTED:
        fn.launches = 0
    for name, call, x, w in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = call(x, w)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        err = rel_err(out, refs[x.dtype])
        limit = MAIN_LIMIT[x.dtype]
        n = x.shape[0]
        ok = (tuple(out.shape) == (n, n) and out.dtype == x.dtype
              and bool(torch.isfinite(out).all()) and err <= limit)
        log(f"main {name}: {n}x{n} rel_err={err:.3e} limit={limit:.0e} first call "
            f"{secs * 1e3:.1f} ms, peak_mem={peak:.2f} GiB {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"main path {name}: rel_err {err:.3e}, shape {tuple(out.shape)}, {out.dtype}")
        del out
    counts = {fn.__name__: fn.launches for fn in COUNTED}
    log(f"main path launches: {counts}")
    for fname, count in counts.items():
        if count <= 0:
            fail(f"{fname} was not launched on the main path")
    return counts


def phase_end_to_end(runs: list, reps: int) -> None:
    """Median time of one whole multiply per configuration (CUDA events)."""
    for name, call, x, w in runs:
        ms = time_ms(lambda: call(x, w), reps)
        n = x.shape[0]
        log(f"e2e {name}: {ms:.3f} ms, {2 * n**3 / ms / 1e9:.2f} TFLOP/s-equivalent (2N^3)")


def phase_timing(a, b, reps: int, counts: dict) -> list:
    """Per-kernel medians at the main path's shapes; returns the JSON entries.

    The inputs are the main path's own intermediates: the quadrants of the
    operands, their depth-1 operand sums and the depth-2 leaves.
    """
    s = get_scheme("strassen")
    h = a.shape[0] // 2
    plane = h * h * a.element_size()  # bytes of one (N/2)^2 fp32 plane
    entries = []

    def entry(name, kernel, plain, library, ops, moved, dtype, kind):
        err = compare(f"{name} at main-path shape", kernel(), plain(), kind)
        ms, plain_ms = time_ms(kernel, reps), time_ms(plain, reps)
        library_ms = time_ms(library, reps) if library is not None else None
        bms, by = bound_ms(ops, moved, dtype)
        lib = "n/a" if library_ms is None else f"{library_ms:.3f} ms"
        log(f"time {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library {lib}, "
            f"bound {bms:.3f} ms ({by}), kernel at {bms / ms:.1%} of bound")
        return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
                    bound_by=by, max_abs_err=err)

    def add(fname, stats):
        entries.append({"name": fname, "route": "cuda", "source": SOURCES[fname],
                        "replaces": REPLACES[fname], "launches": counts[fname], **stats})

    # strassen1 at the depth-1 fused shape; the library call is torch.matmul
    # of the same operands before the quadrant split.
    aq, bq = split_quadrants(a[None]), split_quadrants(b[None])  # (1, 4, N/2, N/2)
    add("strassen1_matmul_cuda", entry(
        f"strassen1 fp32 {tuple(aq.shape)}", lambda: strassen1_matmul_cuda(aq, bq, scheme=s),
        lambda: strassen1_matmul_ref(aq, bq, s), lambda: torch.matmul(a, b),
        2 * 7 * h**3, 12 * plane, torch.float32, "mm"))

    # The staged pipeline's first divide level, and a combine level of the same size.
    coef = torch.as_tensor(s.a_coef, dtype=torch.float32, device="cuda")
    add("divide_cuda", entry(
        f"divide fp32 {tuple(aq.shape)}", lambda: divide_cuda(aq, s.a_coef),
        lambda: divide_ref(aq, s.a_coef), lambda: torch.einsum("pq,mqij->mpij", coef, aq),
        sum_ops(s.a_coef, 1, h * h), 11 * plane, torch.float32, "sum"))
    p = divide_cuda(aq, s.a_coef)  # (1, 7, N/2, N/2)
    del aq, bq
    ccoef = torch.as_tensor(s.c_coef, dtype=torch.float32, device="cuda")
    add("combine_cuda", entry(
        f"combine fp32 {tuple(p.shape)}", lambda: combine_cuda(p, s.c_coef),
        lambda: combine_ref(p, s.c_coef), lambda: torch.einsum("kp,mpij->mkij", ccoef, p),
        sum_ops(s.c_coef, 1, h * h), 11 * plane, torch.float32, "sum"))
    del p

    # Depth 2: the fused kernel on the depth-1 operand sums (printed, not in
    # the JSON line), and the staged pipeline's 49 leaves.
    ta, tb = divide_level(a[None], s.a_coef), divide_level(b[None], s.b_coef)  # (7, N/2, N/2)
    for dtype in (torch.float32, torch.bfloat16):
        aq, bq = split_quadrants(ta.to(dtype)), split_quadrants(tb.to(dtype))  # (7, 4, N/4, N/4)
        am, bm = ta.to(dtype), tb.to(dtype)
        entry(f"strassen1 {str(dtype)[6:]} {tuple(aq.shape)}",
              lambda: strassen1_matmul_cuda(aq, bq, scheme=s),
              lambda: strassen1_matmul_ref(aq, bq, s), lambda: torch.bmm(am, bm),
              2 * 7 * 7 * (h // 2) ** 3, 3 * nbytes(aq), dtype, "mm")
        del aq, bq, am, bm
    la, lb = divide_level(ta, s.a_coef), divide_level(tb, s.b_coef)  # (49, N/4, N/4)
    del ta, tb
    add("batched_matmul_cuda", entry(
        f"batched_matmul fp32 {tuple(la.shape)}", lambda: batched_matmul_cuda(la, lb),
        lambda: batched_matmul_ref(la, lb), lambda: torch.bmm(la, lb),
        2 * 49 * (h // 2) ** 3, 3 * nbytes(la), torch.float32, "mm"))
    return entries


def phase_breakdown(a, b, reps: int) -> None:
    """Where the time of strassen_fused at depth 2 goes, step by step (CUDA events)."""
    s = get_scheme("strassen")
    ta = divide_level(a[None], s.a_coef)
    aq = split_quadrants(ta)
    cq = strassen1_matmul_cuda(aq, split_quadrants(divide_level(b[None], s.b_coef)), scheme=s)
    prod = merge_quadrants(cq)
    steps = [
        ("divide_level (einsum, one operand)", lambda: divide_level(a[None], s.a_coef)),
        ("split_quadrants copy (one operand)", lambda: split_quadrants(ta)),
        ("strassen1 kernel", lambda: strassen1_matmul_cuda(aq, aq, scheme=s)),
        ("merge_quadrants copy", lambda: merge_quadrants(cq)),
        ("combine_level (einsum)", lambda: combine_level(prod, s.c_coef)),
    ]
    for name, fn in steps:
        log(f"breakdown strassen_fused depth=2 fp32: {name}: {time_ms(fn, reps):.3f} ms")


def report_failures() -> int:
    print(f"chip_smoke: {len(FAILURES)} failure(s):", file=sys.stderr)
    for f in FAILURES:
        print(f"  {f}", file=sys.stderr)
    return 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--size", type=int, default=16384, help="N of the N x N main-path operands")
    parser.add_argument("--reps", type=int, default=5, help="timed calls per median")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.size % 16:
        parser.error("--size must be a multiple of 16")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    phase_build()
    gen = np.random.default_rng(args.seed)
    phase_kernels(gen)
    if FAILURES:  # no point driving the main path through a wrong kernel
        return report_failures()

    n = args.size
    t = time.perf_counter()
    a = torch.from_numpy(gen.standard_normal((n, n), dtype=np.float32)).cuda()
    b = torch.from_numpy(gen.standard_normal((n, n), dtype=np.float32)).cuda()
    a16, b16 = a.bfloat16(), b.bfloat16()
    ref32 = torch.matmul(a, b)
    ref16 = torch.matmul(a16.float(), b16.float())
    torch.cuda.synchronize()
    log(f"operands {n}x{n} from seed {args.seed}: {time.perf_counter() - t:.1f} s")

    runs = main_path_runs(a, b, a16, b16)
    counts = phase_main_path(runs, {torch.float32: ref32, torch.bfloat16: ref16})
    del ref32, ref16
    phase_end_to_end(runs, args.reps)
    del runs, a16, b16
    entries = phase_timing(a, b, args.reps, counts)
    phase_breakdown(a, b, args.reps)
    log(f"total {time.perf_counter() - t0:.1f} s")

    if FAILURES:
        return report_failures()
    print(smi)
    print(json.dumps({"kernels": entries}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
