#!/usr/bin/env python3
"""A/B checks and timings of design variants of the bf16 flash-attention
backward and of the RMSNorm backward on one GPU.

Usage, from the root of a checkout on a machine with a Hopper GPU and nvcc::

    python3 tools/flash_bwd_variants.py [--reps R]

Builds ``src/repro_torch/csrc/flash_attention_bwd.cu`` and each variant in
``VARIANTS`` (a few lines replaced) into libraries under
``build/flash_bwd_variants/``, one ``nvcc`` each, all started together, and
prints each one's ptxas registers and spills. At the training shapes of
``chip_smoke.py``'s t1 (phi4, whisper's encoder, decoder and cross-attention,
gemma-7b and recurrentgemma-9b) it holds each variant to t1's rule (bf16
within 2^-5 x (|plain| + rms(plain)) per element and 1e-2 normwise), prints
err/limit for dQ, dK and dV, checks that a second run gives the same bits,
and times the variants in turns (shipped, variants, variants reversed,
shipped) beside torch.autograd through scaled_dot_product_attention and the
bound. Then it times the shipped RMSNorm backward at phi4's (2048, 3072)
rows, cold, beside autograd through F.rms_norm. Exits non-zero if a build
or a check fails.
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

import chip_smoke as cs  # noqa: E402
from matmul_variants import compile_all, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as tfa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_bwd_cuda  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "flash_bwd_variants"
SHIPPED_LO = "constexpr int LO_PRODUCTS = 7;"

# name -> (what it changes, [(shipped text, replacement)])
VARIANTS = {
    "lo_dq": ("P and dS as one bf16 part in the dV and dK products, hi + lo in dQ's",
              [(SHIPPED_LO, "constexpr int LO_PRODUCTS = 4;")]),
    "lo_none": ("P and dS as one bf16 part in every product", [(SHIPPED_LO, "constexpr int LO_PRODUCTS = 0;")]),
    "no_dq_add": ("dQ's terms computed, never added (a wrong dQ: the cost of adding)", [
        ("      add_in_turn<C::NQ, C::V4>(dq,", "      if (false) add_in_turn<C::NQ, C::V4>(dq,")]),
}


def variant_source(name: str) -> str:
    text = (CSRC / "flash_attention_bwd.cu").read_text()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: the shipped source no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    return text


def run(lib: ctypes.CDLL, q, k, v, out, lse, do, causal: bool, window):
    """The wrapper's launch (flash_attention_bwd_cuda) through ``lib``."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    plan = tfa.flash_bwd_plan(b, hq, hkv, sq, sk, d, causal, window, *_build.device_limits(q.device))
    bufs = [torch.empty(max(n, 16) // 4, dtype=torch.int32 if name == "counts" else torch.float32,
                        device=q.device) for name, n in plan.scratch.items()]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
        *(t.data_ptr() for t in bufs), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _build.dtype_code(q),
        b, hq, hkv, sq, sk, d, int(causal), -1 if window is None else window, d**-0.5, plan.parts,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"repro_flash_attention_bwd: CUDA error {err}")
    return dq, dk, dv


def worst(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max err / (2^-5 (|plain| + rms(plain))), normwise distance, finite)."""
    w, g = want.float(), got.float()
    limit = 2**-5 * (w.abs() + w.square().mean().sqrt())
    ratio = ((g - w).abs() / limit.clamp_min(1e-30)).max().item()
    return ratio, ((g - w).norm() / w.norm().clamp_min(1e-30)).item(), bool(torch.isfinite(g).all())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=9)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    _build.build()
    names = ["shipped", *VARIANTS]
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {"shipped": (CSRC / "flash_attention_bwd.cu", OUT / "shipped.so")}
    for name in names[1:]:
        src = OUT / f"{name}.cu"
        src.write_text(variant_source(name))
        jobs[name] = (src, OUT / f"{name}.so")
    for name, log in compile_all(jobs, shared=True).items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
            elif "flash_bwd_wgmma" in fn or "wgmma" in line:
                print(f"ptxas {name} {fn[fn.find('flash_bwd_wgmma'):][:40]}: {line.strip()}")
    libs = {}
    for name in names:
        lib = ctypes.CDLL(str(jobs[name][1]))
        lib.repro_flash_attention_bwd.argtypes = _build._SIGNATURES["repro_flash_attention_bwd"]
        lib.repro_flash_attention_bwd.restype = ctypes.c_int
        libs[name] = lib
    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; " + ", ".join(f"{n}: {VARIANTS[n][0]}" for n in names[1:]), flush=True)

    gen = np.random.default_rng(8)
    failed = 0
    for what, qs, ks, causal, window in cs.train_flash_shapes():
        q, k, v = (cs.randn(gen, s, torch.bfloat16) for s in (qs, ks, ks))
        out, lse = tfa.flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=True)
        do = cs.randn(gen, qs, torch.bfloat16)
        want = attention_bwd_ref(q, k, v, out, lse, do, causal=causal, window=window)
        for name in names:
            got = run(libs[name], q, k, v, out, lse, do, causal, window)
            again = run(libs[name], q, k, v, out, lse, do, causal, window)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            cells = []
            ok = same
            for part, g, w in zip(("dq", "dk", "dv"), got, want):
                ratio, rel, finite = worst(g, w)
                ok = ok and finite and ratio <= 1.0 and rel <= 1e-2
                cells.append(f"{part} err/limit {ratio:.3f} normwise {rel:.2e}")
            failed += not ok
            print(f"check {name} {what} q{qs} kv{ks}: {', '.join(cells)}; same bits {same} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(time_ms(lambda n=name: run(libs[n], q, k, v, out, lse, do, causal, window),
                                       args.reps))
        lib_ms = time_ms(cs.sdpa_grad(q, k, v, do, causal, window), args.reps)
        bound, by = cs.bound_ms(cs.bwd_ops(qs, ks, causal, window),
                                cs.nbytes(q, k, v, out, lse, do) + cs.nbytes(q, k, v), torch.bfloat16)
        cells = ", ".join(f"{n} {' / '.join(f'{t:.5f}' for t in ts)}" for n, ts in times.items())
        print(f"time flash bwd bf16 {what} ms: {cells}; SDPA autograd {lib_ms:.5f}; bound {bound:.5f} ({by})",
              flush=True)
        del q, k, v, out, lse, do, want
        torch.cuda.empty_cache()

    d = cs.get_config(cs.TRAIN_ARCH).d_model
    shape = (cs.TRAIN_BATCH * cs.TRAIN_SEQ, d)
    w = 1.0 + 0.1 * cs.randn(gen, (d,), torch.float32)
    w16 = w.bfloat16().requires_grad_()
    x, dy = cs.randn(gen, shape, torch.bfloat16), cs.randn(gen, shape, torch.bfloat16)
    dx, dw = rmsnorm_bwd_cuda(x, w, dy)
    want_dx, want_dw = rmsnorm_bwd_ref(x, w, dy)
    ratio, rel, finite = worst(dx, want_dx)
    dw_rel = ((dw - want_dw).norm() / want_dw.norm()).item()
    again = rmsnorm_bwd_cuda(x, w, dy)
    same = torch.equal(dx, again[0]) and torch.equal(dw, again[1])
    ok = finite and ratio <= 1.0 and rel <= 1e-2 and dw_rel <= 1e-5 and same
    failed += not ok
    print(f"check rmsnorm bwd bf16 {shape}: dx err/limit {ratio:.3f} normwise {rel:.2e}, dw normwise "
          f"{dw_rel:.2e}, same bits {same} {'ok' if ok else 'FAIL'}")
    xs = cs.cold_inputs(gen, shape, torch.bfloat16)
    pairs = [(xi, xs[(i + 1) % len(xs)]) for i, xi in enumerate(xs)]
    graphs = []
    for xi, gi in pairs:
        xg = xi.detach().requires_grad_()
        graphs.append((torch.nn.functional.rms_norm(xg, (d,), w16, 1e-6), xg, gi))
    kernel = cs.rotating(lambda p: rmsnorm_bwd_cuda(p[0], w, p[1]), pairs)
    library = cs.rotating(lambda g: torch.autograd.grad(g[0], (g[1], w16), g[2], retain_graph=True), graphs)
    ks_ = [time_ms(kernel, args.reps), time_ms(library, args.reps), time_ms(kernel, args.reps),
           time_ms(library, args.reps)]
    bound, _ = cs.bound_ms(10 * shape[0] * shape[1], 3 * shape[0] * shape[1] * 2 + 2 * cs.nbytes(w),
                           torch.float32)
    print(f"time rmsnorm bwd bf16 {shape} w fp32 cold ms: kernel {ks_[0]:.5f} / {ks_[2]:.5f}, F.rms_norm "
          f"autograd {ks_[1]:.5f} / {ks_[3]:.5f}; bound {bound:.5f}")
    print(f"checks: {failed} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
