#!/usr/bin/env python3
"""What a step of the persistent sLSTM kernel costs, taken apart on one GPU.

Usage, from the root of a checkout on a machine with a Hopper GPU and nvcc::

    python3 tools/slstm_variants.py [--reps R]

Builds ``src/repro_torch/csrc/slstm.cu`` and each variant in ``VARIANTS``
(a few lines replaced) into libraries under ``build/slstm_variants/``, one
``nvcc`` each, all started together. The shipped kernel is checked against
the plain version (two of the variants compute wrong values on purpose, so
the variants are only timed). Each is timed with CUDA events in turns (shipped, variants, variants
reversed, shipped) at xlstm-1.3b's shape, 4 heads of 512, over 1024 steps and
over 1 step from zero state, and the time a step adds is (t(1024) - t(1)) /
1023. ``exchange_only`` forms no dot products: its step is the wait for
the head's other blocks, the exchange of h through L2, the staging, the
gates and the publish, the sequential floor of the design. ``no_wait``
never waits for the other blocks: its step is a block's own work. The other
variants are the alternatives that ``csrc/slstm.cu``'s comments say were
measured.

Exits non-zero if a build or the shipped kernel's check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from matmul_variants import compile_all, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.slstm.ref import slstm_seq_ref  # noqa: E402
from repro_torch.kernels.slstm.slstm import slstm_plan  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "slstm_variants"

# name -> (what it changes, [(shipped text, replacement)])
VARIANTS = {
    "exchange_only": ("no dot products: wait, h exchange, staging, gates, publish", [
        ("        if (k < resident) {\n"
         "          tile_dots<ROWS, true>(rs + k * tile_floats, r, sh_h, red, nb, heads, head, dh, e0, vec);\n"
         "        } else {\n"
         "          tile_dots<ROWS, false>(rs, r, sh_h, red, nb, heads, head, dh, e0, vec);\n"
         "        }\n", ""),
    ]),
    "no_wait": ("no wait for the head's other blocks: a block's own work alone", [
        ("          wait_count(counters + head, (last - first + 1) * t);\n",
         "          __syncthreads();\n"),
    ]),
    "fence": ("a __threadfence before the release add", [
        ("      if (last_of_head && tid == 0) add_release(counters + head);\n",
         "      if (last_of_head && tid == 0) {\n        __threadfence();\n"
         "        add_release(counters + head);\n      }\n"),
    ]),
    "unroll_2": ("the dot products' loop over resident r unrolled twice", [
        ("#pragma unroll 1\n    for (int d = slice;", "#pragma unroll 2\n    for (int d = slice;"),
    ]),
    "rows_4": ("the four-row kernel at B = 1 too", [
        ("           : (b == 1 ? reinterpret_cast<const void*>(slstm_seq_kernel<1, false>)",
         "           : (false ? reinterpret_cast<const void*>(slstm_seq_kernel<1, false>)"),
    ]),
}
SHAPE = dict(h=4, dh=512)  # xlstm-1.3b's sLSTM heads


def variant_source(name: str) -> str:
    text = (CSRC / "slstm.cu").read_text()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: the shipped slstm.cu no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    return text


def inputs(b: int, s: int, h: int, dh: int, gen: torch.Generator) -> tuple:
    """wx, r as the model draws them and a zero state, on the card."""
    wx = torch.randn((b, s, 4, h, dh), device="cuda", generator=gen)
    r = torch.randn((4, h, dh, dh), device="cuda", generator=gen) * dh**-0.5
    z = torch.zeros((b, h, dh), device="cuda")
    return wx, r, {"c": z, "n": z.clone(), "m": torch.full_like(z, -1e30), "h": z.clone()}


def run(lib: ctypes.CDLL, wx: torch.Tensor, r: torch.Tensor, state: dict) -> torch.Tensor:
    """hs of one call of ``lib``'s kernel, launched as the wrapper launches it."""
    b, s, _, h, dh = wx.shape
    sms, smem = ctypes.c_int(), ctypes.c_int()
    lib.repro_device_limits(torch.cuda.current_device(), ctypes.byref(sms), ctypes.byref(smem))
    plan = slstm_plan(h, dh, s, sms.value, smem.value)
    c, n, m = (torch.empty_like(state[k]) for k in ("c", "n", "m"))
    hs = torch.empty((b, s, h, dh), device="cuda")
    counters = torch.zeros(h, dtype=torch.int32, device="cuda")
    err = lib.repro_slstm_seq(
        wx.data_ptr(), r.data_ptr(), state["h"].data_ptr(), *(state[k].data_ptr() for k in "cnm"),
        c.data_ptr(), n.data_ptr(), m.data_ptr(),
        hs.data_ptr(), None, None, None, None, counters.data_ptr(), b, s, h, dh, plan.blocks,
        plan.tiles_per_block,
        plan.resident, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"repro_slstm_seq: CUDA error {err}")
    return hs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("slstm_variants: no CUDA device", file=sys.stderr)
        return 2
    names = ["shipped", *VARIANTS]
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {"shipped": (CSRC / "slstm.cu", OUT / "shipped.so")}
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
        for fn in ("repro_slstm_seq", "repro_device_limits"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    gen = torch.Generator(device="cuda").manual_seed(0)
    h, dh = SHAPE["h"], SHAPE["dh"]
    wx, r, state = inputs(1, 1024, h, dh, gen)
    want = slstm_seq_ref(wx, r, state)[1]
    err = (run(libs["shipped"], wx, r, state) - want).abs().max().item()
    limit = 2e-5 * max(1.0, want.abs().max().item())
    ok = err <= limit
    print(f"check shipped {tuple(wx.shape)}: max_abs_err {err:.3e} limit {limit:.3e} {'ok' if ok else 'FAIL'}")
    print(f"card: {torch.cuda.get_device_name(0)}; " + ", ".join(
        f"{n}: {VARIANTS[n][0]}" for n in names[1:]))
    ms = {}
    for s in (1024, 1):
        wx, r, state = inputs(1, s, h, dh, gen)
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(time_ms(lambda: run(libs[name], wx, r, state), args.reps))
        ms[s] = {name: min(ts) for name, ts in times.items()}
        cells = ", ".join(f"{name} {' / '.join(f'{t:.4f}' for t in ts)}" for name, ts in times.items())
        print(f"time (1, {s}, 4, {h}, {dh}) ms: {cells}", flush=True)
    for name in names:
        step_us = (ms[1024][name] - ms[1][name]) / 1023 * 1e3
        print(f"per step {name}: {step_us:.3f} us ((t(1024) - t(1)) / 1023, the faster of each pair)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
