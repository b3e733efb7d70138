#!/usr/bin/env python3
"""What a step of the sLSTM backward kernel costs, taken apart on one GPU.

Usage, from the root of a checkout on a machine with a Hopper GPU and nvcc::

    python3 tools/slstm_bwd_variants.py [--reps R] [--csrc DIR]

Builds ``csrc/slstm_bwd.cu`` and each variant in ``VARIANTS`` (a few lines
replaced) into libraries under ``build/slstm_bwd_variants/``, one ``nvcc``
each, all started together, and prints their ptxas registers and spills.
The kernel as built is checked against the plain backward fed the same
saved tensors (the fp32 backward rule, 1e-4 x max(1, max|plain|)); the
variants compute wrong values on purpose and are only timed. Each is timed
with CUDA events in turns (kernel, variants, variants reversed, kernel) at
xlstm-1.3b's training rows, B = 2 and 4 heads of 512, over 1024 steps and
over 1 step from zero state, and the time a step adds is (t(1024) - t(1)) /
1023. The times are of the kernel's launch alone: r's transpose and the dr
product of the wrapper are left out.

``exchange_only`` forms no dot products: its step is the wait for the
head's other blocks, the staging of dpre, the VJP and the publish, the
sequential floor of the design. ``no_wait`` never waits for the other
blocks: a block's own work alone. ``no_vjp`` writes a constant dpre in
place of the step's VJP, so that the exchange and the dot products are
timed without it. The others are the alternatives that ``slstm_bwd.cu``'s
comments say were measured.

``--csrc DIR`` takes ``slstm_bwd.cu`` and its headers from DIR instead (for
example ``src/repro_torch/csrc`` of a ``git archive`` of an earlier commit
unpacked under ``build/``); each variant then takes the first of its edits
that applies to that source, and a variant none of whose edits applies is
left out. Exits non-zero if a build or the check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from matmul_variants import compile_all, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.slstm.ref import slstm_seq_bwd_ref  # noqa: E402
from repro_torch.kernels.slstm.slstm import slstm_bwd_plan, slstm_seq_cuda  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "slstm_bwd_variants"

# The shipped kernel's lines that the variants replace
_DOTS = ("          if (kk < resident) {\n"
         "            tile_dots_bwd<ROWS, true>(rs + kk * tile_floats, rt, sh_dp, red, nb, heads, head, dh, dhp, d0, vec);\n"
         "          } else {\n"
         "            tile_dots_bwd<ROWS, false>(rs, rt, sh_dp, red, nb, heads, head, dh, dhp, d0, vec);\n"
         "          }\n")
_WAIT = "              spin_until(counters + head, (last - first + 1) * k);\n"
_VJP = "          v = step_vjp_affine(s.p, s.c, s.n, s.m, c1, n1, m1, dc1, dn1, dm1);\n"
_STAGE = "            stage(reinterpret_cast<float4*>(sh_dp), staged, nb * dhp, tid - FIRST_STAGER, STAGERS);\n"
_STAGERS_SYNC = '            asm volatile("bar.sync 1, %0;\\n" ::"n"(STAGERS) : "memory");\n'
# The first version's lines: the staging row by row from dwx, the whole VJP after the exchange
_V1_DOTS = _DOTS.replace("dh, dhp, d0", "dh, d0")
_V1_WAIT = "            wait_count(counters + head, (last - first + 1) * k);\n"
_V1_VJP = "            step_vjp(p, c, n, m, c1, n1, m1, dht + rec, dcs, dns, dms, dp);\n"


# name -> (what it changes, [edits, ...]): each edits a list of (text, replacement);
# the first whose texts all occur once in the source is applied
VARIANTS = {
    "exchange_only": ("no dot products: wait, staging, VJP, publish", [
        [(_DOTS, "")],
        [(_V1_DOTS, "")],
    ]),
    "no_wait": ("no wait for the head's other blocks: a block's own work alone", [
        [(_WAIT, "")],
        [(_V1_WAIT, "            __syncthreads();\n")],
    ]),
    "no_vjp": ("a constant dpre in place of the step's VJP: exchange and dots alone", [
        [(_VJP, "          v.p0[0] = v.p0[1] = v.p0[2] = v.p0[3] = 1e-3f;\n")],
        [(_V1_VJP, "            dp[0] = dp[1] = dp[2] = dp[3] = 1e-3f;\n")],
    ]),
    "serial_staging": ("the first version's staging: the pass's 4 x nb gate rows one after another, from the ring", [
        [(_STAGE,
          "            for (int bb = 0; bb < nb; ++bb)\n"
          "              for (int g = 0; g < 4; ++g)\n"
          "                for (int i = tid - FIRST_STAGER; i < dhp / 4; i += STAGERS)\n"
          "                  reinterpret_cast<float4*>(sh_dp + (bb * 4 + g) * dhp)[i] =\n"
          "                      __ldcg(staged + (bb * 4 + g) * dhp / 4 + i);\n")],
    ]),
    "block_staging": ("the whole block stages, after a block barrier that waits for the gate threads' VJP", [
        [(_STAGERS_SYNC, "          }\n          __syncthreads();\n          {\n"),
         (_STAGE, "            stage(reinterpret_cast<float4*>(sh_dp), staged, nb * dhp, tid, THREADS);\n")],
    ]),
    "stage_loads_8": ("eight float4 loads a stager in flight, not four", [
        [("constexpr int STAGE_LOADS = 4;\n", "constexpr int STAGE_LOADS = 8;\n")],
    ]),
    "rows_4": ("the four-row kernel at B = 2, as the first version ran", [
        [("  const int64_t smem = slstm_bwd_smem_bytes(dh, resident, rows);\n",
          "  if (rows == 2) rows = BT;\n  const int64_t smem = slstm_bwd_smem_bytes(dh, resident, rows);\n")],
    ]),
    "unroll_1": ("the dot products' loop over resident r not unrolled, as in the first version", [
        [("#pragma unroll 2\n    for (int e = slice;", "#pragma unroll 1\n    for (int e = slice;")],
    ]),
}
SHAPE = dict(b=2, h=4, dh=512)  # xlstm-1.3b's training rows (t9): B = 2, 4 heads of 512


def variant_source(name: str, text: Optional[str] = None) -> Optional[str]:
    """``text`` (the shipped slstm_bwd.cu by default) with variant ``name``'s
    first applicable edits; None where none applies."""
    text = (CSRC / "slstm_bwd.cu").read_text() if text is None else text
    for edits in VARIANTS[name][1]:
        if all(text.count(old) == 1 for old, _ in edits):
            for old, new in edits:
                text = text.replace(old, new)
            return text
    return None


def has_ring(source: str) -> bool:
    """Whether the source's entry point takes the dpre exchange ring and the
    plan's rows; the first version's takes neither."""
    return "void* counters, void* ring" in source


def argtypes(source: str) -> list:
    if has_ring(source):
        return _build._SIGNATURES["repro_slstm_seq_bwd"]
    p, n = ctypes.c_void_p, ctypes.c_int64
    return [p] * 19 + [n] * 7 + [p]


def inputs(b: int, s: int, h: int, dh: int, gen: torch.Generator) -> tuple:
    """r transposed as the wrapper hands it over, the state (zero, as a
    training batch starts), the saving forward's tensors, a gradient of hs and
    zero final-state gradients (the final state is unused in training)."""
    wx = torch.randn((b, s, 4, h, dh), device="cuda", generator=gen)
    r = torch.randn((4, h, dh, dh), device="cuda", generator=gen) * dh**-0.5
    z = torch.zeros((b, h, dh), device="cuda")
    state = {"c": z, "n": z.clone(), "m": torch.full_like(z, -1e30), "h": z.clone()}
    _, hs, saved = slstm_seq_cuda(wx, r, state, save=True)
    dhs = torch.randn((b, s, h, dh), device="cuda", generator=gen)
    dfin = {k: torch.zeros_like(z) for k in ("c", "n", "m", "h")}
    return r, state, hs, saved, dhs, dfin


class Call:
    """One launch of a library's backward kernel as the wrapper makes it, with
    its outputs and scratch allocated once."""

    def __init__(self, lib: ctypes.CDLL, ring: bool, r, state, saved, dhs, dfin):
        b, s, _, h, dh = saved["pre"].shape
        self.lib, self.shape = lib, (b, s, h, dh)
        self.plan = slstm_bwd_plan(h, dh, s, *_build.device_limits(r.device), batch=b)
        self.rt = r.transpose(-1, -2).contiguous()
        self.ins = [saved[k] for k in ("pre", "c", "n", "m")] + [state[k] for k in ("c", "n", "m")] + [
            dhs, *(dfin[k] for k in ("h", "c", "n", "m"))]
        self.dwx = torch.empty_like(saved["pre"])
        self.d0 = {k: torch.empty_like(state[k]) for k in ("h", "c", "n", "m")}
        self.counters = torch.zeros(h, dtype=torch.int32, device=r.device)
        self.ring = torch.empty(self.plan.ring_floats, device=r.device) if ring else None

    def __call__(self) -> None:
        self.counters.zero_()
        b, s, h, dh = self.shape
        ring = () if self.ring is None else (self.ring.data_ptr(),)
        rows = () if self.ring is None else (self.plan.rows,)
        err = self.lib.repro_slstm_seq_bwd(
            self.rt.data_ptr(), *(t.data_ptr() for t in self.ins), self.dwx.data_ptr(),
            *(t.data_ptr() for t in self.d0.values()), self.counters.data_ptr(), *ring, b, s, h, dh,
            self.plan.blocks, self.plan.tiles_per_block, self.plan.resident, *rows,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"repro_slstm_seq_bwd: CUDA error {err}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--csrc", type=Path, default=CSRC, help="take slstm_bwd.cu and its headers from DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("slstm_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    _build.build()
    base = (args.csrc / "slstm_bwd.cu").read_text()
    tag = "shipped" if args.csrc.resolve() == CSRC.resolve() else "csrc"
    out = OUT / tag
    out.mkdir(parents=True, exist_ok=True)
    for header in args.csrc.glob("*.cuh"):  # a variant finds its source's headers beside it
        shutil.copy(header, out / header.name)
    sources = {tag: base}
    for name in VARIANTS:
        text = variant_source(name, base)
        if text is None:
            print(f"variant {name}: no edit applies to {args.csrc / 'slstm_bwd.cu'}; left out")
        else:
            sources[name] = text
    jobs = {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        jobs[name] = (out / f"{name}.cu", out / f"{name}.so")
    for name, log in compile_all(jobs, shared=True).items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    libs = {}
    for name, text in sources.items():
        lib = ctypes.CDLL(str(jobs[name][1]))
        lib.repro_slstm_seq_bwd.argtypes = argtypes(text)
        lib.repro_slstm_seq_bwd.restype = ctypes.c_int
        libs[name] = (lib, has_ring(text))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; " + ", ".join(f"{n}: {VARIANTS[n][0]}" for n in list(sources)[1:]), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, dh = SHAPE["b"], SHAPE["h"], SHAPE["dh"]
    ins = inputs(b, 1024, h, dh, gen)
    r, state, hs, saved, dhs, dfin = ins
    call = Call(*libs[tag], r, state, saved, dhs, dfin)
    call()
    dwx, _, d0 = slstm_seq_bwd_ref(*ins)
    ok = True
    for part, got, want in [("dwx", call.dwx, dwx)] + [(f"d{k}0", call.d0[k], d0[k]) for k in "hcnm"]:
        err = (got - want).abs().max().item()
        limit = 1e-4 * max(1.0, want.abs().max().item())
        ok &= err <= limit
        print(f"check {tag} {(b, 1024, 4, h, dh)} {part}: max_abs_err {err:.3e} limit {limit:.3e} "
              f"{'ok' if err <= limit else 'FAIL'}")
    ms = {}
    for s in (1024, 1):
        r, state, hs, saved, dhs, dfin = inputs(b, s, h, dh, gen)
        calls = {name: Call(lib, ring, r, state, saved, dhs, dfin) for name, (lib, ring) in libs.items()}
        order = list(calls)
        times = {name: [] for name in order}
        for name in order + order[::-1]:
            times[name].append(time_ms(calls[name], args.reps))
        ms[s] = {name: min(ts) for name, ts in times.items()}
        cells = ", ".join(f"{name} {' / '.join(f'{t:.4f}' for t in ts)}" for name, ts in times.items())
        print(f"time ({b}, {s}, 4, {h}, {dh}) ms: {cells}", flush=True)
    for name in libs:
        step_us = (ms[1024][name] - ms[1][name]) / 1023 * 1e3
        print(f"per step {name}: {step_us:.3f} us ((t(1024) - t(1)) / 1023, the faster of each pair)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
