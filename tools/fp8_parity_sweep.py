#!/usr/bin/env python3
"""How far an fp8 KV cache lets the port's logits drift from the JAX package's.

Usage, from the root of a checkout with jax and torch (CPU is enough)::

    JAX_PLATFORMS=cpu python3 tools/fp8_parity_sweep.py [--seeds N] [--arch A ...]

For each arch (smoke configs with ``cache_dtype="float8_e4m3fn"``; by default
phi4 and recurrentgemma), prompt length (7, and 21, which wraps
recurrentgemma's 16-token ring) and seed, it runs ``fp8_parity`` of
``tests/test_torch_models.py``: a prefill and 3 greedy decode steps through
both packages in fp32, the JAX cache loaded into the port's before each step.
It prints one line per case (per comparison: the largest logit difference
relative to the largest reference logit, the cached elements that flipped,
and ``!`` where the caches lie more than one e4m3 ulp apart), then, for the
comparisons that an e4m3 flip can reach and for the others, how many lie
above 1e-4 and the largest difference; the cases that fail the test's checks;
and the smallest of the cases' largest differences. These readings back the
test's ``FP8_FLIP_LIMIT``; run on a copy with one of the port's fp8 roundings
left out, the last two show whether the test catches it. Exits non-zero if a
case fails.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import test_torch_models as T  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=72)
    ap.add_argument("--arch", nargs="+", default=["phi4_mini_3_8b", "recurrentgemma_9b"])
    args = ap.parse_args()
    worst = {True: 0.0, False: 0.0}
    over = {True: 0, False: 0}
    n, failed, case_max = 0, 0, []
    for arch in args.arch:
        models = T._models(arch, cache_dtype=T.FP8)
        for prompt in (7, 21):
            for seed in range(args.seeds):
                toks = np.random.default_rng([seed, prompt]).integers(0, models[0].vocab, (2, prompt))
                readings = T.fp8_parity(models, toks)
                for r in readings:
                    n += 1
                    worst[r["reachable"]] = max(worst[r["reachable"]], r["err"])
                    over[r["reachable"]] += r["err"] > 1e-4
                failed += not all(T.fp8_reading_holds(r) for r in readings)
                case_max.append(max(r["err"] for r in readings))
                print(arch, prompt, seed, " ".join(
                    f"{r['err']:.2e}/{r['flips']}{'' if r['cache_within_ulp'] else '!'}"
                    for r in readings), flush=True)
    for reach in (True, False):
        print(f"{'reachable' if reach else 'unreachable'} by a flip: {over[reach]} comparisons "
              f"above 1e-4, largest {worst[reach]:.3e}")
    print(f"{n} comparisons in {len(case_max)} cases; {failed} cases fail the test's checks; "
          f"smallest case maximum {min(case_max):.3e}; FP8_FLIP_LIMIT {T.FP8_FLIP_LIMIT}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
