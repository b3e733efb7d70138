#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as the last line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port (``src/repro_torch``). The run loads and warms up (``setup_s``,
from this process's start), measures for ``--seconds``, with ``--trace 1``
profiles a few steps more, compares what the window produced with the plain
reference, prints each number compared beside its limit on standard error
and the JSON result on standard output. It exits with 2, printing no
result, without a CUDA device or with fewer than the cell asks for, and
with 3 if JAX, Flax or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# Every build and kernel cache at a fixed path inside the checkout; the
# port's own CUDA build lives in build/repro_torch/<hash>/ beside them.
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = str(ROOT / "build" / "bench_cache" / _sub)
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import runner, spec

    cell = spec.cell(ROOT, args.workload)
    print(f"imports done at {time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = runner.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                             "cuda", T_START)
    if result is None:
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
