#!/usr/bin/env python3
"""Read the numbers that decide ``correct``, to set their limits.

    python3 bench/calibrate.py --workload <name> --seeds 12 --controls 3 [--first-seed N]

In one process, at the cell's own sizes: the program's readings on
``--seeds`` seeds (the lower readings of the limits), the control's on
``--controls`` seeds (the reference one precision below the configuration's,
put in the program's place: the upper readings), and for training cells the
planted fault "half of each micro-batch's tokens left out, the mean taken
over the rest" on the same seeds. Prints one JSON line per reading and a
summary: each number's largest program reading and smallest control and
fault readings. The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def multiply_readings(cell, seed: int, control: bool, device) -> dict:
    from harness import multiply

    a, b = multiply.operands(cell.config, cell.traffic, seed, device)
    if control:
        from reference import matmul as ref

        prods = {p: (p, ref.control(a[p], b[p])) for p in range(a.shape[0])}
    else:
        from repro_torch.core.backend import matmul

        backend = multiply.backend_of(cell.config)
        prods = {p: (p, matmul(a[p], b[p], backend)) for p in range(a.shape[0])}
    errs = multiply.judge(a, b, prods)
    return {"rel_fro": max(f for f, _ in errs), "max_over_rms": max(e for _, e in errs)}


def train_readings(cell, seed: int, kinds: tuple, device) -> dict:
    import torch

    from harness import train

    model, traffic = cell.config["model"], cell.traffic
    out = {}
    got = None
    if "program" in kinds:
        state, step_fn, got = train.program_first_steps(model, traffic, seed, device)
        del state, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    want = train.reference_readings(model, traffic, seed, device)
    if got is not None:
        out["program"] = train.compare(got, want)
    if "control" in kinds:
        low = train.reference_readings(model, traffic, seed, device, fp8=True)
        out["control"] = train.compare(low, want)
    if "half_batch" in kinds:
        out["half_batch"] = train.compare(
            train.reference_readings(model, traffic, seed, device, half_batch=True), want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = ap.parse_args(argv)

    import torch

    from harness import spec

    cell = spec.cell(ROOT, args.workload)
    device = torch.device("cuda")
    kind = cell.traffic["kind"]
    summary: dict = {}

    def note(who: str, seed: int, values: dict):
        line = {"workload": args.workload, "who": who, "seed": seed, **values}
        print(json.dumps(line), flush=True)
        for name, v in values.items():
            key = (who, name)
            pick = max if who == "program" else min
            summary[key] = v if key not in summary else pick(summary[key], v)

    for i in range(max(args.seeds, args.controls)):
        seed = args.first_seed + i
        if kind == "multiply":
            if i < args.seeds:
                note("program", seed, multiply_readings(cell, seed, False, device))
            if i < args.controls:
                note("control", seed, multiply_readings(cell, seed, True, device))
        else:
            kinds = (("program",) if i < args.seeds else ()) + (
                ("control", "half_batch") if i < args.controls else ())
            for who, values in train_readings(cell, seed, kinds, device).items():
                note(who, seed, values)
        gc.collect()
        torch.cuda.empty_cache()
    for (who, name), v in sorted(summary.items()):
        print(f"summary {args.workload} {who} {name} {'max' if who == 'program' else 'min'} {v!r}")
    print(f"calibrate {args.workload} took {time.perf_counter() - T_START:.1f} s on "
          f"{torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
