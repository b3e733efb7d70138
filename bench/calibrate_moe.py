#!/usr/bin/env python3
"""Read the numbers that decide ``correct`` in a ``train_moe`` cell, to set
its limits.

    python3 bench/calibrate_moe.py --workload <name> --seeds 12 --controls 3 [--first-seed N]

``calibrate.py`` for traffic kind ``train_moe``, in one process, at the
cell's own sizes: the program's readings on ``--seeds`` seeds (the lower
readings of the limits); on ``--controls`` seeds the control's (the
reference in fp8 e4m3, one precision below bf16, put in the program's
place) and two planted faults': ``half_batch`` (half of each micro-batch's
tokens left out of the mean) and ``drop`` (the assignments past a capacity
factor of 1.25 dropped, as the port's capacity route drops them). Prints
one JSON line per reading (``drop``'s with the share of the held
assignments it dropped over its steps) and a summary: each number's
largest program reading and smallest control and fault readings. The benchmark's own runs
never run this.
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

DROP_CAPACITY = 1.25


def readings(cell, seed: int, kinds: tuple, device) -> dict:
    """{who: the compared numbers} for ``kinds`` of program, control,
    half_batch and drop, each against the reference on ``seed``."""
    import torch

    from harness import train_moe

    model, traffic = cell.config["model"], cell.traffic
    out, got = {}, None
    if "program" in kinds:
        state, step_fn, got = train_moe.program_first_steps(model, traffic, seed, device)
        del state, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    want = train_moe.reference_readings(model, traffic, seed, device)
    if got is not None:
        out["program"] = train_moe.compare(got, want)
    planted = {"control": {"fp8": True}, "half_batch": {"half_batch": True},
               "drop": {"capacity": DROP_CAPACITY}}
    for who, how in planted.items():
        if who in kinds:
            low = train_moe.reference_readings(model, traffic, seed, device, **how)
            out[who] = train_moe.compare(low, want)
            if "drop_share" in low:
                out[who]["drop_share"] = low["drop_share"]
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
    if cell.traffic["kind"] != "train_moe":
        raise SystemExit(f"{args.workload} is of kind {cell.traffic['kind']}: use calibrate.py")
    device = torch.device("cuda")
    summary: dict = {}
    for i in range(max(args.seeds, args.controls)):
        seed = args.first_seed + i
        kinds = (("program",) if i < args.seeds else ()) + (
            ("control", "half_batch", "drop") if i < args.controls else ())
        for who, values in readings(cell, seed, kinds, device).items():
            print(json.dumps({"workload": args.workload, "who": who, "seed": seed, **values}),
                  flush=True)
            pick = max if who == "program" else min
            for name, v in values.items():
                key = (who, name)
                summary[key] = v if key not in summary else pick(summary[key], v)
        gc.collect()
        torch.cuda.empty_cache()
    for (who, name), v in sorted(summary.items()):
        print(f"summary {args.workload} {who} {name} {'max' if who == 'program' else 'min'} {v!r}")
    print(f"calibrate {args.workload} took {time.perf_counter() - T_START:.1f} s on "
          f"{torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
