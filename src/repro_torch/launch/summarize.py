"""Summarize dry-run JSONs into tables: the port of ``repro.launch.summarize``.

The columns are the reference's; the last is the seconds the trace took
(``trace_seconds``), where the reference shows its compile seconds.

Usage: PYTHONPATH=src python -m repro_torch.launch.summarize [--mesh single] [--md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch")
HEADER = ["arch", "shape", "mesh", "compute_s", "memory_s", "collective_s",
          "bottleneck", "useful_frac", "HBM_GiB/dev", "trace"]


def load(mesh: str, tag: str = ""):
    cells = []
    suffix = f"__{tag}" if tag else ""
    for path in sorted(glob.glob(os.path.join(DRYRUN_DIR, f"*__{mesh}{suffix}.json"))):
        base = os.path.basename(path)[: -len(".json")]
        parts = base.split("__")
        if (len(parts) == 3) != (not tag):
            continue
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def fmt_row(c, md=False):
    sep = " | " if md else "  "
    if c.get("skipped"):
        return sep.join([c["arch"], c["shape"], c["mesh"], "SKIP: " + c["skipped"]])
    r = c["roofline"]
    mem = c.get("memory", {})
    hbm = (mem.get("argument_size_in_bytes", 0) + mem.get("temp_size_in_bytes", 0)) / 2**30
    uf = c.get("useful_fraction")
    cols = [
        c["arch"], c["shape"], c["mesh"],
        f"{r['compute_s']:.2e}", f"{r['memory_s']:.2e}", f"{r['collective_s']:.2e}",
        r["bottleneck"],
        f"{uf:.2f}" if uf is not None else "-",
        f"{hbm:.1f}",
        f"{c.get('trace_seconds', 0):.0f}s",
    ]
    return sep.join(cols)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args(argv)
    cells = load(args.mesh, args.tag)
    if args.md:
        print("| " + " | ".join(HEADER) + " |")
        print("|" + "---|" * len(HEADER))
        for c in cells:
            print("| " + fmt_row(c, md=True) + " |")
    else:
        print("  ".join(HEADER))
        for c in cells:
            print(fmt_row(c))


if __name__ == "__main__":
    main()
