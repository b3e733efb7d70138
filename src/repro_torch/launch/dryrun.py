"""Dry-run of every (arch x shape x mesh) cell on fake tensors: the port of ``repro.launch.dryrun``.

The JAX package lowers and compiles each cell's step on 256 or 512
placeholder CPU devices and reads XLA's memory and cost analyses. The port
runs eagerly, one process driving a mesh of positions, so "lower and
compile" becomes "run the step once on fake CUDA tensors under a counting
dispatch mode" (``launch/op_analysis.py``):

  * the training step, prefill or decode step runs under
    ``models.sharding.use_sharding`` on the production mesh of positions,
    all on ``cuda:0`` (16x16, or 2x16x16 for ``multi``), with zero device
    allocation; getting through proves the sharding config coherent on the
    port's model code;
  * the analysis gives per-device dot FLOPs by dtype, HBM bytes, collective
    operand bytes by kind, kernel launches and temporary memory, and the
    cell's layouts give the exact argument bytes per position;
  * ``launch/roofline.py`` turns them into three terms against one H100
    SXM 80GB at 700 W (data-sheet peaks, not a measurement).

It runs on the CPU (a PyTorch without CUDA gets a no-op CUDA device guard,
see ``op_analysis``) and on the card's host alike. A train cell's backward
runs only where PyTorch has CUDA (autograd asks for the device's stream);
on a CPU-only build its record says so.

Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json,
which ``launch/summarize.py`` reads.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper_tiny --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import obs
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, skip_reason
from repro_torch.core import autotune, compat
from repro_torch.core.backend import JIT_SAFE_KINDS, MatmulBackend
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import OpAnalysis, argument_bytes
from repro_torch.launch.roofline import HW, model_flops
from repro_torch.launch.specs import named_leaves, serve_cell_specs, train_cell_specs
from repro_torch.models import model as M
from repro_torch.models.sharding import DEFAULT_RULES, ShardingRules, use_sharding
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.train_step import make_train_step

__all__ = ["lower_cell", "run_cell", "save_result", "main", "TRAIN_ACCUM", "ACCUM_OVERRIDES",
           "OUT_DIR", "DEVICE"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch")
DEVICE = "cuda:0"  # every position's device: fake, so no card is needed

TRAIN_ACCUM = 8  # grad-accumulation microbatches for train cells
# Per-arch overrides: larger models need smaller microbatches to fit HBM.
ACCUM_OVERRIDES = {"qwen2_vl_72b": 16, "qwen1_5_32b": 16, "internlm2_20b": 16}

_CPU_TRAIN = ("train cell not traced: autograd's engine asks a PyTorch without CUDA for a stream "
              "of the fake cuda:0 tensors; trace it on the card's host")


def _ready_auto() -> None:
    """Kind ``auto`` decides from the card's calibrated cost model and first
    probes the fused kernel; both run real work, so they run here, on the
    card and before the trace (each cached for the process), never on fake
    tensors."""
    if not torch.cuda.is_available():
        raise RuntimeError("backend kind 'auto' calibrates on the card: run this cell on the card's host")
    autotune.get_calibration(DEVICE)
    compat.fused_leaf_mode(DEVICE)


def _mesh(kind: str):
    return make_production_mesh(multi_pod=(kind == "multi"), device=DEVICE)


def lower_cell(
    arch: str,
    shape_name: str,
    mesh_kind: str,
    *,
    backend: Optional[MatmulBackend] = None,
    rules: ShardingRules = DEFAULT_RULES,
    accum: int = TRAIN_ACCUM,
):
    """Trace one cell: returns (costs, memory, meta). ``costs`` is the
    step's ``op_analysis.OpCosts``, ``memory`` its argument and temporary
    bytes per position."""
    mesh = _mesh(mesh_kind)
    cfg = get_config(arch)
    if backend is not None:
        cfg = dataclasses.replace(cfg, matmul_backend=backend)
    if cfg.matmul_backend.kind == "auto":
        _ready_auto()
    shape = SHAPES[shape_name]
    chips = mesh.size

    with use_sharding(mesh, rules):
        if shape.kind == "train":
            opt_cfg = AdamWConfig()
            state, batch, state_sh, batch_sh = train_cell_specs(cfg, shape, mesh, opt_cfg, rules)
            # microbatch must stay >= the batch-shard count, or activations
            # fall back to replicated (divisibility rule) and per-device
            # work explodes.
            batch_shards = 1
            for ax in rules.rules.get("batch", ()):
                batch_shards *= mesh.shape.get(ax, 1)
            accum = max(1, min(accum, shape.global_batch // max(batch_shards, 1)))
            step = make_train_step(cfg, opt_cfg, accum_steps=accum)
            args = [(state, state_sh), (batch, batch_sh)]

            def run():
                step(state, batch)
        else:
            params, cache, batch, params_sh, cache_sh, batch_sh = serve_cell_specs(cfg, shape, mesh, rules)
            args = [(params, params_sh), (cache, cache_sh), (batch, batch_sh)]
            if shape.kind == "prefill":
                def run():
                    M.apply_prefill(params, batch, cache, cfg)
            else:
                def run():
                    M.apply_decode(params, batch["tokens"], cache, cfg, positions=batch.get("positions"))
        with OpAnalysis(chips=chips) as analysis:
            run()

    leaves, shardings = {}, {}
    for i, (tree, sh) in enumerate(args):
        leaves.update({f"{i}/{k}": v for k, v in named_leaves(tree).items()})
        shardings.update({f"{i}/{k}": v for k, v in sh.items()})
    costs = analysis.costs()
    memory = {
        "argument_size_in_bytes": argument_bytes(leaves, shardings),
        "temp_size_in_bytes": int(costs.temp_bytes),
        "peak_live_bytes_all_positions": costs.peak_live_bytes,
    }
    meta = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "chips": chips,
        "kind": shape.kind,
        "accum": accum if shape.kind == "train" else None,
        "backend": (backend.kind if backend else cfg.matmul_backend.kind),
    }
    return costs, memory, meta


def run_cell(
    arch: str,
    shape_name: str,
    mesh_kind: str,
    *,
    backend: Optional[MatmulBackend] = None,
    rules: ShardingRules = DEFAULT_RULES,
    accum: int = TRAIN_ACCUM,
    tag: str = "",
) -> Dict[str, Any]:
    """Trace one cell and extract all dry-run artifacts."""
    reason = skip_reason(arch, shape_name)
    if reason is None and SHAPES[shape_name].kind == "train" and torch.version.cuda is None:
        reason = _CPU_TRAIN
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "skipped": reason}

    tr = obs.get_tracer()
    span = tr.begin("dryrun.trace", cat="launch", arch=arch, shape=shape_name, mesh=mesh_kind)
    costs, memory, meta = lower_cell(
        arch, shape_name, mesh_kind, backend=backend, rules=rules, accum=accum
    )
    tr.end(span)
    t_trace = span.duration

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    chips = meta["chips"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = model_flops(cfg.param_count(), cfg.active_param_count(), tokens, shape.kind)
    terms = costs.roofline()
    global_flops = costs.dot_flops * chips
    return {
        **meta,
        "tag": tag,
        "trace_seconds": round(t_trace, 1),
        "hardware": dataclasses.asdict(HW),
        "memory": memory,
        "cost_analysis": {
            "flops_per_device": costs.dot_flops,
            "flops_by_dtype_per_device": costs.flops_by_dtype,
            "hbm_bytes_per_device": costs.hbm_bytes,
            "flops_global": global_flops,
            "busiest_position": costs.busiest,
            "busiest_pinned": costs.pinned,
            "unpinned_global": costs.unpinned,
            "aten_ops": costs.ops,
        },
        "collectives": costs.collectives(),
        "collectives_by_mesh_kind": costs.collective_by_kind,
        "launches": costs.launches,
        "model_flops": mf,
        "useful_fraction": (mf / global_flops) if global_flops else None,
        "roofline": terms,
        "tokens": tokens,
    }


def save_result(result: Dict[str, Any], out_dir: Optional[str] = None):
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    tag = f"__{result['tag']}" if result.get("tag") else ""
    name = f"{result['arch']}__{result['shape']}__{result['mesh']}{tag}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(result, f, indent=2, default=str)
    return os.path.join(out_dir, name)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every (arch x shape)")
    ap.add_argument(
        "--backend",
        choices=list(JIT_SAFE_KINDS),
        help="matmul routing, validated against the registered kinds; 'auto' "
        "resolves per shape from the card's calibrated cost model at trace time "
        "(--depth becomes the max depth; it calibrates on the card first)",
    )
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--min-dim", type=int, default=2048)
    ap.add_argument("--accum", type=int, default=TRAIN_ACCUM)
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument(
        "--trace-out", default="",
        help="enable obs tracing and write a Chrome/Perfetto trace here",
    )
    args = ap.parse_args(argv)
    if args.trace_out:
        obs.configure(enabled=True)

    backend = None
    if args.backend and args.backend != "naive":
        backend = MatmulBackend(kind=args.backend, depth=args.depth, min_dim=args.min_dim)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    failures = []
    for arch, shape in cells:
        for mesh_kind in meshes:
            tag = f"__{args.tag}" if args.tag else ""
            out_name = os.path.join(OUT_DIR, f"{arch}__{shape}__{mesh_kind}{tag}.json")
            if args.skip_existing and os.path.exists(out_name):
                print(f"[skip existing] {arch} {shape} {mesh_kind}")
                continue
            print(f"[dryrun] {arch} x {shape} x {mesh_kind} ...", flush=True)
            try:
                accum = (
                    ACCUM_OVERRIDES.get(arch, args.accum)
                    if args.accum == TRAIN_ACCUM
                    else args.accum
                )
                result = run_cell(arch, shape, mesh_kind, backend=backend, accum=accum, tag=args.tag)
                path = save_result(result)
                if result.get("skipped"):
                    print(f"  SKIPPED: {result['skipped']}")
                else:
                    r = result["roofline"]
                    print(
                        f"  ok in {result['trace_seconds']}s | "
                        f"compute {r['compute_s']:.3e}s memory {r['memory_s']:.3e}s "
                        f"collective {r['collective_s']:.3e}s -> {r['bottleneck']}"
                    )
                    mem = result["memory"]
                    print(
                        f"  mem/position: args {mem['argument_size_in_bytes'] / 2**30:.2f} GiB, "
                        f"temps {mem['temp_size_in_bytes'] / 2**30:.2f} GiB"
                    )
                print(f"  -> {path}")
            except Exception as e:
                failures.append((arch, shape, mesh_kind, repr(e)))
                print(f"  FAILED: {e}")
                traceback.print_exc()
    if args.trace_out:
        from repro_torch.obs import export

        export.write_trace(args.trace_out, metrics=obs.get_metrics())
        print(f"trace -> {args.trace_out}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall requested cells OK")


if __name__ == "__main__":
    main()
