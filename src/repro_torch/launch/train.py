"""Training launcher: config -> data -> train step -> checkpoint loop; the port
of ``repro.launch.train``, with its flags plus ``--device``.

It runs on the card unless asked for the CPU:

  python -m repro_torch.launch.train --arch phi4_mini_3_8b --smoke --steps 50 \\
      --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu
  python -m repro_torch.launch.train --arch phi4_mini_3_8b --steps 8 --batch 2 --seq 1024
  python -m repro_torch.launch.train --arch phi4_mini_3_8b --smoke --steps 4 --batch 4 \
      --seq 32 --mesh --positions 8 --model-parallel 2 --device cpu

The loop auto-resumes from the newest complete checkpoint, and the straggler
watchdog forces a checkpoint and a stop (exit code 75) on a sustained
slowdown. Parameters are random, drawn on the device from ``seed``. The step
runs eagerly: the flash and RMSNorm forward and backward kernels on the card.
``--mesh`` trains on a (data, model) mesh of ``--positions`` positions
(``launch/mesh.py:make_mesh_for``; by default one per visible card): the
state's layouts come from ``launch/specs.py:sharding_tree`` and the step runs
under ``models.sharding.use_sharding``, so every projection, attention core
and expert FFN runs once per position with its collectives counted in
``mesh.traffic``. The positions of one card share it: physical bytes are 0.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import torch

from repro_torch import obs
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.backend import JIT_SAFE_KINDS, MatmulBackend
from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_for_host
from repro_torch.launch.mesh import format_traffic, launcher_mesh
from repro_torch.launch.specs import batch_logical_axes, place
from repro_torch.models.sharding import DEFAULT_RULES, constrain, use_sharding
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.checkpoint import CheckpointManager, save_pytree
from repro_torch.runtime.elastic import StragglerMonitor
from repro_torch.training.train_step import init_train_state, make_train_step

# Clean exit for "checkpointed and stopped on sustained straggler": the job
# supervisor restarts the run instead of treating it as a crash (EX_TEMPFAIL).
STRAGGLER_EXIT_CODE = 75


def build(cfg, opt_cfg, *, batch, seq, accum, mesh=None, rules=DEFAULT_RULES, seed=0,
          device="cuda"):
    """Returns (state, pipeline, step) on ``device``.

    With a ``mesh`` (positions on ``device``) the state's layouts
    (``launch/specs.py:place``) are recorded on the mesh and kept as
    ``step.specs`` (path -> NamedSharding). The state stays global, as every
    tensor between ops does. The step runs under
    ``use_sharding(mesh, rules)`` with the batch constrained by
    ``batch_logical_axes``, as the JAX step's input shardings are.
    """
    data = SyntheticLM(cfg, DataConfig(batch=batch, seq_len=seq, seed=seed), device=device)
    state = init_train_state(cfg, opt_cfg, torch.Generator(device=device).manual_seed(seed))
    step = make_train_step(cfg, opt_cfg, accum_steps=accum)
    if mesh is None:
        return state, data, step
    specs = place(state, mesh, rules)

    def sharded_step(state, batch):
        with use_sharding(mesh, rules):
            batch = {name: constrain(x, *batch_logical_axes(name, tuple(x.shape)))
                     for name, x in batch.items()}
            return step(state, batch)

    sharded_step.specs = specs
    return state, data, sharded_step


def train_loop(
    cfg,
    opt_cfg,
    *,
    steps,
    batch,
    seq,
    accum=1,
    mesh=None,
    ckpt_dir=None,
    save_every=50,
    log_every=10,
    seed=0,
    stats_out=None,
    stop_on_straggler=False,
    device="cuda",
    data_cycle=0,
):
    """Run the training loop; returns (state, loss history).

    ``stats_out``: optional dict filled with run measurements:
    median_step_time_s, steps_run, and each executed step's ``grad_norm``.

    ``stop_on_straggler``: when the watchdog flags a sustained slowdown,
    force-save a checkpoint (whatever ``save_every`` says) and stop the loop
    cleanly; the flag's evidence lands in ``stats_out['straggler']`` so the
    launcher can exit with :data:`STRAGGLER_EXIT_CODE`. Off, the flag is
    logged and training continues.

    ``data_cycle``: when > 0, step i trains on batch ``i % data_cycle`` (a
    model that learns shows it by memorizing them); 0 draws a new batch
    each step.
    """
    state, data, step_fn = build(
        cfg, opt_cfg, batch=batch, seq=seq, accum=accum, mesh=mesh, seed=seed, device=device
    )
    start = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, save_every=save_every, keep_last=3)
        resumed, state = mgr.restore_latest(state)
        if resumed is not None:
            start = resumed
            print(f"[resume] from step {resumed}")

    watchdog = StragglerMonitor()
    history, grad_norms = [], []
    with use_sharding(mesh, DEFAULT_RULES) if mesh is not None else contextlib.nullcontext():
        for step_i in range(start, steps):
            watchdog.start_step()
            state, metrics = step_fn(state, data(step_i % data_cycle if data_cycle else step_i))
            loss = float(metrics["loss"])  # waits for the step
            flagged = watchdog.end_step()
            history.append(loss)
            grad_norms.append(float(metrics["grad_norm"]))
            if step_i % log_every == 0 or step_i == steps - 1:
                print(
                    f"step {step_i:5d} loss {loss:.4f} gnorm {grad_norms[-1]:.3f} "
                    f"lr {float(metrics['lr']):.2e} ({watchdog.median_step_time*1e3:.0f} ms/step)",
                    flush=True,
                )
            if mgr:
                mgr.maybe_save(state, step_i + 1, extra={"loss": loss})
            if flagged:
                reason = watchdog.flag_reason()
                print(
                    f"[straggler] sustained slowdown (step/median x{reason['median']:.2f}, "
                    f"streak {reason['streak']}) -- checkpoint + restart advised"
                )
                if stop_on_straggler:
                    if ckpt_dir:
                        save_pytree(state, ckpt_dir, step=step_i + 1,
                                    extra={"loss": loss, "straggler": reason})
                        print(f"[straggler] checkpointed step {step_i + 1}; stopping")
                    if stats_out is not None:
                        stats_out["straggler"] = reason
                    break
                if mgr:
                    mgr.maybe_save(state, step_i + 1, extra={"straggler": True})
    if stats_out is not None:
        stats_out["median_step_time_s"] = watchdog.median_step_time
        stats_out["steps_run"] = len(history)  # executed, not planned
        stats_out["grad_norm"] = grad_norms
    return state, history


def autotune_step_delta(
    baseline_cfg,
    opt_cfg,
    *,
    auto_step_time,
    steps,
    batch,
    seq,
    accum=1,
    mesh=None,
    device="cuda",
):
    """Measure the autotuned-vs-hand-picked step-time delta.

    Runs a short baseline segment on ``baseline_cfg`` (the hand-picked
    backend; same shapes, no checkpointing) and returns the summary-JSON
    fields: step_time_handpicked_s, step_time_delta_s and, when the baseline
    measured, step_time_delta_pct.
    """
    base_stats = {}
    train_loop(
        baseline_cfg, opt_cfg,
        steps=steps, batch=batch, seq=seq, accum=accum, mesh=mesh,
        ckpt_dir=None, log_every=max(steps, 1), stats_out=base_stats, device=device,
    )
    base_t = base_stats.get("median_step_time_s", 0.0)
    out = {
        "step_time_handpicked_s": base_t,
        "step_time_delta_s": auto_step_time - base_t,
    }
    if base_t:
        out["step_time_delta_pct"] = 100.0 * (auto_step_time - base_t) / base_t
    print(
        f"[autotune] step time {auto_step_time*1e3:.1f} ms vs hand-picked "
        f"{base_t*1e3:.1f} ms ({out.get('step_time_delta_pct', 0.0):+.1f}%)"
    )
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train a repro_torch model on synthetic tokens.")
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--mesh", action="store_true",
                    help="train on a (data, model) mesh of positions")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--positions", type=int, default=None,
                    help="mesh positions (the forced device count of the JAX launcher); "
                    "default: the visible cards, 1 on the CPU")
    ap.add_argument(
        "--backend", choices=list(JIT_SAFE_KINDS), default="naive",
        help="matmul routing, validated against the registered kinds; 'auto' sets "
        "matmul_autotune=True so every dense projection resolves from the calibrated "
        "dispatcher (--strassen-depth becomes the max depth it may pick); "
        "strassen_fused has no gradient and raises",
    )
    ap.add_argument("--strassen-depth", type=int, default=1)
    ap.add_argument("--strassen-min-dim", type=int, default=1024)
    ap.add_argument(
        "--compare-steps", type=int, default=0,
        help="with --backend auto: also run this many steps on the hand-picked "
        "(config default) backend and record the measured step-time delta in the summary JSON",
    )
    ap.add_argument(
        "--no-exit-on-straggler", action="store_true",
        help="keep training through a straggler flag instead of checkpointing and "
        "exiting with code 75 for a supervised restart",
    )
    ap.add_argument("--summary-out", default=None,
                    help="write a run-summary JSON (loss, step time, backend, autotune "
                    "telemetry) here")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace of the run here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("repro_torch.launch.train: no CUDA device; pass --device cpu to train on the CPU",
              file=sys.stderr)
        return 2
    if args.trace_out:
        obs.configure(enabled=True)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    baseline_cfg = cfg  # the hand-picked backend, for --compare-steps
    if args.backend == "auto":
        cfg = dataclasses.replace(
            cfg,
            matmul_autotune=True,
            matmul_backend=MatmulBackend(
                kind="auto", depth=max(args.strassen_depth, 1), min_dim=args.strassen_min_dim,
            ),
        )
    elif args.backend != "naive":
        cfg = dataclasses.replace(
            cfg,
            matmul_backend=MatmulBackend(
                kind=args.backend, depth=args.strassen_depth, min_dim=args.strassen_min_dim
            ),
        )
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps)
    mesh = launcher_mesh(args, device)

    per_host = shard_for_host(args.batch)
    run_stats = {}
    t0 = time.time()
    _, history = train_loop(
        cfg, opt_cfg,
        steps=args.steps, batch=per_host, seq=args.seq, accum=args.accum, mesh=mesh,
        ckpt_dir=args.ckpt_dir, save_every=args.save_every, stats_out=run_stats,
        stop_on_straggler=not args.no_exit_on_straggler, device=device,
    )
    dt = time.time() - t0
    if history:
        print(f"done: {len(history)} steps in {dt:.1f}s; loss {history[0]:.3f} -> {history[-1]:.3f}")
    else:
        print(f"done: no steps to run (resumed at or past step {args.steps})")

    summary = {
        "arch": args.arch,
        "backend": args.backend,
        "steps": args.steps,
        "wall_s": dt,
        "loss_first": history[0] if history else None,
        "loss_last": history[-1] if history else None,
        **run_stats,
    }
    if args.backend == "auto":
        from repro_torch.core import autotune

        summary["autotune"] = {
            "kinds": autotune.get_telemetry().kind_counts(),
            "calibration": autotune.calibration_snapshot(device),
        }
        if args.compare_steps > 0:
            summary.update(
                autotune_step_delta(
                    baseline_cfg, opt_cfg,
                    auto_step_time=run_stats.get("median_step_time_s", 0.0),
                    steps=args.compare_steps, batch=per_host, seq=args.seq,
                    accum=args.accum, mesh=mesh, device=device,
                )
            )
    if args.summary_out:
        with open(args.summary_out, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"wrote {args.summary_out}")
    if args.trace_out:
        from repro_torch.obs import export

        export.write_trace(args.trace_out, metrics=obs.get_metrics())
        print(f"wrote {args.trace_out}")
    if mesh is not None:
        print(f"mesh traffic: {format_traffic(mesh)}")
    if "straggler" in run_stats:
        return STRAGGLER_EXIT_CODE
    return 0


if __name__ == "__main__":
    sys.exit(main())
