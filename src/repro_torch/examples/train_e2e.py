"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps.

The port of ``examples/train_e2e.py``, over
``repro_torch.launch.train.train_loop``: a scaled phi4-family decoder
(~100M parameters with its 32k vocab) on the synthetic Zipf+motif pipeline;
the loss falls as the model learns the motif structure, and the run fails
unless the last loss is below the first. With ``--ckpt-dir`` it checkpoints
every 50 steps (atomic, keep-last-3) and auto-resumes: kill it mid-run and
rerun to see the restart. It runs on the card unless given ``--device cpu``.

Full run (a few hundred steps, ~100M parameters):
  python -m repro_torch.examples.train_e2e --steps 300
CI-scale run (~8M parameters):
  python -m repro_torch.examples.train_e2e --ci --steps 120
Strassen-backend run (the paper's technique in the training path):
  python -m repro_torch.examples.train_e2e --ci --backend strassen
Autotuned run: every projection resolves from the calibrated dispatcher, and
the summary JSON records the measured step-time delta against the
hand-picked (naive) backend:
  python -m repro_torch.examples.train_e2e --ci --backend auto --out run.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from repro_torch.core import autotune
from repro_torch.core.backend import MatmulBackend
from repro_torch.launch.train import autotune_step_delta, train_loop
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig

FULL_100M = ModelConfig(
    name="repro-100m", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
    d_ff=2048, vocab=32768, act="silu", glu=True,
    rope_theta=10000.0, tie_embeddings=True,
    dtype="float32", remat=False,
)

CI_8M = dataclasses.replace(
    FULL_100M, name="repro-8m", n_layers=4, d_model=256, n_heads=8,
    n_kv_heads=4, d_ff=704, vocab=4096,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ci", action="store_true", help="8M-param CI-scale config")
    ap.add_argument(
        "--backend", choices=["naive", "strassen", "winograd", "auto"], default="naive",
        help="'auto' sets ModelConfig(matmul_autotune=True): every dense "
        "projection resolves from the calibrated dispatcher",
    )
    ap.add_argument(
        "--compare-steps", type=int, default=20,
        help="with --backend auto: steps of the hand-picked baseline run "
        "used to measure the step-time delta (0 = skip)",
    )
    ap.add_argument("--ckpt-dir", default=None, help="checkpoint here every 50 steps and resume")
    ap.add_argument("--out", default=None, help="write run summary JSON here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("repro_torch.examples.train_e2e: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2

    cfg = CI_8M if args.ci else FULL_100M
    handpicked_cfg = cfg  # config-default backend, the comparison baseline
    if args.backend == "auto":
        # the flag (not a hand-built backend) drives the rewrite, so the run
        # exercises exactly what users toggle
        cfg = dataclasses.replace(
            cfg,
            matmul_autotune=True,
            matmul_backend=MatmulBackend(kind="auto", depth=2, min_dim=256),
        )
    elif args.backend != "naive":
        cfg = dataclasses.replace(
            cfg, matmul_backend=MatmulBackend(kind=args.backend, depth=1, min_dim=256)
        )
    n_params = cfg.param_count()
    print(f"config {cfg.name}: ~{n_params/1e6:.1f}M params, backend={args.backend}, device={args.device}")

    opt = AdamWConfig(
        lr=args.lr, warmup_steps=max(args.steps // 20, 10), total_steps=args.steps
    )
    run_stats = {}
    _, history = train_loop(
        cfg, opt,
        steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, save_every=50, log_every=10,
        stats_out=run_stats, device=args.device,
    )
    print(f"loss: first={history[0]:.4f} min={min(history):.4f} last={history[-1]:.4f}")

    summary = {
        "config": cfg.name,
        "params": n_params,
        "backend": args.backend,
        "loss": history,
        "median_step_time_s": run_stats.get("median_step_time_s"),
    }
    if args.backend == "auto" and args.compare_steps > 0:
        summary.update(
            autotune_step_delta(
                handpicked_cfg, opt,
                auto_step_time=run_stats.get("median_step_time_s", 0.0),
                steps=args.compare_steps, batch=args.batch, seq=args.seq, device=args.device,
            )
        )
        summary["autotune_kinds"] = autotune.get_telemetry().kind_counts()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
        print(f"wrote {args.out}")
    if not history[-1] < history[0]:
        raise AssertionError("loss must decrease")
    return 0


if __name__ == "__main__":
    sys.exit(main())
