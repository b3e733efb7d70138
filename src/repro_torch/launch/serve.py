"""Serving launcher: the port's continuous-batching engine, and whisper's static path.

The port of ``repro.launch.serve``, with its flags plus ``--device``. It runs
on the card unless asked for the CPU:

  python -m repro_torch.launch.serve --arch phi4_mini_3_8b --full
  python -m repro_torch.launch.serve --arch xlstm_1_3b --full
  python -m repro_torch.launch.serve --arch xlstm_1_3b --device cpu --smoke
  python -m repro_torch.launch.serve --arch olmoe_1b_7b --full
  python -m repro_torch.launch.serve --arch recurrentgemma_9b --device cpu --smoke
  python -m repro_torch.launch.serve --arch whisper_tiny --device cpu --smoke
  python -m repro_torch.launch.serve --backend auto --trace-out trace.json --device cpu
  python -m repro_torch.launch.serve --mesh --positions 8 --model-parallel 2 --device cpu

Every family is served: the decoder-only ones (the dense decoders, the MoE
models olmoe-1b-7b and qwen2-moe-a2.7b, xlstm-1.3b and recurrentgemma-9b)
through the request API, and the encoder-decoder whisper-tiny, on stub audio
frames made on the device, through ``Engine.generate``'s static batch.

Parameters are random, drawn on the device from ``--seed`` in the config's
dtype. ``--backend auto`` routes every projection through the autotune
dispatcher; ``--trace-out`` writes a Chrome/Perfetto trace of the run's spans
(the ``autotune.resolve`` and ``backend.matmul`` spans among them).
``--mesh`` serves on a (data, model) mesh of ``--positions`` positions (by
default one per visible card): the parameters' layouts come from
``launch/specs.py:sharding_tree`` and the engine runs under
``models.sharding.use_sharding``, so every projection, attention core and
expert FFN runs once per position, its collectives counted in
``mesh.traffic`` (printed at the end). On one card the positions share it.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch import obs
from repro_torch.core.backend import JIT_SAFE_KINDS, MatmulBackend
from repro_torch.launch.mesh import format_traffic, launcher_mesh
from repro_torch.launch.specs import place
from repro_torch.models import sharding
from repro_torch.models import model as M
from repro_torch.models.frontends import make_stub_frames
from repro_torch.obs import export
from repro_torch.serving.engine import Engine, ServeConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="phi4_mini_3_8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    # continuous-batching surface (ServeConfig)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode bucket width (requests resident at once)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page in the paged pool")
    ap.add_argument("--page-budget", type=int, default=0,
                    help="usable KV pages; 0 = slots * ceil(max_seq/page_size)")
    ap.add_argument("--admission", choices=["queue", "reject"], default="queue")
    ap.add_argument("--sync-interval", type=int, default=4,
                    help="decode steps between host<->device token syncs")
    ap.add_argument("--batching", choices=["continuous", "static"], default="continuous",
                    help="scheduler: continuous admits mid-decode; static "
                    "gang-schedules full batches (baseline)")
    ap.add_argument("--request-timeout", type=float, default=0.0,
                    help="per-request watchdog seconds; 0 disables")
    ap.add_argument("--mesh", action="store_true",
                    help="serve on a (data, model) mesh of positions")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--positions", type=int, default=None,
                    help="mesh positions (the forced device count of the JAX launcher); "
                    "default: the visible cards, 1 on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", choices=list(JIT_SAFE_KINDS), default=None,
                    help="matmul routing of every projection; 'auto' turns on "
                    "the autotune dispatcher")
    ap.add_argument("--strassen-depth", type=int, default=1)
    ap.add_argument("--strassen-min-dim", type=int, default=1024)
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome/Perfetto trace of the run here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("repro_torch.launch.serve: no CUDA device; pass --device cpu to serve on the CPU",
              file=sys.stderr)
        return 2
    if args.trace_out:
        obs.configure(enabled=True)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.backend:
        cfg = dataclasses.replace(
            cfg,
            matmul_backend=MatmulBackend(
                kind=args.backend, depth=max(args.strassen_depth, 1), min_dim=args.strassen_min_dim,
            ),
        )
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed))
    mesh = launcher_mesh(args, device)
    if mesh is not None:
        place(params, mesh)
    with sharding.use_sharding(mesh):
        code = _serve(args, cfg, params, device, t0)
    if mesh is not None:
        print(f"mesh traffic: {format_traffic(mesh)}")
    return code


def _serve(args, cfg, params, device: torch.device, t0: float) -> int:
    engine = Engine(
        cfg,
        params,
        ServeConfig(
            max_seq=args.max_seq,
            temperature=args.temperature,
            slots=args.slots,
            page_size=args.page_size,
            page_budget=args.page_budget,
            admission=args.admission,
            sync_interval=args.sync_interval,
            batching=args.batching,
            request_timeout_s=args.request_timeout,
        ),
        device=device,
    )
    print(f"arch={cfg.name} on {device}: parameters made in {time.perf_counter() - t0:.2f}s")
    prompts = np.random.default_rng(args.seed).integers(0, cfg.vocab, (args.batch, args.prompt_len))
    if cfg.frontend == "audio_stub":
        # encoder-decoder archs serve through the legacy batched path
        gen = torch.Generator(device=device).manual_seed(args.seed)
        frames = make_stub_frames(cfg, args.batch, gen, device=device)
        t0 = time.perf_counter()
        tokens, stats = engine.generate(prompts, args.new_tokens, frames=frames)
        dt = time.perf_counter() - t0
        n = tokens.shape[0] * tokens.shape[1]
        print(f"arch={cfg.name} generated {tuple(tokens.shape)} in {dt:.2f}s "
              f"({n / dt:.1f} tok/s incl. first-call set-up); stats={stats}")
        _write_trace(args.trace_out, engine)
        return 0
    # request API: submit the batch as independent requests (staggered
    # lengths) and let the scheduler pack the decode bucket
    t0 = time.perf_counter()
    handles = [engine.submit(prompts[i], args.new_tokens + (i % 3)) for i in range(args.batch)]
    n = len(list(engine.stream(handles)))
    dt = time.perf_counter() - t0
    for h in handles:
        ttft, _ = h.latency_stats()
        ttft_s = "n/a" if ttft is None else f"{ttft:.3f}s"
        print(f"  req {h.id}: {h.state.value} ({h.finish_reason}) "
              f"{len(h.tokens())} tokens, ttft={ttft_s}")
    print(f"arch={cfg.name} served {len(handles)} requests / {n} tokens "
          f"in {dt:.2f}s ({n / dt:.1f} tok/s incl. first-call set-up)")
    print(f"serve_stats: {engine.serve_stats()}")
    _write_trace(args.trace_out, engine)
    return 0


def _write_trace(path, engine: Engine) -> None:
    if path:
        export.write_trace(path, metrics=engine.metrics)
        st = engine.stats()["obs"]
        print(f"wrote {path} ({st['tracer']['spans']} spans, {len(st['metrics'])} metric series)")


if __name__ == "__main__":
    sys.exit(main())
