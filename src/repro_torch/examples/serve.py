"""Continuous-batching serving demo: submit, stream, evict.

The port of ``examples/serve.py`` over the port's ``Engine``
(``launch/serve.py``'s engine): submits a handful of mixed-length requests
to the smoke config of ``--arch``, streams tokens as they arrive (a
per-token callback and the ``stream()`` iterator), cancels one request
mid-decode, and prints each request's latencies and the scheduler's pool
accounting. The default recurrentgemma config exercises the ring-buffer
local-attention cache and the RG-LRU state beside the paged full-attention
pool; whisper (the encoder-decoder arch) serves through
``Engine.generate``'s static batch on stub frames (``make_stub_frames``).
Parameters are random, drawn on the device from ``--seed``.

Run: ``python -m repro_torch.examples.serve [--arch phi4_mini_3_8b] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import model as M
from repro_torch.models.frontends import make_stub_frames
from repro_torch.serving.engine import Engine, ServeConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="recurrentgemma_9b", choices=list(ARCH_IDS))
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("repro_torch.examples.serve: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2

    cfg = get_smoke_config(args.arch)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed))
    engine = Engine(
        cfg,
        params,
        ServeConfig(
            max_seq=256,
            temperature=0.8,
            slots=3,  # decode bucket width: requests resident at once
            page_size=16,  # paged KV pool granularity (full-attention layers)
            sync_interval=4,  # host fetches tokens every 4 decode steps
        ),
        device=device,
    )
    rng = np.random.default_rng(args.seed)

    if cfg.is_encdec:
        # whisper: encoder-decoder serving runs the static batched path
        prompts = rng.integers(0, cfg.vocab, (4, 8))
        frames = make_stub_frames(cfg, 4, torch.Generator(device=device).manual_seed(args.seed),
                                  device=device)
        tokens, stats = engine.generate(prompts, args.new_tokens, frames=frames)
        print(f"arch={cfg.name} (encdec static path) generated {tuple(tokens.shape)}")
        print("stats:", stats)
        return 0

    t0 = time.perf_counter()

    def on_token(handle, event):
        if event.index == 0:
            print(f"  [{time.perf_counter() - t0:6.2f}s] req {event.request_id}: "
                  f"first token {event.token}")

    # mixed prompt/output lengths: the scheduler packs the decode bucket and
    # backfills slots as short requests finish
    handles = [
        engine.submit(
            rng.integers(0, cfg.vocab, size=int(rng.integers(4, 17))),
            args.new_tokens + int(rng.integers(0, 16)),
            on_token=on_token,
        )
        for _ in range(args.requests)
    ]
    victim = handles[-1]

    n_events = 0
    for _ in engine.stream(handles):
        n_events += 1
        if n_events == 10 and not victim.done:
            victim.cancel()  # mid-decode eviction: pages return to the pool
            print(f"  evicted req {victim.id} after {len(victim.tokens())} tokens")

    dt = time.perf_counter() - t0
    for h in handles:
        ttft, gaps = h.latency_stats()
        mean_tpot = float(np.mean(gaps)) if gaps else 0.0
        ttft_s = f"{ttft:.3f}s" if ttft is not None else "-"
        print(f"req {h.id}: {h.state.value:8s} reason={h.finish_reason:8s} "
              f"tokens={len(h.tokens()):3d} ttft={ttft_s} tpot={mean_tpot * 1e3:.1f}ms")
    print(f"\n{n_events} tokens streamed in {dt:.2f}s ({n_events / dt:.1f} tok/s "
          f"incl. first-call set-up)")
    st = engine.serve_stats()
    print(f"pool: {st.get('pages_in_use', 0)} pages in use / {st.get('page_budget', 0)} budget; "
          f"requests={st['requests']}; decode_steps={st['decode_steps']}")
    print("sample:", handles[0].tokens()[:16])
    return 0


if __name__ == "__main__":
    sys.exit(main())
