"""olmoe-1b-7b [moe]: 16L d2048 16H (kv=16) expert_ff=1024 v50304, 64e top-8.

64 routed experts, top-8, no shared experts. [arXiv:2409.02060]

``CONFIG`` and ``SMOKE_CONFIG`` are the JAX package's (its parity tests
use them). ``TRAIN_CONFIG`` is the model as published and trained
(allenai/OLMoE-1B-7B-0924 ``config.json``): RMSNorm over the whole q and k
projections, the top-8 gates not renormalised (``norm_topk_prob`` false),
dropless routing, RMSNorm eps 1e-5. ``share(cfg, rank, ranks)`` is one
chip's share of ``ranks``-way expert parallelism. ``TRAIN_SMOKE_CONFIG`` is
its CPU-test size: 16 experts, top-4.
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab=50304,
    # remat/scan boundary every 4 layers (halves stash vs per-layer scan)
    block_pattern=("attn",) * 4,
    head_dim=128,
    act="silu",
    glu=True,
    rope_theta=10000.0,
    n_experts=64,
    top_k=8,
    d_expert=1024,
)

SMOKE_CONFIG = ModelConfig(
    name="olmoe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=128,
    head_dim=16,
    act="silu",
    glu=True,
    n_experts=8,
    top_k=2,
    d_expert=32,
    capacity_factor=2.0,
    dtype="float32",
    remat=False,
)

TRAIN_CONFIG = dataclasses.replace(
    CONFIG, norm_eps=1e-5, qk_norm=True, norm_topk_prob=False, moe_dropless=True)

TRAIN_SMOKE_CONFIG = dataclasses.replace(
    SMOKE_CONFIG, name="olmoe-train-smoke", n_experts=16, top_k=4, norm_eps=1e-5, qk_norm=True,
    norm_topk_prob=False, moe_dropless=True)


def share(cfg: ModelConfig, rank: int, ranks: int) -> ModelConfig:
    """EP rank ``rank``'s layer of ``ranks``: experts [rank * E / ranks, ...)."""
    held = cfg.n_experts // ranks
    return dataclasses.replace(cfg, experts_held=held, expert_first=rank * held)
