"""olmoe-1b-7b [moe]: 16L d2048 16H (kv=16) expert_ff=1024 v50304, 64e top-8.

64 routed experts, top-8, no shared experts. [arXiv:2409.02060]
"""
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
