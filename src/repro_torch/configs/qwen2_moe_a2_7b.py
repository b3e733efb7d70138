"""qwen2-moe-a2.7b [moe]: 24L d2048 16H (kv=16) expert_ff=1408 v151936.

60 routed experts top-4 + 4 shared experts. [hf Qwen/Qwen1.5-MoE-A2.7B]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab=151936,
    # remat/scan boundary every 4 layers (halves stash vs per-layer scan)
    block_pattern=("attn",) * 4,
    head_dim=128,
    act="silu",
    glu=True,
    qkv_bias=True,
    rope_theta=1000000.0,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    d_expert=1408,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-moe-smoke",
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
    qkv_bias=True,
    n_experts=6,
    top_k=2,
    n_shared_experts=2,
    d_expert=32,
    capacity_factor=2.0,
    dtype="float32",
    remat=False,
)
