"""qwen1.5-32b [dense]: 64L d5120 40H (GQA kv=40 = MHA) ff27392 v152064.

QKV bias (the Qwen1.5 signature). [hf Qwen/Qwen1.5-32B]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    # remat/scan boundary every 4 layers (halves stash vs per-layer scan)
    block_pattern=("attn",) * 4,
    head_dim=128,
    act="silu",
    glu=True,
    qkv_bias=True,
    rope_theta=1000000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen1.5-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab=128,
    head_dim=16,
    act="silu",
    glu=True,
    qkv_bias=True,
    dtype="float32",
    remat=False,
)
