"""phi4-mini-3.8b [dense]: 32L d3072 24H (GQA kv=8) ff8192 v200064.

RoPE + SwiGLU + GQA. [arXiv:2412.08905; hf microsoft/Phi-4-mini-instruct]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200064,
    # remat/scan boundary every 4 layers (halves stash vs per-layer scan)
    block_pattern=("attn",) * 4,
    head_dim=128,
    act="silu",
    glu=True,
    rope_theta=10000.0,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="phi4-mini-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=192,
    vocab=128,
    head_dim=16,
    act="silu",
    glu=True,
    rope_theta=10000.0,
    tie_embeddings=True,
    dtype="float32",
    remat=False,
)
