"""gemma-7b [dense]: 28L d3072 16H (MHA kv=16) ff24576 v256000.

GeGLU, head_dim=256 (wider than d_model/heads). [arXiv:2403.08295]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab=256000,
    # remat/scan boundary every 4 layers (halves stash vs per-layer scan)
    block_pattern=("attn",) * 4,
    head_dim=256,
    act="gelu",
    glu=True,
    rope_theta=10000.0,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab=128,
    head_dim=32,  # wider-than-d_model/heads preserved
    act="gelu",
    glu=True,
    tie_embeddings=True,
    dtype="float32",
    remat=False,
)
