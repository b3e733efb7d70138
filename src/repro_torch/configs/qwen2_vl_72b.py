"""qwen2-vl-72b [vlm]: 80L d8192 64H (GQA kv=8) ff29568 v152064 — M-RoPE.

Vision frontend is a STUB: the backbone receives token ids plus (B, S, 3)
M-RoPE position triplets; dynamic resolution lives in the (stubbed) ViT.
[arXiv:2409.12191]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    # remat/scan boundary every 4 layers (halves stash vs per-layer scan)
    block_pattern=("attn",) * 4,
    head_dim=128,
    act="silu",
    glu=True,
    qkv_bias=True,
    rope_theta=1000000.0,
    mrope=True,
    mrope_sections=(16, 24, 24),
    frontend="vision_stub",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab=128,
    head_dim=16,
    act="silu",
    glu=True,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(4, 2, 2),
    frontend="vision_stub",
    dtype="float32",
    remat=False,
)
