"""internlm2-20b [dense]: 48L d6144 48H (GQA kv=8) ff16384 v92544.

GQA. [arXiv:2403.17297; hf internlm/internlm2-20b]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92544,
    # remat/scan boundary every 4 layers (halves stash vs per-layer scan)
    block_pattern=("attn",) * 4,
    head_dim=128,
    act="silu",
    glu=True,
    rope_theta=1000000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="internlm2-smoke",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=1,
    d_ff=256,
    vocab=128,
    head_dim=16,
    act="silu",
    glu=True,
    dtype="float32",
    remat=False,
)
