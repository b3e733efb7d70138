"""recurrentgemma-9b [hybrid]: 38L d4096 16H (MQA kv=1) ff12288 v256000.

Griffin layout — (RG-LRU, RG-LRU, local attention) repeating 1:2, local
window 2048, GeGLU MLPs. State is O(window) -> long_500k eligible.
[arXiv:2402.19427]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    act="gelu",
    glu=True,
    rope_theta=10000.0,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=2048,
    rnn_width=4096,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab=128,
    head_dim=16,
    act="gelu",
    glu=True,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=16,
    rnn_width=64,
    tie_embeddings=True,
    dtype="float32",
    remat=False,
)
