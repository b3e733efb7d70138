"""whisper-tiny [audio]: 4+4L d384 6H ff1536 v51865 — enc-dec backbone.

Conv/mel frontend is a STUB: input_specs provides (B, 1500, 384) frame
embeddings. LayerNorm + plain-GELU MLPs, tied output head, sinusoidal
positions (no RoPE). [arXiv:2212.04356]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,          # decoder layers
    enc_layers=4,
    enc_seq=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    act="gelu",
    glu=False,
    norm="layernorm",
    norm_eps=1e-5,
    rope_theta=0.0,
    tie_embeddings=True,
    frontend="audio_stub",
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    enc_layers=2,
    enc_seq=24,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=128,
    head_dim=16,
    act="gelu",
    glu=False,
    norm="layernorm",
    norm_eps=1e-5,
    rope_theta=0.0,
    tie_embeddings=True,
    frontend="audio_stub",
    dtype="float32",
    remat=False,
)
