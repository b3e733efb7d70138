"""xlstm-1.3b [ssm]: 48L d2048 4H ff=0 v50304 — mLSTM + sLSTM blocks.

xLSTM[7:1] layout: 7 mLSTM blocks per sLSTM block. Recurrent state is O(1)
in sequence length -> long_500k eligible. [arXiv:2405.04517]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    rope_theta=0.0,
    block_pattern=(
        "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm",
    ),
    mlstm_qk_dim=1024,
    mlstm_v_dim=2048,
)

SMOKE_CONFIG = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=128,
    rope_theta=0.0,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    mlstm_qk_dim=32,
    mlstm_v_dim=64,
    dtype="float32",
    remat=False,
)
