"""Peak rates of one NVIDIA H100 SXM 80GB at its 700 W limit, frozen.

The numbers of NVIDIA's data sheet (dense, no sparsity), as
``src/repro_torch/launch/roofline.py``'s ``Hardware`` holds them: fp32 67e12
FLOP/s on the CUDA cores, TF32 495e12, bf16 and fp16 989e12 on the tensor
cores, fp8 1979e12, HBM3 3.35e12 B/s. A card set below 700 W runs slower
under load, so every share is printed beside the card's power limit
(:func:`power_limit`).
"""
from __future__ import annotations

import subprocess
from typing import Optional

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "float16": 989e12,
              "float8_e4m3fn": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, dtype: str, nbytes: float) -> float:
    """The roofline's least time: the larger of the compute and the memory bound."""
    return max(ops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
