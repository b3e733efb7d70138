"""Plain PyTorch versions of the matmul kernels (the JAX oracles' counterparts).

They compute in fp32 with TF32 off and round once to the input dtype, as
``repro.kernels.matmul.ref`` does with ``precision="highest"``. The wrappers
use them for CPU tensors; ``chip_smoke.py`` holds the kernels against them.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import matmul_precision


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with matmul_precision("highest"):
        return torch.matmul(a.float(), b.float()).to(a.dtype)


def batched_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with matmul_precision("highest"):
        return torch.bmm(a.float(), b.float()).to(a.dtype)
