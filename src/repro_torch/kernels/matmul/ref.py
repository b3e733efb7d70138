"""Plain PyTorch versions of the matmul kernels (the JAX oracles' counterparts).

They compute in fp32 with TF32 off and round once to ``out_dtype`` (a's
dtype by default), as ``repro.kernels.matmul.ref`` does with
``precision="highest"``. The wrappers
use them for CPU tensors; ``chip_smoke.py`` holds the kernels against them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.precision import matmul_precision
from repro_torch.kernels.common import out_dtype_of


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    dtype = out_dtype_of(out_dtype, a)
    with matmul_precision("highest"):
        return torch.matmul(a.float(), b.float()).to(dtype)


def batched_matmul_ref(
    a: torch.Tensor, b: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    dtype = out_dtype_of(out_dtype, a)
    with matmul_precision("highest"):
        return torch.bmm(a.float(), b.float()).to(dtype)
