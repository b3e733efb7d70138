"""Architecture registry: the 10 assigned archs (a copy of ``repro.configs``).

Each <arch>.py exports CONFIG (the exact published configuration) and
SMOKE_CONFIG (a reduced same-family config for CPU tests). These are plain
data: a family the port does not run yet fails when its model is built
(``repro_torch.models.transformer``), not here. Input shapes
(train_4k / prefill_32k / decode_32k / long_500k) are defined here because
they are shared by every LM architecture.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

from repro_torch.models.config import ModelConfig

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "Shape",
    "get_config",
    "get_smoke_config",
    "list_archs",
    "cell_is_runnable",
    "skip_reason",
]

ARCH_IDS: Tuple[str, ...] = (
    "phi4_mini_3_8b",
    "internlm2_20b",
    "qwen1_5_32b",
    "gemma_7b",
    "olmoe_1b_7b",
    "qwen2_moe_a2_7b",
    "xlstm_1_3b",
    "whisper_tiny",
    "qwen2_vl_72b",
    "recurrentgemma_9b",
)


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).SMOKE_CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def list_archs() -> List[str]:
    return list(ARCH_IDS)


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    """Why an (arch x shape) dry-run cell is skipped, or None if runnable.

    Policy (DESIGN.md §Arch-applicability):
      * long_500k requires sub-quadratic context handling -> only the SSM
        (xlstm) and hybrid (recurrentgemma, whose attention is a 2048-token
        local window) archs run it.
    """
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.name == "long_500k":
        kinds = set(cfg.layer_kinds())
        if "attn" in kinds or cfg.is_encdec:
            return "long_500k skipped: full-attention arch (quadratic KV cache)"
    return None


def cell_is_runnable(arch: str, shape_name: str) -> bool:
    return skip_reason(arch, shape_name) is None
