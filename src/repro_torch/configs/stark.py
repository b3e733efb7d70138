"""The paper's own workload configs: square matmuls 4096..16384.

The port of ``repro.configs.stark`` (the same tables, on
``repro_torch.core.backend.MatmulBackend``). They size the examples and the
Strassen phases of ``chip_smoke.py``. Depth is the paper's p - q (recursion
levels); the paper's partition count b = 2**depth.
"""
import dataclasses
from typing import Tuple

from repro_torch.core.backend import MatmulBackend


@dataclasses.dataclass(frozen=True)
class StarkWorkload:
    n: int                      # matrix side (paper: 2^p)
    depth: int                  # recursion levels (paper: p - q)
    scheme: str = "strassen"    # strassen | winograd | naive8
    fused: bool = False         # beyond-paper fused last level (strassen1 kernel)

    @property
    def partitions(self) -> int:
        return 2**self.depth


# Paper §V sizes, and the smaller set the examples and tests run first.
PAPER_SIZES: Tuple[int, ...] = (4096, 8192, 16384)
BENCH_SIZES: Tuple[int, ...] = (256, 512, 1024, 2048)
PARTITIONS: Tuple[int, ...] = (2, 4, 8, 16, 32)

DEFAULT = StarkWorkload(n=1024, depth=2)

BACKENDS = {
    "naive": MatmulBackend(kind="naive"),
    "stark": MatmulBackend(kind="strassen", depth=2, min_dim=256),
    "stark_winograd": MatmulBackend(kind="winograd", depth=2, min_dim=256),
    "stark_fused": MatmulBackend(kind="strassen_fused", depth=2, min_dim=256),
}
