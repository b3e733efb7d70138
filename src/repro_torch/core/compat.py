"""Whether the fused Strassen kernel runs on a device: the port's leaf-mode gate.

The JAX package asks ``repro.core.compat.pallas_leaf_mode()`` whether its
Pallas leaf compiles (on a TPU), runs interpreted (on the CPU) or is broken,
and the autotuner enumerates ``strassen_fused`` candidates only where it
runs. Here the device decides, as it decides for every kernel wrapper:

* ``"plain"``: a CPU device, where ``strassen1_matmul_cuda`` computes its
  plain PyTorch version (the role of interpret mode on the JAX side);
* ``"compiled"``: a CUDA device on which the kernel was built and launched
  once, with the right result.

A failed build or launch on the card raises: it is a fault of the build,
not a reason to drop the kernel's candidates. ``"none"`` is a value callers
test for (a cache warmed where the kernel ran must not route to it where it
cannot); no device returns it today.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["fused_leaf_mode"]


@functools.lru_cache(None)
def _probe_cuda(device: torch.device) -> str:
    from repro_torch.kernels.strassen.strassen import strassen1_matmul_cuda

    x = torch.ones((1, 4, 128, 128), device=device)
    out = strassen1_matmul_cuda(x, x)
    # Quadrants of ones make a 256 x 256 matrix of ones, whose square is 256.
    if not bool(torch.all(out == 256.0)):
        raise RuntimeError(f"the strassen1 kernel gave a wrong product on {device}")
    return "compiled"


def fused_leaf_mode(device: str | torch.device = "cuda") -> str:
    """How the fused Strassen kernel runs on ``device``: 'plain' or 'compiled'.

    On a CUDA device the first call builds the kernels and launches
    ``strassen1`` once on a (1, 4, 128, 128) input; a build or launch failure
    raises. A successful probe is cached per device.
    """
    device = torch.device(device)
    if device.type == "cpu":
        return "plain"
    if device.type != "cuda":
        raise ValueError(f"no fused Strassen kernel for device {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _probe_cuda(device)
