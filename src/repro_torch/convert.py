"""Carries state between the JAX package and the port.

This system holds no weights: its state is the operands and the backend
configuration. Operands cross as numpy arrays. ``torch.from_numpy`` rejects
ml_dtypes' ``bfloat16``, so bf16 crosses through an ``int16`` view of the
same bits. A backend crosses as the dict ``dataclasses.asdict`` makes of a
JAX ``MatmulBackend``; the port never imports the JAX class.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.backend import MatmulBackend

__all__ = ["tensor_from_numpy", "tensor_to_numpy", "backend_from_fields"]


def tensor_from_numpy(arr: np.ndarray, device: torch.device | str = "cuda") -> torch.Tensor:
    """A tensor on ``device`` holding ``arr``'s values bit for bit."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes.bfloat16
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`tensor_from_numpy`: a host copy, bf16 as ml_dtypes.bfloat16."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def backend_from_fields(fields: Dict[str, Any]) -> MatmulBackend:
    """The port's MatmulBackend from ``dataclasses.asdict`` of a JAX one."""
    fields = dict(fields)
    if "schemes" in fields:
        fields["schemes"] = tuple(fields["schemes"])
    return MatmulBackend(**fields)
