"""Carries state between the JAX package and the port.

Operands, model parameters and backend settings cross as numpy arrays and
plain dicts. :func:`params_from_jax` maps the JAX model's parameter tree
onto the port's state dict. ``torch.from_numpy`` rejects
ml_dtypes' ``bfloat16``, so bf16 crosses through an ``int16`` view of the
same bits. A backend crosses as the dict ``dataclasses.asdict`` makes of a
JAX ``MatmulBackend``; the port never imports the JAX class. A training
state crosses the same way: gradient and moment trees have the parameter
tree's shape, so :func:`params_from_jax` maps them too
(:func:`opt_state_from_jax`, :func:`train_state_from_jax`).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.backend import MatmulBackend
from repro_torch.models.config import ModelConfig

__all__ = ["tensor_from_numpy", "tensor_to_numpy", "backend_from_fields", "params_from_jax",
           "opt_state_from_jax", "train_state_from_jax"]


def tensor_from_numpy(arr: np.ndarray, device: torch.device | str = "cuda") -> torch.Tensor:
    """A tensor on ``device`` holding ``arr``'s values bit for bit."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes.bfloat16
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`tensor_from_numpy`: a host copy, bf16 as ml_dtypes.bfloat16.

    A bf16 tensor needs ml_dtypes, which the port's runtime neither imports
    nor needs (its host blocks stay torch tensors): this is a helper for the
    tests that hand results to the JAX package.
    """
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


def _flatten(tree: Dict[str, Any], prefix: str, out: Dict[str, Any], index=None) -> None:
    for name, sub in tree.items():
        key = f"{prefix}{name}"
        if isinstance(sub, dict):
            _flatten(sub, key + ".", out, index)
        else:
            out[key] = sub if index is None else sub[index]


def params_from_jax(
    params_np: Dict[str, Any], cfg: ModelConfig, device: torch.device | str = "cuda"
) -> Dict[str, torch.Tensor]:
    """The port's state dict from the JAX model's parameter tree, bit for bit.

    ``params_np`` is ``repro.models.model.init_params``'s tree with numpy
    leaves. The JAX decoder stacks layers into scan groups: leaf
    ``groups/pos{j}`` index ``g`` is layer ``g * period + j``, and
    ``tail[i]`` is layer ``n_groups * period + i``
    (``repro/models/transformer.py:139-180``). The port keeps the layers as
    one list, so they become ``layers.{i}.<name>``. The encoder-decoder
    tree keeps plain lists ``enc[i]`` and ``dec[i]``, which become
    ``enc.{i}.<name>`` and ``dec.{i}.<name>``.
    """
    if cfg.is_encdec:
        flat: Dict[str, Any] = {}
        _flatten({k: params_np[k] for k in ("embed", "enc_norm", "dec_norm")}, "", flat)
        for stack in ("enc", "dec"):
            for i, layer in enumerate(params_np[stack]):
                _flatten(layer, f"{stack}.{i}.", flat)
        return {k: tensor_from_numpy(np.array(v), device) for k, v in flat.items()}
    period = len(cfg.block_pattern)
    n_groups = cfg.n_layers // period
    flat: Dict[str, Any] = {}
    _flatten({"embed": params_np["embed"], "final_norm": params_np["final_norm"]}, "", flat)
    for j in range(period if "groups" in params_np else 0):
        for g in range(n_groups):
            _flatten(params_np["groups"][f"pos{j}"], f"layers.{g * period + j}.", flat, g)
    for i, layer in enumerate(params_np.get("tail", [])):
        _flatten(layer, f"layers.{n_groups * period + i}.", flat)
    return {k: tensor_from_numpy(np.array(v), device) for k, v in flat.items()}


def opt_state_from_jax(opt_np, cfg: ModelConfig, device: torch.device | str = "cuda"):
    """The port's ``OptState`` from a JAX ``OptState`` (step, m, v) with numpy
    leaves: the moments keyed like the port's parameters, bit for bit."""
    from repro_torch.optim.adamw import OptState

    step, m, v = opt_np
    return OptState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
        m=params_from_jax(m, cfg, device),
        v=params_from_jax(v, cfg, device),
    )


def train_state_from_jax(state_np, cfg: ModelConfig, device: torch.device | str = "cuda"):
    """The port's ``TrainState`` from a JAX ``TrainState`` (params, opt) with
    numpy leaves: a model of ``cfg`` holding the JAX parameters bit for bit,
    trainable, and the optimizer state of :func:`opt_state_from_jax`."""
    from repro_torch.models import model as M
    from repro_torch.training.train_step import TrainState

    params_np, opt_np = state_np
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    params.load_state_dict(params_from_jax(params_np, cfg, device))
    for p in params.parameters():
        p.requires_grad_(True)
    return TrainState(params=params, opt=opt_state_from_jax(opt_np, cfg, device))
