"""Logical axes of every parameter, optimizer moment, cache entry and batch
input, and the sharding tree they give on a mesh.

The rule half of ``repro.launch.specs``: the same ordered regex tables,
matched with ``re.search`` against a leaf's path, so one table covers raw
parameters, the optimizer's moments (the same tails under ``m/`` and
``v/``) and the caches. A leaf's path is its name in the port with ``.``
turned into ``/`` (``layers/3/mixer/wq/w``). The port does not stack
layers into scan groups, so its leaf's logical axes are the JAX package's
for the stacked leaf without the leading ``None``.

The cell half (:func:`train_cell_specs`, :func:`serve_cell_specs`) gives a
dry-run cell's arguments: the training state, or the parameters and the
serving cache, and the batch, as fake tensors on the mesh's device
(``launch/op_analysis.py``'s ``fake_mode``: no allocation), with their
sharding trees. The JAX package's are ``ShapeDtypeStruct`` stand-ins of
the same shapes and dtypes.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.mesh import Mesh
from repro_torch.launch.op_analysis import fake_mode, to_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import DEFAULT_RULES, NamedSharding, ShardingRules, note
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.training.train_step import TrainState

__all__ = [
    "param_logical_axes",
    "cache_logical_axes",
    "batch_logical_axes",
    "sharding_tree",
    "place",
    "named_leaves",
    "path_of",
    "train_cell_specs",
    "serve_cell_specs",
]

# (regex matched with .search against the path, logical axes for the BASE
# (unstacked) shape). Order matters: first hit wins.
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"embed/unembedding$", ("fsdp", "vocab")),
    (r"embed/embedding$", ("vocab", "fsdp")),
    (r"w(q|k|v)/w$", ("fsdp", "heads")),
    (r"w(q|k|v)/b$", ("heads",)),
    (r"wo/w$", ("heads", "fsdp")),  # attention out OR mlstm output gate (D, dv)
    (r"wo/b$", ("heads",)),
    (r"(wi|wf)/w$", ("fsdp", None)),
    (r"(wi|wf)/b$", (None,)),
    (r"(up|gate|in_gate|in_rec|wa|wx)/w$", ("fsdp", "d_ff")),
    (r"(up|gate|in_gate|in_rec|wa|wx)/b$", ("d_ff",)),
    (r"down/w$", ("d_ff", "fsdp")),
    (r"down/b$", (None,)),
    (r"out/w$", ("d_ff", "fsdp")),  # mlstm/slstm/rglru output proj (wide, D)
    (r"out/b$", (None,)),
    (r"router/w$", (None, "experts")),
    (r"w_(gate|up)$", ("experts", "fsdp", "d_ff")),
    (r"w_down$", ("experts", "d_ff", "fsdp")),
    (r"mixer/w/w$", ("fsdp", None, None, "state")),  # slstm input proj
    (r"mixer/w/b$", (None, None, "state")),
    (r"mixer/r$", (None, None, "state", None)),  # slstm recurrent (4,H,dh,dh)
    (r"conv_w$", (None, "d_ff")),
    (r"conv_b$", ("d_ff",)),
    (r"lam$", ("d_ff",)),
    (r"(scale|bias)$", None),  # norms: replicate (None * ndim)
)

_CACHE_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"(^|/)pos$", ()),
    (r"/(k|v)$", ("batch", "kv_heads", "cache_seq", None)),
    (r"/C$", ("batch", None, "state", None)),  # mlstm matrix memory (B,H,dk,dv)
    (r"/n$", ("batch", None, "state")),
    (r"/m$", ("batch", None)),
    (r"/c$", ("batch", None, "state")),  # slstm
    (r"/h$", None),  # slstm (B,H,dh) / rglru (B,W): resolved by ndim below
    (r"/conv$", ("batch", None, "state")),
)


def path_of(name: str) -> str:
    """A leaf's path from its dotted name in the port (``layers.3.mixer.wq.w``)."""
    return name.replace(".", "/")


def _match(rules, path: str, shape: Tuple[int, ...]) -> Tuple[Optional[str], ...]:
    ndim = len(shape)
    base_ndim = ndim - 1 if "groups/" in path else ndim  # a scan-stacked leaf
    for pattern, axes in rules:
        if re.search(pattern, path):
            if axes is None:
                if pattern == r"/h$":  # slstm (B,H,dh) vs rglru (B,W)
                    axes = ("batch", None, "state") if base_ndim == 3 else ("batch", "state")
                else:
                    return (None,) * ndim
            if len(axes) < ndim:  # leading layer-group dims replicate
                return (None,) * (ndim - len(axes)) + tuple(axes)
            if len(axes) != ndim:
                raise ValueError(f"rule {pattern!r} gives {axes} for {path} of shape {shape}")
            return tuple(axes)
    return (None,) * ndim


def param_logical_axes(path: str, shape: Tuple[int, ...]) -> Tuple[Optional[str], ...]:
    return _match(_PARAM_RULES, path, shape)


def cache_logical_axes(path: str, shape: Tuple[int, ...]) -> Tuple[Optional[str], ...]:
    return _match(_CACHE_RULES, path, shape)


def batch_logical_axes(name: str, shape: Tuple[int, ...]) -> Tuple[Optional[str], ...]:
    return ("batch",) + (None,) * (len(shape) - 1)


def named_leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every tensor of ``tree`` by its path: an ``nn.Module``'s parameters by
    their names, a mapping's or a NamedTuple's (``TrainState``, ``OptState``)
    entries by key or field, a list's by index, nested; tensors are the
    leaves."""
    if isinstance(tree, torch.Tensor):
        return {prefix.rstrip("/"): tree}
    if isinstance(tree, nn.Module):
        return {prefix + path_of(k): v for k, v in tree.named_parameters()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        raise TypeError(f"no leaves in {type(tree).__name__} at {prefix!r}")
    out: Dict[str, torch.Tensor] = {}
    for key, sub in items:
        out.update(named_leaves(sub, f"{prefix}{path_of(str(key))}/"))
    return out


def sharding_tree(
    tree,
    mesh: Mesh,
    logical_fn: Callable[[str, Tuple[int, ...]], Tuple[Optional[str], ...]],
    rules: ShardingRules = DEFAULT_RULES,
) -> Dict[str, NamedSharding]:
    """Each leaf's layout on ``mesh``, by path (see :func:`named_leaves`):
    the spec its logical axes give, divisible shardings only."""
    out = {}
    for path, leaf in named_leaves(tree).items():
        shape = tuple(leaf.shape)
        out[path] = NamedSharding(mesh, rules.spec(mesh, logical_fn(path, shape), shape))
    return out


def place(tree, mesh: Mesh, rules: ShardingRules = DEFAULT_RULES) -> Dict[str, NamedSharding]:
    """A parameter tree's or a training state's layouts on ``mesh``
    (:func:`sharding_tree` by :func:`param_logical_axes`), each recorded on
    the mesh. The tensors stay global, as every tensor between ops does."""
    specs = sharding_tree(tree, mesh, param_logical_axes, rules)
    for sh in specs.values():
        note(mesh, sh.spec)
    return specs


# ------------------------------------------------------------------ cells


def _batch_specs(cfg: ModelConfig, shape, *, with_labels: bool, device) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": torch.empty((b, s), dtype=torch.int32, device=device)}
    if with_labels:
        specs["labels"] = torch.empty((b, s), dtype=torch.int32, device=device)
    if cfg.frontend == "audio_stub":
        specs["frames"] = torch.empty((b, cfg.enc_seq, cfg.d_model), dtype=getattr(torch, cfg.dtype),
                                      device=device)
    if cfg.mrope:
        specs["positions"] = torch.empty((b, s, 3), dtype=torch.int32, device=device)
    return specs


def _fake_params(cfg: ModelConfig, device):
    """The model's parameters as fake tensors on ``device``: drawn on the CPU
    (a CUDA generator needs a card), then given fake tensors on ``device``."""
    return to_device(M.init_params(cfg, torch.Generator().manual_seed(0)), device)


def train_cell_specs(
    cfg: ModelConfig,
    shape,
    mesh: Mesh,
    opt_cfg: AdamWConfig,
    rules: ShardingRules = DEFAULT_RULES,
):
    """(state, batch, state_shardings, batch_shardings): a trainable state
    and a batch with labels, fake, on the mesh's device."""
    with fake_mode():
        params = _fake_params(cfg, mesh.device)
        for p in params.parameters():
            p.requires_grad_(True)
        state = TrainState(params=params, opt=init_opt_state(params, opt_cfg))
        batch = _batch_specs(cfg, shape, with_labels=True, device=mesh.device)
    state_sh = sharding_tree(state, mesh, param_logical_axes, rules)
    batch_sh = sharding_tree(batch, mesh, batch_logical_axes, rules)
    return state, batch, state_sh, batch_sh


def serve_cell_specs(
    cfg: ModelConfig,
    shape,
    mesh: Mesh,
    rules: ShardingRules = DEFAULT_RULES,
):
    """Specs for prefill (full seq) or decode (1 token + cache of seq_len):
    (params, cache, batch, params_sh, cache_sh, batch_sh), fake, on the
    mesh's device."""
    b, s = shape.global_batch, shape.seq_len
    device = mesh.device
    with fake_mode():
        params = _fake_params(cfg, device)
        cache = M.init_cache(cfg, b, s, device=device)
        if shape.kind == "prefill":
            batch = _batch_specs(cfg, shape, with_labels=False, device=device)
        else:  # decode: one new token; an encoder context needs no frames (cross-KV cached)
            batch = {"tokens": torch.empty((b, 1), dtype=torch.int32, device=device)}
            if cfg.mrope:
                batch["positions"] = torch.empty((b, 1, 3), dtype=torch.int32, device=device)
    params_sh = sharding_tree(params, mesh, param_logical_axes, rules)
    cache_sh = sharding_tree(cache, mesh, cache_logical_axes, rules)
    batch_sh = sharding_tree(batch, mesh, batch_logical_axes, rules)
    return params, cache, batch, params_sh, cache_sh, batch_sh
