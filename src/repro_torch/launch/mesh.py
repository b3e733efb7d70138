"""Mesh construction for the launchers: the port of ``repro.launch.mesh``.

Functions, not module constants, so importing this module touches no
device. A mesh here is a :class:`repro_torch.core.mesh.Mesh` of positions:
on one card every position is ``cuda:0``, so ``n`` positions stand where
the JAX launchers get ``n`` devices from ``XLA_FLAGS``'s forced host device
count. The copies between positions are then counted as logical bytes and
move no physical byte.
"""
from __future__ import annotations

import torch

from repro_torch.core.mesh import Mesh, make_mesh

__all__ = ["make_production_mesh", "make_mesh_for", "launcher_mesh", "format_traffic"]


def make_production_mesh(*, multi_pod: bool = False, device: str | torch.device = "cuda") -> Mesh:
    """The production mesh: 16x16 per pod; 2 pods when multi_pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh_for(n_devices: int, model_parallel: int = 16,
                  device: str | torch.device = "cuda") -> Mesh:
    """Elastic variant: fit (data, model) to ``n_devices`` positions on ``device``."""
    from repro_torch.runtime.elastic import plan_mesh

    shape, axes = plan_mesh(n_devices, model_parallel=model_parallel)
    return make_mesh(shape, axes, device=device)


def launcher_mesh(args, device: torch.device):
    """The (data, model) mesh a launcher's ``--mesh`` asks for, or None:
    ``--positions`` positions (by default one per visible card, 1 on the
    CPU) with ``--model-parallel`` on the model axis, on ``device``."""
    if not args.mesh:
        return None
    n = args.positions or (torch.cuda.device_count() if device.type == "cuda" else 1)
    mesh = make_mesh_for(n, args.model_parallel, device=device)
    print(f"mesh: {dict(mesh.shape)} on {device}")
    return mesh


def format_traffic(mesh: Mesh) -> str:
    """The mesh's movements that carried bytes, one ``kind[axes] xcount`` entry each."""
    return ", ".join(
        f"{op}{list(axes)} x{t.count} {t.logical_bytes} B logical / {t.physical_bytes} B physical"
        for (op, axes), t in sorted(mesh.traffic.items()) if t.logical_bytes or t.physical_bytes
    ) or "none"
