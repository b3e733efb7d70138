"""Fault-tolerant checkpointing: atomic writes, manifests, keep-last-k; the
port of ``repro.runtime.checkpoint``.

Layout: ``<dir>/step_<n>/`` holds one ``.npy`` file per leaf and
``manifest.json``, which names each leaf's file, dtype, shape and sha256
digest. Writes go to a temporary directory that is renamed into place, so a
crash mid-write never corrupts the latest checkpoint (restore scans for the
newest complete manifest). :func:`load_pytree` re-hashes every file and
raises :class:`CheckpointError` on a digest mismatch, a torn or incomplete
manifest, a missing file or a missing leaf, before it writes anything.

A tree is a tensor, a dict (string keys), a list, a tuple or NamedTuple, or
an ``nn.Module`` (its state dict), nested. numpy has no bf16, and the port
imports no ``ml_dtypes``: a bf16 leaf is stored as its bits, a uint16 array.
Where the JAX package returns new arrays, :func:`load_pytree` copies the
checkpoint into the template's tensors in place and returns the template: a
training state on the card has no room for a second copy.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.obs import tracer as obs_tracer

__all__ = ["CheckpointError", "CheckpointManager", "save_pytree", "load_pytree"]

_MANIFEST = "manifest.json"


class CheckpointError(RuntimeError):
    """A checkpoint is missing, torn, partial, or fails digest verification."""


def _digest_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return "sha256:" + h.hexdigest()


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, paths joined by '/' (a module's own
    state-dict names keep their dots)."""
    def join(key) -> str:
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, nn.Module):
        return [(join(k), v) for k, v in tree.state_dict(keep_vars=True).items()]
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        raise TypeError(f"checkpoint leaf {prefix!r} is a {type(tree).__name__}, not a tensor")
    out: List[Tuple[str, torch.Tensor]] = []
    for key, sub in items:
        out += _flatten_with_paths(sub, join(key))
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_pytree(tree, directory: str, *, step: int, extra: Optional[Dict] = None) -> str:
    """Atomic save of a tree; returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=directory)
    span = obs_tracer.get_tracer().begin("ckpt.save", cat="runtime", track="runtime", step=step)
    try:
        leaves, nbytes = {}, 0
        for i, (key, leaf) in enumerate(_flatten_with_paths(tree)):
            arr = _to_numpy(leaf)
            name = f"{i:05d}.npy"
            np.save(os.path.join(tmp, name), arr)
            nbytes += arr.nbytes
            leaves[key] = {
                "file": name,
                "dtype": str(leaf.dtype).removeprefix("torch."),
                "shape": list(leaf.shape),
                "digest": _digest_file(os.path.join(tmp, name)),
            }
        manifest = {
            "step": step,
            "time": time.time(),
            "n_arrays": len(leaves),
            "devices": torch.cuda.device_count() if torch.cuda.is_available() else 0,
            "leaves": leaves,
            "extra": extra or {},
            "complete": True,
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        obs_tracer.get_tracer().end(span, n_arrays=len(leaves), bytes=nbytes)
        return final
    except BaseException:
        obs_tracer.get_tracer().end(span, failed=True)
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _read_manifest(path: str) -> Dict:
    manifest_path = os.path.join(path, _MANIFEST)
    if not os.path.exists(manifest_path):
        raise CheckpointError(f"checkpoint {path}: missing {_MANIFEST}")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (ValueError, json.JSONDecodeError) as e:
        raise CheckpointError(f"checkpoint {path}: torn manifest ({e})") from e
    if not manifest.get("complete"):
        raise CheckpointError(
            f"checkpoint {path}: manifest not marked complete (partial or interrupted write)"
        )
    return manifest


def load_pytree(template, path: str):
    """Load a checkpoint into ``template``'s tensors, in place; returns the template.

    Every leaf of the template must be in the manifest with its file, the
    same shape and dtype, and (when the manifest carries digests; checkpoints
    without them still load) a file whose sha256 matches. All of that is
    verified before any tensor is written: any violation raises
    :class:`CheckpointError` naming the failure and leaves the template as
    it was.
    """
    with obs_tracer.get_tracer().span(
        "ckpt.load", cat="runtime", track="runtime", path=os.path.basename(path)
    ):
        leaves = _read_manifest(path).get("leaves", {})
        plan = []
        for key, leaf in _flatten_with_paths(template):
            entry = leaves.get(key)
            if entry is None:
                raise CheckpointError(
                    f"checkpoint {path}: payload missing array {key!r} (partial checkpoint?)"
                )
            file = os.path.join(path, entry["file"])
            if not os.path.exists(file):
                raise CheckpointError(f"checkpoint {path}: missing {entry['file']} ({key!r})")
            want = entry.get("digest")
            if want is not None and _digest_file(file) != want:
                raise CheckpointError(
                    f"checkpoint {path}: digest mismatch for {key!r} ({entry['file']}) "
                    "-- corrupt checkpoint"
                )
            saved = (tuple(entry["shape"]), entry["dtype"])
            have = (tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."))
            if saved != have:
                raise CheckpointError(
                    f"checkpoint {path}: {key!r} saved as {saved}, template {have}"
                )
            plan.append((key, leaf, file, entry["dtype"]))
        arrays = []
        for key, leaf, file, dtype_name in plan:
            try:
                arr = np.load(file)
            except (ValueError, OSError) as e:
                raise CheckpointError(f"checkpoint {path}: unreadable {file} ({e})") from e
            arrays.append(_from_numpy(arr, dtype_name))
        with torch.no_grad():
            for (_key, leaf, _file, _dtype), t in zip(plan, arrays):
                leaf.copy_(t)
        return template


@dataclasses.dataclass
class CheckpointManager:
    """save-every / keep-last-k / resume-latest policy around save/load."""

    directory: str
    save_every: int = 100
    keep_last: int = 3

    def maybe_save(self, tree, step: int, extra: Optional[Dict] = None) -> Optional[str]:
        if step % self.save_every:
            return None
        path = save_pytree(tree, self.directory, step=step, extra=extra)
        self._gc()
        return path

    def _steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        out = []
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name, _MANIFEST)
            if name.startswith("step_") and os.path.exists(full):
                try:
                    with open(full) as f:
                        if json.load(f).get("complete"):
                            out.append(int(name.split("_")[1]))
                except (ValueError, json.JSONDecodeError):
                    continue  # torn manifest -> not a valid checkpoint
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, template) -> Tuple[Optional[int], Any]:
        """(step, template loaded in place) of the newest complete checkpoint,
        or (None, template)."""
        step = self.latest_step()
        if step is None:
            return None, template
        path = os.path.join(self.directory, f"step_{step:08d}")
        return step, load_pytree(template, path)

    def manifest(self, step: int) -> Dict:
        with open(os.path.join(self.directory, f"step_{step:08d}", _MANIFEST)) as f:
            return json.load(f)

    def _gc(self):
        steps = self._steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
