"""Roofline terms of a dry-run cell against one H100: the port of ``repro.launch.roofline``.

Three terms per (arch x shape x mesh) cell, from the analysis of one traced
step (``launch/op_analysis.py``):

    compute    = sum over dtypes of flops_dtype / peak_flops[dtype]
    memory     = hbm_bytes        / hbm_bw
    collective = collective_bytes / ici_bw

``Hardware`` holds one H100 SXM 80GB at 700 W from NVIDIA's data sheet:
dense fp32 67e12 FLOP/s on the CUDA cores (the kernels' fp32 path; TF32
would change the result), dense bf16 and fp16 989e12 on the tensor cores,
fp8 1979e12, HBM3 3.35e12 B/s, and NVLink 4 450e9 B/s each way. Peaks are
kept per dtype, because one step mixes fp32 and bf16 work; a dtype the
table lacks is priced at fp32's rate. ``chip_smoke.py`` bounds every
kernel's time by the same numbers.

The collective term is a data-sheet figure that no run has measured: the
card this port runs on is one, and the positions of a mesh on it move
their bytes within its memory.

``collective_bytes`` sums the analysis's collective records under XLA's
kind names, as the reference's HLO parse does: ``psum`` is an all-reduce,
``all_gather`` an all-gather, ``psum_scatter`` a reduce-scatter, and a
fetch between layouts (``reshard``, :func:`repro_torch.core.mesh.fetch`) a
collective-permute of the bytes each position did not hold.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Tuple, Union

import torch

__all__ = [
    "HW",
    "Hardware",
    "KIND_NAMES",
    "collective_bytes",
    "roofline_terms",
    "model_flops",
    "bound_ms",
]


def _h100_peaks() -> Dict[str, float]:
    return {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
            "float8_e4m3fn": 1979e12, "float8_e5m2": 1979e12}


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "h100-sxm-80gb-700w"
    peak_flops: Mapping[str, float] = dataclasses.field(default_factory=_h100_peaks)  # dense, per dtype
    hbm_bw: float = 3.35e12  # bytes/s per card
    ici_bw: float = 450e9  # bytes/s per card, NVLink 4, each way

    def peak(self, dtype: Union[str, torch.dtype]) -> float:
        """The dense peak for ``dtype`` (a name or a torch dtype); fp32's where the table has none."""
        name = str(dtype).removeprefix("torch.")
        return self.peak_flops.get(name, self.peak_flops["float32"])


HW = Hardware()

# The mesh's movement names and the XLA collective each stands for.
KIND_NAMES = {
    "psum": "all-reduce",
    "all_gather": "all-gather",
    "psum_scatter": "reduce-scatter",
    "reshard": "collective-permute",
}
_COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def collective_bytes(records: Union[Mapping[str, float], Iterable[Tuple[str, float]]]) -> Dict[str, float]:
    """Operand bytes per XLA collective kind, and their ``total``, from the
    analysis's records: (mesh kind, bytes) pairs or a mapping of them."""
    items = records.items() if isinstance(records, Mapping) else records
    totals: Dict[str, float] = {k: 0 for k in _COLLECTIVE_OPS}
    for kind, nbytes in items:
        totals[KIND_NAMES[kind]] += nbytes
    totals["total"] = sum(totals[k] for k in _COLLECTIVE_OPS)
    return totals


def model_flops(param_count: int, active_param_count: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference fwd), N = active params."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * active_param_count * tokens


def roofline_terms(
    *,
    hlo_flops: Union[float, Mapping[str, float]],
    hlo_bytes: float,
    coll_bytes: float,
    chips: int,
    per_device: bool,
    hw: Hardware = HW,
) -> Dict[str, float]:
    """Seconds for each roofline term; per_device: the counts are one device's.

    ``hlo_flops`` is a mapping of dtype name to FLOPs, or one number, taken
    as bf16 (the dtype the reference's single peak is quoted for).
    """
    scale = 1.0 if per_device else 1.0 / chips
    flops = hlo_flops if isinstance(hlo_flops, Mapping) else {"bfloat16": hlo_flops}
    t_compute = sum(f * scale / hw.peak(dt) for dt, f in flops.items())
    t_memory = hlo_bytes * scale / hw.hbm_bw
    t_coll = coll_bytes * scale / hw.ici_bw
    terms = {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
    }
    terms["bottleneck"] = max(terms, key=lambda k: terms[k])[: -2]
    terms["bound_s"] = max(t_compute, t_memory, t_coll)
    return terms


def bound_ms(ops: float, nbytes: float, dtype: torch.dtype, hw: Hardware = HW) -> Tuple[float, str]:
    """One kernel call's least time on the card, in ms, and what bounds it:
    ``ops`` at ``dtype``'s peak or ``nbytes`` at the memory rate, the larger."""
    t_ops, t_bytes = ops / hw.peak(dtype) * 1e3, nbytes / hw.hbm_bw * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
