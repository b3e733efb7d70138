"""Perf hillclimb runner: scripted hypothesis -> change -> re-trace -> diff.

The port of ``repro.launch.perf``. Each VARIANT is a named, reproducible
modification of a dry-run cell (backend routing, accumulation, attention
tiling, sharding rules). The runner traces the variant
(``launch/dryrun.py``), extracts the roofline terms, and prints the delta
vs the cell's baseline; the JSONs carry the variant name as their tag.

The variants are the reference's, by name. Where the port ignores a knob
the hypothesis says so: the flash kernel fixes its own tiles, so
``attn_q_chunk``/``attn_k_chunk`` change nothing here.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.perf --cell internlm2_20b:train_4k:single \\
      --variants baseline strassen_d1 winograd_d1
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional

from repro_torch import configs
from repro_torch.core.backend import MatmulBackend
from repro_torch.launch import dryrun
from repro_torch.models.sharding import DEFAULT_RULES, ShardingRules

__all__ = ["Variant", "VARIANTS", "run_variant", "main"]

# A variant transforms (cfg_overrides, backend, rules, accum) knobs.


@dataclasses.dataclass
class Variant:
    name: str
    hypothesis: str
    backend: Optional[MatmulBackend] = None
    accum: Optional[int] = None
    cfg_overrides: Dict = dataclasses.field(default_factory=dict)
    rules: Optional[ShardingRules] = None


def _rules_with(**updates) -> ShardingRules:
    base = dict(DEFAULT_RULES.rules)
    base.update(updates)
    return ShardingRules(rules=base)


_TILES_FIXED = ("; the port's flash kernel fixes its own tiles, so attn_q_chunk and "
                "attn_k_chunk change nothing here")

VARIANTS: Dict[str, Variant] = {
    v.name: v
    for v in [
        Variant("baseline", "paper-faithful framework defaults"),
        # --- the paper's technique applied to the model's projections
        Variant(
            "strassen_d1",
            "Strassen depth-1 on projections >= 2048: compute term x7/8 on "
            "routed matmuls; memory term grows ~ (7/4-1) on operand combos",
            backend=MatmulBackend(kind="strassen", depth=1, min_dim=2048),
        ),
        Variant(
            "strassen_d2",
            "depth-2: compute x(7/8)^2 on routed matmuls, more combine traffic",
            backend=MatmulBackend(kind="strassen", depth=2, min_dim=2048),
        ),
        Variant(
            "winograd_d1",
            "Winograd 7-mult/15-add: same compute as strassen_d1, ~17% fewer "
            "divide/combine adds -> lower memory term (beyond paper)",
            backend=MatmulBackend(kind="winograd", depth=1, min_dim=2048),
        ),
        # --- memory-term levers
        Variant(
            "accum_2x",
            "double grad accumulation: halves live activation stash; HBM "
            "temp down ~2x, weight re-read traffic up ~2x",
            accum=-2,  # marker: multiply default by 2
        ),
        Variant(
            "qchunk_1k",
            "larger attention q-chunk (512->1024): fewer stash rounds, "
            "bigger transient p-block; net HBM traffic down for long seq" + _TILES_FIXED,
            cfg_overrides={"attn_q_chunk": 1024, "attn_k_chunk": 2048},
        ),
        Variant(
            "scan_group_8",
            "8-layer groups: halves boundary stash count vs 4 (the port has no "
            "scan; its remat checkpoints each group of len(block_pattern) layers)",
            cfg_overrides={"block_pattern": ("attn",) * 8},
        ),
        # --- family-specific levers
        Variant(
            "mlstm_chunk64",
            "chunkwise-parallel mLSTM (exact): matrix state written once "
            "per 64-token chunk instead of per token -> state HBM traffic "
            "/64; intra-chunk work becomes (64x64) matmuls",
            cfg_overrides={"mlstm_chunk": 64},
        ),
        Variant(
            "mlstm_chunk128",
            "chunk=128: state traffic /128, quadratic intra term x2 vs 64",
            cfg_overrides={"mlstm_chunk": 128},
        ),
        Variant(
            "mlstm_chunk256",
            "chunk=256: state traffic /256, quadratic intra term x4 vs 64",
            cfg_overrides={"mlstm_chunk": 256},
        ),
        Variant(
            "moe_grouped",
            "per-batch-row MoE dispatch: data-dependent scatter/gather stay "
            "on their data shard -> routing-induced collectives vanish; "
            "capacity per group (same expected compute)",
            cfg_overrides={"moe_group_dispatch": True},
        ),
        Variant(
            "moe_grouped_accum4",
            "grouped dispatch + accum 4 (vs 8): half the per-microbatch "
            "grad reductions per step -> all-reduce bytes down ~2x; live "
            "activations up 2x",
            cfg_overrides={"moe_group_dispatch": True},
            accum=4,
        ),
        Variant(
            "moe_grouped_accum16",
            "grouped dispatch + accum 16: tests the reverse direction — "
            "smaller microbatches, more reduction rounds",
            cfg_overrides={"moe_group_dispatch": True},
            accum=16,
        ),
        Variant(
            "mlstm_chunk64_qchunk",
            "chunkwise mLSTM + bigger attention chunks (xlstm has no attn; "
            "isolates whether residual memory is mLSTM-side or elsewhere)" + _TILES_FIXED,
            cfg_overrides={"mlstm_chunk": 64, "attn_q_chunk": 1024},
        ),
        # --- collective-term levers
        Variant(
            "no_fsdp",
            "replicate params over data axis (no FSDP): removes per-layer "
            "all-gathers -> collective term down; HBM args up by data-axis x",
            rules=_rules_with(fsdp=()),
        ),
        Variant(
            "fsdp_pod",
            "FSDP over (pod,data) both: param shards 2x smaller, all-gather "
            "crosses pods — tests pod-axis sensitivity",
            rules=_rules_with(fsdp=("pod", "data")),
        ),
    ]
}


def run_variant(arch: str, shape: str, mesh: str, variant: Variant):
    accum = dryrun.ACCUM_OVERRIDES.get(arch, dryrun.TRAIN_ACCUM)
    if variant.accum is not None:
        accum = accum * 2 if variant.accum == -2 else variant.accum

    # config overrides ride through a patched get_config
    orig = configs.get_config
    if variant.cfg_overrides:
        def patched(a, **kw):
            cfg = orig(a, **kw)
            return dataclasses.replace(cfg, **variant.cfg_overrides)

        configs.get_config = patched
        dryrun.get_config = patched
    try:
        result = dryrun.run_cell(
            arch, shape, mesh,
            backend=variant.backend,
            rules=variant.rules or DEFAULT_RULES,
            accum=accum,
            tag=variant.name,
        )
    finally:
        configs.get_config = orig
        dryrun.get_config = orig
    result["hypothesis"] = variant.hypothesis
    dryrun.save_result(result)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape:mesh")
    ap.add_argument("--variants", nargs="+", default=["baseline"], choices=list(VARIANTS))
    args = ap.parse_args(argv)
    arch, shape, mesh = args.cell.split(":")

    results = {}
    for name in args.variants:
        v = VARIANTS[name]
        print(f"[perf] {args.cell} variant={name}")
        print(f"       hypothesis: {v.hypothesis}")
        r = run_variant(arch, shape, mesh, v)
        results[name] = r
        if r.get("skipped"):
            print(f"       SKIPPED: {r['skipped']}")
            continue
        t = r["roofline"]
        print(
            f"       compute {t['compute_s']:.3e}  memory {t['memory_s']:.3e}  "
            f"collective {t['collective_s']:.3e}  -> {t['bottleneck']}"
        )
    base = results.get("baseline")
    if base is not None and not base.get("skipped") and len(results) > 1:
        b = base["roofline"]
        print("\ndeltas vs baseline:")
        for name, r in results.items():
            if name == "baseline" or r.get("skipped"):
                continue
            t = r["roofline"]
            ratio = {k: (t[k] / b[k] if b[k] else float("nan"))
                     for k in ("compute_s", "memory_s", "collective_s", "bound_s")}
            print(
                f"  {name:16s} compute {ratio['compute_s']:.3f}x  "
                f"memory {ratio['memory_s']:.3f}x  "
                f"collective {ratio['collective_s']:.3f}x  "
                f"bound {ratio['bound_s']:.3f}x"
            )


if __name__ == "__main__":
    main()
