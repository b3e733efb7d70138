"""Tagged BlockMatrix runtime: out-of-core Strassen over host block stores.

The port of :mod:`repro.blocks`. The paper's defining mechanism is an RDD of
*tagged* matrix blocks whose base-7 tag paths encode the recursion tree. This
package is that mechanism for one host and one CUDA device whose memory is the
scarce resource:

  tags         — the base-7 (M-index) / base-4 (quadrant) tag-path codec.
  plan         — declarative RecursivePlans: divide schema, leaf op,
                 combine schema. Strassen/winograd/naive8 matmul plans
                 plus SPIN inversion and triangular-solve dataflow plans.
  blockmatrix  — (row, col, tag)-addressed CPU tensor blocks over a
                 pluggable host store (dict, preallocated RAM arena,
                 npy/memmap spill).
  scheduler    — a level-order wave executor that walks a BilinearPlan,
                 staging the rank^q leaf ops through device memory in
                 budgeted waves: pinned host buffers, a copy stream, events.
  solve        — the sequential DataflowPlan executor: SPIN
                 block-recursive inversion / triangular solves whose
                 multiplies re-enter the wave scheduler.
  recovery     — lineage-based fault tolerance: the tag algebra IS the
                 lineage graph, so any lost/corrupt block recomputes from
                 its parents (RecoveringStore), with a deterministic
                 chaos-injection harness (ChaosStore / FlakyLeaf).

Where Stark bounds per-executor memory by partitioning the RDD, this
package bounds peak *device* memory by a byte budget while the operands
live in host RAM or on disk.
"""
from repro_torch.blocks.blockmatrix import (
    ArenaStore,
    BlockMatrix,
    BlockStore,
    DictStore,
    MemmapStore,
    make_store,
    signed_block_sum,
)
from repro_torch.blocks.recovery import (
    BlockLossError,
    ChaosConfig,
    ChaosStore,
    FaultError,
    FlakyLeaf,
    InjectedFault,
    Lineage,
    RecoveringStore,
    recompute_block,
)
from repro_torch.blocks.plan import (
    BilinearPlan,
    DataflowPlan,
    RecursivePlan,
    as_bilinear_plan,
    get_plan,
    matmul_plan,
    plan_names,
    register_plan,
)
from repro_torch.blocks.scheduler import (
    OotStats,
    PlanScheduler,
    StrassenScheduler,
    leaf_bytes,
    min_depth_for_budget,
    strassen_oot_matmul,
)
from repro_torch.blocks.solve import (
    SolveScheduler,
    solver_min_depth_for_budget,
    spin_inverse_oot,
    triangular_solve_oot,
)
from repro_torch.blocks import tags

__all__ = [
    "tags",
    "RecursivePlan",
    "BilinearPlan",
    "DataflowPlan",
    "matmul_plan",
    "register_plan",
    "get_plan",
    "plan_names",
    "as_bilinear_plan",
    "PlanScheduler",
    "SolveScheduler",
    "solver_min_depth_for_budget",
    "spin_inverse_oot",
    "triangular_solve_oot",
    "BlockStore",
    "DictStore",
    "ArenaStore",
    "MemmapStore",
    "make_store",
    "BlockMatrix",
    "signed_block_sum",
    "StrassenScheduler",
    "OotStats",
    "strassen_oot_matmul",
    "leaf_bytes",
    "min_depth_for_budget",
    "FaultError",
    "InjectedFault",
    "BlockLossError",
    "ChaosConfig",
    "ChaosStore",
    "FlakyLeaf",
    "Lineage",
    "RecoveringStore",
    "recompute_block",
]
