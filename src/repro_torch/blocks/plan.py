"""Declarative recursive plans: the operator-agnostic layer between tags
and the scheduler.

A copy of :mod:`repro.blocks.plan` on the port's coefficient tables (the
same numpy arrays, so every plan's schemas equal the reference's).

Stark's recursion-tree-of-tagged-blocks machinery (PAPER.md) is not
specific to Strassen's 7-multiply scheme — the same authors proved it
with SPIN (arxiv 1801.04723), which runs block-recursive matrix
*inversion* over the identical divide/combine stages. This module makes
that generality explicit: a :class:`RecursivePlan` *describes* a
recursive block computation — its divide schema (which tagged sub-blocks
each child needs, with signed coefficients), its leaf op, and its
combine schema — and the executors walk the description instead of
hard-coding an operator:

* :class:`BilinearPlan` — one bilinear (two-operand) recursion whose
  children are all independent: exactly the shape the level-order wave
  scheduler (:mod:`repro_torch.blocks.scheduler`) executes. The Strassen
  base-7 and naive base-4 multiplies are the first two plans, wrapping
  the coefficient tables of :mod:`repro_torch.core.coefficients` unchanged —
  so the refactor is bit-identical by construction (pinned by tests).
* :class:`DataflowPlan` — a sequential per-node step program whose
  recursions and block multiplies *depend on each other* (SPIN's
  Schur-complement inversion, triangular solves). Executed by
  :mod:`repro_torch.blocks.solve`; every ``matmul`` step re-enters the matmul
  scheduler (``kind="auto"`` on device, ``strassen_oot`` when the
  product exceeds the device budget).

The tag algebra (tensor-product expansion of the per-level coefficient
rows) lives here now; :mod:`repro_torch.blocks.tags` keeps thin delegating
wrappers for its historical ``operand_terms``/``combine_terms`` API.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.coefficients import Scheme, get_scheme

__all__ = [
    "Q_BASE",
    "Term",
    "expand_terms",
    "apply_divide_schema",
    "apply_combine_schema",
    "RecursivePlan",
    "BilinearPlan",
    "Step",
    "DataflowPlan",
    "matmul_plan",
    "register_plan",
    "get_plan",
    "as_bilinear_plan",
    "plan_names",
    "SPIN_INVERSE",
    "TRSM_LOWER",
    "TRSM_UPPER",
]

Q_BASE = 4  # quadrant alphabet, row-major [11, 12, 21, 22]

TagPath = Tuple[int, ...]
Term = Tuple[TagPath, float]


def expand_terms(m_path: TagPath, coef: np.ndarray, q_base: int = Q_BASE) -> List[Term]:
    """Tensor-product expansion of one coefficient table down a tag path.

    ``coef`` is a (rank, q_base) table; digit ``d`` of ``m_path`` selects
    row ``coef[d]`` at that level and the expansion multiplies the rows
    out into (quadrant path, coefficient) terms — the closed form of
    running a divide (or transposed combine) stage ``len(m_path)`` times.
    """
    terms: List[Term] = [((), 1.0)]
    for digit in m_path:
        nxt: List[Term] = []
        for q_path, c in terms:
            for q in range(q_base):
                cq = float(coef[digit, q])
                if cq != 0.0:
                    nxt.append((q_path + (q,), c * cq))
        terms = nxt
    return terms


def _quadrants(dense: np.ndarray) -> List[np.ndarray]:
    """Row-major 2x2 quadrant views [X11, X12, X21, X22] of a dense array."""
    r, c = dense.shape
    hr, hc = r // 2, c // 2
    return [
        dense[:hr, :hc], dense[:hr, hc:], dense[hr:, :hc], dense[hr:, hc:],
    ]


def apply_divide_schema(
    dense: np.ndarray, coef: np.ndarray, acc_dtype=None
) -> List[np.ndarray]:
    """Apply one divide schema level: child_p = sum_q coef[p, q] * quadrant_q.

    The reference (all-in-memory) semantics of the scheduler's
    block-streamed ``_divide_child`` loop; property tests round-trip
    arbitrary well-formed schemas through this and
    :func:`apply_combine_schema`.
    """
    acc_dtype = np.dtype(acc_dtype) if acc_dtype is not None else dense.dtype
    quads = _quadrants(np.asarray(dense))
    out = []
    for p in range(coef.shape[0]):
        acc = np.zeros(quads[0].shape, acc_dtype)
        for q in range(Q_BASE):
            cq = float(coef[p, q])
            if cq == 1.0:
                acc += quads[q].astype(acc_dtype, copy=False)
            elif cq == -1.0:
                acc -= quads[q].astype(acc_dtype, copy=False)
            elif cq != 0.0:
                acc += cq * quads[q].astype(acc_dtype, copy=False)
        out.append(acc)
    return out


def apply_combine_schema(
    children: Sequence[np.ndarray], coef: np.ndarray, acc_dtype=None
) -> np.ndarray:
    """Apply one combine schema level: quadrant_k = sum_p coef[k, p] * child_p.

    Inverse of :func:`apply_divide_schema` whenever ``coef`` is a left
    inverse of the divide table (``coef @ divide == I``) — the algebraic
    well-formedness condition the plan property tests exercise.
    """
    acc_dtype = np.dtype(acc_dtype) if acc_dtype is not None else children[0].dtype
    hr, hc = children[0].shape
    dense = np.zeros((2 * hr, 2 * hc), acc_dtype)
    quads = _quadrants(dense)
    for k in range(Q_BASE):
        acc = np.zeros((hr, hc), acc_dtype)
        for p in range(len(children)):
            cp = float(coef[k, p])
            if cp == 1.0:
                acc += children[p].astype(acc_dtype, copy=False)
            elif cp == -1.0:
                acc -= children[p].astype(acc_dtype, copy=False)
            elif cp != 0.0:
                acc += cp * children[p].astype(acc_dtype, copy=False)
        quads[k][...] = acc
    return dense


@dataclasses.dataclass(frozen=True)
class RecursivePlan:
    """Metadata every recursive plan shares.

    Attributes:
      name: registry name (``get_plan(name)``).
      op: the operator the plan computes — ``"matmul"``, ``"inverse"``,
        ``"solve"``. Threaded through the executors into the obs layer:
        root spans are ``oot.{op}`` and ``OotStats.op``/``fault.*.{op}``
        counters attribute telemetry to the right operator.
      operands: input names, in call order (``("A", "B")`` for matmul,
        ``("A",)`` for inversion, ``("L", "B")`` for a solve). Operand
        names prefix block tags (``"A:3,0"``) and key the lineage graph.
      result: output name (tag prefix of the result's node tree).
      leaf_kind: the dense op dispatched at the recursion floor —
        ``"matmul"`` through :func:`repro_torch.core.backend.matmul`, or a
        small dense ``"inv"`` / ``"trsm_lower"`` / ``"trsm_upper"``.
    """

    name: str
    op: str
    operands: Tuple[str, ...]
    result: str
    leaf_kind: str


@dataclasses.dataclass(frozen=True)
class BilinearPlan(RecursivePlan):
    """A wave-schedulable bilinear recursion described by coefficient tables.

    ``divide_coef`` maps each operand name to its (rank, 4) table: child
    ``p`` of an operand node is ``sum_q coef[p, q] * quadrant_q`` — the
    divide schema. ``combine_coef`` is the (4, rank) combine schema:
    result quadrant ``k`` is ``sum_p coef[k, p] * child_p``. All rank
    children are mutually independent, which is what lets the scheduler
    batch the ``rank**depth`` leaves into budgeted device waves.

    ``scheme`` retains the source coefficient scheme so telemetry,
    autotune cache keys, and lineage records keep their historical
    names; the tables above are *the same arrays* (not copies), making
    the plan extraction bit-identical to the pre-plan scheduler.
    """

    scheme: Scheme = None  # type: ignore[assignment]
    divide_coef: Mapping[str, np.ndarray] = None  # type: ignore[assignment]
    combine_coef: np.ndarray = None  # type: ignore[assignment]

    @property
    def rank(self) -> int:
        return int(self.combine_coef.shape[1])

    def validate(self) -> None:
        rank = self.rank
        if tuple(sorted(self.divide_coef)) != tuple(sorted(self.operands)):
            raise ValueError(
                f"plan {self.name!r}: divide_coef keys {sorted(self.divide_coef)} "
                f"must match operands {sorted(self.operands)}"
            )
        for name, coef in self.divide_coef.items():
            if coef.shape != (rank, Q_BASE):
                raise ValueError(
                    f"plan {self.name!r}: divide schema for {name!r} has shape "
                    f"{coef.shape}, want {(rank, Q_BASE)}"
                )
        if self.combine_coef.shape != (Q_BASE, rank):
            raise ValueError(
                f"plan {self.name!r}: combine schema has shape "
                f"{self.combine_coef.shape}, want {(Q_BASE, rank)}"
            )

    def operand_terms(self, m_path: TagPath, operand: str) -> List[Term]:
        """Divide algebra: root-operand quadrant paths feeding a leaf.

        For leaf M-path ``m_path``, the (base-4 quadrant path,
        coefficient) terms whose signed sum over the root operand's
        blocks equals the leaf's ``operand`` input.
        """
        try:
            coef = self.divide_coef[operand]
        except KeyError:
            raise ValueError(
                f"plan {self.name!r} has no operand {operand!r}; "
                f"operands: {', '.join(self.operands)}"
            ) from None
        if any(not 0 <= d < self.rank for d in m_path):
            raise ValueError(f"{m_path} has digits outside rank {self.rank}")
        return expand_terms(m_path, coef)

    def combine_terms(self, m_path: TagPath) -> List[Term]:
        """Combine algebra: where a leaf product lands in the result.

        (base-4 quadrant path of the result, coefficient) terms — the
        transposed-combine tensor-product expansion.
        """
        if any(not 0 <= d < self.rank for d in m_path):
            raise ValueError(f"{m_path} has digits outside rank {self.rank}")
        return expand_terms(m_path, self.combine_coef.T)


# Selectors a DataflowPlan's divide/combine schemas may address:
# quadrants of a square operand, or row-halves of a tall RHS panel.
_SELECTORS = ("q0", "q1", "q2", "q3", "r0", "r1")


def select_part(dense: np.ndarray, selector: str) -> np.ndarray:
    """Slice one schema part (quadrant ``q0..q3`` or row-half ``r0/r1``)."""
    if selector.startswith("q"):
        return _quadrants(dense)[int(selector[1])]
    if selector.startswith("r"):
        half = dense.shape[0] // 2
        return dense[:half] if selector == "r0" else dense[half:]
    raise ValueError(f"unknown part selector {selector!r}; have {_SELECTORS}")


@dataclasses.dataclass(frozen=True)
class Step:
    """One instruction of a :class:`DataflowPlan` node program.

    kind:
      ``"recurse"`` — apply ``plan`` (default: the enclosing plan) to the
        symbols named in ``args`` (matched positionally to the child
        plan's operands), producing ``out``. Each recurse step appends
        its ordinal as a tag digit, so solver recursion trees are
        base-(#recursions) tag paths like the bilinear base-7 ones.
      ``"matmul"`` — ``out = alpha * (args[0] @ args[1])``; re-enters the
        matmul scheduler (device ``kind="auto"`` when the product fits
        the budget, the out-of-core wave pipeline when it does not).
      ``"axpy"`` — ``out = sum_i coef_i * sym_i`` over ``terms``; a
        host-side signed block sum, same accumulation discipline as the
        divide/combine stages.
    """

    kind: str
    out: str
    args: Tuple[str, ...] = ()
    terms: Tuple[Tuple[str, float], ...] = ()
    alpha: float = 1.0
    plan: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DataflowPlan(RecursivePlan):
    """A sequential per-node recursion with data-dependent steps.

    ``divide`` names each symbol a node starts from: a (operand, part
    selector) pair — the plan's divide schema. ``program`` is the node's
    step list (see :class:`Step`); ``combine`` places named symbols into
    the result's parts — the combine schema. The recursion floor runs
    ``leaf_kind`` densely on device.

    Unlike a :class:`BilinearPlan`, the children are *not* independent
    (SPIN's second recursion inverts a Schur complement built from the
    first), so these plans run on :mod:`repro_torch.blocks.solve`'s sequential
    executor rather than the wave scheduler — but every block multiply
    inside the program dispatches back into the wave scheduler, which is
    where the waves/budget/pipeline machinery is reused.
    """

    divide: Tuple[Tuple[str, Tuple[str, str]], ...] = ()
    program: Tuple[Step, ...] = ()
    combine: Tuple[Tuple[str, Optional[str]], ...] = ()

    @property
    def recursions(self) -> int:
        return sum(1 for s in self.program if s.kind == "recurse")

    def validate(self) -> None:
        defined = {sym for sym, _ in self.divide}
        for sym, (op_name, selector) in self.divide:
            if op_name not in self.operands:
                raise ValueError(
                    f"plan {self.name!r}: divide symbol {sym!r} reads unknown "
                    f"operand {op_name!r}; operands: {', '.join(self.operands)}"
                )
            if selector not in _SELECTORS:
                raise ValueError(
                    f"plan {self.name!r}: divide symbol {sym!r} uses unknown "
                    f"selector {selector!r}; have {_SELECTORS}"
                )
        for step in self.program:
            needed = step.args if step.kind != "axpy" else tuple(
                s for s, _ in step.terms
            )
            missing = [s for s in needed if s not in defined]
            if missing:
                raise ValueError(
                    f"plan {self.name!r}: step {step.out!r} reads undefined "
                    f"symbols {missing}"
                )
            defined.add(step.out)
        for selector, sym in self.combine:
            if sym is not None and sym not in defined:
                raise ValueError(
                    f"plan {self.name!r}: combine places undefined symbol {sym!r}"
                )
            if selector not in _SELECTORS:
                raise ValueError(
                    f"plan {self.name!r}: combine uses unknown selector "
                    f"{selector!r}; have {_SELECTORS}"
                )


def matmul_plan(scheme: Scheme | str) -> BilinearPlan:
    """Wrap a coefficient scheme as the equivalent bilinear matmul plan.

    The divide/combine schemas ARE the scheme's coefficient arrays
    (shared, not copied): walking this plan reproduces the pre-plan
    scheduler's arithmetic bit for bit.
    """
    scheme = get_scheme(scheme) if isinstance(scheme, str) else scheme
    return BilinearPlan(
        name=scheme.name,
        op="matmul",
        operands=("A", "B"),
        result="C",
        leaf_kind="matmul",
        scheme=scheme,
        divide_coef={"A": scheme.a_coef, "B": scheme.b_coef},
        combine_coef=scheme.c_coef,
    )


# --- SPIN block-recursive inversion (arxiv 1801.04723, Algorithm 2).
#
# For invertible A with invertible leading block, with X11 = inv(A11) and
# S = A22 - A21 X11 A12 the Schur complement:
#
#   inv(A) = [[ X11 + T2 inv(S) T1, -T2 inv(S) ],
#             [     -inv(S) T1,      inv(S)    ]]
#   where T1 = A21 X11, T2 = X11 A12.
#
# Two recursions (A11, then S) and six half-size multiplies per node.
SPIN_INVERSE = DataflowPlan(
    name="spin_inverse",
    op="inverse",
    operands=("A",),
    result="X",
    leaf_kind="inv",
    divide=(
        ("A11", ("A", "q0")),
        ("A12", ("A", "q1")),
        ("A21", ("A", "q2")),
        ("A22", ("A", "q3")),
    ),
    program=(
        Step("recurse", out="X11", args=("A11",)),
        Step("matmul", out="T1", args=("A21", "X11")),
        Step("matmul", out="T2", args=("X11", "A12")),
        Step("matmul", out="TS", args=("T1", "A12")),
        Step("axpy", out="S", terms=(("A22", 1.0), ("TS", -1.0))),
        Step("recurse", out="X22", args=("S",)),
        Step("matmul", out="B12", args=("T2", "X22"), alpha=-1.0),
        Step("matmul", out="B21", args=("X22", "T1"), alpha=-1.0),
        Step("matmul", out="TB", args=("T2", "B21")),
        Step("axpy", out="B11", terms=(("X11", 1.0), ("TB", -1.0))),
    ),
    combine=(
        ("q0", "B11"),
        ("q1", "B12"),
        ("q2", "B21"),
        ("q3", "X22"),
    ),
)

# --- Block-recursive triangular solve, X = inv(L) B for lower L:
#   X1 = solve(L11, B1);  X2 = solve(L22, B2 - L21 X1)
TRSM_LOWER = DataflowPlan(
    name="spin_trsm_lower",
    op="solve",
    operands=("L", "B"),
    result="X",
    leaf_kind="trsm_lower",
    divide=(
        ("L11", ("L", "q0")),
        ("L21", ("L", "q2")),
        ("L22", ("L", "q3")),
        ("B1", ("B", "r0")),
        ("B2", ("B", "r1")),
    ),
    program=(
        Step("recurse", out="X1", args=("L11", "B1")),
        Step("matmul", out="T", args=("L21", "X1")),
        Step("axpy", out="R", terms=(("B2", 1.0), ("T", -1.0))),
        Step("recurse", out="X2", args=("L22", "R")),
    ),
    combine=(("r0", "X1"), ("r1", "X2")),
)

# --- Upper-triangular solve, X = inv(U) B:
#   X2 = solve(U22, B2);  X1 = solve(U11, B1 - U12 X2)
TRSM_UPPER = DataflowPlan(
    name="spin_trsm_upper",
    op="solve",
    operands=("L", "B"),
    result="X",
    leaf_kind="trsm_upper",
    divide=(
        ("U11", ("L", "q0")),
        ("U12", ("L", "q1")),
        ("U22", ("L", "q3")),
        ("B1", ("B", "r0")),
        ("B2", ("B", "r1")),
    ),
    program=(
        Step("recurse", out="X2", args=("U22", "B2")),
        Step("matmul", out="T", args=("U12", "X2")),
        Step("axpy", out="R", terms=(("B1", 1.0), ("T", -1.0))),
        Step("recurse", out="X1", args=("U11", "R")),
    ),
    combine=(("r0", "X1"), ("r1", "X2")),
)


_PLANS: Dict[str, RecursivePlan] = {}


def register_plan(plan: RecursivePlan) -> RecursivePlan:
    """Validate and register a plan under its name (idempotent by name)."""
    plan.validate()
    _PLANS[plan.name] = plan
    return plan


for _scheme_name in ("strassen", "winograd", "naive8"):
    register_plan(matmul_plan(_scheme_name))
for _p in (SPIN_INVERSE, TRSM_LOWER, TRSM_UPPER):
    register_plan(_p)


def get_plan(name: str) -> RecursivePlan:
    try:
        return _PLANS[name]
    except KeyError:
        raise ValueError(
            f"unknown recursive plan {name!r}; have {sorted(_PLANS)}"
        ) from None


def plan_names() -> List[str]:
    return sorted(_PLANS)


def as_bilinear_plan(plan: "BilinearPlan | Scheme | str") -> BilinearPlan:
    """Coerce a plan name / Scheme / plan to a wave-schedulable plan.

    The scheduler's entry points historically accepted ``scheme=`` names
    and Scheme instances; this keeps them working while the plan layer
    owns the schemas.
    """
    if isinstance(plan, BilinearPlan):
        return plan
    if isinstance(plan, Scheme):
        return matmul_plan(plan)
    if isinstance(plan, str):
        got = _PLANS.get(plan)
        if isinstance(got, BilinearPlan):
            return got
        if got is None:
            # A scheme name that never registered (custom Scheme objects
            # go through matmul_plan): fail with the plan registry error.
            return matmul_plan(plan)
        raise ValueError(
            f"plan {plan!r} is {type(got).__name__}, not wave-schedulable; "
            f"bilinear plans: "
            f"{sorted(n for n, p in _PLANS.items() if isinstance(p, BilinearPlan))}"
        )
    raise TypeError(f"cannot interpret {plan!r} as a bilinear plan")
