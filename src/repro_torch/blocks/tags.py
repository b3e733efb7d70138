"""Tag-path codec and divide/combine tag algebra (paper §III).

A copy of :mod:`repro.blocks.tags` on the port's coefficient tables.

Stark tags every RDD block with a comma-separated index string recording,
per recursion level, which branch the block took through the recursion
tree. Two alphabets appear in the paper's pipeline:

* the 7-way **M-index** (which of the scheme's rank products a divide
  level routed the block into) — base-``rank`` digits, rank 7 for
  Strassen/Winograd, 8 for the naive baseline scheme;
* the 4-way **quadrant index** (which quarter of a sub-matrix a block
  addresses) — base-4 digits, row-major [11, 12, 21, 22].

A *tag path* here is a tuple of digits, most-significant (outermost
recursion level) first, exactly the digit order of
:func:`repro_torch.core.coefficients.leaf_tag_path`; ``encode``/``decode`` are
the generic-radix generalization of that function and its inverse.

The *tag algebra* the out-of-core scheduler runs on — for a leaf M-path,
which (quadrant-path, coefficient) terms of the root operands form its
left/right operand, and with which coefficient the leaf product lands in
each quadrant path of C — lives in :mod:`repro_torch.blocks.plan` now (it is a
property of a recursive plan's divide/combine schemas, not of the tag
codec). :func:`operand_terms` / :func:`combine_terms` remain here as thin
wrappers over the scheme's matmul plan for the historical
(scheme, side)-keyed API.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from repro_torch.core.coefficients import Scheme, get_scheme

__all__ = [
    "M_BASE",
    "Q_BASE",
    "encode",
    "decode",
    "to_string",
    "from_string",
    "child",
    "parent",
    "leaf_paths",
    "operand_terms",
    "combine_terms",
    "validate_algebra",
]

M_BASE = 7  # M-index alphabet of the rank-7 schemes (paper's base-7 tags)
Q_BASE = 4  # quadrant alphabet, row-major [11, 12, 21, 22]

TagPath = Tuple[int, ...]
Term = Tuple[TagPath, float]


def encode(path: Sequence[int], base: int = M_BASE) -> int:
    """Tag path -> flat index, most-significant digit first.

    ``encode(leaf_tag_path(i, d)) == i`` for every base-7 path: this is
    :func:`repro_torch.core.coefficients.leaf_index_from_path` generalized to
    any radix (base-4 quadrant paths address blocks inside a sub-matrix).
    """
    index = 0
    for digit in path:
        if not 0 <= digit < base:
            raise ValueError(f"digit {digit} out of range for base {base}")
        index = index * base + digit
    return index


def decode(index: int, depth: int, base: int = M_BASE) -> TagPath:
    """Flat index -> tag path of ``depth`` digits (inverse of :func:`encode`)."""
    if not 0 <= index < base**depth:
        raise ValueError(f"index {index} out of range for depth {depth} base {base}")
    digits: List[int] = []
    for _ in range(depth):
        digits.append(index % base)
        index //= base
    return tuple(reversed(digits))


def to_string(path: Sequence[int]) -> str:
    """The paper's comma-separated tag string: (3, 0, 5) -> ``"3,0,5"``."""
    return ",".join(str(d) for d in path)


def from_string(s: str) -> TagPath:
    """Inverse of :func:`to_string`; the empty string is the root path."""
    if not s:
        return ()
    return tuple(int(d) for d in s.split(","))


def child(path: TagPath, digit: int, base: int = M_BASE) -> TagPath:
    """Descend one recursion level (append a branch digit)."""
    if not 0 <= digit < base:
        raise ValueError(f"digit {digit} out of range for base {base}")
    return path + (digit,)


def parent(path: TagPath) -> TagPath:
    """Ascend one recursion level; the root has no parent."""
    if not path:
        raise ValueError("root tag path has no parent")
    return path[:-1]


def leaf_paths(depth: int, base: int = M_BASE) -> Iterator[TagPath]:
    """All level-``depth`` tag paths in index order (lexicographic)."""
    for i in range(base**depth):
        yield decode(i, depth, base)


def _expand(m_path: TagPath, coef: np.ndarray) -> List[Term]:
    """Tensor-product expansion down a tag path (now plan-layer algebra)."""
    from repro_torch.blocks.plan import expand_terms

    return expand_terms(m_path, coef, Q_BASE)


def operand_terms(
    m_path: TagPath, scheme: Scheme | str, side: str
) -> List[Term]:
    """The divide algebra of a scheme's matmul plan, (scheme, side)-keyed.

    For leaf M-path ``m_path``, returns the (base-4 quadrant path,
    coefficient) terms such that the leaf's ``side`` operand ('a' or 'b')
    equals the signed sum of the root operand's blocks at those quadrant
    paths. Delegates to
    :meth:`repro_torch.blocks.plan.BilinearPlan.operand_terms` — the schemas
    live on the plan; this keeps the historical scheme-keyed spelling.
    """
    from repro_torch.blocks.plan import matmul_plan

    if side == "a":
        operand = "A"
    elif side == "b":
        operand = "B"
    else:
        raise ValueError(f"side must be 'a' or 'b', got {side!r}")
    return matmul_plan(scheme).operand_terms(m_path, operand)


def combine_terms(m_path: TagPath, scheme: Scheme | str) -> List[Term]:
    """The combine algebra of a scheme's matmul plan: where a leaf lands.

    Returns (base-4 quadrant path of C, coefficient) terms. Delegates to
    :meth:`repro_torch.blocks.plan.BilinearPlan.combine_terms`.
    """
    from repro_torch.blocks.plan import matmul_plan

    return matmul_plan(scheme).combine_terms(m_path)


def validate_algebra(scheme: Scheme | str, depth: int) -> None:
    """Check the depth-level tag algebra reproduces the matmul tensor.

    Summing ``c_term * a_term * b_term`` over every leaf M-path must give
    exactly the block-matmul tensor over 4^depth-quadrant addresses:

        T[c, qa, qb] = 1  iff  row(c)==row(qa), col(qa)==row(qb),
                               col(qb)==col(c)  (per level)

    — the multi-level generalization of ``Scheme.validate``. Used by
    tests; O((4^depth)^3) so keep depth small.
    """
    if isinstance(scheme, str):
        scheme = get_scheme(scheme)
    nq = Q_BASE**depth
    got = np.zeros((nq, nq, nq))
    for m_path in leaf_paths(depth, scheme.n_mults):
        a_terms = operand_terms(m_path, scheme, "a")
        b_terms = operand_terms(m_path, scheme, "b")
        c_terms = combine_terms(m_path, scheme)
        for cq, cc in c_terms:
            for aq, ac in a_terms:
                for bq, bc in b_terms:
                    got[encode(cq, Q_BASE), encode(aq, Q_BASE), encode(bq, Q_BASE)] += (
                        cc * ac * bc
                    )
    want = np.zeros((nq, nq, nq))
    for c in range(nq):
        cp = decode(c, depth, Q_BASE)
        for a in range(nq):
            ap = decode(a, depth, Q_BASE)
            for b in range(nq):
                bp = decode(b, depth, Q_BASE)
                ok = all(
                    (cd // 2 == ad // 2) and (ad % 2 == bd // 2) and (bd % 2 == cd % 2)
                    for cd, ad, bd in zip(cp, ap, bp)
                )
                if ok:
                    want[c, a, b] = 1.0
    if not np.array_equal(got, want):
        raise ValueError(f"tag algebra of {scheme.name} fails at depth {depth}")
