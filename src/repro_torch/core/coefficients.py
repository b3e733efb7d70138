"""Strassen-family coefficient schemes as constant +/-1 matrices.

A copy of :mod:`repro.core.coefficients`, which the port may not import
(``repro.core`` pulls in JAX). The arrays stay numpy float64, so the tests
can hold them ``np.array_equal`` to the reference.

A fast 2x2 block-matmul scheme with r multiplications is a triple of
coefficient matrices (A_COEF, B_COEF, C_COEF):

    M_p   = (sum_q A_COEF[p, q] * A_q) @ (sum_q B_COEF[p, q] * B_q)
    C_k   =  sum_p C_COEF[k, p] * M_p

where quadrants are enumerated row-major: [X11, X12, X21, X22].

The paper (Algorithm 1) uses Strassen's original 7-multiplication scheme.
We additionally ship the Winograd variant (7 mults, 15 additions in staged
form vs Strassen's 18) as a beyond-paper optimization, and the naive
8-multiplication scheme as the MLLib/Marlin-style baseline.

Paper erratum: Algorithm 1 in the paper lists C22 = M1 - M2 - M3 + M6;
the correct identity is C22 = M1 - M2 + M3 + M6 (validated in tests).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = [
    "Scheme",
    "STRASSEN",
    "WINOGRAD",
    "NAIVE8",
    "get_scheme",
    "leaf_tag_path",
    "leaf_index_from_path",
]


@dataclasses.dataclass(frozen=True)
class Scheme:
    """A 2x2 fast-matmul scheme.

    Attributes:
      name: scheme identifier.
      a_coef: (r, 4) left-operand coefficients over [A11, A12, A21, A22].
      b_coef: (r, 4) right-operand coefficients over [B11, B12, B21, B22].
      c_coef: (4, r) combine coefficients producing [C11, C12, C21, C22].
      n_mults: r, the number of block multiplications (the paper's key metric:
        7 for Stark vs 8 for MLLib/Marlin).
      n_adds: block additions/subtractions in the *staged* (serial) form;
        used by the cost model.
    """

    name: str
    a_coef: np.ndarray
    b_coef: np.ndarray
    c_coef: np.ndarray
    n_mults: int
    n_adds: int

    def __post_init__(self):
        r = self.a_coef.shape[0]
        assert self.a_coef.shape == (r, 4), self.a_coef.shape
        assert self.b_coef.shape == (r, 4), self.b_coef.shape
        assert self.c_coef.shape == (4, r), self.c_coef.shape
        assert self.n_mults == r

    @property
    def rank(self) -> int:
        return self.n_mults

    def exponent(self) -> float:
        """The asymptotic exponent log2(n_mults): 2.807 for Strassen, 3 for naive."""
        return float(np.log2(self.n_mults))

    def validate(self) -> None:
        """Check the bilinear identity <C_k> == sum over the 2x2 algebra.

        The scheme is correct iff for all k=(i,j), and all quadrant pairs
        (q_a=(i,l), q_b=(l,j)):

            sum_p c_coef[k,p] * a_coef[p,q_a] * b_coef[p,q_b]
                == 1 if (row(q_a)==row(k) and col(q_a)==row(q_b)
                         and col(q_b)==col(k)) else 0
        """
        # Tensor T[k, qa, qb] produced by the scheme.
        t = np.einsum("kp,pq,pr->kqr", self.c_coef, self.a_coef, self.b_coef)
        # Target matmul tensor for 2x2: C[i,j] = sum_l A[i,l] B[l,j].
        want = np.zeros((4, 4, 4))
        for i in range(2):
            for j in range(2):
                for l in range(2):
                    want[i * 2 + j, i * 2 + l, l * 2 + j] = 1.0
        if not np.array_equal(t, want):
            raise ValueError(f"scheme {self.name} fails bilinear identity")


def _arr(rows) -> np.ndarray:
    return np.array(rows, dtype=np.float64)


# --- Strassen's original scheme (paper Algorithm 1, with C22 erratum fixed).
# Quadrant order: [11, 12, 21, 22].
STRASSEN = Scheme(
    name="strassen",
    a_coef=_arr(
        [
            [1, 0, 0, 1],   # M1: (A11 + A22)
            [0, 0, 1, 1],   # M2: (A21 + A22)
            [1, 0, 0, 0],   # M3: A11
            [0, 0, 0, 1],   # M4: A22
            [1, 1, 0, 0],   # M5: (A11 + A12)
            [-1, 0, 1, 0],  # M6: (A21 - A11)
            [0, 1, 0, -1],  # M7: (A12 - A22)
        ]
    ),
    b_coef=_arr(
        [
            [1, 0, 0, 1],   # M1: (B11 + B22)
            [1, 0, 0, 0],   # M2: B11
            [0, 1, 0, -1],  # M3: (B12 - B22)
            [-1, 0, 1, 0],  # M4: (B21 - B11)
            [0, 0, 0, 1],   # M5: B22
            [1, 1, 0, 0],   # M6: (B11 + B12)
            [0, 0, 1, 1],   # M7: (B21 + B22)
        ]
    ),
    c_coef=_arr(
        [
            # M1  M2  M3  M4  M5  M6  M7
            [1, 0, 0, 1, -1, 0, 1],   # C11 = M1 + M4 - M5 + M7
            [0, 0, 1, 0, 1, 0, 0],    # C12 = M3 + M5
            [0, 1, 0, 1, 0, 0, 0],    # C21 = M2 + M4
            [1, -1, 1, 0, 0, 1, 0],   # C22 = M1 - M2 + M3 + M6
        ]
    ),
    n_mults=7,
    n_adds=18,
)


# --- Winograd's variant: 7 multiplications, 15 additions in staged form.
# Beyond-paper optimization (the paper uses classic Strassen only).
WINOGRAD = Scheme(
    name="winograd",
    a_coef=_arr(
        [
            [1, 0, 0, 0],     # M1: A11
            [0, 1, 0, 0],     # M2: A12
            [1, 1, -1, -1],   # M3: S4 = A11 + A12 - A21 - A22
            [0, 0, 0, 1],     # M4: A22
            [0, 0, 1, 1],     # M5: S1 = A21 + A22
            [-1, 0, 1, 1],    # M6: S2 = A21 + A22 - A11
            [1, 0, -1, 0],    # M7: S3 = A11 - A21
        ]
    ),
    b_coef=_arr(
        [
            [1, 0, 0, 0],     # M1: B11
            [0, 0, 1, 0],     # M2: B21
            [0, 0, 0, 1],     # M3: B22
            [1, -1, -1, 1],   # M4: T4 = B11 - B12 - B21 + B22
            [-1, 1, 0, 0],    # M5: T1 = B12 - B11
            [1, -1, 0, 1],    # M6: T2 = B11 - B12 + B22  (sign: B22 - T1)
            [0, -1, 0, 1],    # M7: T3 = B22 - B12
        ]
    ),
    c_coef=_arr(
        [
            # M1  M2  M3  M4  M5  M6  M7
            [1, 1, 0, 0, 0, 0, 0],    # C11 = M1 + M2
            [1, 0, 1, 0, 1, 1, 0],    # C12 = M1 + M3 + M5 + M6
            [1, 0, 0, -1, 0, 1, 1],   # C21 = M1 - M4 + M6 + M7
            [1, 0, 0, 0, 1, 1, 1],    # C22 = M1 + M5 + M6 + M7
        ]
    ),
    n_mults=7,
    n_adds=15,
)


# --- Naive 8-multiplication block scheme: the MLLib/Marlin-style baseline.
NAIVE8 = Scheme(
    name="naive8",
    a_coef=_arr(
        [
            [1, 0, 0, 0],  # A11 (for C11 term 1)
            [0, 1, 0, 0],  # A12 (for C11 term 2)
            [1, 0, 0, 0],  # A11 (for C12 term 1)
            [0, 1, 0, 0],  # A12 (for C12 term 2)
            [0, 0, 1, 0],  # A21
            [0, 0, 0, 1],  # A22
            [0, 0, 1, 0],  # A21
            [0, 0, 0, 1],  # A22
        ]
    ),
    b_coef=_arr(
        [
            [1, 0, 0, 0],  # B11
            [0, 0, 1, 0],  # B21
            [0, 1, 0, 0],  # B12
            [0, 0, 0, 1],  # B22
            [1, 0, 0, 0],  # B11
            [0, 0, 1, 0],  # B21
            [0, 1, 0, 0],  # B12
            [0, 0, 0, 1],  # B22
        ]
    ),
    c_coef=_arr(
        [
            [1, 1, 0, 0, 0, 0, 0, 0],  # C11 = A11B11 + A12B21
            [0, 0, 1, 1, 0, 0, 0, 0],  # C12
            [0, 0, 0, 0, 1, 1, 0, 0],  # C21
            [0, 0, 0, 0, 0, 0, 1, 1],  # C22
        ]
    ),
    n_mults=8,
    n_adds=4,
)


_SCHEMES = {s.name: s for s in (STRASSEN, WINOGRAD, NAIVE8)}


def get_scheme(name: str) -> Scheme:
    try:
        return _SCHEMES[name]
    except KeyError:
        raise ValueError(f"unknown scheme {name!r}; have {sorted(_SCHEMES)}")


def leaf_tag_path(index: int, depth: int) -> Tuple[int, ...]:
    """The paper's M-index tag path for a leaf: base-7 digits of ``index``.

    Stark tags every block with a comma-separated M-index string recording
    which M_i branch it took at each recursion level. In the batched layout
    the leaf's position in the 7^depth batch encodes the same path:
    digit i (most-significant first) is the level-i branch (0-based M-index).
    """
    if not 0 <= index < 7**depth:
        raise ValueError(f"index {index} out of range for depth {depth}")
    digits = []
    for _ in range(depth):
        digits.append(index % 7)
        index //= 7
    return tuple(reversed(digits))


def leaf_index_from_path(path: Tuple[int, ...]) -> int:
    """Inverse of :func:`leaf_tag_path`."""
    index = 0
    for digit in path:
        if not 0 <= digit < 7:
            raise ValueError(f"bad M-index digit {digit}")
        index = index * 7 + digit
    return index
