"""Strassen matrix multiplication in PyTorch: serial and batched-BFS forms.

The port of :mod:`repro.core.strassen`, function for function:

* :func:`strassen_recursive` is the paper's Algorithm 1 (serial recursion
  on a single node), the reference implementation.
* :func:`divide_level` / :func:`combine_level` are one level of Stark's
  distributed recursion. The batch index plays the role of the paper's
  M-index tag (base-7 digits, see
  :func:`repro_torch.core.coefficients.leaf_tag_path`). On a CPU tensor a
  level is the JAX package's form: :func:`split_quadrants` (a contiguous
  copy), one ``torch.einsum`` against the scheme's constant coefficient
  matrix, and for a combine :func:`merge_quadrants` (another copy). On a
  CUDA tensor it is one launch of ``csrc/strassen_level.cu`` per operand
  and level (:func:`~repro_torch.kernels.strassen.strassen.divide_level_cuda`,
  :func:`~repro_torch.kernels.strassen.strassen.combine_level_cuda`), which
  stands for those einsum levels and for ``divide_pallas``/``combine_pallas``:
  it reads each block's quadrants where they lie (a divide) or writes them
  there (a combine), so it moves each input once and each output once, the
  least bytes of a level, at 3.35 TB/s its bound; no split or merge copy is
  made. Each thread takes a 16-byte chunk of every input plane, sums every
  output from registers in fp32 and rounds once on the store: the einsum's
  arithmetic (bf16 operands accumulated in fp32, fp32 with TF32 off), not
  ``signed_sum``'s rounding of each bf16 add, which stays with the staged
  pipeline that stands for the Pallas kernels. A CUDA level runs as the
  autograd function :class:`DivideLevel` or :class:`CombineLevel`: the
  gradient of each is the other's kernel with the transposed coefficient
  table, and a second derivative raises.
* :func:`strassen_matmul` is the full pipeline: ``depth`` divide levels, one
  batched leaf multiplication (``torch.bmm`` by default, or any ``leaf_fn``)
  and ``depth`` combine levels.

With the tracer on, the pipeline records one span per stage, so that a
device trace splits a multiply by stage whatever implements it:
``strassen.divide`` (one a level, around both operands' divide with their
quadrant copies), ``strassen.leaf`` (the leaf product) and
``strassen.combine`` (one a level, with its merge copy). A level's span
carries ``level`` (0 at the top, where the operands are split first),
``blocks`` (the blocks it takes in) and ``plane`` (the elements of one
quadrant block it sums: a divide's output block of A plus one of B, a
combine's input block), so that its least bytes are
``(rank + 4) * rank**level * plane`` elements; the leaf's carries ``batch``,
``m``, ``k`` and ``n``. :mod:`repro_torch.kernels.strassen.ops` records the
same spans at the same boundaries.

Quadrants are ordered row-major [11, 12, 21, 22] and the leaf index is
level-major (``m_old * rank + p``), exactly as in the JAX package, so tag
paths agree between the two. M, K and N must be divisible by ``2**depth``;
:mod:`repro_torch.core.backend` falls back to a shallower depth otherwise.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch.core.coefficients import STRASSEN, Scheme, get_scheme
from repro_torch.core.precision import matmul_precision
from repro_torch.kernels.common import on_cuda
from repro_torch.kernels.strassen.strassen import combine_level_cuda, divide_level_cuda
from repro_torch.obs import tracer as obs_tracer

__all__ = [
    "divide_span",
    "leaf_span",
    "combine_span",
    "strassen_recursive",
    "split_quadrants",
    "merge_quadrants",
    "divide_level",
    "combine_level",
    "DivideLevel",
    "CombineLevel",
    "strassen_matmul",
    "leaf_count",
]

LeafFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def divide_span(level: int, blocks: int, m: int, k: int, n: int):
    """The ``strassen.divide`` span of ``level`` of an (m, k) @ (k, n) multiply,
    whose ``blocks`` blocks of A and of B are split and summed."""
    tracer = obs_tracer.get_tracer()
    if not tracer.enabled:
        return obs_tracer.NULL_SPAN
    half = 2 ** (level + 1)
    return tracer.span("strassen.divide", cat="matmul", level=level, blocks=blocks,
                       plane=(m // half) * (k // half) + (k // half) * (n // half))


def leaf_span(ta: torch.Tensor, tb: torch.Tensor, **attrs):
    """The ``strassen.leaf`` span of the (batch, m, k) @ (batch, k, n) leaf."""
    tracer = obs_tracer.get_tracer()
    if not tracer.enabled:
        return obs_tracer.NULL_SPAN
    return tracer.span("strassen.leaf", cat="matmul", batch=ta.shape[0], m=ta.shape[1],
                       k=ta.shape[2], n=tb.shape[2], **attrs)


def combine_span(level: int, products: torch.Tensor):
    """The ``strassen.combine`` span of ``level``, over its (blocks, h, w) products."""
    tracer = obs_tracer.get_tracer()
    if not tracer.enabled:
        return obs_tracer.NULL_SPAN
    return tracer.span("strassen.combine", cat="matmul", level=level,
                       blocks=products.shape[0], plane=products.shape[1] * products.shape[2])


def leaf_count(scheme: Scheme, depth: int) -> int:
    """Number of leaf multiplications: the paper's 7^(p-q) (= b^2.807)."""
    return scheme.n_mults**depth


def split_quadrants(x: torch.Tensor) -> torch.Tensor:
    """(..., r, c) -> (..., 4, r/2, c/2), quadrants row-major [11, 12, 21, 22].

    The paper's "Divide" of a sub-matrix into four equal quadrants,
    vectorized over any leading batch dims. The result is contiguous.
    """
    *lead, r, c = x.shape
    if r % 2 or c % 2:
        raise ValueError(f"need even dims, got {tuple(x.shape)}")
    hr, hc = r // 2, c // 2
    x = x.reshape(*lead, 2, hr, 2, hc).movedim(-2, -3)  # (..., 2, 2, hr, hc)
    return x.reshape(*lead, 4, hr, hc)


def merge_quadrants(q: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_quadrants`: (..., 4, hr, hc) -> (..., 2hr, 2hc)."""
    *lead, four, hr, hc = q.shape
    if four != 4:
        raise ValueError(f"need (..., 4, hr, hc), got {tuple(q.shape)}")
    q = q.reshape(*lead, 2, 2, hr, hc).movedim(-3, -2)  # (..., 2, hr, 2, hc)
    return q.reshape(*lead, 2 * hr, 2 * hc)


def _coef(coef, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(coef), dtype=like.dtype, device=like.device)


class DivideLevel(torch.autograd.Function):
    """A divide level's kernel on CUDA tensors; its backward is the combine
    kernel with the transposed table, from the sums back into the quadrants.
    The backward is not itself differentiable: a second derivative raises."""

    @staticmethod
    def forward(ctx, x, coef):
        ctx.coef = np.asarray(coef)
        return divide_level_cuda(x, ctx.coef)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        return combine_level_cuda(grad, ctx.coef.T), None


class CombineLevel(torch.autograd.Function):
    """A combine level's kernel on CUDA tensors; its backward is the divide
    kernel with the transposed table, from the quadrants back into the products.
    The backward is not itself differentiable: a second derivative raises."""

    @staticmethod
    def forward(ctx, products, c_coef):
        ctx.c_coef = np.asarray(c_coef)
        return combine_level_cuda(products, ctx.c_coef)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        return divide_level_cuda(grad, ctx.c_coef.T), None


def divide_level(x: torch.Tensor, coef, *, precision: Optional[str] = None) -> torch.Tensor:
    """One divide level: (m, r, c) -> (m*rank, r/2, c/2).

    ``coef`` is the scheme's (rank, 4) a_coef or b_coef. Stark's divide
    stage (replicate quadrants into the rank groups, then form each group's
    signed sum). The output index is m_old * rank + p, so the base-rank
    digits of a leaf index are the paper's M-index tag path. A CUDA tensor
    takes the level kernel, whose fp32 sums need no ``precision``; a CPU
    tensor one einsum at ``precision``.
    """
    if on_cuda(x):
        return DivideLevel.apply(x, coef)
    m, r, c = x.shape
    q = split_quadrants(x)  # (m, 4, r/2, c/2)
    cf = _coef(coef, x)
    with matmul_precision(precision):
        out = torch.einsum("pq,mqij->mpij", cf, q)
    return out.reshape(m * cf.shape[0], r // 2, c // 2)


def combine_level(
    products: torch.Tensor, c_coef, *, precision: Optional[str] = None
) -> torch.Tensor:
    """One combine level: (m*rank, hr, hc) -> (m, 2hr, 2hc).

    ``c_coef`` is the scheme's (4, rank) combine matrix: Stark's combine
    stage over the M-index tags. A CUDA tensor takes the level kernel, which
    writes each quadrant in place; a CPU tensor one einsum and the merge copy.
    """
    if on_cuda(products):
        return CombineLevel.apply(products, c_coef)
    cf = _coef(c_coef, products)
    rank = cf.shape[1]
    mr, hr, hc = products.shape
    if mr % rank:
        raise ValueError(f"batch {mr} not divisible by rank {rank}")
    prod = products.reshape(mr // rank, rank, hr, hc)
    with matmul_precision(precision):
        quads = torch.einsum("kp,mpij->mkij", cf, prod)
    return merge_quadrants(quads)


def strassen_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    depth: int,
    scheme: Scheme | str = STRASSEN,
    leaf_fn: Optional[LeafFn] = None,
    precision: Optional[str] = None,
    constrain_a: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    constrain_b: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    constrain_out: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Batched-BFS Strassen: ``depth`` unrolled recursion levels.

    Stark's flattened recursion (Fig. 2): each divide level runs in
    parallel, the 7^depth leaf products form one batched stage, and the
    combine levels rebuild C bottom-up.

    Args:
      a: (M, K); b: (K, N). M, K, N divisible by 2**depth.
      depth: number of Strassen levels (the paper's p - q).
      scheme: coefficient scheme (strassen | winograd | naive8).
      leaf_fn: batched leaf multiply (m, i, j) x (m, j, k) -> (m, i, k).
        Defaults to ``torch.bmm`` at ``precision``.
      precision: matmul precision of the default leaf only; the divide and
        combine levels run with TF32 off whatever the caller asks, as the
        JAX package runs them without the caller's precision.
      constrain_a/b/out: optional per-level hooks (m, r, c) -> tensor,
        applied after each divide level, the leaf and each combine level.
    """
    if isinstance(scheme, str):
        scheme = get_scheme(scheme)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if depth < 0:
        raise ValueError("depth must be >= 0")
    step = 2**depth
    for d in (*a.shape, b.shape[1]):
        if d % step:
            raise ValueError(f"dim {d} not divisible by 2**depth={step}")

    if leaf_fn is None:
        def leaf_fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
            with matmul_precision(precision):
                return torch.bmm(x, y)

    (m, k), n = a.shape, b.shape[1]
    ta, tb = a[None], b[None]  # (1, M, K), (1, K, N)
    for level in range(depth):
        with divide_span(level, ta.shape[0], m, k, n):
            ta = divide_level(ta, scheme.a_coef)
            tb = divide_level(tb, scheme.b_coef)
            if constrain_a is not None:
                ta = constrain_a(ta)
            if constrain_b is not None:
                tb = constrain_b(tb)

    with leaf_span(ta, tb):
        prod = leaf_fn(ta, tb)
        if constrain_out is not None:
            prod = constrain_out(prod)

    for level in reversed(range(depth)):
        with combine_span(level, prod):
            prod = combine_level(prod, scheme.c_coef)
            if constrain_out is not None:
                prod = constrain_out(prod)
    return prod[0]


def strassen_recursive(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    threshold: int = 64,
    scheme: Scheme | str = STRASSEN,
) -> torch.Tensor:
    """Paper Algorithm 1: serial recursive Strassen (single node reference).

    Recurses until the smallest dim reaches ``threshold`` or a dim turns
    odd, then multiplies with ``a @ b`` (the paper's BLAS leaf call).
    """
    if isinstance(scheme, str):
        scheme = get_scheme(scheme)
    m, k = a.shape
    n = b.shape[1]
    if min(m, k, n) <= threshold or m % 2 or k % 2 or n % 2:
        return a @ b
    aq, bq = split_quadrants(a), split_quadrants(b)
    prods = [
        strassen_recursive(
            _combo(aq, scheme.a_coef[p], a.dtype),
            _combo(bq, scheme.b_coef[p], b.dtype),
            threshold=threshold,
            scheme=scheme,
        )
        for p in range(scheme.n_mults)
    ]
    quads = [_combo(prods, scheme.c_coef[kk], prods[0].dtype) for kk in range(4)]
    return merge_quadrants(torch.stack(quads))


def _combo(terms, coef_row: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Signed sum of ``terms`` per one coefficient row, skipping zeros."""
    acc = None
    for t, c in zip(terms, coef_row):
        c = float(c)
        if c == 0.0:
            continue
        term = t if c == 1.0 else (-t if c == -1.0 else c * t)
        acc = term if acc is None else acc + term
    assert acc is not None, "coefficient row is all zero"
    return acc.to(dtype)
