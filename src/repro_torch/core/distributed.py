"""Distributed Strassen on a mesh of positions: the port of :mod:`repro.core.distributed`.

The strategies, their names, signatures, defaults and exceptions are the
reference's. Each is written as local phases per position of a
:class:`repro_torch.core.mesh.Mesh` with explicit movements between them
(one process drives every position, as one JAX controller drives its
mesh). Inputs and outputs are global tensors, gathered from the
per-position results at the strategy's out_specs (``_bfs_sharded``,
``_2d_sharded`` and ``_shardmap_3d_sharded`` return those results), and
``mesh.traffic`` totals the bytes the movements would send between
positions.

1. :func:`strassen_bfs_sharded`: Stark's own strategy (CAPS's BFS). The
   7^depth leaf batch is cut over ``batch_axes[0]`` and the block rows over
   the rest. Every divide and combine level is a fetch, keyed by the
   M-index tag: each position fetches the quadrant rows its output slab
   needs (Stark's flatMapToPair and groupByKey) and forms the signed sums
   locally. Where GSPMD inserts the reshards, the port writes them out.
2. :func:`strassen_2d`: Strassen on top, every leaf a 2D-parallel product
   over (row_axis, col_axis) (Luo and Drake's Strassen-2D).
3. :func:`strassen_shardmap`, :func:`strassen_shardmap_2d` and
   :func:`strassen_shardmap_3d`: one explicit level on a 7-way ``mult``
   axis from replicated inputs; the whole combine is one psum over ``mult``.
4. :func:`strassen_fused_sharded`: A row-striped over every ``rows_axes``
   axis present, B replicated, and each position's product on the fused
   pipeline, whose last level is the ``strassen1`` kernel on the card: one
   launch per position, no combine collective.

The leaves of 1-3 are plain products (``torch.bmm``/``torch.matmul``, the
reference's ``jnp.einsum``/``jnp.matmul``), their signed sums
``torch.einsum`` as the port's ``divide_level`` forms them, all with TF32
off under ``precision`` None or "highest". On one card the positions run
one after another on one stream: a strategy's time there is its work plus
the copies and adds of its movements, not an interconnect's.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import compat
from repro_torch.core.coefficients import STRASSEN, Scheme, get_scheme
from repro_torch.core.mesh import Mesh, P, Sharded, fetch, gather, reshard, shard, spec_axes
from repro_torch.core.mesh import slab as _slab
from repro_torch.core.precision import matmul_precision
from repro_torch.core.strassen import merge_quadrants, split_quadrants

__all__ = [
    "strassen_bfs_sharded",
    "strassen_2d",
    "strassen_shardmap",
    "strassen_shardmap_2d",
    "strassen_shardmap_3d",
    "strassen_fused_sharded",
    "MESH_STRATEGIES",
    "register_strategy",
    "get_strategy",
    "available_strategies",
]


def _coef(coef, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(coef), dtype=like.dtype, device=like.device)


def _level(x: Sharded, spec: P, shape, boxes, local) -> Sharded:
    """One level on the mesh: each position fetches ``boxes(pos)`` of ``x``
    and forms its slab of the output (``shape`` under ``spec``) with
    ``local(pos, tensors)``; replicas of a slab on one device share one
    result."""
    mesh = x.mesh
    out = fetch(x, boxes, then=local, key=lambda pos: tuple(_slab(mesh, spec, shape, pos)),
                axes=spec_axes(spec))
    return Sharded(mesh, spec, shape, out, x.dtype)


def _divide_level(x: Sharded, coef, spec: P) -> Sharded:
    """One divide level (m, r, c) -> (m * rank, r/2, c/2), laid out under ``spec``.

    Output leaf l = m_old * rank + p (the M-index tag). Each position
    fetches its slab's rows and columns of the four quadrants of the m_old
    it covers (Stark's divide shuffle), then forms only the leaves of its
    slab.
    """
    coef = np.asarray(coef)
    rank = coef.shape[0]
    m, r, c = x.shape
    h, w = r // 2, c // 2
    shape = (m * rank, h, w)
    mesh = x.mesh

    def boxes(pos):
        (l0, l1), (i0, i1), (j0, j1) = _slab(mesh, spec, shape, pos)
        ms = slice(l0 // rank, -(-l1 // rank))
        return [(ms, slice(qi * h + i0, qi * h + i1), slice(qj * w + j0, qj * w + j1))
                for qi in (0, 1) for qj in (0, 1)]

    def local(pos, quads):
        (l0, l1), (i0, i1), (j0, j1) = _slab(mesh, spec, shape, pos)
        if l0 == l1 or i0 == i1 or j0 == j1:
            return torch.empty((l1 - l0, i1 - i0, j1 - j0), dtype=x.dtype,
                               device=mesh.device_of(pos))
        q = torch.stack(quads, dim=1)  # (m_old, 4, rows, cols)
        cf = _coef(coef, q)
        m0 = l0 // rank
        parts = []
        with matmul_precision(None):
            for mo in range(m0, -(-l1 // rank)):
                p0, p1 = max(l0 - mo * rank, 0), min(l1 - mo * rank, rank)
                parts.append(torch.einsum("pq,qij->pij", cf[p0:p1], q[mo - m0]))
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    return _level(x, spec, shape, boxes, local)


def _combine_level(x: Sharded, c_coef, spec: P) -> Sharded:
    """One combine level (m * rank, h, w) -> (m, 2h, 2w), laid out under ``spec``.

    Each position fetches, for each quadrant its slab touches, the rank
    products of its m's at the quadrant's rows and columns (Stark's combine
    shuffle), and forms the quadrant's signed sum.
    """
    c_coef = np.asarray(c_coef)
    rank = c_coef.shape[1]
    mr, h, w = x.shape
    shape = (mr // rank, 2 * h, 2 * w)
    mesh = x.mesh

    def segments(a, b, half):
        """(which half, start, stop) of [a, b) in each half of a dim of 2 * half."""
        return [(k, max(a, k * half), min(b, (k + 1) * half)) for k in (0, 1)
                if max(a, k * half) < min(b, (k + 1) * half)]

    def plan(pos):
        (m0, m1), (i0, i1), (j0, j1) = _slab(mesh, spec, shape, pos)
        return m0, m1, segments(i0, i1, h), segments(j0, j1, w)

    def boxes(pos):
        m0, m1, rows, cols = plan(pos)
        if m0 == m1:
            return []
        ms = slice(m0 * rank, m1 * rank)
        return [(ms, slice(a - ri * h, b - ri * h), slice(c - ci * w, d - ci * w))
                for ri, a, b in rows for ci, c, d in cols]

    def local(pos, prods):
        m0, m1, rows, cols = plan(pos)
        if not prods:
            (_, _), (i0, i1), (j0, j1) = _slab(mesh, spec, shape, pos)
            return torch.empty((m1 - m0, i1 - i0, j1 - j0), dtype=x.dtype,
                               device=mesh.device_of(pos))
        cf = _coef(c_coef, prods[0])
        pieces = iter(prods)
        band = []
        with matmul_precision(None):
            for ri, _, _ in rows:
                row = []
                for ci, _, _ in cols:
                    prod = next(pieces)
                    grouped = prod.reshape(m1 - m0, rank, *prod.shape[1:])
                    row.append(torch.einsum("p,mpij->mij", cf[2 * ri + ci], grouped))
                band.append(torch.cat(row, dim=2) if len(row) > 1 else row[0])
        return torch.cat(band, dim=1) if len(band) > 1 else band[0]

    return _level(x, spec, shape, boxes, local)


def _leaf(ta: Sharded, tb: Sharded, spec: P, leaf_fn, precision) -> Sharded:
    """The batched leaf (m, i, j) x (m, j, k) -> (m, i, k) under ``spec``:
    each position fetches its leaves' rows of A and columns of B."""
    mesh = ta.mesh
    shape = (ta.shape[0], ta.shape[1], tb.shape[2])

    def a_box(pos):
        (l0, l1), (i0, i1), _ = _slab(mesh, spec, shape, pos)
        return [(slice(l0, l1), slice(i0, i1), slice(None))]

    def b_box(pos):
        (l0, l1), _, (j0, j1) = _slab(mesh, spec, shape, pos)
        return [(slice(l0, l1), slice(None), slice(j0, j1))]

    lhs = fetch(ta, a_box, then=lambda pos, got: got[0], axes=spec_axes(spec))

    def local(pos, got):
        if leaf_fn is not None:
            return leaf_fn(lhs[pos], got[0])
        with matmul_precision(precision):
            return torch.bmm(lhs[pos], got[0])

    return _level(tb, spec, shape, b_box, local)


def _drop_leading(s: Sharded) -> Sharded:
    """(1, M, N) -> (M, N): every local loses its leading dim of one."""
    locals_ = s.mesh.map(lambda t: t[0], s.locals)
    return Sharded(s.mesh, P(*s.spec[1:]), s.shape[1:], locals_, s.dtype)


def strassen_bfs_sharded(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    mesh: Mesh,
    depth: int,
    scheme: Scheme | str = STRASSEN,
    batch_axes: Sequence[str] = ("data", "model"),
    leaf_fn=None,
    precision=None,
) -> torch.Tensor:
    """Stark/CAPS-BFS: shard the 7^depth leaf batch across ``batch_axes``.

    A, B and C are row-sharded across the same axes (an RDD of block rows).
    Each level's shuffle is an explicit fetch into the batch layout: the
    leaf batch over the first axis (uneven shards are ceil-sized, as JAX
    pads them: 343 over 16 wastes 2.6%), the block rows over the rest.
    """
    return gather(_bfs_sharded(a, b, mesh, depth, scheme, batch_axes, leaf_fn, precision))


def _bfs_sharded(a, b, mesh, depth, scheme, batch_axes, leaf_fn, precision) -> Sharded:
    """:func:`strassen_bfs_sharded`'s C as per-position row slabs."""
    if isinstance(scheme, str):
        scheme = get_scheme(scheme)
    axes = tuple(batch_axes)
    if len(axes) > 1:
        batch_spec = P(axes[0], axes[1:], None)
    else:
        batch_spec = P(axes[0], None, None)
    rows3 = P(None, axes, None)

    ta = shard(a[None], mesh, rows3)
    tb = shard(b[None], mesh, rows3)
    for _ in range(depth):
        ta = _divide_level(ta, scheme.a_coef, batch_spec)
        tb = _divide_level(tb, scheme.b_coef, batch_spec)
    prod = _leaf(ta, tb, batch_spec if depth else rows3, leaf_fn, precision)
    del ta, tb
    for _ in range(depth):
        prod = _combine_level(prod, scheme.c_coef, batch_spec)
    return _drop_leading(reshard(prod, rows3))


def strassen_2d(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    mesh: Mesh,
    depth: int,
    scheme: Scheme | str = STRASSEN,
    row_axis: str = "data",
    col_axis: str = "model",
    precision=None,
) -> torch.Tensor:
    """Strassen-2D (Luo & Drake): Strassen on top, 2D-parallel leaves.

    A and B start replicated; each divide level lays A's leaves out by rows
    over ``row_axis`` and B's by columns over ``col_axis``, so every leaf
    product is local: C_leaf tiles over both axes. The leaf batch is never
    cut; the combine levels keep C tiled and C ends up laid out (row_axis,
    col_axis).
    """
    return gather(_2d_sharded(a, b, mesh, depth, scheme, row_axis, col_axis, precision))


def _2d_sharded(a, b, mesh, depth, scheme, row_axis, col_axis, precision) -> Sharded:
    """:func:`strassen_2d`'s C as per-position (row_axis, col_axis) tiles."""
    if isinstance(scheme, str):
        scheme = get_scheme(scheme)
    a_spec, b_spec = P(None, row_axis, None), P(None, None, col_axis)
    c_spec = P(None, row_axis, col_axis)
    ta = shard(a[None], mesh, P())
    tb = shard(b[None], mesh, P())
    for _ in range(depth):
        ta = _divide_level(ta, scheme.a_coef, a_spec)
        tb = _divide_level(tb, scheme.b_coef, b_spec)
    prod = _leaf(ta, tb, c_spec, None, precision)
    del ta, tb
    for _ in range(depth):
        prod = _combine_level(prod, scheme.c_coef, c_spec)
    return _drop_leading(prod)


def _signed_sum(coef_row, terms) -> torch.Tensor:
    """``einsum('q,qij->ij')`` of a coefficient row and stacked terms."""
    with matmul_precision(None):
        return torch.einsum("q,qij->ij", _coef(coef_row, terms), terms)


def strassen_shardmap_2d(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    mesh: Mesh,
    rows_axis: str = "rows",
    mult_axis: str = "mult",
    scheme: Scheme | str = STRASSEN,
    precision=None,
) -> torch.Tensor:
    """Explicit one-level Strassen on a (rows x 7) grid.

    The 7-way ``mult`` axis owns one M_p each (Stark's seven sub-matrix
    groups), the ``rows`` axis splits each M_p's row range. Inputs are
    replicated, so divide is local arithmetic, and the only collective is
    one psum over ``mult``: Stark's whole combine phase.
    """
    if isinstance(scheme, str):
        scheme = get_scheme(scheme)
    n = a.shape[0]
    n_rows = mesh.shape[rows_axis]
    assert mesh.shape[mult_axis] == scheme.n_mults
    blk = (n // 2) // n_rows
    a_rep, b_rep = shard(a, mesh, P()), shard(b, mesh, P())

    def body(pos):
        r = mesh.axis_index(pos, rows_axis)
        p = mesh.axis_index(pos, mult_axis)
        aq = split_quadrants(a_rep[pos])  # (4, n/2, n/2)
        bq = split_quadrants(b_rep[pos])
        # left operand: only this position's row stripe of the combo
        left = _signed_sum(scheme.a_coef[p], aq[:, r * blk:(r + 1) * blk])
        right = _signed_sum(scheme.b_coef[p], bq)
        del aq, bq
        with matmul_precision(precision):
            mp_rows = torch.matmul(left, right)  # (blk, n/2)
        return _coef(scheme.c_coef[:, p], mp_rows)[:, None, None] * mp_rows[None]

    quads = mesh.psum(mesh.run(body), mult_axis)  # (4, blk, n/2) each
    q = Sharded(mesh, P(None, rows_axis, None), (4, n // 2, n // 2), quads, a.dtype)
    return merge_quadrants(gather(q))


def strassen_shardmap_3d(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    mesh: Mesh,
    rb_axis: str = "rb",
    cb_axis: str = "cb",
    mult_axis: str = "mult",
    scheme: Scheme | str = STRASSEN,
    precision=None,
    merge: bool = True,
) -> torch.Tensor:
    """Explicit one-level Strassen on an (rb x cb x 7) grid.

    Each position owns one (row stripe, column stripe) tile of one M_p: it
    reads only its stripes of the replicated inputs (views, no copy of the
    quadrants), computes a (blk_r, n/2) x (n/2, blk_c) product, and the one
    psum over ``mult`` both combines Stark's seven products and leaves C
    tiled over (rb, cb). ``merge=False`` returns C in quadrant-block layout
    (4, n/2, n/2), the paper's Block structure.
    """
    out = gather(_shardmap_3d_sharded(a, b, mesh, rb_axis, cb_axis, mult_axis, scheme,
                                      precision))
    return merge_quadrants(out) if merge else out


def _shardmap_3d_sharded(a, b, mesh, rb_axis, cb_axis, mult_axis, scheme,
                         precision) -> Sharded:
    """:func:`strassen_shardmap_3d`'s C quadrants as per-position (rb, cb) tiles."""
    if isinstance(scheme, str):
        scheme = get_scheme(scheme)
    n = a.shape[0]
    nrb, ncb = mesh.shape[rb_axis], mesh.shape[cb_axis]
    assert mesh.shape[mult_axis] == scheme.n_mults
    blk_r = (n // 2) // nrb
    blk_c = (n // 2) // ncb
    n2 = n // 2
    a_rep, b_rep = shard(a, mesh, P()), shard(b, mesh, P())

    def body(pos):
        r = mesh.axis_index(pos, rb_axis)
        c = mesh.axis_index(pos, cb_axis)
        p = mesh.axis_index(pos, mult_axis)

        def a_stripe(qi):
            row0 = (qi // 2) * n2 + r * blk_r
            col0 = (qi % 2) * n2
            return a_rep[pos][row0:row0 + blk_r, col0:col0 + n2]

        def b_stripe(qi):
            row0 = (qi // 2) * n2
            col0 = (qi % 2) * n2 + c * blk_c
            return b_rep[pos][row0:row0 + n2, col0:col0 + blk_c]

        def combo(coefs, stripe):
            acc = None
            for qi in range(4):
                coef = float(coefs[qi])
                if coef == 0.0:
                    continue
                term = stripe(qi) if coef == 1.0 else coef * stripe(qi)
                acc = term if acc is None else acc + term
            return acc

        left = combo(scheme.a_coef[p], a_stripe)
        right = combo(scheme.b_coef[p], b_stripe)
        with matmul_precision(precision):
            mp = torch.matmul(left, right)
        cc = scheme.c_coef[:, p]
        return torch.stack([float(cc[k]) * mp for k in range(4)], dim=0)

    quads = mesh.psum(mesh.run(body), mult_axis)  # (4, blk_r, blk_c) each
    return Sharded(mesh, P(None, rb_axis, cb_axis), (4, n2, n2), quads, a.dtype)


def strassen_shardmap(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    mesh: Mesh,
    axis: str = "mult",
    scheme: Scheme | str = STRASSEN,
    precision=None,
) -> torch.Tensor:
    """One explicit BFS level over a mesh axis of size 7 (rank of the scheme).

    Position p forms its operand combos locally (replicated inputs),
    computes M_p, and the combine is one weighted psum:

        C_quadrants = psum_p( c_coef[:, p] outer* M_p )

    Stark's combine groupByKey collapses to one all-reduce whose payload is
    4 * (n/2)^2, less than shuffling all 7 products.
    """
    if isinstance(scheme, str):
        scheme = get_scheme(scheme)
    if mesh.shape[axis] != scheme.n_mults:
        raise ValueError(
            f"axis {axis!r} must have size {scheme.n_mults}, got {mesh.shape[axis]}"
        )
    a_rep, b_rep = shard(a, mesh, P()), shard(b, mesh, P())

    def body(pos):
        p = mesh.axis_index(pos, axis)
        left = _signed_sum(scheme.a_coef[p], split_quadrants(a_rep[pos]))  # (m/2, k/2)
        right = _signed_sum(scheme.b_coef[p], split_quadrants(b_rep[pos]))
        with matmul_precision(precision):
            m_p = torch.matmul(left, right)
        # Weighted contribution of M_p to all four C quadrants, then one psum.
        return _coef(scheme.c_coef[:, p], m_p)[:, None, None] * m_p[None]

    quads = mesh.psum(mesh.run(body), axis)
    out = mesh.map(merge_quadrants, quads)
    return gather(Sharded(mesh, P(), (a.shape[0], b.shape[1]), out, a.dtype))


def strassen_fused_sharded(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    mesh: Mesh,
    depth: int,
    scheme: Scheme | str = STRASSEN,
    rows_axes: Sequence[str] = ("data", "model"),
    precision=None,
) -> torch.Tensor:
    """Row-parallel Strassen with the fused leaf on every position.

    Each position owns an M-stripe of A (and of C) with B replicated: the
    classic row-parallel matmul's traffic (one B broadcast, no combine
    collective), but each position's product runs
    :func:`repro_torch.kernels.strassen.ops.strassen_matmul_fused_padded`,
    whose last level is the ``strassen1`` kernel on the card (its plain
    version on the CPU): one launch per position. A failed build or launch
    raises.

    Rows shard over every ``rows_axes`` axis present in the mesh, so the
    whole mesh carries leaf work. M is zero-padded up to the stripe grain
    (row shards * 2**depth) and sliced back.
    """
    from repro_torch.kernels.strassen.ops import strassen_matmul_fused_padded

    if isinstance(scheme, str):
        scheme = get_scheme(scheme)
    axes = tuple(ax for ax in rows_axes if ax in mesh.shape)
    if not axes:
        raise ValueError(f"none of {rows_axes} in mesh axes {tuple(mesh.shape)}")
    n_rows = math.prod(mesh.shape[ax] for ax in axes)
    m = a.shape[0]
    grain = n_rows * 2**depth
    mp = -(-m // grain) * grain
    a_p = F.pad(a, (0, 0, 0, mp - m)) if mp != m else a

    def body(a_loc, b_rep):
        return strassen_matmul_fused_padded(
            a_loc, b_rep, depth=depth, scheme_name=scheme.name, precision=precision
        )

    a_s, b_s = shard(a_p, mesh, P(axes, None)), shard(b, mesh, P())
    out = mesh.map(body, a_s.locals, b_s.locals)
    full = gather(Sharded(mesh, P(axes, None), (mp, b.shape[1]), out, a.dtype))
    return full[:m] if mp != m else full


# --------------------------------------------------------------------------
# Strategy registry: the autotuner's enumeration surface.
#
# Each entry maps a stable name to (fn, requires). ``requires(mesh, scheme)``
# answers whether the strategy can run on that mesh at all; the autotuner
# only costs candidates whose requirement holds. Registration is open.
# --------------------------------------------------------------------------


def _axes_cover(mesh: Mesh, names: Sequence[str]) -> bool:
    return all(n in mesh.shape for n in names)


def _req_bfs(mesh: Mesh, scheme: Scheme) -> bool:
    return _axes_cover(mesh, ("data", "model"))


def _req_2d(mesh: Mesh, scheme: Scheme) -> bool:
    return _axes_cover(mesh, ("data", "model"))


def _req_shardmap(mesh: Mesh, scheme: Scheme) -> bool:
    return mesh.shape.get("mult") == scheme.n_mults


def _req_shardmap_2d(mesh: Mesh, scheme: Scheme) -> bool:
    return "rows" in mesh.shape and mesh.shape.get("mult") == scheme.n_mults


def _req_shardmap_3d(mesh: Mesh, scheme: Scheme) -> bool:
    return (
        _axes_cover(mesh, ("rb", "cb"))
        and mesh.shape.get("mult") == scheme.n_mults
    )


def _req_fused_sharded(mesh: Mesh, scheme: Scheme) -> bool:
    # Enumerable only where the fused kernel runs on the mesh's device
    # (compiled on the card, its plain version on the CPU).
    return "data" in mesh.shape and compat.fused_leaf_mode(mesh.device) != "none"


MESH_STRATEGIES: dict = {}


def register_strategy(name: str, fn, requires) -> None:
    """Register a distributed matmul strategy for autotune enumeration."""
    MESH_STRATEGIES[name] = (fn, requires)


def get_strategy(name: str):
    return MESH_STRATEGIES[name][0]


def available_strategies(mesh: Optional[Mesh], scheme: Scheme | str = STRASSEN):
    """Names of registered strategies whose mesh requirement holds."""
    if mesh is None:
        return []
    if isinstance(scheme, str):
        scheme = get_scheme(scheme)
    return [n for n, (_, req) in MESH_STRATEGIES.items() if req(mesh, scheme)]


register_strategy("strassen_bfs_sharded", strassen_bfs_sharded, _req_bfs)
register_strategy("strassen_2d", strassen_2d, _req_2d)
register_strategy("strassen_shardmap", strassen_shardmap, _req_shardmap)
register_strategy("strassen_shardmap_2d", strassen_shardmap_2d, _req_shardmap_2d)
register_strategy("strassen_shardmap_3d", strassen_shardmap_3d, _req_shardmap_3d)
register_strategy("strassen_fused_sharded", strassen_fused_sharded, _req_fused_sharded)
