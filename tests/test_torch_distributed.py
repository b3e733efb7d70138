"""Port parity: repro_torch.core.distributed against repro.core.distributed.

The same seeded numpy operands go through the reference, on meshes of
conftest's 8 host devices (a 7-way mesh is ``Mesh(devices[:7], ("mult",))``;
the 14- and 28-device meshes run in a subprocess that forces 28), and
through the port on CPU meshes of positions of the same shape.

Tolerances: max|port - reference| <= 5e-4 in fp32 (``test_distributed.py``'s
bound against ``a @ b``), 3e-3 for ``strassen_fused_sharded``
(``test_autotune.py``'s), and ||port - reference|| / ||reference|| <= 2e-2 in
bf16 (the main path's bf16 limit): both packages add the bf16 signed sums
and psums in bf16, in orders that differ. Per-position output shards are
held to the reference's ``addressable_shards`` at the same mesh coordinate;
the counters to exactly one psum over ``mult`` for the shardmap variants
and to no collective at all for ``strassen_fused_sharded``.
"""
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import distributed as jd
from repro.core.compat import make_mesh as jmake_mesh
from repro_torch.core import distributed as td
from repro_torch.core.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_TOL = 5e-4
FUSED_TOL = 3e-3
BF16_LIMIT = 2e-2


def _meshes(shape, names):
    size = int(np.prod(shape))
    if jax.device_count() < size:
        pytest.skip("needs the conftest multi-device host platform")
    jmesh = (jmake_mesh(shape, names) if size == jax.device_count()
             else jax.sharding.Mesh(np.array(jax.devices()[:size]).reshape(shape), names))
    return make_mesh(shape, names, device="cpu"), jmesh


def _operands(seed, m, k, n, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return (torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype),
            jnp.asarray(a, jdt), jnp.asarray(b, jdt))


def _f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _run_both(fn_name, shape, names, seed, dims, dtype=torch.float32, **kw):
    mesh, jmesh = _meshes(shape, names)
    a, b, ja_, jb_ = _operands(seed, *dims, dtype)
    got = getattr(td, fn_name)(a, b, mesh=mesh, **kw)
    want = jax.jit(functools.partial(getattr(jd, fn_name), mesh=jmesh, **kw))(ja_, jb_)
    return mesh, jmesh, got, want


def _layout(layout_fn, shape, names, seed, dims, *args):
    """The port's per-position results at the strategy's out_specs, from the
    private function its public one gathers."""
    a, b, _, _ = _operands(seed, *dims)
    return layout_fn(a, b, make_mesh(shape, names, device="cpu"), *args)


def _check_layout(out, jmesh, want, tol):
    """The port's per-position results equal the reference's addressable
    shards at the same mesh coordinate."""
    mesh = out.mesh
    seen = set()
    for sh in want.addressable_shards:
        pos = tuple(int(i) for i in np.argwhere(jmesh.devices == sh.device)[0])
        seen.add(pos)
        local = _f32(out[pos])
        ref = _f32(sh.data)
        assert local.shape == ref.shape, (pos, local.shape, ref.shape)
        np.testing.assert_allclose(local, ref, atol=tol, rtol=0, err_msg=str(pos))
        idx = tuple((s.start or 0, s.stop if s.stop is not None else d)
                    for s, d in zip(sh.index, want.shape))
        assert tuple(out.slab(pos)) == idx, (pos, out.slab(pos), idx)
    assert len(seen) == mesh.size


@pytest.mark.parametrize("scheme", ["strassen", "winograd"])
@pytest.mark.parametrize("depth", [1, 2])
def test_bfs_sharded_matches_reference_and_its_layout(depth, scheme):
    mesh, jmesh, got, want = _run_both("strassen_bfs_sharded", (4, 2), ("data", "model"), 0,
                                       (256, 256, 256), depth=depth, scheme=scheme)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=FP32_TOL, rtol=0)
    _check_layout(_layout(td._bfs_sharded, (4, 2), ("data", "model"), 0, (256, 256, 256),
                          depth, scheme, ("data", "model"), None, None), jmesh, want, FP32_TOL)
    # every level's shuffle moved bytes between positions; none between cards
    assert mesh.count("reshard") > 0 and mesh.logical_bytes > 0 and mesh.physical_bytes == 0
    assert mesh.count("psum") == 0


def test_bfs_sharded_one_batch_axis_uneven_leaves():
    """batch_axes=('data',) on an 8-way mesh, as fig12_scalability calls it:
    49 leaves over 8 (ceil-sized shards of 7, the last 0) and 343 at depth 3."""
    for depth in (2, 3):
        mesh, jmesh, got, want = _run_both("strassen_bfs_sharded", (8,), ("data",), 3,
                                           (256, 256, 256), depth=depth, batch_axes=("data",))
        np.testing.assert_allclose(_f32(got), _f32(want), atol=FP32_TOL, rtol=0)
        _check_layout(_layout(td._bfs_sharded, (8,), ("data",), 3, (256, 256, 256),
                              depth, "strassen", ("data",), None, None), jmesh, want, FP32_TOL)


def test_bfs_sharded_bf16_within_the_bf16_limit():
    mesh, jmesh, got, want = _run_both("strassen_bfs_sharded", (4, 2), ("data", "model"), 4,
                                       (256, 256, 256), torch.bfloat16, depth=2)
    assert got.dtype == torch.bfloat16
    diff = np.linalg.norm(_f32(got) - _f32(want)) / np.linalg.norm(_f32(want))
    assert diff <= BF16_LIMIT, diff


def test_bfs_sharded_leaf_fn_runs_per_position():
    mesh, _ = _meshes((4, 2), ("data", "model"))
    a, b, _, _ = _operands(5, 128, 128, 128)
    shapes = []

    def leaf(x, y):
        shapes.append((tuple(x.shape), tuple(y.shape)))
        return torch.bmm(x, y)

    got = td.strassen_bfs_sharded(a, b, mesh=mesh, depth=1, leaf_fn=leaf)
    np.testing.assert_allclose(_f32(got), _f32(a @ b), atol=FP32_TOL, rtol=0)
    # 7 leaves over data (2, 2, 2, 1), block rows of 64 over model (32 each)
    assert sorted(shapes) == sorted([((2, 32, 64), (2, 64, 64))] * 6 + [((1, 32, 64), (1, 64, 64))] * 2)


@pytest.mark.parametrize("scheme", ["strassen", "winograd"])
@pytest.mark.parametrize("depth", [1, 2])
def test_strassen_2d_matches_reference(depth, scheme):
    mesh, jmesh, got, want = _run_both("strassen_2d", (4, 2), ("data", "model"), 1,
                                       (256, 256, 256), depth=depth, scheme=scheme)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=FP32_TOL, rtol=0)
    _check_layout(_layout(td._2d_sharded, (4, 2), ("data", "model"), 1, (256, 256, 256),
                          depth, scheme, "data", "model", None), jmesh, want, FP32_TOL)
    assert mesh.count("psum") == 0 and mesh.physical_bytes == 0


@pytest.mark.parametrize("scheme", ["strassen", "winograd"])
def test_shardmap_matches_reference_with_one_psum(scheme):
    mesh, jmesh, got, want = _run_both("strassen_shardmap", (7,), ("mult",), 1,
                                       (128, 128, 128), scheme=scheme)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=FP32_TOL, rtol=0)
    assert mesh.count("psum", "mult") == 1 and mesh.count("psum") == 1
    assert mesh.count("reshard") == 0 and mesh.count("all_gather") == 0
    # the psum's payload: 4 quadrants of (n/2)^2 fp32 over 7 positions, ring-counted
    assert mesh.logical_bytes == 2 * 6 * 4 * 64 * 64 * 4


@pytest.mark.parametrize("scheme", ["strassen", "winograd"])
@pytest.mark.parametrize("merge", [True, False])
def test_shardmap_2d_and_3d_on_one_row_block(merge, scheme):
    """(1, 7) and (1, 1, 7) fit the 8 host devices: products, layouts, one psum."""
    mesh, jmesh, got, want = _run_both("strassen_shardmap_3d", (1, 1, 7), ("rb", "cb", "mult"), 2,
                                       (128, 128, 128), merge=merge, scheme=scheme)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=FP32_TOL, rtol=0)
    assert mesh.count("psum", "mult") == 1 and mesh.count("psum") == 1
    if not merge:
        _check_layout(_layout(td._shardmap_3d_sharded, (1, 1, 7), ("rb", "cb", "mult"), 2,
                              (128, 128, 128), "rb", "cb", "mult", scheme, None),
                      jmesh, want, FP32_TOL)
    mesh, jmesh, got, want = _run_both("strassen_shardmap_2d", (1, 7), ("rows", "mult"), 2,
                                       (128, 128, 128), scheme=scheme)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=FP32_TOL, rtol=0)
    assert mesh.count("psum", "mult") == 1 and mesh.count("psum") == 1


_GRID_REFERENCE = """
    import numpy as np, jax, jax.numpy as jnp
    from repro.core.compat import make_mesh
    from repro.core import distributed as jd
    rng = np.random.default_rng(6)
    a = rng.standard_normal((256, 256)).astype(np.float32)
    b = rng.standard_normal((256, 256)).astype(np.float32)
    out = {"a": a, "b": b}
    for tag, shape, names, fn, kw in (
            ("3d", (2, 2, 7), ("rb", "cb", "mult"), jd.strassen_shardmap_3d, dict(merge=False)),
            ("3d_merged", (2, 2, 7), ("rb", "cb", "mult"), jd.strassen_shardmap_3d, {}),
            ("2d", (2, 7), ("rows", "mult"), jd.strassen_shardmap_2d, {})):
        mesh = make_mesh(shape, names)
        got = jax.jit(lambda x, y: fn(x, y, mesh=mesh, **kw))(jnp.asarray(a), jnp.asarray(b))
        out[tag] = np.asarray(got)
        for sh in got.addressable_shards:
            pos = tuple(int(i) for i in np.argwhere(mesh.devices == sh.device)[0])
            out[tag + "@" + ",".join(map(str, pos))] = np.asarray(sh.data)
    np.savez(OUT, **out)
"""


def test_shardmap_2d_and_3d_on_full_grids_match_reference(tmp_path):
    """(2, 7) and (2, 2, 7) need 14 and 28 devices: the reference runs them
    in a subprocess on 28 forced host devices. shardmap_3d(merge=False)'s
    per-position tiles equal the reference's shards at each coordinate."""
    path = tmp_path / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=28",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    code = f"OUT = {str(path)!r}\n" + textwrap.dedent(_GRID_REFERENCE)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr
    ref = np.load(path)
    a, b = torch.from_numpy(ref["a"]), torch.from_numpy(ref["b"])
    mesh = make_mesh((2, 2, 7), ("rb", "cb", "mult"), device="cpu")
    quads = td.strassen_shardmap_3d(a, b, mesh=mesh, merge=False)
    np.testing.assert_allclose(quads.numpy(), ref["3d"], atol=FP32_TOL, rtol=0)
    assert mesh.count("psum", "mult") == 1 and mesh.count("psum") == 1
    tiles = td._shardmap_3d_sharded(a, b, mesh, "rb", "cb", "mult", "strassen", None)
    for pos in mesh.positions():
        want = ref["3d@" + ",".join(map(str, pos))]
        assert tuple(tiles[pos].shape) == want.shape == (4, 64, 64)
        np.testing.assert_allclose(tiles[pos].numpy(), want, atol=FP32_TOL, rtol=0)
    mesh.reset()
    merged = td.strassen_shardmap_3d(a, b, mesh=mesh)
    np.testing.assert_allclose(merged.numpy(), ref["3d_merged"], atol=FP32_TOL, rtol=0)
    mesh2 = make_mesh((2, 7), ("rows", "mult"), device="cpu")
    got = td.strassen_shardmap_2d(a, b, mesh=mesh2)
    np.testing.assert_allclose(got.numpy(), ref["2d"], atol=FP32_TOL, rtol=0)
    assert mesh2.count("psum", "mult") == 1 and mesh2.count("psum") == 1


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("dims,scheme", [((256, 128, 192), "strassen"),
                                         ((200, 200, 200), "strassen"),
                                         ((256, 128, 192), "winograd")], ids=str)
def test_fused_sharded_matches_reference_with_no_collective(dims, scheme, depth):
    """strassen1's plain version on every CPU position against the Pallas
    kernel in interpret mode under shard_map, M padded to the stripe grain."""
    mesh, jmesh = _meshes((4, 2), ("data", "model"))
    a, b, ja_, jb_ = _operands(7, *dims)
    got = td.strassen_fused_sharded(a, b, mesh=mesh, depth=depth, scheme=scheme)
    want = jd.strassen_fused_sharded(ja_, jb_, mesh=jmesh, depth=depth, scheme=scheme)
    assert tuple(got.shape) == tuple(want.shape) == (dims[0], dims[2])
    np.testing.assert_allclose(_f32(got), _f32(want), atol=FUSED_TOL, rtol=FUSED_TOL)
    # no combine collective, no reshard: B is placed, never moved between positions
    assert mesh.logical_bytes == 0
    assert {op for op, _ in mesh.traffic} == {"shard", "gather"}


@pytest.mark.parametrize("depth", [1, 2])
def test_fused_sharded_bf16_within_the_bf16_limit(depth):
    mesh, jmesh = _meshes((4, 2), ("data", "model"))
    a, b, ja_, jb_ = _operands(8, 256, 256, 256, torch.bfloat16)
    got = td.strassen_fused_sharded(a, b, mesh=mesh, depth=depth)
    want = jd.strassen_fused_sharded(ja_, jb_, mesh=jmesh, depth=depth)
    assert got.dtype == torch.bfloat16
    diff = np.linalg.norm(_f32(got) - _f32(want)) / np.linalg.norm(_f32(want))
    assert diff <= BF16_LIMIT, diff


def test_a_mesh_keeps_bounded_totals_and_no_results_across_calls():
    """A mesh serves many calls (autotune's timing loops): its totals keep
    one entry per kind of movement and axes, they add up, and the mesh holds
    no tensor of a finished call."""
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    a, b, _, _ = _operands(10, 128, 128, 128)
    td.strassen_bfs_sharded(a, b, mesh=mesh, depth=1)
    once = dict(mesh.traffic)
    for _ in range(3):
        td.strassen_bfs_sharded(a, b, mesh=mesh, depth=1)
    assert list(mesh.traffic) == list(once)
    assert all(mesh.traffic[k].count == 4 * t.count
               and mesh.traffic[k].logical_bytes == 4 * t.logical_bytes for k, t in once.items())
    assert not [v for v in vars(mesh).values() if isinstance(v, torch.Tensor)]
    mesh.reset()
    assert mesh.traffic == {} and mesh.count() == 0 and mesh.logical_bytes == 0


def test_fused_sharded_runs_each_position_once(monkeypatch):
    """One fused product per position, at the stripe shape; positions off
    ``rows_axes`` hold replicas of a stripe and share its product."""
    from repro_torch.kernels.strassen import ops

    calls = []
    real = ops.strassen_matmul_fused_padded
    monkeypatch.setattr(ops, "strassen_matmul_fused_padded",
                        lambda a, b, **k: calls.append(tuple(a.shape)) or real(a, b, **k))
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    a, b, _, _ = _operands(9, 256, 128, 64)
    td.strassen_fused_sharded(a, b, mesh=mesh, depth=2)
    assert calls == [(32, 128)] * 8
    calls.clear()
    td.strassen_fused_sharded(a, b, mesh=mesh, depth=1, rows_axes=("data",))
    assert calls == [(64, 128)] * 4


@pytest.mark.parametrize("shape,names", [
    ((4, 2), ("data", "model")), ((8,), ("data",)), ((7,), ("mult",)), ((1, 7), ("rows", "mult")),
    ((1, 1, 7), ("rb", "cb", "mult")), ((2, 2), ("rb", "cb")), ((2, 4), ("model", "data")),
])
def test_registry_and_available_strategies_equal_reference(shape, names):
    mesh, jmesh = _meshes(shape, names)
    assert list(td.MESH_STRATEGIES) == list(jd.MESH_STRATEGIES)
    for scheme in ("strassen", "winograd", "naive8"):
        assert td.available_strategies(mesh, scheme) == jd.available_strategies(jmesh, scheme)
    assert td.available_strategies(None) == jd.available_strategies(None) == []
    for name in td.MESH_STRATEGIES:
        assert td.get_strategy(name).__name__ == jd.get_strategy(name).__name__ == name


def test_requirement_errors_equal_reference():
    a, b, ja_, jb_ = _operands(10, 128, 128, 128)
    mesh, jmesh = _meshes((4, 2), ("data", "model"))
    with pytest.raises(ValueError) as got:
        td.strassen_shardmap(a, b, mesh=mesh, axis="data")
    with pytest.raises(ValueError) as want:
        jd.strassen_shardmap(ja_, jb_, mesh=jmesh, axis="data")
    assert str(got.value) == str(want.value)
    m8, jm8 = _meshes((8,), ("mult",))
    with pytest.raises(ValueError) as got:
        td.strassen_shardmap(a, b, mesh=m8)
    with pytest.raises(ValueError) as want:
        jd.strassen_shardmap(ja_, jb_, mesh=jm8)
    assert str(got.value) == str(want.value) == "axis 'mult' must have size 7, got 8"
    with pytest.raises(AssertionError):
        td.strassen_shardmap_2d(a, b, mesh=make_mesh((1, 8), ("rows", "mult"), device="cpu"))
    with pytest.raises(AssertionError):
        td.strassen_shardmap_3d(a, b, mesh=make_mesh((1, 1, 8), ("rb", "cb", "mult"), device="cpu"))
    mult, jmult = _meshes((7,), ("mult",))
    with pytest.raises(ValueError) as got:
        td.strassen_fused_sharded(a, b, mesh=mult, depth=1)
    with pytest.raises(ValueError) as want:
        jd.strassen_fused_sharded(ja_, jb_, mesh=jmult, depth=1)
    assert str(got.value) == str(want.value)
    with pytest.raises(KeyError):
        td.get_strategy("strassen_nope")
    assert m8.count() == 0  # refused before any movement
