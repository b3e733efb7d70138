"""The port's mesh layer (repro_torch.core.mesh) against JAX's sharding and numpy.

On the CPU every position of a mesh is the CPU. Layouts whose dims divide
evenly are held against ``jax.device_put`` under the same ``NamedSharding``
on conftest's 8 host devices, shard for shard at the same mesh coordinate;
uneven dims against JAX's padded cut (ceil-sized shards, the last short or
empty), which jit applies inside a program and no array API exposes. The
collectives are held against JAX's ``shard_map`` collectives and numpy,
exactly (fp32 sums of a few small integers).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.core.compat import make_mesh as jmake_mesh
from repro.core.compat import shard_map as jshard_map
from repro_torch.core import mesh as M
from repro_torch.core.mesh import P, Traffic, dim_parts, fetch, gather, make_mesh, reshard, shard

RNG = np.random.default_rng(23)
SPECS = [P(), P("data"), P(None, "model"), P(("data", "model"), None), P("model", "data"),
         P(("model", "data")), P(None, ("data", "model"))]


def _jmesh(shape=(4, 2), names=("data", "model")):
    if jax.device_count() < int(np.prod(shape)):
        pytest.skip("needs the conftest multi-device host platform")
    return jmake_mesh(shape, names)


def _coord(jmesh, device):
    return tuple(int(i) for i in np.argwhere(jmesh.devices == device)[0])


def test_make_mesh_shape_and_placement(monkeypatch):
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    assert list(mesh.shape.items()) == [("data", 4), ("model", 2)]
    assert mesh.shape.get("mult") is None and mesh.size == 8 and mesh.devices.shape == (4, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat) and mesh.physical_count() == 1
    assert mesh.axis_index((3, 1), ("data", "model")) == 7
    assert mesh.axis_index((3, 1), ("model", "data")) == 7 and mesh.axis_index((1, 1), ("model", "data")) == 5
    # round-robin over the visible cards, in row-major order of the positions
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = make_mesh((2, 2), ("a", "b"), device="cuda")
    assert [d.index for d in cards.devices.flat] == [0, 1, 2, 0] and cards.physical_count() == 3
    one = make_mesh((7,), ("mult",), device="cuda:2")
    assert {str(d) for d in one.devices.flat} == {"cuda:2"}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((2,), ("a",), device="cuda")
    with pytest.raises(ValueError):
        M.Mesh(np.empty((2, 2), dtype=object), ("a",))


@pytest.mark.parametrize("size,n,want", [
    (343, 4, [86, 86, 86, 85]), (49, 4, [13, 13, 13, 10]), (7, 4, [2, 2, 2, 1]),
    (5, 4, [2, 2, 1, 0]), (1, 4, [1, 0, 0, 0]), (16, 8, [2] * 8), (343, 16, [22] * 15 + [13]),
])
def test_uneven_cut_is_jax_padded_cut(size, n, want):
    """ceil(size / n) per shard, the last ones short or empty: 343 over 16
    pads 9 of 352 rows (2.6%), as distributed.py's comment counts."""
    parts = dim_parts(size, n)
    assert [b - a for a, b in parts] == want
    assert parts[0][0] == 0 and parts[-1][1] == size
    assert all(p[1] == q[0] for p, q in zip(parts, parts[1:]))


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_shard_matches_jax_named_sharding(spec):
    """Every spec form (None, a name, a tuple of names, either order) cuts
    the positions' shards as JAX's NamedSharding does."""
    jmesh = _jmesh()
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    x = RNG.standard_normal((16, 8)).astype(np.float32)
    s = shard(torch.from_numpy(x), mesh, spec)
    jx = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, JP(*spec)))
    for sh in jx.addressable_shards:
        pos = _coord(jmesh, sh.device)
        np.testing.assert_array_equal(s[pos].numpy(), np.asarray(sh.data))
        assert tuple(slice(a, b) for a, b in s.slab(pos)) == tuple(
            slice(i.start or 0, i.stop if i.stop is not None else dim)
            for i, dim in zip(sh.index, x.shape))
    assert torch.equal(gather(s), torch.from_numpy(x))


@pytest.mark.parametrize("shape", [(7, 5), (343, 3), (1, 9), (5, 3, 2)])
@pytest.mark.parametrize("spec", [P("data", "model"), P(("data", "model")), P(None, "data")],
                         ids=repr)
def test_shard_gather_reshard_round_trips_on_uneven_dims(shape, spec):
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    x = torch.from_numpy(RNG.standard_normal(shape).astype(np.float32))
    s = shard(x, mesh, spec)
    for pos in mesh.positions():
        bounds = s.slab(pos)
        assert torch.equal(s[pos], x[tuple(slice(a, b) for a, b in bounds)])
    assert torch.equal(gather(s), x)
    for other in SPECS[:4]:
        r = reshard(s, other)
        assert r.spec == other and torch.equal(gather(r), x)
        for pos in mesh.positions():
            assert torch.equal(r[pos], x[tuple(slice(a, b) for a, b in r.slab(pos))])
        assert torch.equal(gather(reshard(r, spec)), x)


def test_replicated_operand_on_one_device_shares_storage():
    """Seven positions of a replicated operand alias one storage, and a
    function over replicas runs once."""
    mesh = make_mesh((7,), ("mult",), device="cpu")
    x = torch.from_numpy(RNG.standard_normal((64, 64)).astype(np.float32))
    s = shard(x, mesh, P())
    assert all(s[pos] is x for pos in mesh.positions())
    calls = []
    out = mesh.map(lambda t: calls.append(1) or t * 2, s.locals)
    assert len(calls) == 1 and len({id(out[pos]) for pos in mesh.positions()}) == 1
    assert gather(s) is x  # a replicated layout gathers without a copy
    # rows over data only: the model replicas of a stripe share one view
    mesh42 = make_mesh((4, 2), ("data", "model"), device="cpu")
    rows = shard(x, mesh42, P("data"))
    for d in range(4):
        assert rows[(d, 0)] is rows[(d, 1)]
        assert rows[(d, 0)].data_ptr() == x[16 * d].data_ptr()
    assert mesh.physical_bytes == 0 and mesh.logical_bytes == 0


def _locals(mesh, shape, fn):
    return mesh.run(lambda pos: torch.from_numpy(fn(pos, shape)))


@pytest.mark.parametrize("axis", ["data", "model", ("data", "model"), ("model", "data")],
                         ids=str)
def test_collectives_match_jax_shard_map(axis):
    """psum, tiled all_gather and tiled psum_scatter over an axis or a tuple
    of axes give each position what JAX's shard_map collectives give the
    device at the same coordinate."""
    jmesh = _jmesh()
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    k = mesh.axis_size(axis)
    glob = RNG.integers(-4, 5, size=(4 * 8, 2 * 3)).astype(np.float32)
    # position (d, m) holds block (d, m) of the global: (8, 3)
    xs = mesh.run(lambda pos: torch.from_numpy(glob[8 * pos[0]:8 * pos[0] + 8,
                                                    3 * pos[1]:3 * pos[1] + 3].copy()))
    jx = jax.device_put(jnp.asarray(glob), NamedSharding(jmesh, JP("data", "model")))
    cases = [
        ("psum", mesh.psum(xs, axis), lambda v: jax.lax.psum(v, axis)),
        ("all_gather", mesh.all_gather(xs, axis),
         lambda v: jax.lax.all_gather(v, axis, axis=0, tiled=True)),
        ("psum_scatter", mesh.psum_scatter(xs, axis),
         lambda v: jax.lax.psum_scatter(v, axis, scatter_dimension=0, tiled=True)),
    ]
    for name, got, body in cases:
        fn = jshard_map(body, mesh=jmesh, in_specs=(JP("data", "model"),),
                        out_specs=JP("data", "model"))
        want = np.asarray(fn(jx))
        rows, cols = want.shape[0] // 4, want.shape[1] // 2
        for pos in mesh.positions():
            block = want[rows * pos[0]:rows * (pos[0] + 1), cols * pos[1]:cols * (pos[1] + 1)]
            np.testing.assert_array_equal(got[pos].numpy(), block, err_msg=f"{name} {pos}")
    # the totals: psum 2(k-1)B, all-gather (k-1) x the gathered bytes,
    # psum-scatter (k-1)B per group
    groups = mesh.size // k
    nbytes = 8 * 3 * 4
    axes = (axis,) if isinstance(axis, str) else axis
    assert mesh.traffic == {
        ("psum", axes): Traffic(1, groups * 2 * (k - 1) * nbytes, 0),
        ("all_gather", axes): Traffic(1, groups * (k - 1) * k * nbytes, 0),
        ("psum_scatter", axes): Traffic(1, groups * (k - 1) * nbytes, 0),
    }
    assert mesh.physical_bytes == 0
    assert mesh.count("psum", axis) == 1 and mesh.count("psum", "other") == 0


def test_psum_adds_in_member_order_in_the_tensors_dtype():
    """bf16 contributions add in bf16, one rounding per add, in the order of
    the members' index along the axis."""
    mesh = make_mesh((3,), ("mult",), device="cpu")
    vals = [1.0, 2.0 ** -8, 2.0 ** -8]
    xs = mesh.run(lambda pos: torch.tensor([vals[pos[0]]], dtype=torch.bfloat16))
    got = mesh.psum(xs, "mult")
    # (1 + 2^-8) rounds to 1 in bf16 (8 bits of mantissa), twice
    assert got[(0,)].item() == 1.0 and got[(0,)] is got[(2,)]
    xs32 = mesh.run(lambda pos: torch.tensor([vals[pos[0]]], dtype=torch.float32))
    assert mesh.psum(xs32, "mult")[(1,)].item() == 1.0 + 2.0 ** -7


def test_fetch_counts_only_what_a_position_did_not_hold():
    mesh = make_mesh((4,), ("data",), device="cpu")
    x = torch.arange(32 * 2, dtype=torch.float32).reshape(32, 2)
    s = shard(x, mesh, P("data"))
    # every position fetches rows 0..16: positions 0 and 1 hold half of it each
    got = fetch(s, lambda pos: [(slice(0, 16), slice(None))], then=lambda pos, got: got[0])
    for pos in mesh.positions():
        assert torch.equal(got[pos], x[:16])
    row = 2 * 4
    assert mesh.traffic[("reshard", ())] == Traffic(1, (8 + 8 + 16 + 16) * row, 0)
    with pytest.raises(ValueError):
        shard(x, mesh, P("nope"))
    with pytest.raises(ValueError, match="split"):
        mesh.psum_scatter(mesh.run(lambda pos: torch.ones(3)), "data")
