"""The port's sharding layer against the JAX package's, on the CPU.

``repro_torch.models.sharding`` (rules, context, ``constrain``),
``repro_torch.launch.mesh`` and the rule half of ``repro_torch.launch.specs``
against ``repro.models.sharding``, ``repro.launch.mesh`` and
``repro.launch.specs``: the specs are compared with ``==`` (they are pure
functions of names, shapes and ``mesh.shape``). The JAX side runs on
conftest's 8 host devices; the port's meshes have the same shapes, every
position on the CPU. ``backend.matmul`` with ``w_logical`` under a (4, 2)
mesh is held against the JAX package's under ``use_sharding`` at the
unsharded parity tests' fp32 bound (2e-4, ``tests/test_torch_backend.py``),
and ``mesh.traffic`` after one forward of each family's smoke config
against a closed form this file derives from the config.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # fall back to the vendored grid shim
    from _propshim import given, settings, strategies as st

from repro import configs as jconfigs
from repro.core import backend as JB
from repro.launch import mesh as JLM
from repro.launch import specs as JS
from repro.models import sharding as JSH
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.training.train_step import init_train_state as jinit_train_state
from repro_torch import configs as tconfigs
from repro_torch.convert import _flatten
from repro_torch.core import backend as TB
from repro_torch.core.mesh import P, Traffic, distinct_slabs, slab
from repro_torch.launch import mesh as TLM
from repro_torch.launch import specs as TS
from repro_torch.models import model as TM
from repro_torch.models import sharding as TSH
from repro_torch.models.frontends import make_stub_frames
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.train_step import init_train_state

RNG = np.random.default_rng(31)
FAMILIES = ["phi4_mini_3_8b", "qwen1_5_32b", "gemma_7b", "internlm2_20b", "qwen2_vl_72b",
            "olmoe_1b_7b", "qwen2_moe_a2_7b", "recurrentgemma_9b", "xlstm_1_3b",
            "whisper_tiny"]
LOGICAL = list(JSH.DEFAULT_RULES.rules) + [None, "unknown"]
MESH_AXES = [("data", "model"), ("pod", "data", "model"), ("model",), ("data",), ("model", "data")]


class _Shape:
    """A stand-in mesh: both packages' ``spec`` read only ``mesh.shape``."""

    def __init__(self, names, sizes):
        self.shape = dict(zip(names, sizes))


def _jmesh(n=8, mp=2):
    if jax.device_count() < n:
        pytest.skip("needs the conftest multi-device host platform")
    return JLM.make_mesh_for(n, model_parallel=mp)


def _tmesh(n=8, mp=2):
    return TLM.make_mesh_for(n, model_parallel=mp, device="cpu")


# ------------------------------------------------------------------- rules
@settings(max_examples=300, deadline=None)
@given(
    axes=st.sampled_from(MESH_AXES),
    sizes=st.lists(st.integers(1, 16), min_size=3, max_size=3),
    names=st.lists(st.sampled_from(LOGICAL), min_size=1, max_size=5),
    dims=st.lists(st.integers(1, 64), min_size=5, max_size=5),
    uneven=st.booleans(),
)
def test_spec_matches_jax(axes, sizes, names, dims, uneven):
    mesh = _Shape(axes, sizes[: len(axes)])
    shape = tuple(dims[: len(names)])
    want = JSH.DEFAULT_RULES.spec(mesh, names, shape, allow_uneven=uneven)
    got = TSH.DEFAULT_RULES.spec(mesh, names, shape, allow_uneven=uneven)
    assert isinstance(got, P)
    assert tuple(got) == tuple(want)
    for name, dim in zip(names, shape):
        assert TSH.DEFAULT_RULES.axes_for(mesh, name, dim, allow_uneven=uneven) == (
            JSH.DEFAULT_RULES.axes_for(mesh, name, dim, allow_uneven=uneven))


def test_rules_table_is_the_jax_one():
    assert TSH.DEFAULT_RULES.rules == JSH.DEFAULT_RULES.rules


def test_spec_raises_where_jax_raises():
    mesh = _Shape(("data", "model"), (4, 2))
    with pytest.raises(AssertionError):
        JSH.DEFAULT_RULES.spec(mesh, ("batch",), (8, 8))
    with pytest.raises(ValueError, match="do not fit"):
        TSH.DEFAULT_RULES.spec(mesh, ("batch",), (8, 8))


def test_use_sharding_nests_and_resets():
    outer, inner = _tmesh(8, 2), _tmesh(4, 2)
    assert TSH.current() is None and TSH.current_mesh() is None
    with TSH.use_sharding(outer):
        assert TSH.current_mesh() is outer
        with TSH.use_sharding(inner):
            assert TSH.current_mesh() is inner
            with TSH.use_sharding(None):
                assert TSH.current() is None
            assert TSH.current_mesh() is inner
        assert TSH.current() == (outer, TSH.DEFAULT_RULES)
    assert TSH.current() is None
    with pytest.raises(RuntimeError):
        with TSH.use_sharding(outer):
            raise RuntimeError("boom")
    assert TSH.current() is None


def test_bind_carries_the_context_to_another_thread():
    """Remat's recompute runs in autograd's device thread on the card, which
    sees no context of the caller's thread; ``bind`` carries it there."""
    import threading

    mesh, seen = _tmesh(8, 2), {}
    with TSH.use_sharding(mesh):
        bound = TSH.bind(lambda: TSH.current_mesh())
        plain = lambda: TSH.current_mesh()
    for name, fn in (("bound", bound), ("plain", plain)):
        t = threading.Thread(target=lambda n=name, f=fn: seen.__setitem__(n, f()))
        t.start()
        t.join()
    assert seen == {"bound": mesh, "plain": None}
    assert TSH.bind(plain)() is None


def test_constrain_is_the_identity_and_records_the_layout():
    x = torch.zeros(8, 6, 24)
    assert TSH.constrain(x, "batch", "seq", "heads") is x
    mesh = _tmesh(8, 2)
    with TSH.use_sharding(mesh):
        assert TSH.constrain(x, "batch", "seq", "heads") is x
        with pytest.raises(ValueError):
            TSH.constrain(x, "batch")
    assert mesh.traffic == {("constrain", ("data", "model")): Traffic(1, 0, 0)}
    assert mesh.logical_bytes == 0
    jmesh = _jmesh()
    want = JSH.DEFAULT_RULES.spec(jmesh, ("batch", "seq", "heads"), (8, 6, 24), allow_uneven=True)
    got = TSH.DEFAULT_RULES.spec(mesh, ("batch", "seq", "heads"), (8, 6, 24), allow_uneven=True)
    assert tuple(got) == tuple(want)


def test_make_named_sharding_and_meshes_match_jax():
    jmesh, tmesh = _jmesh(8, 2), _tmesh(8, 2)
    assert dict(tmesh.shape) == dict(jmesh.shape)
    for names, shape in ((("fsdp", "heads"), (64, 48)), (("vocab", "fsdp"), (250, 64)),
                         (("experts", "fsdp", "d_ff"), (8, 64, 96))):
        want = JSH.make_named_sharding(jmesh, names, shape)
        got = TSH.make_named_sharding(tmesh, names, shape)
        assert got.mesh is tmesh and tuple(got.spec) == tuple(want.spec)
    prod = TLM.make_production_mesh(device="cpu")
    assert dict(prod.shape) == {"data": 16, "model": 16} and prod.size == 256
    multi = TLM.make_production_mesh(multi_pod=True, device="cpu")
    assert dict(multi.shape) == {"pod": 2, "data": 16, "model": 16}
    assert dict(TLM.make_mesh_for(12, model_parallel=4, device="cpu").shape) == {"data": 3, "model": 4}


# ------------------------------------------------- the launcher's rule cases
# tests/test_launch.py:76-104, through the port's functions.
PARAM_CASES = [
    ("groups/pos0/mixer/wq/w", (8, 3072, 3072), (None, "fsdp", "heads")),
    ("tail/0/mixer/wo/w", (3072, 3072), ("heads", "fsdp")),
    ("embed/embedding", (200064, 3072), ("vocab", "fsdp")),
    ("m/embed/unembedding", (3072, 200064), ("fsdp", "vocab")),
    ("groups/pos1/ffn/w_gate", (4, 64, 2048, 1024), (None, "experts", "fsdp", "d_ff")),
    ("groups/pos0/ln1/scale", (8, 3072), (None, None)),
    ("layers/3/mixer/wq/w", (3072, 3072), ("fsdp", "heads")),
    ("opt/v/layers/0/ffn/down/w", (8192, 3072), ("d_ff", "fsdp")),
]
CACHE_CASES = [
    ("groups/pos0/k", (8, 128, 8, 32768, 128), (None, "batch", "kv_heads", "cache_seq", None)),
    ("groups/pos7/h", (6, 1, 4, 512), (None, "batch", None, "state")),
    ("tail/0/h", (1, 4096), ("batch", "state")),
    ("pos", (), ()),
    ("layers/2/h", (1, 4, 512), ("batch", None, "state")),
]


@pytest.mark.parametrize("path,shape,want", PARAM_CASES)
def test_param_rules(path, shape, want):
    assert TS.param_logical_axes(path, shape) == want == JS.param_logical_axes(path, shape)


@pytest.mark.parametrize("path,shape,want", CACHE_CASES)
def test_cache_rules(path, shape, want):
    assert TS.cache_logical_axes(path, shape) == want == JS.cache_logical_axes(path, shape)


def test_batch_rules():
    assert TS.batch_logical_axes("tokens", (256, 4096)) == ("batch", None)
    assert TS.batch_logical_axes("positions", (32, 128, 3)) == ("batch", None, None)
    assert TS._PARAM_RULES == JS._PARAM_RULES and TS._CACHE_RULES == JS._CACHE_RULES


# ------------------------------------------------------------ sharding trees
def _jax_specs_by_port_name(tree, cfg) -> dict:
    """JAX ``NamedSharding`` leaves of a parameter-shaped tree, keyed by the
    port's names; a scan-stacked leaf's spec loses its leading ``None``."""
    specs = jax.tree.map(lambda s: tuple(s.spec), tree,
                         is_leaf=lambda s: isinstance(s, jax.sharding.NamedSharding))
    out: dict = {}
    if cfg.is_encdec:
        _flatten({k: specs[k] for k in ("embed", "enc_norm", "dec_norm")}, "", out)
        for stack in ("enc", "dec"):
            for i, layer in enumerate(specs[stack]):
                _flatten(layer, f"{stack}.{i}.", out)
        return {k: (v, False) for k, v in out.items()}
    period = len(cfg.block_pattern)
    n_groups = cfg.n_layers // period
    _flatten({"embed": specs["embed"], "final_norm": specs["final_norm"]}, "", out)
    flat = {k: (v, False) for k, v in out.items()}
    for j in range(period if "groups" in specs else 0):
        grp: dict = {}
        _flatten(specs["groups"][f"pos{j}"], "", grp)
        for g in range(n_groups):
            flat.update({f"layers.{g * period + j}.{k}": (v, True) for k, v in grp.items()})
    for i, layer in enumerate(specs.get("tail", [])):
        tail: dict = {}
        _flatten(layer, f"layers.{n_groups * period + i}.", tail)
        flat.update({k: (v, False) for k, v in tail.items()})
    return flat


def _same_spec(got: P, want, stacked: bool) -> bool:
    return tuple(got) == (tuple(want)[1:] if stacked else tuple(want))


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharding_tree_matches_jax_for_params_and_moments(arch):
    jmesh, tmesh = _jmesh(8, 2), _tmesh(8, 2)
    jcfg, tcfg = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    opt = JAdamWConfig(lr=1e-3)
    shapes = jax.eval_shape(lambda k: jinit_train_state(jcfg, opt, k), jax.random.PRNGKey(0))
    jtree = JS.sharding_tree(shapes, jmesh, JS.param_logical_axes)
    state = init_train_state(tcfg, AdamWConfig(lr=1e-3), torch.Generator().manual_seed(0))
    got = TS.sharding_tree(state, tmesh, TS.param_logical_axes)
    assert set(got) == ({f"params/{TS.path_of(n)}" for n, _ in state.params.named_parameters()}
                        | {"opt/step"}
                        | {f"opt/{mv}/{TS.path_of(n)}" for mv in "mv" for n in state.opt.m})
    assert tuple(got["opt/step"].spec) == tuple(jtree.opt.step.spec) == ()
    named = dict(state.params.named_parameters())
    for prefix, sub in (("params", jtree.params), ("opt/m", jtree.opt.m), ("opt/v", jtree.opt.v)):
        want = _jax_specs_by_port_name(sub, tcfg)
        assert set(want) == set(named)
        for name, (spec, stacked) in want.items():
            sh = got[f"{prefix}/{TS.path_of(name)}"]
            assert sh.mesh is tmesh
            assert len(sh.spec) == named[name].ndim
            assert _same_spec(sh.spec, spec, stacked), (prefix, name, sh.spec, spec)


# --------------------------------------------------------- sharded projections
KINDS = ["naive", "strassen", "winograd", "strassen_fused"]
W_LOGICAL = [("fsdp", "heads"), ("heads", "fsdp"), ("d_ff", "fsdp"), (None, "experts")]


@pytest.mark.parametrize("w_logical", W_LOGICAL)
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_matmul_matches_jax_and_cuts_the_specs_slabs(kind, w_logical, monkeypatch):
    """Rows 24 over data 4 and a K of 42 (21 a slab over model 2, odd: the
    row-parallel slabs pad to the depth); x leads with (3, 8)."""
    x = RNG.standard_normal((3, 8, 42)).astype(np.float32)
    w = RNG.standard_normal((42, 48)).astype(np.float32)
    be = dict(kind=kind, depth=1, min_dim=8)
    jmesh, tmesh = _jmesh(8, 2), _tmesh(8, 2)
    with JSH.use_sharding(jmesh):
        want = jax.jit(lambda a, b: JB.matmul(a, b, JB.MatmulBackend(**be), w_logical=w_logical))(
            jnp.asarray(x), jnp.asarray(w))
    seen = []
    real = TB._local_product

    def spy(*args):
        product = real(*args)

        def run(a, b):
            seen.append((tuple(a.shape), tuple(b.shape)))
            return product(a, b)
        return run

    monkeypatch.setattr(TB, "_local_product", spy)
    with TSH.use_sharding(tmesh):
        got = TB.matmul(torch.from_numpy(x), torch.from_numpy(w), TB.MatmulBackend(**be),
                        w_logical=w_logical)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    _, wg_spec, x_spec, _ = TB.sharded_layouts(tmesh, TSH.DEFAULT_RULES, 24, 42, 48, w_logical)
    want_shapes = set()
    for pos in tmesh.positions():
        xs = slab(tmesh, x_spec, (24, 42), pos)
        ws = slab(tmesh, wg_spec, (42, 48), pos)
        want_shapes.add((tuple(b - a for a, b in xs), tuple(b - a for a, b in ws)))
    assert set(seen) == want_shapes
    assert len(seen) == distinct_slabs(tmesh, (x_spec, (24, 42)), (wg_spec, (42, 48)))
    assert tmesh.physical_bytes == 0


def test_sharded_matmul_gradient_matches_unsharded():
    """Autograd through shard, all-gather, psum and gather: the sharded
    product's gradients equal the unsharded ones (fp32, 1e-5 normwise)."""
    tmesh = _tmesh(8, 2)
    x = torch.from_numpy(RNG.standard_normal((32, 40)).astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(RNG.standard_normal((40, 24)).astype(np.float32)).requires_grad_(True)
    for kind in ("naive", "strassen"):
        be = TB.MatmulBackend(kind=kind, depth=1, min_dim=8)
        for w_logical in (("fsdp", "d_ff"), ("d_ff", "fsdp")):
            grads = []
            for ctx in (TSH.use_sharding(tmesh), TSH.use_sharding(None)):
                x.grad = w.grad = None
                with ctx:
                    TB.matmul(x, w, be, w_logical=w_logical).pow(2).sum().backward()
                grads.append((x.grad.clone(), w.grad.clone()))
            for g, h in zip(*grads):
                assert float((g - h).norm() / h.norm()) <= 1e-5, (kind, w_logical)


# ------------------------------------------------------------------ traffic
def _closed_form(cfg, batch: int, seq: int, data: int, model: int) -> dict:
    """Logical bytes of one fp32 forward's projections under (data, model):

    * all-gather over data: (data - 1) x the bytes of every weight whose
      FSDP dim is sharded (every projection that carries ``w_logical``:
      attention's wq/wk/wv/wo, the MLPs' up/gate/down, a shared expert's);
    * psum over model: 2 (model - 1) x the row-parallel outputs' (wo,
      down: rows x d_model) bytes in each data group, over the groups.
    """
    d, hd = cfg.d_model, cfg.head_dim
    item = 4

    def attn_elems():
        return d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)

    def mlp_elems(f):
        return d * f * (3 if cfg.glu else 2)

    def rows_in_groups(rows):  # the data groups' rows: all of them once, or each group all
        return rows if rows % data == 0 or rows > data // 2 else rows * data

    gathered = psum_rows = 0
    stacks = []
    if cfg.is_encdec:
        stacks = [(cfg.enc_layers, batch * cfg.enc_seq), (cfg.n_layers, batch * seq)]
        for n_layers, rows in stacks:
            gathered += n_layers * (attn_elems() + mlp_elems(cfg.d_ff))
            psum_rows += n_layers * 2 * rows_in_groups(rows)
    else:
        rows = batch * seq
        period = cfg.block_pattern
        for i in range(cfg.n_layers):
            kind = period[i % len(period)]
            if kind in ("attn", "local_attn"):
                gathered += attn_elems()
                psum_rows += rows_in_groups(rows)
            if cfg.is_moe:
                if cfg.n_shared_experts:
                    gathered += mlp_elems(cfg.d_expert * cfg.n_shared_experts)
                    psum_rows += rows_in_groups(rows)
            elif cfg.d_ff > 0:
                gathered += mlp_elems(cfg.d_ff)
                psum_rows += rows_in_groups(rows)
    return {
        ("all_gather", ("data",)): (data - 1) * gathered * item,
        ("psum", ("model",)): 2 * (model - 1) * psum_rows * d * item,
    }


@pytest.mark.parametrize("arch", FAMILIES)
def test_traffic_of_one_forward_equals_the_closed_form(arch):
    cfg = tconfigs.get_smoke_config(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(3))
    batch, seq = 4, 8
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab, (batch, seq)))
    inputs = {"tokens": toks}
    if cfg.is_encdec:
        inputs["frames"] = make_stub_frames(cfg, batch, torch.Generator().manual_seed(4), device="cpu")
    mesh = _tmesh(8, 2)
    with torch.no_grad(), TSH.use_sharding(mesh):
        TM.apply_train(params, inputs, cfg)
    want = _closed_form(cfg, batch, seq, 4, 2)
    for key, nbytes in want.items():
        got = mesh.traffic.get(key)
        assert (got.logical_bytes if got else 0) == nbytes, (key, got, nbytes)
    other = {k: t for k, t in mesh.traffic.items() if k not in want and t.logical_bytes}
    if cfg.is_moe:  # the expert FFN's weight gathers and the dispatch/combine reshards
        assert set(other) <= {("all_gather", ("model",)), ("reshard", ()), ("reshard", ("data",))}
    else:
        assert other == {}
    assert mesh.physical_bytes == 0


def test_closed_form_sees_uneven_rows():
    cfg = dataclasses.replace(tconfigs.get_smoke_config("phi4_mini_3_8b"), n_layers=1)
    params = TM.init_params(cfg, torch.Generator().manual_seed(3))
    mesh = _tmesh(8, 2)
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab, (1, 7)))  # 7 rows over data 4: 2, 2, 2, 1
    with torch.no_grad(), TSH.use_sharding(mesh):
        TM.apply_train(params, {"tokens": toks}, cfg)
    assert mesh.traffic[("psum", ("model",))].logical_bytes == 2 * 2 * 7 * cfg.d_model * 4
