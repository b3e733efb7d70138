"""Port parity: the MoE FFN of repro_torch against repro.models.moe, on the CPU.

The same seeded numpy inputs and the JAX parameters (carried across by
``convert.params_from_jax``'s flattening) go through both packages, on the
olmoe and qwen2-moe smoke configs (qwen2-moe has shared experts):

* the router: expert indices and keep masks exactly equal, gates and the aux
  loss within 1e-6 relative;
* ``moe_block`` on all three routes (one global group, one group per row,
  the grouped expert-parallel layout): fp32 outputs within
  1e-5 * max(1, max|ref|), and the capacity_factor=0.01 drop case finite and
  equal to the reference;
* in bf16, the routed experts bit for bit, once SiLU is evaluated as XLA's
  CPU backend evaluates it (1 / (1 + exp(-x)), rounded to bf16 after each
  op): dispatch, the expert products, the gate's cast and the combine's
  order of adds are then the same computation. With PyTorch's fused SiLU
  (one rounding) every output element lies within BF16_TOL x (|ref| +
  rms(ref)) of the reference; the worst seen on these inputs is 6.5 x 2^-8;
* grouped dispatch equals the global group with ample capacity, through
  ``transformer.forward`` with no cache, as ``tests/test_perf_features.py``
  holds it for the JAX package.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT

RNG = np.random.default_rng(41)
ARCHS = ["olmoe_1b_7b", "qwen2_moe_a2_7b"]
# route name -> (moe_group_dispatch, moe_expert_parallel)
ROUTES = {"global": (False, False), "grouped": (True, False), "grouped_ep": (True, True)}
# 8 bf16 roundings (2^-8 each) of an output element's own scale, with a floor
# of the output's rms for elements near 0 (the terms of a sum cancel there).
BF16_TOL = 2.0**-5


def _t(a):
    return tensor_from_numpy(np.array(a), "cpu")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = _t(v)
    return out


def _cfgs(arch, route="global", **overrides):
    group, ep = ROUTES[route]
    kw = dict(moe_group_dispatch=group, moe_expert_parallel=ep, **overrides)
    return jax_smoke(arch, **kw), get_smoke_config(arch, **kw)


def _pair(arch, dtype, route="global", **overrides):
    jcfg, tcfg = _cfgs(arch, route, **overrides)
    jp = JMOE.init_moe(jax.random.PRNGKey(3), jcfg, jnp.dtype(dtype))
    tp = TMOE.init_moe(torch.Generator().manual_seed(0), tcfg, getattr(torch, dtype))
    tp.load_state_dict(_flat(jp), strict=True)
    return jcfg, tcfg, jp, tp


def _x(shape, dtype):
    x = RNG.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), _t(jnp.asarray(x).astype(dtype))


def _jax_keep(expert_idx, cfg, cap):
    """repro/models/moe.py:81-84, on the JAX expert indices."""
    e_flat = expert_idx.reshape(-1)
    onehot = jax.nn.one_hot(e_flat, cfg.n_experts, dtype=jnp.int32)
    pos_in_e = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1
    return np.asarray(pos_in_e < cap), np.asarray(jnp.where(pos_in_e < cap, pos_in_e, cap))


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=rel * scale, rtol=0)


def _within_bf16(got, want, tol=BF16_TOL):
    """|got - want| <= tol * (|want| + rms(want)), elementwise."""
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    g = got.float().numpy()
    assert g.shape == w.shape and np.isfinite(g).all()
    worst = float(np.max(np.abs(g - w) / (np.abs(w) + np.sqrt(np.mean(w**2)))))
    assert worst <= tol, f"worst |d| / (|ref| + rms(ref)) = {worst:.4f} > {tol}"


def _xla_cpu_silu(x):
    """jax.nn.silu as XLA's CPU backend computes it in bf16: x * 1 / (1 +
    exp(-x)), each op computed in fp32 and rounded to bf16."""
    return x * (1 / (1 + torch.exp(-x)))


# ------------------------------------------------------------------ router
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens", [4, 64])
def test_route_picks_and_keeps_exactly_as_reference(arch, dtype, tokens):
    jcfg, tcfg, jp, tp = _pair(arch, dtype)
    jx, tx = _x((tokens, jcfg.d_model), dtype)
    jg, je, ja = JMOE._route(jp, jx, jcfg)
    tg, te, ta = TMOE._route(tp, tx, tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    assert abs(float(ta) - float(ja)) <= 1e-6 * abs(float(ja))
    for cap in (TMOE._capacity(tokens, tcfg), 1, 3):
        keep, slot = TMOE._slots(te.reshape(-1), tcfg, cap)
        jkeep, jslot = _jax_keep(je, jcfg, cap)
        np.testing.assert_array_equal(keep.numpy(), jkeep)
        np.testing.assert_array_equal(slot.numpy(), jslot)
    assert TMOE._capacity(tokens, tcfg) == JMOE._capacity(tokens, jcfg)


def test_capacity_matches_reference_on_the_shipped_configs():
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config

    for arch in ARCHS:
        for t in (1, 4, 8, 100, 1024, 1984):
            assert TMOE._capacity(t, get_config(arch)) == JMOE._capacity(t, jax_config(arch))


# --------------------------------------------------------------- moe_block
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_moe_block_fp32_matches_reference(arch, route):
    jcfg, tcfg, jp, tp = _pair(arch, "float32", route)
    jx, tx = _x((2, 16, jcfg.d_model), "float32")
    want, jaux = JMOE.moe_block(jp, jx, jcfg)
    got, taux = TMOE.moe_block(tp, tx, tcfg)
    _close(got, want)
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_moe_block_bf16_matches_reference(arch, route):
    jcfg, tcfg, jp, tp = _pair(arch, "bfloat16", route)
    jx, tx = _x((2, 16, jcfg.d_model), "bfloat16")
    want, jaux = JMOE.moe_block(jp, jx, jcfg)
    got, taux = TMOE.moe_block(tp, tx, tcfg)
    assert got.dtype == torch.bfloat16
    _within_bf16(got, want)
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("capacity_factor", [2.0, 0.01])
def test_routed_experts_bf16_bit_equal_under_xla_cpu_silu(arch, route, capacity_factor,
                                                           monkeypatch):
    """The routed experts alone (shared experts are a dense MLP, held by
    tests/test_torch_models.py), with SiLU rounded as XLA's CPU backend rounds it."""
    jcfg, tcfg, jp, tp = _pair(arch, "bfloat16", route, capacity_factor=capacity_factor)
    jp = {k: v for k, v in jp.items() if k != "shared"}
    tp.shared = None
    monkeypatch.setitem(TMOE._ACTS, "silu", _xla_cpu_silu)
    jx, tx = _x((2, 16, jcfg.d_model), "bfloat16")
    want, _ = JMOE.moe_block(jp, jx, jcfg)
    got, _ = TMOE.moe_block(tp, tx, tcfg)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_capacity_drops_match_reference(route, dtype):
    """capacity_factor 0.01: capacity falls to top_k and most assignments drop;
    the output stays finite and equal to the reference's."""
    jcfg, tcfg, jp, tp = _pair("olmoe_1b_7b", dtype, route, capacity_factor=0.01)
    jx, tx = _x((2, 16, jcfg.d_model), dtype)
    want, _ = JMOE.moe_block(jp, jx, jcfg)
    got, _ = TMOE.moe_block(tp, tx, tcfg)
    assert bool(torch.isfinite(got).all())
    if dtype == "float32":
        _close(got, want)
    else:
        _within_bf16(got, want)
    _, te, _ = TMOE._route(tp, tx.reshape(-1, tcfg.d_model), tcfg)
    keep, _ = TMOE._slots(te.reshape(-1), tcfg, TMOE._capacity(32, tcfg))
    assert 0 < int(keep.sum()) < keep.numel()  # some kept, some dropped


def test_combine_adds_in_ascending_k_with_one_rounding_per_add():
    """Three bf16 terms whose sum depends on the order of the adds."""
    w = torch.tensor([[1.0], [2.0**-8], [2.0**-8]], dtype=torch.bfloat16)  # (T*k=3, D=1), k=3
    out = TMOE._combine(w, 3)
    # 1 + 2^-8 rounds to 1 (ties to even), twice; the other order would give 1 + 2^-7
    assert out.item() == 1.0


# ---------------------------------------------- grouped == global, in a model
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ep", [False, True])
def test_grouped_moe_matches_global_with_ample_capacity(arch, ep):
    jcfg = jax_smoke(arch, capacity_factor=4.0)
    tcfg = get_smoke_config(arch, capacity_factor=4.0)
    tcfg_g = dataclasses.replace(tcfg, moe_group_dispatch=True, moe_expert_parallel=ep)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(2))
    tp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu"), strict=True)
    toks = RNG.integers(0, jcfg.vocab, (2, 16))
    l1, _, a1 = TT.forward(tp, torch.from_numpy(toks), tcfg)
    l2, _, a2 = TT.forward(tp, torch.from_numpy(toks), tcfg_g)
    _close(l2, l1.numpy())
    assert abs(float(a1) - float(a2)) < 1e-4
    want, _, jaux = JT.forward(jp, jnp.asarray(toks), jcfg)
    _close(l1, want)
    assert abs(float(a1) - float(jaux)) <= 1e-6 * abs(float(jaux))


@pytest.mark.parametrize("arch", ARCHS)
def test_router_stays_naive_fp32_under_a_strassen_backend(arch):
    """The router runs through the naive backend in fp32 whatever the model's
    backend, as the JAX package's does; the projections take the model's."""
    from repro_torch import obs
    from repro_torch.core.backend import MatmulBackend

    cfg = get_smoke_config(arch, matmul_backend=MatmulBackend(kind="strassen", min_dim=8))
    params = TM.init_params(cfg, torch.Generator().manual_seed(3))
    obs.reset_tracing()
    obs.configure(enabled=True)
    try:
        TT.forward(params, torch.from_numpy(RNG.integers(0, cfg.vocab, (2, 8))), cfg)
        spans = obs.get_tracer().find("backend.matmul")
    finally:
        obs.configure(enabled=False)
        obs.reset_tracing()
    router = [s.attrs for s in spans if s.attrs["site"] == "moe.router"]
    assert len(router) == cfg.n_layers
    assert all(a["kind"] == "naive" and a["n"] == cfg.n_experts for a in router)
    assert {s.attrs["kind"] for s in spans if s.attrs["site"] == "attn.wq"} == {"strassen"}
