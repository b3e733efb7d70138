"""Sharded models of the port against the JAX package's sharded models, on the CPU.

Every family's smoke config runs under a (data 4, model 2) mesh in both
packages: the JAX side under ``repro.models.sharding.use_sharding`` on
conftest's 8 host devices (GSPMD partitions the program), the port under
``repro_torch.models.sharding.use_sharding`` on a mesh of 8 CPU positions
(one local phase per position for the projections, the attention core and
the expert FFN). From the same parameters (``convert.params_from_jax``):

* forward logits of the dense, MoE (global dispatch, and per-row groups with
  expert parallelism on and off), xLSTM, RG-LRU and whisper configs agree at
  1e-4 relative to the largest logit, the bound of the unsharded parity
  tests (``tests/test_torch_models.py``); with no context the port's output
  is bit for bit the same as before;
* one train step, with accum 1 and 4, against ``repro.launch.train.build``
  with the mesh, at ``tests/test_torch_train.py``'s bounds (loss, grad norm
  and lr 1e-5 relative; moments 1e-4 and updates 1e-3 normwise);
* the sharded engine's greedy tokens equal the unsharded port's and the JAX
  engine's for phi4;
* the launchers' ``--mesh`` paths run on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.launch import mesh as JLM
from repro.launch import train as JLT
from repro.models import model as JM
from repro.models import sharding as JSH
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.core.mesh import distinct_slabs
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import mesh as TLM
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as TLT
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import sharding as TSH
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serving.engine import Engine, ServeConfig

RNG = np.random.default_rng(37)
CASES = {
    "phi4_mini_3_8b": ("phi4_mini_3_8b", {}),
    "gemma_7b": ("gemma_7b", {}),
    "qwen2_vl_72b": ("qwen2_vl_72b", {}),
    "olmoe_1b_7b": ("olmoe_1b_7b", {}),
    "olmoe_1b_7b-groups": ("olmoe_1b_7b", dict(moe_group_dispatch=True)),
    "olmoe_1b_7b-ep": ("olmoe_1b_7b", dict(moe_group_dispatch=True, moe_expert_parallel=True)),
    "qwen2_moe_a2_7b-ep": ("qwen2_moe_a2_7b", dict(moe_group_dispatch=True,
                                                    moe_expert_parallel=True)),
    "xlstm_1_3b": ("xlstm_1_3b", {}),
    "recurrentgemma_9b": ("recurrentgemma_9b", {}),
    "whisper_tiny": ("whisper_tiny", {}),
}


def _meshes(n=8, mp=2):
    if jax.device_count() < n:
        pytest.skip("needs the conftest multi-device host platform")
    return JLM.make_mesh_for(n, model_parallel=mp), TLM.make_mesh_for(n, model_parallel=mp,
                                                                      device="cpu")


def _models(arch, **overrides):
    jcfg = jconfigs.get_smoke_config(arch, **overrides)
    tcfg = tconfigs.get_smoke_config(arch, **overrides)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(1))
    tp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu"), strict=True)
    return jcfg, tcfg, jp, tp


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=rel * scale, rtol=0)


def _inputs(cfg, batch=4, seq=8):
    out = {"tokens": RNG.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)}
    if cfg.frontend == "audio_stub":
        out["frames"] = RNG.standard_normal((batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        out["positions"] = np.broadcast_to(np.arange(seq)[None, :, None], (batch, seq, 3)).copy()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_forward_matches_jax_sharded_forward(case):
    arch, overrides = CASES[case]
    jcfg, tcfg, jp, tp = _models(arch, **overrides)
    jmesh, tmesh = _meshes()
    inputs = _inputs(jcfg)
    with JSH.use_sharding(jmesh):
        want, jaux = jax.jit(lambda p, b: JM.apply_train(p, b, jcfg))(
            jp, {k: jnp.asarray(v) for k, v in inputs.items()})
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        plain, _ = TM.apply_train(tp, tin, tcfg)
        with TSH.use_sharding(tmesh):
            got, aux = TM.apply_train(tp, tin, tcfg)
    _close(got, want)
    assert abs(float(aux) - float(jaux)) <= 1e-5 * max(abs(float(jaux)), 1e-6)
    _close(got, plain.numpy())
    assert tmesh.physical_bytes == 0
    if tcfg.is_moe and tcfg.moe_expert_parallel:
        assert tmesh.count("reshard", ("data",)) > 0
    with torch.no_grad():  # no context: the unsharded route, bit for bit
        again, _ = TM.apply_train(tp, tin, tcfg)
    assert torch.equal(again, plain)


def test_sharded_prefill_and_decode_match_jax():
    """phi4 prefill + 2 greedy decodes under the mesh, against JAX's under its mesh."""
    jcfg, tcfg, jp, tp = _models("phi4_mini_3_8b")
    jmesh, tmesh = _meshes()
    toks = RNG.integers(0, jcfg.vocab, (4, 7))
    with JSH.use_sharding(jmesh):
        jlog, jcache = JM.apply_prefill(jp, {"tokens": jnp.asarray(toks)},
                                        JM.init_cache(jcfg, 4, 16), jcfg)
    with TSH.use_sharding(tmesh):
        tlog, tcache = TM.apply_prefill(tp, {"tokens": torch.from_numpy(toks)},
                                        TM.init_cache(tcfg, 4, 16, device="cpu"), tcfg)
    _close(tlog, jlog)
    for _ in range(2):
        nxt = np.array(jnp.argmax(jlog, -1))[:, None]
        with JSH.use_sharding(jmesh):
            jlog, jcache = JM.apply_decode(jp, jnp.asarray(nxt), jcache, jcfg)
        with TSH.use_sharding(tmesh):
            tlog, tcache = TM.apply_decode(tp, torch.from_numpy(nxt), tcache, tcfg)
        _close(tlog, jlog)


def test_flash_calls_per_forward_follow_the_specs(monkeypatch):
    """The attention core runs once per distinct (batch slab, head slab) of
    q: a batch of 4 over data 4 and 4 heads over model 2 gives 8 a layer; a
    batch of 1 does not split, leaving the 2 head slabs."""
    _, tcfg, _, tp = _models("phi4_mini_3_8b")
    _, tmesh = _meshes()
    calls = []
    real = flash_ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return real(q, k, v, **kw)

    monkeypatch.setattr("repro_torch.models.attention.flash_attention", spy)
    for batch in (4, 1):
        calls.clear()
        toks = torch.from_numpy(RNG.integers(0, tcfg.vocab, (batch, 8)))
        with torch.no_grad(), TSH.use_sharding(tmesh):
            TM.apply_train(tp, {"tokens": toks}, tcfg)
        q_shape = (batch, tcfg.n_heads, 8, tcfg.head_dim)
        q_spec = TSH.DEFAULT_RULES.spec(tmesh, ("batch", "heads", "seq", "head_dim"), q_shape,
                                        allow_uneven=True)
        assert len(calls) == tcfg.n_layers * distinct_slabs(tmesh, (q_spec, q_shape))
        assert len(calls) == tcfg.n_layers * (8 if batch == 4 else 2)


def test_gqa_slabs_that_cut_a_group_read_their_kv_heads():
    """6 q heads in 2 GQA groups of 3, over model 4: the slabs of 2, 2, 2 and
    0 heads cut the groups, and each reads the kv heads its q heads use."""
    from repro_torch.models.attention import _flash_core, _per_position

    mesh = TLM.make_mesh_for(4, model_parallel=4, device="cpu")
    q = torch.from_numpy(RNG.standard_normal((2, 6, 5, 8)).astype(np.float32))
    k = torch.from_numpy(RNG.standard_normal((2, 2, 5, 8)).astype(np.float32))
    v = torch.from_numpy(RNG.standard_normal((2, 2, 5, 8)).astype(np.float32))
    core = _flash_core(True, None)
    want = core(q, k, v, None)
    with TSH.use_sharding(mesh):
        got = _per_position(core, q, k, v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("accum", [1, 4])
def test_sharded_train_step_matches_jax_build_with_a_mesh(accum):
    """As ``tests/test_distributed.py:65,93`` run the JAX step: phi4 smoke,
    batch 8 x 16, from the JAX state."""
    jmesh, tmesh = _meshes()
    jcfg, tcfg = jconfigs.get_smoke_config("phi4_mini_3_8b"), tconfigs.get_smoke_config("phi4_mini_3_8b")
    jopt = JAdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    topt = AdamWConfig(**dataclasses.asdict(jopt))
    jstate, data, jstep = JLT.build(jcfg, jopt, batch=8, seq=16, accum=accum, mesh=jmesh, seed=3)
    np_state = jax.tree.map(np.asarray, jstate)
    batch = jax.tree.map(np.asarray, data(0))
    _, _, tstep = TLT.build(tcfg, topt, batch=8, seq=16, accum=accum, mesh=tmesh, seed=3,
                            device="cpu")
    assert set(tstep.specs) >= {"params/layers/0/mixer/wq/w", "opt/m/layers/0/ffn/down/w"}
    assert tuple(tstep.specs["params/layers/0/mixer/wq/w"].spec) == ("data", "model")
    state = train_state_from_jax(np_state, tcfg, "cpu")
    js, jm = jstep(jstate, batch)
    ts, tm = tstep(state, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(tm[key]) - float(jm[key])) <= 1e-5 * abs(float(jm[key])), key
    p0 = params_from_jax(np_state.params, tcfg, "cpu")
    p1 = params_from_jax(jax.tree.map(np.asarray, js.params), tcfg, "cpu")
    m1 = params_from_jax(jax.tree.map(np.asarray, js.opt.m), tcfg, "cpu")
    v1 = params_from_jax(jax.tree.map(np.asarray, js.opt.v), tcfg, "cpu")

    def rel(got, want):
        got, want = got.detach().double(), want.double()
        return float((got - want).norm() / max(float(want.norm()), 1e-30))

    for name, p in ts.params.named_parameters():
        assert rel(ts.opt.m[name], m1[name]) <= 1e-4, name
        assert rel(ts.opt.v[name], v1[name]) <= 1e-4, name
        assert rel(p.detach() - p0[name], p1[name] - p0[name]) <= 1e-3, name
    assert tmesh.count("psum", "model") > 0 and tmesh.physical_bytes == 0


@pytest.mark.parametrize("case", ["phi4_mini_3_8b", "phi4_mini_3_8b-remat", "olmoe_1b_7b",
                                  "recurrentgemma_9b", "xlstm_1_3b", "whisper_tiny-remat"])
def test_sharded_gradients_equal_the_unsharded_ones(case):
    """Autograd through the per-position phases: every gradient leaf of the
    loss under the mesh against the unsharded port's, 1e-4 normwise (the
    leaf bound of ``tests/test_torch_train.py``); ``-remat`` recomputes the
    layers in the backward under the bound context."""
    arch, _, remat = case.partition("-")
    _, tcfg, _, tp = _models(arch, **({"remat": True} if remat else {}))
    _, tmesh = _meshes()
    for p in tp.parameters():
        p.requires_grad_(True)
    inputs = _inputs(tcfg, batch=4, seq=9)
    batch = {k: torch.from_numpy(v[:, :-1] if k == "tokens" else v) for k, v in inputs.items()}
    batch["labels"] = torch.from_numpy(inputs["tokens"][:, 1:])
    grads = []
    for mesh in (None, tmesh):
        for p in tp.parameters():
            p.grad = None
        with TSH.use_sharding(mesh):
            loss, _ = TM.loss_fn(tp, batch, tcfg)
            loss.backward()
        grads.append({n: p.grad.clone() for n, p in tp.named_parameters()})
    total = sum(float(g.double().pow(2).sum()) for g in grads[0].values()) ** 0.5
    for name, want in grads[0].items():
        diff = float((grads[1][name] - want).double().norm())
        assert diff <= 1e-4 * max(float(want.double().norm()), 1e-6 * total), name


def test_sharded_engine_tokens_match_the_port_and_jax():
    jcfg, tcfg, jp, tp = _models("phi4_mini_3_8b")
    jmesh, tmesh = _meshes()
    args = dict(max_seq=64, temperature=0.0, slots=3, page_size=8, sync_interval=2)
    prompts = [np.arange(5) % jcfg.vocab, (np.arange(9) * 7) % jcfg.vocab, np.arange(3) + 40]
    with JSH.use_sharding(jmesh):
        jeng = JaxEngine(jcfg, jp, JaxServeConfig(**args))
        jh = [jeng.submit(p, 6 + i) for i, p in enumerate(prompts)]
        jeng.run()
    want = [h.tokens() for h in jh]
    got = {}
    for name, mesh in (("plain", None), ("sharded", tmesh)):
        with TSH.use_sharding(mesh):
            eng = Engine(tcfg, tp, ServeConfig(**args), device="cpu")
            hs = [eng.submit(p, 6 + i) for i, p in enumerate(prompts)]
            eng.run()
        got[name] = [h.tokens() for h in hs]
        assert all(h.finish_reason == "length" for h in hs)
        assert eng.serve_stats()["pages_in_use"] == 0
    assert got["sharded"] == got["plain"] == want
    assert tmesh.count("psum", "model") > 0


def test_serve_launcher_mesh_runs_on_the_cpu(capsys):
    for arch in ("phi4_mini_3_8b", "olmoe_1b_7b", "whisper_tiny"):
        assert tserve.main(["--arch", arch, "--device", "cpu", "--mesh", "--positions", "8",
                            "--model-parallel", "2", "--batch", "2", "--new-tokens", "3"]) == 0
        out = capsys.readouterr().out
        assert "mesh: {'data': 4, 'model': 2} on cpu" in out
        assert "psum['model']" in out and "0 B physical" in out


def test_moe_reshard_bytes_are_counted():
    """Expert parallelism: the dispatch keeps each position's expert slab
    (0 bytes), the combine gathers the others' (model - 1 of model shares of
    the (G, E, C, D) products in each position)."""
    _, tcfg, _, tp = _models("olmoe_1b_7b", moe_group_dispatch=True, moe_expert_parallel=True)
    _, tmesh = _meshes()
    TMOE.RESHARD_BYTES.update(dispatch=0, combine=0)
    toks = torch.from_numpy(RNG.integers(0, tcfg.vocab, (4, 8)))
    with torch.no_grad(), TSH.use_sharding(tmesh):
        TM.apply_train(tp, {"tokens": toks}, tcfg)
    cap = TMOE._capacity(8, tcfg)
    per_layer = 8 * 1 * (tcfg.n_experts // 2) * cap * tcfg.d_model * 4  # 8 positions, 1 group each
    assert TMOE.RESHARD_BYTES == {"dispatch": 0, "combine": tcfg.n_layers * per_layer}
