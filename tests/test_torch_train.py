"""Port parity: training in repro_torch against repro's, on the CPU.

The same seeded numpy tokens (and frames, and M-RoPE positions) and the JAX
parameters, converted with ``convert.params_from_jax``, go through both
packages' ``loss_fn`` in fp32 on the smoke configs of every family: the loss
to 1e-5 relative, and each gradient leaf (the JAX tree converted the same
way) normwise to 1e-4, ||g_port - g_jax|| / ||g_jax|| (a leaf whose gradient
is zero in exact arithmetic, and so below 1e-6 of the whole gradient's norm
in both packages, is held to 1e-6 of that norm). One train step of the
port is held against one of ``repro.training.train_step`` from the same
state (``convert.train_state_from_jax``), with 1 and 4 microbatches: grad
norm and lr to 1e-5 relative, each moment normwise to 1e-4, and each
parameter's update normwise to 1e-3 (AdamW's first updates are about
lr * sign(g), so an element whose gradient is near 0 may flip: the update is
compared as a whole, never by its largest element). The plain backwards of
the two kernels (``attention_bwd_ref``, ``rmsnorm_bwd_ref``) are held
against ``torch.autograd`` and ``jax.grad``; remat changes no gradient; the
fused Strassen route has no gradient in either package; and the launcher
trains, summarizes and resumes on the CPU.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.core import backend as JB
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.training import train_step as JTS
from repro_torch import configs as tconfigs
from repro_torch.convert import backend_from_fields, params_from_jax, train_state_from_jax
from repro_torch.core import backend as TB
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
from repro_torch.kernels.rmsnorm import rmsnorm as trn
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step

RNG = np.random.default_rng(11)
FAMILIES = ["phi4_mini_3_8b", "internlm2_20b", "qwen2_vl_72b", "olmoe_1b_7b",
            "qwen2_moe_a2_7b", "recurrentgemma_9b", "xlstm_1_3b", "whisper_tiny"]
B, S = 2, 16
# Below this share of the whole gradient's norm a leaf is fp32 roundoff (a
# few ulps of the sums that form it), and is held to that absolutely.
NOISE = 1e-6


def _models(arch, **overrides):
    jcfg = jconfigs.get_smoke_config(arch, **overrides)
    tcfg = tconfigs.get_smoke_config(arch, **overrides)
    assert jcfg.dtype == tcfg.dtype == "float32"
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(1))
    tp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu"), strict=True)
    for p in tp.parameters():
        p.requires_grad_(True)
    return jcfg, tcfg, jp, tp


def _batch(cfg):
    toks = RNG.integers(0, cfg.vocab, (B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    if cfg.frontend == "audio_stub":
        batch["frames"] = RNG.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        batch["positions"] = np.broadcast_to(np.arange(S)[None, :, None], (B, S, 3)).copy()
    return batch


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _port_grads(tp, tcfg, batch):
    for p in tp.parameters():
        p.grad = None
    loss, metrics = TM.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    loss.backward()
    return loss, metrics, {n: p.grad for n, p in tp.named_parameters()}


# Each family's smoke config, and xlstm's with the chunkwise mLSTM (chunk 8
# of the 16 tokens), the route a long training sequence takes.
LEAF_CASES = {**{arch: (arch, {}) for arch in FAMILIES},
              "xlstm_1_3b-mlstm_chunk8": ("xlstm_1_3b", dict(mlstm_chunk=8))}


@pytest.mark.parametrize("case", list(LEAF_CASES))
def test_loss_and_every_gradient_leaf_match_jax(case):
    arch, overrides = LEAF_CASES[case]
    jcfg, tcfg, jp, tp = _models(arch, **overrides)
    batch = _batch(jcfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True), static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, metrics, grads = _port_grads(tp, tcfg, batch)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    for key in ("ce", "aux", "ppl"):
        assert abs(float(metrics[key]) - float(jmet[key])) <= 1e-5 * max(abs(float(jmet[key])), 1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg, "cpu")
    assert set(want) == set(grads)
    total = np.sqrt(sum(float(np.sum(w.double().numpy() ** 2)) for w in want.values()))
    worst = 0.0
    for name, g in grads.items():
        w = want[name].numpy()
        got = np.zeros_like(w) if g is None else g.detach().numpy()
        diff = float(np.linalg.norm(got.astype(np.float64) - w))
        if np.linalg.norm(w) <= NOISE * total:
            # A leaf whose gradient is zero in exact arithmetic, left with fp32
            # roundoff in both packages (the mLSTM input-gate bias: the
            # stabilizer cancels a shift of every input gate of a head).
            assert diff <= NOISE * total, (name, diff)
            continue
        worst = max(worst, _rel(got, w))
        assert _rel(got, w) <= 1e-4, (name, _rel(got, w))
    print(f"{case}: loss {loss.item():.6f}, worst leaf {worst:.2e}")


@pytest.mark.parametrize("arch,overrides", [
    ("phi4_mini_3_8b", dict(n_layers=3, block_pattern=("attn", "attn"))),  # a group and a tail
    ("whisper_tiny", {}),
    # one 8-layer group of xlstm-1.3b's pattern: 7 mLSTM and the sLSTM, whose
    # saving forward runs again under remat
    ("xlstm_1_3b", dict(n_layers=8, block_pattern=tconfigs.get_config("xlstm_1_3b").block_pattern)),
])
def test_remat_changes_no_gradient(arch, overrides):
    _, tcfg, _, tp = _models(arch, **overrides)
    batch = _batch(tcfg)
    loss, _, plain = _port_grads(tp, tcfg, batch)
    loss_r, _, remat = _port_grads(tp, dataclasses.replace(tcfg, remat=True), batch)
    assert float(loss) == float(loss_r)
    for name, g in plain.items():
        assert torch.allclose(g, remat[name], rtol=0, atol=1e-7 * max(1.0, g.abs().max().item())), name


def _rel_t(got: torch.Tensor, want) -> float:
    return _rel(got.detach().float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("accum", [1, 4])
def test_train_step_matches_jax(accum):
    jcfg = jconfigs.get_smoke_config("phi4_mini_3_8b")
    tcfg = tconfigs.get_smoke_config("phi4_mini_3_8b")
    jopt = JAdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50)
    topt = AdamWConfig(**dataclasses.asdict(jopt))
    jstate = JTS.init_train_state(jcfg, jopt, jax.random.PRNGKey(0))
    np_state = jax.tree.map(np.asarray, jstate)
    state = train_state_from_jax(np_state, tcfg, "cpu")
    batch = jax.tree.map(np.asarray, JSyntheticLM(jcfg, JDataConfig(batch=4, seq_len=16, seed=1))(0))
    js, jm = jax.jit(JTS.make_train_step(jcfg, jopt, accum_steps=accum))(jstate, batch)
    ts, tm = make_train_step(tcfg, topt, accum_steps=accum)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tm) == set(jm)
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(tm[key]) - float(jm[key])) <= 1e-5 * abs(float(jm[key])), key
    assert int(ts.opt.step) == int(js.opt.step) == 1
    p0 = params_from_jax(np_state.params, tcfg, "cpu")
    p1 = params_from_jax(jax.tree.map(np.asarray, js.params), tcfg, "cpu")
    m1 = params_from_jax(jax.tree.map(np.asarray, js.opt.m), tcfg, "cpu")
    v1 = params_from_jax(jax.tree.map(np.asarray, js.opt.v), tcfg, "cpu")
    for name, p in ts.params.named_parameters():
        assert _rel_t(ts.opt.m[name], m1[name]) <= 1e-4, name
        assert _rel_t(ts.opt.v[name], v1[name]) <= 1e-4, name
        assert _rel_t(p.detach() - p0[name], (p1[name] - p0[name]).numpy()) <= 1e-3, name


# ----------------------------------------------------------- plain backwards
ATTN_CASES = [
    ((2, 4, 2, 32, 32), dict(causal=True)),             # GQA
    ((1, 4, 1, 48, 48), dict(causal=True, window=5)),   # MQA, a window
    ((1, 2, 2, 16, 40), dict(causal=True)),             # Sq < Sk
    ((1, 2, 2, 40, 16), dict(causal=True)),             # Sq > Sk
    ((1, 3, 3, 12, 36), dict(causal=False)),
    ((1, 2, 2, 32, 8), dict(causal=True, window=4)),    # rows with no live key
    ((1, 8, 1, 70, 70), dict(causal=True, window=20)),  # MQA 8/1, a window, ragged
    ((2, 6, 2, 45, 45), dict(causal=True)),             # GQA 3, ragged
]


@pytest.mark.parametrize("shape,kw", ATTN_CASES, ids=lambda v: str(v))
def test_attention_bwd_ref_matches_autograd_and_jax(shape, kw):
    _check_attention_bwd(shape, kw, 16)


@pytest.mark.parametrize("shape,kw", ATTN_CASES, ids=lambda v: str(v))
def test_attention_bwd_ref_matches_autograd_and_jax_at_head_dim_256(shape, kw):
    """The bf16 backward kernel's widest head dim (gemma-7b, recurrentgemma-9b)."""
    _check_attention_bwd(shape, kw, 256)


def _check_attention_bwd(shape, kw, d):
    b, hq, hkv, sq, sk = shape
    q, k, v = (RNG.standard_normal(s).astype(np.float32)
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    do = RNG.standard_normal((b, hq, sq, d)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    auto = torch.autograd.grad(attention_ref(tq, tk, tv, **kw), (tq, tk, tv), torch.from_numpy(do))
    o, lse = attention_ref(tq.detach(), tk.detach(), tv.detach(), return_lse=True, **kw)
    ref = attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(), o, lse, torch.from_numpy(do), **kw)
    jgrads = jax.jit(lambda *a: jax.vjp(
        lambda *x: JA.chunked_attention(*x, q_chunk=8, k_chunk=8, **kw), *a[:3])[1](a[3]))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do))
    # the op's autograd (the plain versions on the CPU) is the same function
    op = torch.autograd.grad(flash_attention(tq, tk, tv, **kw), (tq, tk, tv), torch.from_numpy(do))
    for r, a, j, g in zip(ref, auto, jgrads, op):
        assert torch.allclose(r, a, rtol=0, atol=1e-5 * max(1.0, a.abs().max().item()))
        assert torch.equal(r, g)
        np.testing.assert_allclose(r.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(j).max())))
    if kw.get("window") == 4:  # rows from 11 on have no live key
        assert not ref[0][:, :, 11:].any()


# ----------------------------------------------------- backward launch plans
H100 = dict(sms=132, smem_per_block=232448)


def _train_attention_shapes():
    """(name, (b, hq, hkv, sq, sk, d, causal, window)) at the training
    shapes chip_smoke.py's t1 checks: phi4 at t3's 2 x 1024, gemma-7b at
    2048, recurrentgemma-9b at t7's 4096, whisper's encoder, decoder and
    cross-attention at t5's 8 x 128 tokens against 1500 frames."""
    out = []
    for arch, b, s in (("phi4_mini_3_8b", 2, 1024), ("gemma_7b", 1, 2048), ("recurrentgemma_9b", 1, 4096)):
        c = tconfigs.get_config(arch)
        window = c.local_window if "local_attn" in c.block_pattern else None
        out.append((arch, (b, c.n_heads, c.n_kv_heads, s, s, c.head_dim, True, window)))
    w = tconfigs.get_config("whisper_tiny")
    h, hd, enc = w.n_heads, w.head_dim, w.enc_seq
    out += [("whisper encoder", (8, h, h, enc, enc, hd, False, None)),
            ("whisper decoder", (8, h, h, 128, 128, hd, True, None)),
            ("whisper cross", (8, h, h, 128, enc, hd, False, None))]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("name,shape", _train_attention_shapes(), ids=lambda v: str(v))
def test_flash_bwd_plan_fits_the_h100_at_training_shapes(name, shape, dtype):
    b, hq, hkv, sq, sk, d, causal, window = shape
    plan = tfa.flash_bwd_plan(*shape, **H100, dtype=dtype)
    assert plan.smem_bytes <= H100["smem_per_block"] and plan.threads <= 1024
    assert (hq // hkv) % plan.parts == 0 and 1 <= plan.grid <= 2**31 - 1
    dq_bytes = 4 * b * hq * sq * d
    if dtype == torch.bfloat16:
        assert plan.tile == (128 if d <= 64 else 64)
        assert plan.grid == -(-sk // plan.tile) * plan.parts * b * hkv
        # one fp32 sum of dQ's size, whatever the number of key tiles; dK's
        # and dV's sums only when the group is split
        longer = tfa.flash_bwd_plan(b, hq, hkv, sq, 4 * sk, d, causal, window, **H100, dtype=dtype)
        for p, keys in ((plan, sk), (longer, 4 * sk)):
            assert p.scratch["dq_acc"] == (dq_bytes if keys > p.tile else 0)  # none at one key tile
            assert p.scratch["dkv_acc"] == (2 * 4 * b * hkv * keys * d if p.parts > 1 else 0)
        assert longer.scratch["lse_delta"] == plan.scratch["lse_delta"]
        assert plan.scratch_bytes < 2 * dq_bytes + 8 * b * hkv * sk * d + 4096 * 64
    else:  # the fp32 kernel keeps its partial dQ per 32-key tile
        assert plan.scratch["dq_part"] == -(-sk // 32) * dq_bytes


def test_flash_bwd_plan_fills_the_card_under_mqa():
    """recurrentgemma-9b's MQA (16 query heads on one KV head): 64 key tiles
    alone leave half the SMs idle, so the group is split into parts."""
    plan = tfa.flash_bwd_plan(1, 16, 1, 4096, 4096, 256, True, 2048, **H100)
    assert plan.grid >= H100["sms"] and plan.parts == 4 and plan.stages == 2
    assert plan.scratch["dkv_acc"] == 2 * 4 * 4096 * 256
    # enough blocks already: no split, no dK and dV sums
    gemma = tfa.flash_bwd_plan(1, 16, 16, 2048, 2048, 256, True, None, **H100)
    assert gemma.parts == 1 and gemma.scratch["dkv_acc"] == 0 and gemma.grid == 32 * 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
def test_flash_bwd_plan_at_every_head_dim(d, dtype):
    assert d in tfa.BWD_HEAD_DIMS[dtype]
    plan = tfa.flash_bwd_plan(1, 4, 2, 100, 100, d, True, None, **H100, dtype=dtype)
    assert plan.smem_bytes <= H100["smem_per_block"]
    if dtype == torch.bfloat16:
        # D < 64 runs as 64 (128 keys a block); K, V, two Q and dO stages at
        # 256, three below
        assert plan.stages == (2 if d == 256 else 3) and plan.tile == (128 if d <= 64 else 64)
        assert plan.smem_bytes == tfa.flash_bwd_plan(1, 4, 2, 100, 100, max(d, 64), True, None,
                                                     **H100).smem_bytes
    with pytest.raises(ValueError, match="shared memory"):
        tfa.flash_bwd_plan(1, 4, 2, 100, 100, d, True, None, sms=132, smem_per_block=plan.smem_bytes - 1,
                           dtype=dtype)


@pytest.mark.parametrize("rows,d,itemsize", [(2048, 3072, 2), (4099, 2048, 2), (1, 3072, 2), (5, 250, 4),
                                             (33, 8192, 2), (4099, 8192, 4), (300, 48, 4), (4099, 16384, 2)])
def test_rmsnorm_bwd_plan_is_persistent_and_resident(rows, d, itemsize):
    plan = trn.rmsnorm_bwd_plan(rows, d, itemsize, H100["sms"])
    # every block resident at once (the last ones wait for all), each a
    # partial row of dw, the reducers a share of the columns each
    assert plan.groups <= plan.per_sm * H100["sms"] and plan.per_sm * plan.block <= 2048
    assert 1 <= plan.reducers <= plan.groups and plan.reducers * 64 >= min(d, 64 * plan.reducers)
    assert plan.scratch_bytes == 4 * plan.groups * d and plan.smem_bytes <= 48 * 1024
    slots = plan.block // plan.row
    assert plan.groups == min(-(-rows // slots), plan.per_sm * H100["sms"])
    if (rows, d) == (2048, 3072):  # phi4's rows: 264 blocks of 256 threads, 2 rows each
        assert (plan.row, plan.block, plan.groups, plan.reducers) == (128, 256, 264, 48)


def test_rmsnorm_bwd_plan_refuses_what_the_kernel_refuses():
    for d, itemsize, vec in ((16384, 4, True), (16392, 2, True), (2049, 2, False)):
        with pytest.raises(ValueError, match="at most"):  # rows past 2048 vectors of a thread block
            trn.rmsnorm_bwd_plan(8, d, itemsize, H100["sms"], vec)


def test_rmsnorm_bwd_ref_matches_autograd_and_jax():
    x = RNG.standard_normal((3, 5, 48)).astype(np.float32)
    scale = (0.1 * RNG.standard_normal(48)).astype(np.float32)
    dy = RNG.standard_normal((3, 5, 48)).astype(np.float32)
    tx, ts = torch.from_numpy(x).requires_grad_(), torch.from_numpy(scale).requires_grad_()
    w = 1.0 + ts
    auto = torch.autograd.grad(rmsnorm_ref(tx.reshape(-1, 48), w), (tx, ts), torch.from_numpy(dy).reshape(-1, 48))
    dx, dw = rmsnorm_bwd_ref(tx.detach().reshape(-1, 48), w.detach(), torch.from_numpy(dy).reshape(-1, 48))
    op = torch.autograd.grad(rmsnorm(tx, 1.0 + ts), (tx, ts), torch.from_numpy(dy))
    _, vjp = jax.vjp(lambda x_, s_: JL.rmsnorm({"scale": s_}, x_), jnp.asarray(x), jnp.asarray(scale))
    jdx, jds = vjp(jnp.asarray(dy))
    for got, a, o, j in ((dx.reshape(x.shape), auto[0], op[0], jdx), (dw, auto[1], op[1], jds)):
        assert torch.allclose(got, a, rtol=0, atol=1e-5)
        assert torch.equal(got, o)
        np.testing.assert_allclose(got.numpy(), np.asarray(j), rtol=0, atol=1e-5)


def test_fused_route_has_no_gradient_in_either_package():
    a = RNG.standard_normal((64, 64)).astype(np.float32)
    jb = JB.MatmulBackend(kind="strassen_fused", depth=1, min_dim=16)
    with pytest.raises(Exception):
        jax.grad(lambda x: JB.matmul(x, jnp.asarray(a), jb).sum())(jnp.asarray(a))
    tb = backend_from_fields(dataclasses.asdict(jb))
    x = torch.from_numpy(a).requires_grad_()
    with pytest.raises(NotImplementedError, match="no gradient"):
        TB.matmul(x, torch.from_numpy(a), tb)
    with torch.no_grad():  # without autograd the route runs (its plain version here)
        assert TB.matmul(x, torch.from_numpy(a), tb).shape == (64, 64)


# ------------------------------------------------------------- mirrors
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_smoke_forward_and_grad(arch):
    """tests/test_arch_smoke.py::test_smoke_forward_and_grad on the port."""
    cfg = tconfigs.get_smoke_config(arch)
    state = init_train_state(cfg, AdamWConfig(), torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    logits, _ = TM.apply_train(state.params, batch, cfg)
    assert logits.shape == (B, S, cfg.vocab) and bool(torch.isfinite(logits).all())
    loss, _ = TM.loss_fn(state.params, batch, cfg)
    loss.backward()
    gnorm = sum(float((p.grad.float() ** 2).sum()) for p in state.params.parameters()
                if p.grad is not None)
    assert np.isfinite(float(loss)) and np.isfinite(gnorm) and gnorm > 0.0


def test_flash_attention_is_differentiable_and_matches_naive_grad():
    """tests/test_model_consistency.py's chunked-attention gradient test on the port's op."""
    q, k, v = (torch.from_numpy(RNG.standard_normal((1, 2, 64, 16)).astype(np.float32))
               for _ in range(3))
    q1, q2 = q.clone().requires_grad_(), q.clone().requires_grad_()
    g1, = torch.autograd.grad((flash_attention(q1, k, v) ** 2).sum(), q1)
    g2, = torch.autograd.grad((attention_ref(q2, k, v) ** 2).sum(), q2)
    assert torch.allclose(g1, g2, atol=2e-4, rtol=2e-4)
    _, vjp = jax.vjp(lambda x: JA.chunked_attention(x, jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                                                    q_chunk=16, k_chunk=16), jnp.asarray(q.numpy()))
    jg, = vjp(2 * JA.chunked_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                       jnp.asarray(v.numpy()), q_chunk=16, k_chunk=16))
    np.testing.assert_allclose(g1.numpy(), np.asarray(jg), atol=2e-4, rtol=2e-4)


def test_grouped_moe_grad_flows():
    """tests/test_perf_features.py::test_grouped_moe_grad_flows on the port."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("olmoe_1b_7b"), moe_group_dispatch=True,
                              capacity_factor=2.0)
    state = init_train_state(cfg, AdamWConfig(), torch.Generator().manual_seed(2))
    tokens = torch.from_numpy(RNG.integers(0, cfg.vocab, (2, 16)))
    loss, metrics = TM.loss_fn(state.params, {"tokens": tokens, "labels": tokens}, cfg)
    loss.backward()
    gnorm = sum(float((p.grad ** 2).sum()) for p in state.params.parameters() if p.grad is not None)
    assert np.isfinite(gnorm) and gnorm > 0 and float(metrics["aux"]) > 0


# ------------------------------------------------------------- the launcher
def test_train_cli_trains_summarizes_and_resumes(tmp_path, capsys):
    ckpt, summary = tmp_path / "ckpt", tmp_path / "summary.json"
    argv = ["--arch", "phi4_mini_3_8b", "--smoke", "--device", "cpu", "--batch", "4",
            "--seq", "32", "--ckpt-dir", str(ckpt), "--save-every", "2",
            "--summary-out", str(summary)]
    assert ttrain.main(argv + ["--steps", "4"]) == 0
    out = json.loads(summary.read_text())
    assert {"arch", "backend", "steps", "wall_s", "loss_first", "loss_last",
            "median_step_time_s", "steps_run"} <= set(out)
    assert out["steps_run"] == 4 and out["loss_last"] < out["loss_first"]
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_00000002", "step_00000004"]
    assert ttrain.main(argv + ["--steps", "6"]) == 0
    assert "[resume] from step 4" in capsys.readouterr().out
    assert json.loads(summary.read_text())["steps_run"] == 2
    # --mesh trains on a (data 4, model 2) mesh of CPU positions, resuming at step 6
    assert ttrain.main(argv + ["--steps", "8", "--mesh", "--positions", "8",
                               "--model-parallel", "2"]) == 0
    out = capsys.readouterr().out
    assert "[resume] from step 6" in out and "mesh: {'data': 4, 'model': 2} on cpu" in out
    assert "psum['model']" in out and json.loads(summary.read_text())["steps_run"] == 2
