"""Port parity: the model modules of repro_torch against repro.models.

The same seeded numpy inputs and the JAX parameters, converted with
``convert.params_from_jax``, go through both packages in fp32 on the CPU:
rope, the layers, the MLP and whole-model logits of ``transformer.forward``
on dense smoke configs, and on the MoE (olmoe, qwen2-moe) and RG-LRU
(recurrentgemma) smoke configs with the summed router aux loss and prefill +
decode, at 1e-4 relative to the largest output (the JAX package's own model
tests hold fp32 paths at 1e-4). The configs are plain data and equal the
JAX ones field for field. The fp8 KV cache (``cache_dtype="float8_e4m3fn"``)
is held to the reference on dense, windowed and RG-LRU configs. The
encoder-decoder family has ``tests/test_torch_encdec.py``. The xLSTM
family has its own file, ``tests/test_torch_xlstm.py``; the MoE and RG-LRU
blocks have ``tests/test_torch_moe.py`` and ``tests/test_torch_rglru.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import mlp as JMLP
from repro.models import model as JM
from repro.models import rope as JR
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import mlp as TMLP
from repro_torch.models import model as TM
from repro_torch.models import rope as TR
from repro_torch.models import transformer as TT

RNG = np.random.default_rng(5)
DENSE = ["phi4_mini_3_8b", "qwen1_5_32b", "gemma_7b", "internlm2_20b", "qwen2_vl_72b"]
MOE_AND_RGLRU = ["olmoe_1b_7b", "qwen2_moe_a2_7b", "recurrentgemma_9b"]


def _np(shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=rel * scale, rtol=0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v))
    return out


# The port's own ModelConfig fields (models/config.py), which the JAX
# package lacks, at the defaults that keep its behaviour.
PORT_FIELDS = {"qk_norm": False, "norm_topk_prob": True, "moe_dropless": False,
               "experts_held": 0, "expert_first": 0}


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_the_reference_field_for_field(arch):
    for get in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(jconfigs, get)(arch))
        got = dataclasses.asdict(getattr(tconfigs, get)(arch))
        assert got == {**want, **PORT_FIELDS}
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.SHAPES.keys() == jconfigs.SHAPES.keys()
    for shape in jconfigs.SHAPES:
        assert tconfigs.skip_reason(arch, shape) == jconfigs.skip_reason(arch, shape)


def test_rope_matches_reference():
    x, pos = _np((2, 3, 7, 16)), np.arange(14).reshape(2, 7) * 3
    want = JR.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    _close(TR.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0), want)


def test_mrope_matches_reference():
    x = _np((2, 3, 7, 16))
    pos = RNG.integers(0, 50, (2, 7, 3))
    want = JR.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (4, 2, 2))
    _close(TR.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (4, 2, 2)), want)


def test_rmsnorm_one_plus_scale_matches_reference():
    x, scale = _np((3, 5, 32)), _np((32,))
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    norm = TL.Norm("rmsnorm", 32, torch.float32, "cpu")
    norm.scale.copy_(torch.from_numpy(scale))
    _close(TL.rmsnorm(norm, torch.from_numpy(x), 1e-6), want)


def test_layernorm_matches_reference():
    x, scale, bias = _np((3, 5, 32)), _np((32,)), _np((32,))
    want = JL.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x))
    norm = TL.Norm("layernorm", 32, torch.float32, "cpu")
    norm.load_state_dict({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    _close(TL.layernorm(norm, torch.from_numpy(x)), want)


@pytest.mark.parametrize("tied,softcap", [(True, 0.0), (True, 30.0), (False, 0.0)])
def test_embed_and_unembed_match_reference(tied, softcap):
    emb, unemb = _np((50, 16)), _np((16, 50))
    toks, x = RNG.integers(0, 50, (2, 6)), _np((2, 6, 16))
    jp = {"embedding": jnp.asarray(emb)}
    if not tied:
        jp["unembedding"] = jnp.asarray(unemb)
    tp = TL.Embed(torch.from_numpy(emb), None if tied else torch.from_numpy(unemb))
    _close(TL.embed(tp, torch.from_numpy(toks)), JL.embed(jp, jnp.asarray(toks)))
    want = JL.unembed(jp, jnp.asarray(x), tied=tied, softcap=softcap)
    _close(TL.unembed(tp, torch.from_numpy(x), tied=tied, softcap=softcap), want)


@pytest.mark.parametrize("kind", ["naive", "strassen"])
def test_linear_with_bias_matches_reference(kind):
    from repro.core.backend import MatmulBackend as JB
    from repro_torch.core.backend import MatmulBackend as TB

    w, b, x = _np((32, 4, 8)), _np((4, 8)), _np((2, 16, 32))
    want = JL.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                     JB(kind=kind, min_dim=8), w_logical=("fsdp", "heads"), site="attn.wq")
    got = TL.linear(TL.Linear(torch.from_numpy(w), torch.from_numpy(b)), torch.from_numpy(x),
                    TB(kind=kind, min_dim=8), w_logical=("fsdp", "heads"), site="attn.wq")
    _close(got, want)


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", True), ("gelu", False)])
def test_mlp_block_matches_reference(act, glu):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("gemma_7b"), act=act, glu=glu)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("gemma_7b"), act=act, glu=glu)
    jp = JMLP.init_mlp(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = TMLP.init_mlp(torch.Generator().manual_seed(0), tcfg, torch.float32)
    tp.load_state_dict(_flat(jp), strict=True)
    x = _np((2, 5, jcfg.d_model))
    _close(TMLP.mlp_block(tp, torch.from_numpy(x), tcfg), JMLP.mlp_block(jp, jnp.asarray(x), jcfg))


def _models(arch, **overrides):
    jcfg = jconfigs.get_smoke_config(arch, **overrides)
    tcfg = tconfigs.get_smoke_config(arch, **overrides)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(1))
    tp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu"), strict=True)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_reference(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    toks = RNG.integers(0, jcfg.vocab, (2, 12))
    want, _, _ = JT.forward(jp, jnp.asarray(toks), jcfg)
    got, cache, aux = TT.forward(tp, torch.from_numpy(toks), tcfg)
    assert cache is None and float(aux) == 0.0
    _close(got, want)


def test_prefill_and_decode_match_reference_on_a_tail_layout():
    """Three layers in groups of two: one scan group and one tail layer in JAX."""
    jcfg, tcfg, jp, tp = _models("phi4_mini_3_8b", n_layers=3, block_pattern=("attn", "attn"))
    assert "tail" in jp and "groups" in jp
    toks = RNG.integers(0, jcfg.vocab, (2, 7))
    jlog, jcache = JM.apply_prefill(jp, {"tokens": jnp.asarray(toks)},
                                    JM.init_cache(jcfg, 2, 16), jcfg)
    tlog, tcache = TM.apply_prefill(tp, {"tokens": torch.from_numpy(toks)},
                                    TM.init_cache(tcfg, 2, 16, device="cpu"), tcfg)
    _close(tlog, jlog)
    nxt = np.array(jnp.argmax(jlog, -1))[:, None]
    jlog, _ = JM.apply_decode(jp, jnp.asarray(nxt), jcache, jcfg)
    tlog, tcache = TM.apply_decode(tp, torch.from_numpy(nxt), tcache, tcfg)
    _close(tlog, jlog)
    assert int(tcache["pos"]) == 8


@pytest.mark.parametrize("arch", MOE_AND_RGLRU)
def test_forward_logits_and_aux_match_reference(arch):
    """The summed router aux loss of every MoE layer (0 for recurrentgemma)."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks = RNG.integers(0, jcfg.vocab, (2, 12))
    want, _, jaux = JT.forward(jp, jnp.asarray(toks), jcfg)
    got, cache, aux = TT.forward(tp, torch.from_numpy(toks), tcfg)
    assert cache is None
    _close(got, want)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * max(abs(float(jaux)), 1e-30)
    assert (float(aux) > 0) == tcfg.is_moe


@pytest.mark.parametrize("arch", MOE_AND_RGLRU)
@pytest.mark.parametrize("prompt", [7, 21])
def test_prefill_and_decode_match_reference(arch, prompt):
    """21 tokens pass recurrentgemma's 16-token window, so its ring wraps."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks = RNG.integers(0, jcfg.vocab, (2, prompt))
    jlog, jcache = JM.apply_prefill(jp, {"tokens": jnp.asarray(toks)},
                                    JM.init_cache(jcfg, 2, 32), jcfg)
    tlog, tcache = TM.apply_prefill(tp, {"tokens": torch.from_numpy(toks)},
                                    TM.init_cache(tcfg, 2, 32, device="cpu"), tcfg)
    _close(tlog, jlog)
    for _ in range(3):
        nxt = np.array(jnp.argmax(jlog, -1))[:, None]
        jlog, jcache = JM.apply_decode(jp, jnp.asarray(nxt), jcache, jcfg)
        tlog, tcache = TM.apply_decode(tp, torch.from_numpy(nxt), tcache, tcfg)
        _close(tlog, jlog)
    assert int(tcache["pos"]) == prompt + 3


# ------------------------------------------------------------- fp8 KV cache
FP8 = "float8_e4m3fn"
# The two packages' fp32 projections differ in their last bits. Where such a
# difference straddles an e4m3 rounding boundary, one rounded element (a
# cached K or V, or a decode step's q or probability) lands one e4m3 ulp from
# the reference's, and the logits move with it. tools/fp8_parity_sweep.py
# reads how far over 1152 comparisons: up to 1.8e-3 relative where a flip can
# reach, at most 2.1e-6 where none can. With one of the port's roundings left
# out (q, the probabilities, or the prefill's K/V) every case of its sweep
# fails, by 8.3e-3 or more. A comparison that such a flip can reach is held
# to FP8_FLIP_LIMIT, any other to 1e-4.
FP8_FLIP_LIMIT = 4e-3


def _jax_cache_leaf(jcache, jcfg, i, name):
    """Layer ``i``'s ``name`` leaf of a JAX cache (scan groups, then a tail)."""
    period = len(jcfg.block_pattern)
    grouped = jcfg.n_layers // period * period if "groups" in jcache else 0
    if i < grouped:
        return np.array(jcache["groups"][f"pos{i % period}"][name][i // period])
    return np.array(jcache["tail"][i - grouped][name])


def _fp8_flips(tcache, jcache, jcfg):
    """Cached fp8 elements whose bits differ from the reference's, and
    whether every cached element is fp8 and within one e4m3 ulp of it."""
    flips, within = 0, True
    for i, layer in enumerate(tcache["layers"]):
        for name in ("k", "v") if "k" in layer else ():
            got, want = layer[name], _jax_cache_leaf(jcache, jcfg, i, name)
            ulp = 2**-3 * np.abs(want.astype(np.float32)) + 2**-9
            within &= (got.dtype == torch.float8_e4m3fn
                       and bool((np.abs(got.float().numpy() - want.astype(np.float32)) <= ulp).all()))
            flips += int((TA.as_bits(got).numpy() != want.view(np.uint8)).sum())
    return flips, within


@torch.inference_mode()
def _load_jax_cache(tcache, jcache, jcfg):
    """Copies every leaf of the JAX cache into the port's, fp8 bit for bit."""
    for i, layer in enumerate(tcache["layers"]):
        for name, t in layer.items():
            want = _jax_cache_leaf(jcache, jcfg, i, name)
            if t.dtype == torch.float8_e4m3fn:
                TA.as_bits(t).copy_(torch.from_numpy(want.view(np.uint8)))
            else:
                t.copy_(torch.from_numpy(want.astype(np.float32)))


def fp8_parity(models, toks, steps=3):
    """Prefill and ``steps`` greedy decode steps of an fp8-cache model through
    both packages, the JAX cache loaded into the port's before each step, so
    that each step starts from the same state. Per comparison: the largest
    logit difference over the largest reference logit (at least 1), whether
    an e4m3 flip can reach it, the cached elements that flipped, and whether
    the caches lie within one e4m3 ulp of each other.

    A prefill's flips all lie in its cache, unless a ring dropped some K/V;
    a decode step also rounds q and the probabilities, which no cache shows.
    """
    jcfg, tcfg, jp, tp = models
    jlog, jcache = JM.apply_prefill(jp, {"tokens": jnp.asarray(toks)},
                                    JM.init_cache(jcfg, 2, 32), jcfg)
    tlog, tcache = TM.apply_prefill(tp, {"tokens": torch.from_numpy(toks)},
                                    TM.init_cache(tcfg, 2, 32, device="cpu"), tcfg)
    dropped = "local_attn" in jcfg.block_pattern and toks.shape[1] > jcfg.local_window
    out = []
    for step in range(steps + 1):
        if step:
            nxt = np.array(jnp.argmax(jlog, -1))[:, None]
            _load_jax_cache(tcache, jcache, jcfg)
            jlog, jcache = JM.apply_decode(jp, jnp.asarray(nxt), jcache, jcfg)
            tlog, tcache = TM.apply_decode(tp, torch.from_numpy(nxt), tcache, tcfg)
        want = np.asarray(jlog, np.float32)
        err = float(np.abs(tlog.numpy() - want).max()) / max(1.0, float(np.abs(want).max()))
        flips, within = _fp8_flips(tcache, jcache, jcfg)
        out.append({"step": step, "err": err, "flips": flips, "cache_within_ulp": within,
                    "reachable": bool(step or flips or dropped)})
    assert int(tcache["pos"]) == toks.shape[1] + steps
    return out


def fp8_reading_holds(reading):
    limit = FP8_FLIP_LIMIT if reading["reachable"] else 1e-4
    return reading["cache_within_ulp"] and reading["err"] <= limit


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "recurrentgemma_9b"])
@pytest.mark.parametrize("prompt", [7, 21])
def test_fp8_cache_prefill_and_decode_match_reference(arch, prompt):
    """K/V rounded to fp8 in the cache: the prefill attends over the rounded
    K/V and each decode step reads them back (with q and the probabilities
    rounded to fp8), as the JAX model does. 21 tokens wrap recurrentgemma's
    16-token ring."""
    models = _models(arch, cache_dtype=FP8)
    toks = RNG.integers(0, models[0].vocab, (2, prompt))
    for reading in fp8_parity(models, toks):
        print(reading)
        assert fp8_reading_holds(reading), reading


def test_fp8_cache_decode_close_to_full_precision():
    """Mirror of tests/test_perf_features.py: fp8 shifts the logits but keeps
    the argmax most of the time."""
    cfg = tconfigs.get_smoke_config("phi4_mini_3_8b")
    cfg8 = dataclasses.replace(cfg, cache_dtype=FP8)
    params = TM.init_params(cfg, torch.Generator().manual_seed(3))
    tokens = torch.from_numpy(RNG.integers(0, cfg.vocab, (2, 24)))
    outs = {}
    for name, c in (("full", cfg), ("fp8", cfg8)):
        lp, _ = TM.apply_prefill(params, {"tokens": tokens}, TM.init_cache(c, 2, 28, device="cpu"), c)
        outs[name] = lp
        assert bool(torch.isfinite(lp).all())
    agree = (outs["full"].argmax(-1) == outs["fp8"].argmax(-1)).float().mean().item()
    assert agree >= 0.5, agree


def test_fp8_cache_halves_cache_bytes():
    """Mirror of tests/test_perf_features.py: a quarter of the fp32 smoke
    cache, the same bytes as the JAX cache."""
    cfg = tconfigs.get_smoke_config("phi4_mini_3_8b")
    cfg8 = dataclasses.replace(cfg, cache_dtype=FP8)

    def nbytes(c):
        return sum(t.numel() * t.element_size() for layer in c["layers"] for t in layer.values())

    b_full = nbytes(TM.init_cache(cfg, 2, 64, device="cpu"))
    b_fp8 = nbytes(TM.init_cache(cfg8, 2, 64, device="cpu"))
    assert b_fp8 < 0.3 * b_full
    jcfg8 = jconfigs.get_smoke_config("phi4_mini_3_8b", cache_dtype=FP8)
    j_fp8 = sum(x.nbytes for x in jax.tree.leaves(JM.init_cache(jcfg8, 2, 64)))
    assert j_fp8 == b_fp8 + 4  # the JAX cache's int32 pos
