"""Port parity: the model modules of repro_torch against repro.models.

The same seeded numpy inputs and the JAX parameters, converted with
``convert.params_from_jax``, go through both packages in fp32 on the CPU:
rope, the layers, the MLP and whole-model logits of ``transformer.forward``
on dense smoke configs, and on the MoE (olmoe, qwen2-moe) and RG-LRU
(recurrentgemma) smoke configs with the summed router aux loss and prefill +
decode, at 1e-4 relative to the largest output (the JAX package's own model
tests hold fp32 paths at 1e-4). The configs are plain data and equal the
JAX ones field for field; the encoder-decoder family, which the port does
not run yet, raises NotImplementedError naming its ROADMAP item. The xLSTM
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


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_the_reference_field_for_field(arch):
    for get in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(jconfigs, get)(arch))
        got = dataclasses.asdict(getattr(tconfigs, get)(arch))
        assert got == want
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


@pytest.mark.parametrize("arch,match", [
    ("whisper_tiny", "encoder-decoder"),
])
def test_unported_families_raise_not_implemented(arch, match):
    cfg = tconfigs.get_smoke_config(arch)  # config lookup works: plain data
    with pytest.raises(NotImplementedError, match=f"{match}.*ROADMAP.md queue 1 item 9"):
        TM.init_params(cfg, torch.Generator().manual_seed(0))
