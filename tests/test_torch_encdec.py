"""Port parity: the encoder-decoder family (whisper) of repro_torch against repro.

The same seeded numpy frames and tokens, and the JAX parameters converted
with ``convert.params_from_jax``, go through both packages in fp32 on the
CPU: the sinusoid, cross-attention, the encoder, prefill + greedy decode
steps (also with an fp8 self-attention cache, where a comparison that an
e4m3 rounding flip can reach is held to ``FP8_FLIP_LIMIT``) and the
engine's static generate path, at 1e-4 relative to the largest output (the
port's model tolerance, ``tests/test_torch_models.py:_close``). The launcher serves the
smoke config on the CPU.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import encdec as JE
from repro.models import model as JM
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import encdec as TE
from repro_torch.models import frontends as TF
from repro_torch.models import model as TM
from repro_torch.serving.engine import Engine, ServeConfig
from test_torch_models import FP8_FLIP_LIMIT

ARCH = "whisper_tiny"
RNG = np.random.default_rng(11)


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=rel * scale, rtol=0)


def _models(**overrides):
    jcfg = jconfigs.get_smoke_config(ARCH, **overrides)
    tcfg = tconfigs.get_smoke_config(ARCH, **overrides)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(1))
    tp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu"), strict=True)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def models():
    return _models()


def _frames(cfg, b):
    return RNG.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _np(shape):
    return RNG.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("d", [16, 64, 384])
def test_sinusoid_at_matches_reference(d):
    pos = np.arange(1500).reshape(2, 750)
    _close(TE._sinusoid_at(torch.from_numpy(pos), d), JE._sinusoid_at(jnp.asarray(pos), d))


def test_encode_cross_kv_matches_reference(models):
    jcfg, tcfg, jp, tp = models
    enc = _np((2, jcfg.enc_seq, jcfg.d_model))
    jk, jv = JA.encode_cross_kv(jp["dec"][0]["cross_attn"], jnp.asarray(enc), jcfg)
    tk, tv = TA.encode_cross_kv(tp.dec[0].cross_attn, torch.from_numpy(enc), tcfg)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("s", [1, 5])
def test_cross_attention_block_matches_reference(models, s):
    """s = 1 is a decode step: one query against every encoder frame."""
    jcfg, tcfg, jp, tp = models
    x = _np((2, s, jcfg.d_model))
    shape = (2, jcfg.n_kv_heads, jcfg.enc_seq, jcfg.head_dim)
    k, v = _np(shape), _np(shape)
    want = JA.cross_attention_block(jp["dec"][1]["cross_attn"], jnp.asarray(x),
                                    (jnp.asarray(k), jnp.asarray(v)), jcfg)
    got = TA.cross_attention_block(tp.dec[1].cross_attn, torch.from_numpy(x),
                                   (torch.from_numpy(k), torch.from_numpy(v)), tcfg)
    _close(got, want)


def test_encode_matches_reference(models):
    jcfg, tcfg, jp, tp = models
    frames = _frames(jcfg, 2)
    _close(TE.encode(tp, torch.from_numpy(frames), tcfg), JE.encode(jp, jnp.asarray(frames), jcfg))


def _self_flips(tcache, jcache):
    """fp8 self-cache elements whose bits differ from the reference's; each
    must lie within one e4m3 ulp of it."""
    flips = 0
    for tc, jc in zip(tcache["self"], jcache["self"]):
        for name in ("k", "v"):
            want = np.array(jc[name])
            np.testing.assert_allclose(tc[name].float().numpy(), want.astype(np.float32),
                                       rtol=2**-3, atol=2**-9)
            flips += int((TA.as_bits(tc[name]).numpy() != want.view(np.uint8)).sum())
    return flips


@torch.inference_mode()
def _load_self_cache(tcache, jcache):
    for tc, jc in zip(tcache["self"], jcache["self"]):
        for name in ("k", "v"):
            TA.as_bits(tc[name]).copy_(torch.from_numpy(np.array(jc[name]).view(np.uint8)))


def _prefill_and_decode(jcfg, tcfg, jp, tp, prompt, steps=3, fp8=False):
    """With ``fp8`` the port's self cache takes the reference's before each
    decode step, and a comparison that an e4m3 flip can reach (see
    tests/test_torch_models.py) is held to FP8_FLIP_LIMIT."""
    frames = _frames(jcfg, 2)
    toks = RNG.integers(0, jcfg.vocab, (2, prompt))
    jlog, jcache = JM.apply_prefill(jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
                                    JM.init_cache(jcfg, 2, 16), jcfg)
    tlog, tcache = TM.apply_prefill(tp, {"tokens": torch.from_numpy(toks),
                                         "frames": torch.from_numpy(frames)},
                                    TM.init_cache(tcfg, 2, 16, device="cpu"), tcfg)
    _close(tlog, jlog, FP8_FLIP_LIMIT if fp8 and _self_flips(tcache, jcache) else 1e-4)
    for _ in range(steps):
        nxt = np.array(jnp.argmax(jlog, -1))[:, None]
        if fp8:
            _load_self_cache(tcache, jcache)
        jlog, jcache = JM.apply_decode(jp, jnp.asarray(nxt), jcache, jcfg)
        tlog, tcache = TM.apply_decode(tp, torch.from_numpy(nxt), tcache, tcfg)
        _close(tlog, jlog, FP8_FLIP_LIMIT if fp8 else 1e-4)
        if fp8:
            _self_flips(tcache, jcache)
    assert int(tcache["pos"]) == prompt + steps
    return jcache, tcache


@pytest.mark.parametrize("prompt", [1, 4, 7])
def test_prefill_and_decode_match_reference(models, prompt):
    jcache, tcache = _prefill_and_decode(*models, prompt)
    for jc, tc in zip(jcache["cross"], tcache["cross"]):
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])


def test_fp8_self_cache_prefill_and_decode_match_reference():
    """The self-attention cache in fp8; the cross K/V stay in the model dtype."""
    jcfg, tcfg, jp, tp = _models(cache_dtype="float8_e4m3fn")
    _, tcache = _prefill_and_decode(jcfg, tcfg, jp, tp, 4, fp8=True)
    assert tcache["self"][0]["k"].dtype == torch.float8_e4m3fn
    assert tcache["cross"][0]["k"].dtype == torch.float32


def test_cross_kv_is_written_in_place_and_read_by_decode(models, monkeypatch):
    """The prefill fills the cache's own cross buffers (no alias of the
    encoder output); a decode step reads them and recomputes nothing."""
    _, tcfg, _, tp = models
    frames = torch.from_numpy(_frames(tcfg, 2))
    cache = TM.init_cache(tcfg, 2, 16, device="cpu")
    bufs = [(c["k"].data_ptr(), c["v"].data_ptr()) for c in cache["cross"]]
    _, cache = TM.apply_prefill(tp, {"tokens": torch.ones((2, 3), dtype=torch.long),
                                     "frames": frames}, cache, tcfg)
    enc = TE.encode(tp, frames, tcfg)
    for i, c in enumerate(cache["cross"]):
        assert (c["k"].data_ptr(), c["v"].data_ptr()) == bufs[i]
        k, v = TA.encode_cross_kv(tp.dec[i].cross_attn, enc, tcfg)
        assert torch.equal(c["k"], k) and torch.equal(c["v"], v)
    calls = []
    monkeypatch.setattr(TE, "encode_cross_kv", lambda *a: calls.append(a) or TA.encode_cross_kv(*a))
    TM.apply_decode(tp, torch.ones((2, 1), dtype=torch.long), cache, tcfg)
    assert not calls


def test_params_from_jax_maps_the_encdec_tree_bit_for_bit(models):
    jcfg, tcfg, jp, tp = models
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}.")
        else:
            flat[prefix[:-1]] = np.asarray(tree)

    walk(jp, "")
    sd = tp.state_dict()
    assert set(sd) == set(flat)
    assert {"enc.0.ln1.bias", "dec.1.ln_x.scale", "dec.0.cross_attn.wk.w"} <= set(sd)
    for k, v in flat.items():
        assert np.array_equal(sd[k].numpy(), v), k


def test_init_params_and_cache_shapes():
    cfg = tconfigs.get_config(ARCH)
    spec = TF.audio_frames_spec(cfg, 3)
    assert spec.device.type == "meta" and tuple(spec.shape) == (3, 1500, 384)
    assert spec.dtype == torch.bfloat16
    small = tconfigs.get_smoke_config(ARCH)
    p = TM.init_params(small, torch.Generator().manual_seed(0))
    assert len(p.enc) == small.enc_layers and len(p.dec) == small.n_layers
    assert p.embed.unembedding is None
    cache = TM.init_cache(small, 2, 10, device="cpu")
    assert tuple(cache["self"][0]["k"].shape) == (2, small.n_kv_heads, 10, small.head_dim)
    assert tuple(cache["cross"][0]["k"].shape) == (2, small.n_kv_heads, small.enc_seq,
                                                   small.head_dim)


def test_make_stub_frames_is_seeded():
    cfg = tconfigs.get_smoke_config(ARCH)
    a = TF.make_stub_frames(cfg, 2, device="cpu")
    b = TF.make_stub_frames(cfg, 2, torch.Generator().manual_seed(0), device="cpu")
    c = TF.make_stub_frames(cfg, 2, torch.Generator().manual_seed(1), device="cpu")
    assert tuple(a.shape) == (2, cfg.enc_seq, cfg.d_model) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("new", [1, 6])
def test_engine_generate_matches_jax_engine(models, new):
    jcfg, tcfg, jp, tp = models
    frames = _frames(jcfg, 2)
    prompts = RNG.integers(0, jcfg.vocab, (2, 3))
    jtok, jst = JaxEngine(jcfg, jp, JaxServeConfig(max_seq=32)).generate(
        jnp.asarray(prompts), new, frames=jnp.asarray(frames))
    ttok, tst = Engine(tcfg, tp, ServeConfig(max_seq=32), device="cpu").generate(
        prompts, new, frames=frames)
    assert ttok.tolist() == np.asarray(jtok).tolist()
    assert tst.keys() == jst.keys()
    assert tst == jst


def test_submit_on_an_encdec_engine_raises(models):
    _, tcfg, _, tp = models
    eng = Engine(tcfg, tp, ServeConfig(max_seq=32), device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-decoder configs serve through generate"):
        eng.submit([1, 2, 3], 4)


def test_generate_with_frames_takes_the_static_path(models):
    """generate(frames=...) and _generate_static give the same tokens; the
    request API's pool is never built."""
    _, tcfg, _, tp = models
    frames = torch.from_numpy(_frames(tcfg, 2))
    prompts = RNG.integers(0, tcfg.vocab, (2, 4))
    eng = Engine(tcfg, tp, ServeConfig(max_seq=32, temperature=2.0), device="cpu")
    a, _ = eng.generate(prompts, 5, frames=frames, seed=3)
    b, _ = eng._generate_static(prompts, 5, frames=frames, seed=3)
    assert torch.equal(a, b) and tuple(a.shape) == (2, 5)
    assert eng._layout is None


def test_launch_serve_whisper_smoke(capsys):
    assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "4", "--new-tokens", "3", "--max-seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "arch=whisper-smoke generated (2, 3)" in out


def test_strassen_backend_matches_naive_on_the_encoder_projections():
    """A Strassen backend routes the encoder's (B * S_enc)-row projections;
    the logits stay within the model tolerance of the naive route in fp32."""
    from repro_torch.core.backend import MatmulBackend

    _, tcfg, _, tp = _models()
    scfg = dataclasses.replace(tcfg, matmul_backend=MatmulBackend(kind="strassen", depth=1,
                                                                 min_dim=16))
    frames = torch.from_numpy(_frames(tcfg, 2))
    toks = torch.from_numpy(RNG.integers(0, tcfg.vocab, (2, 4)))
    want, _ = TM.apply_prefill(tp, {"tokens": toks, "frames": frames},
                               TM.init_cache(tcfg, 2, 8, device="cpu"), tcfg)
    got, _ = TM.apply_prefill(tp, {"tokens": toks, "frames": frames},
                              TM.init_cache(scfg, 2, 8, device="cpu"), scfg)
    _close(got, want.numpy())
