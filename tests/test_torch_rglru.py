"""Port parity: the RG-LRU block of repro_torch against repro.models.rglru, on the CPU.

The same seeded numpy inputs and the JAX parameters (carried across by
``convert.params_from_jax``'s flattening) go through both packages, on the
recurrentgemma smoke config, at sequence lengths 1, 2, 7 and 24 (odd and
even lengths take both branches of the scan's recursion, 24 three levels of
it):

* ``associative_scan`` against ``jax.lax.associative_scan`` of the same
  linear recurrence (the same association order: within 2 fp32 ulps) and
  against a sequential fp32 loop, at 1e-5;
* ``_causal_conv`` and its new tail, ``init_rglru_state``, and
  ``rglru_block`` with and without a carried state in fp32, at
  1e-5 * max(1, max|ref|), the returned ``{h, conv}`` included;
* ``rglru_block`` in bf16 within 2^-5 x (|ref| + rms(ref)) per element (8
  bf16 roundings of the output's scale; XLA's CPU backend and PyTorch round
  GELU's and the projections' intermediate steps differently);
* two halves of a sequence with the carried state equal one pass.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as jax_smoke
from repro.models import rglru as JR
from repro_torch.configs import get_smoke_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.models import rglru as TR

RNG = np.random.default_rng(43)
LENGTHS = [1, 2, 7, 24]
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


def _pair(dtype="float32"):
    jcfg, tcfg = jax_smoke("recurrentgemma_9b"), get_smoke_config("recurrentgemma_9b")
    jp = JR.init_rglru(jax.random.PRNGKey(5), jcfg, jnp.dtype(dtype))
    tp = TR.init_rglru(torch.Generator().manual_seed(0), tcfg, getattr(torch, dtype))
    tp.load_state_dict(_flat(jp), strict=True)
    return jcfg, tcfg, jp, tp


def _np(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _state(cfg, b):
    return {"h": _np((b, cfg.rnn_width)), "conv": _np((b, cfg.conv_width - 1, cfg.rnn_width))}


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=rel * scale, rtol=0)


def _recurrence(left, right):
    (a1, b1), (a2, b2) = left, right
    return a1 * a2, a2 * b1 + b2


# ------------------------------------------------------------------- scan
@pytest.mark.parametrize("s", LENGTHS + [3, 5, 16, 33])
def test_associative_scan_matches_jax_and_a_sequential_loop(s):
    a = np.exp(-np.abs(_np((2, s, 8))))  # decays in (0, 1], as the RG-LRU's
    b = _np((2, s, 8))
    _, want = jax.lax.associative_scan(_recurrence, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    _, got = TR.associative_scan(TR._linear_recurrence, [torch.from_numpy(a), torch.from_numpy(b)], 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.5e-7, atol=2.5e-7)
    h, seq = np.zeros((2, 8), np.float32), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(seq, 1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("carried", [False, True])
def test_rglru_scan_matches_reference(s, carried):
    jcfg, tcfg, jp, tp = _pair()
    xr = _np((2, s, jcfg.rnn_width))
    h0 = _np((2, jcfg.rnn_width)) if carried else None
    jh, jlast = JR._rglru_scan(jnp.asarray(xr), jp, jcfg, None if h0 is None else jnp.asarray(h0))
    th, tlast = TR._rglru_scan(torch.from_numpy(xr), tp, tcfg, None if h0 is None else torch.from_numpy(h0))
    _close(th, jh)
    _close(tlast, jlast)


# ------------------------------------------------------------- conv, state
def test_init_rglru_state_matches_reference():
    jcfg, tcfg = jax_smoke("recurrentgemma_9b"), get_smoke_config("recurrentgemma_9b")
    want = JR.init_rglru_state(jcfg, 3)
    got = TR.init_rglru_state(tcfg, 3, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32
        assert want[k].dtype == jnp.float32 and not got[k].any()


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_and_its_tail_match_reference(s, carried):
    jcfg, _, jp, tp = _pair()
    x = _np((2, s, jcfg.rnn_width))
    tail = _np((2, jcfg.conv_width - 1, jcfg.rnn_width)) if carried else None
    want, wtail = JR._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"],
                                  None if tail is None else jnp.asarray(tail))
    got, gtail = TR._causal_conv(torch.from_numpy(x), tp.conv_w, tp.conv_b,
                                 None if tail is None else torch.from_numpy(tail))
    _close(got, want)
    np.testing.assert_array_equal(gtail.numpy(), np.asarray(wtail))


# ------------------------------------------------------------------ block
@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("carried", [False, True])
def test_rglru_block_fp32_matches_reference(s, carried):
    jcfg, tcfg, jp, tp = _pair()
    x = _np((2, s, jcfg.d_model))
    st = _state(jcfg, 2) if carried else None
    want, wstate = JR.rglru_block(jp, jnp.asarray(x), jcfg,
                                  state=None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    got, gstate = TR.rglru_block(tp, torch.from_numpy(x), tcfg,
                                 state=None if st is None else {k: torch.from_numpy(v) for k, v in st.items()})
    _close(got, want)
    assert (gstate is None) == (wstate is None)
    if carried:
        assert gstate.keys() == wstate.keys()
        for k in wstate:
            assert gstate[k].dtype == torch.float32
            _close(gstate[k], wstate[k])
        # the state passed in is not written
        for k, v in st.items():
            assert not np.shares_memory(gstate[k].numpy(), v)


@pytest.mark.parametrize("s", [1, 24])
@pytest.mark.parametrize("carried", [False, True])
def test_rglru_block_bf16_matches_reference(s, carried):
    jcfg, tcfg, jp, tp = _pair("bfloat16")
    x = jnp.asarray(_np((2, s, jcfg.d_model))).astype(jnp.bfloat16)
    st = _state(jcfg, 2) if carried else None
    want, wstate = JR.rglru_block(jp, x, jcfg,
                                  state=None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    got, gstate = TR.rglru_block(tp, _t(x), tcfg,
                                 state=None if st is None else {k: torch.from_numpy(v) for k, v in st.items()})
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    g = got.float().numpy()
    worst = float(np.max(np.abs(g - w) / (np.abs(w) + np.sqrt(np.mean(w**2)))))
    assert np.isfinite(g).all() and worst <= BF16_TOL, worst
    if carried:
        for k in wstate:
            ws = np.asarray(wstate[k])
            assert np.max(np.abs(gstate[k].numpy() - ws)) <= BF16_TOL * (np.abs(ws).max() + 1.0)


def test_two_halves_with_the_carried_state_equal_one_pass():
    _, tcfg, _, tp = _pair()
    x = torch.from_numpy(_np((2, 24, tcfg.d_model)))
    zero = TR.init_rglru_state(tcfg, 2, device="cpu")
    full, fstate = TR.rglru_block(tp, x, tcfg, state=zero)
    a, astate = TR.rglru_block(tp, x[:, :11], tcfg, state=zero)
    b, bstate = TR.rglru_block(tp, x[:, 11:], tcfg, state=astate)
    _close(torch.cat([a, b], 1), full.numpy())
    for k in fstate:
        _close(bstate[k], fstate[k].numpy())


def test_gate_projections_stay_naive_fp32_under_a_strassen_backend():
    """wa and wx run through the naive backend in fp32 whatever the model's
    backend, as the JAX package's do; in_gate, in_rec and out take the model's."""
    from repro_torch import obs
    from repro_torch.core.backend import MatmulBackend
    from repro_torch.models import model as TM
    from repro_torch.models import transformer as TT

    cfg = get_smoke_config("recurrentgemma_9b", matmul_backend=MatmulBackend(kind="strassen", min_dim=8))
    params = TM.init_params(cfg, torch.Generator().manual_seed(3))
    obs.reset_tracing()
    obs.configure(enabled=True)
    try:
        TT.forward(params, torch.from_numpy(RNG.integers(0, cfg.vocab, (2, 8))), cfg)
        spans = obs.get_tracer().find("backend.matmul")
        scans = obs.get_tracer().find("rglru.scan")
    finally:
        obs.configure(enabled=False)
        obs.reset_tracing()
    n_rglru = cfg.layer_kinds().count("rglru")
    assert len(scans) == n_rglru
    for site in ("rglru.wa", "rglru.wx"):
        gates = [s.attrs for s in spans if s.attrs["site"] == site]
        assert len(gates) == n_rglru and all(a["kind"] == "naive" for a in gates)
    for site in ("rglru.in_gate", "rglru.in_rec", "rglru.out"):
        assert {s.attrs["kind"] for s in spans if s.attrs["site"] == site} == {"strassen"}
