"""Port parity: the attention and RMSNorm kernels' ops and the attention block.

The port's ops run their plain versions here (CPU tensors) and are held
against the JAX package's Pallas kernels in interpret mode, on the same
seeded numpy inputs, at the JAX tests' tolerances
(``tests/test_kernels_attention.py``): 2e-5 in fp32 and 2e-2 in bf16 for
flash attention, 1e-5 and 2e-2 for RMSNorm. ``attention_block`` (prefill
with a cache, decode at a scalar and at per-row positions, the ring
``local_attn`` cache) is held against the JAX block at 1e-5.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro.models import attention as JA
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.models import attention as TA

RNG = np.random.default_rng(2)


def _np(shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _pair(x, dtype=np.float32):
    """The same values as a JAX array and a CPU tensor (bf16 rounded once, in JAX)."""
    if dtype == np.float32:
        return jnp.asarray(x), torch.from_numpy(x)
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize(
    "b,hq,hkv,s,d",
    [
        (2, 4, 2, 128, 32),   # GQA
        (1, 8, 1, 64, 16),    # MQA
        (2, 4, 4, 128, 64),   # MHA
        (1, 2, 2, 256, 128),  # long-ish
        (1, 4, 2, 100, 32),   # ragged: no tile divides S
    ],
)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference(b, hq, hkv, s, d, causal):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_np(sh)) for sh in
                                    [(b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)])
    got = flash_attention(tq, tk, tv, causal=causal)
    want = jax_flash(jq, jk, jv, causal=causal, block_q=32, block_k=32, interpret=True)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("window", [16, 64, 1])
def test_flash_sliding_window_matches_reference(window):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_np((1, 2, 128, 32))) for _ in range(3))
    got = flash_attention(tq, tk, tv, causal=True, window=window)
    want = jax_flash(jq, jk, jv, causal=True, window=window, block_q=32, block_k=32,
                     interpret=True)
    _close(got, want, 2e-5)


def test_flash_bf16_matches_reference():
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_np(sh), "bf16") for sh in
                                    [(1, 4, 128, 64), (1, 2, 128, 64), (1, 2, 128, 64)])
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    want = jax_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True)
    _close(got, want, 2e-2)


def test_flash_fully_masked_rows_are_zero_like_the_kernel():
    """More queries than keys under a window: rows >= Sk + window - 1 see no
    key. The TPU kernel divides their zero row sum as 1 and writes 0."""
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_np(sh)) for sh in
                                    [(1, 2, 64, 16), (1, 2, 16, 16), (1, 2, 16, 16)])
    got = flash_attention(tq, tk, tv, causal=True, window=8)
    want = jax_flash(jq, jk, jv, causal=True, window=8, block_q=32, block_k=16, interpret=True)
    _close(got, want, 2e-5)
    assert torch.isfinite(got).all()
    assert torch.count_nonzero(got[:, :, 23:]) == 0 and torch.count_nonzero(got[:, :, :23]) > 0


def test_flash_window_requires_causal():
    q = torch.zeros(1, 1, 32, 16)
    with pytest.raises(ValueError, match="requires causal"):
        flash_attention(q, q, q, causal=False, window=8)


@pytest.mark.parametrize("shape", [(64, 128), (4, 32, 256), (2, 2, 8, 64), (5, 3072)])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_rmsnorm_matches_reference(shape, dtype):
    (jx, tx), (jw, tw) = _pair(_np(shape), dtype), _pair(_np(shape[-1:]), dtype)
    got = rmsnorm(tx, tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    want = jax_rmsnorm(jx, jw, interpret=True)
    _close(got, want, 2e-2 if dtype == "bf16" else 1e-5)


def test_rmsnorm_takes_fp32_weights_beside_bf16_rows():
    jx, tx = _pair(_np((8, 64)), "bf16")
    w = _np((64,))
    got = rmsnorm(tx, torch.from_numpy(w))
    want = jax_rmsnorm(jx, jnp.asarray(w), interpret=True)
    assert got.dtype == torch.bfloat16
    _close(got, want, 2e-2)


# ------------------------------------------------------------ attention_block
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v))
    return out


def _block_pair(cfg_overrides):
    import jax

    jcfg = dataclasses.replace(jax_smoke("qwen1_5_32b"), **cfg_overrides)  # QKV bias
    tcfg = dataclasses.replace(torch_smoke("qwen1_5_32b"), **cfg_overrides)
    jp = JA.init_attention(jax.random.PRNGKey(4), jcfg, jnp.float32)
    jp = jax.tree.map(lambda a: a + 0.1 if a.ndim == 1 else a, jp)  # nonzero biases
    tp = TA.init_attention(torch.Generator().manual_seed(0), tcfg, torch.float32)
    tp.load_state_dict(_flat(jp), strict=True)
    return jcfg, tcfg, jp, tp


def _cache_pair(tcfg, batch, seq):
    tc = TA.init_kv_cache(tcfg, batch, seq, torch.float32, "cpu")
    jc = {k: jnp.asarray(v.numpy()) for k, v in tc.items()}
    return jc, tc


def _positions(b, s, off=0):
    pos = np.broadcast_to(np.arange(s)[None, :] + off, (b, s)).copy()
    return jnp.asarray(pos), torch.from_numpy(pos)


def test_attention_block_prefill_then_decode_matches_reference():
    jcfg, tcfg, jp, tp = _block_pair({})
    jc, tc = _cache_pair(tcfg, 2, 16)
    jx, tx = _pair(_np((2, 6, tcfg.d_model)))
    jpos, tpos = _positions(2, 6)
    zero = np.int32(0)
    jout, jc = JA.attention_block(jp, jx, jcfg, positions=jpos, cache=jc, cache_pos=jnp.asarray(zero))
    tout, tc = TA.attention_block(tp, tx, tcfg, positions=tpos, cache=tc,
                                  cache_pos=torch.tensor(0))
    _close(tout, jout, 1e-5)
    for name in ("k", "v"):
        _close(tc[name], jc[name], 1e-5)
    # one decode step at the scalar position 6
    jx1, tx1 = _pair(_np((2, 1, tcfg.d_model)))
    jpos1, tpos1 = _positions(2, 1, 6)
    jout, jc = JA.attention_block(jp, jx1, jcfg, positions=jpos1, cache=jc,
                                  cache_pos=jnp.asarray(np.int32(6)))
    tout, tc = TA.attention_block(tp, tx1, tcfg, positions=tpos1, cache=tc,
                                  cache_pos=torch.tensor(6))
    _close(tout, jout, 1e-5)
    for name in ("k", "v"):
        _close(tc[name], jc[name], 1e-5)


def test_attention_block_decode_at_per_row_positions_matches_reference():
    jcfg, tcfg, jp, tp = _block_pair({})
    jc, tc = _cache_pair(tcfg, 3, 16)
    fill = _np(tuple(tc["k"].shape))
    tc = {"k": torch.from_numpy(fill.copy()), "v": torch.from_numpy(fill[::-1].copy())}
    jc = {k: jnp.asarray(v.numpy()) for k, v in tc.items()}
    pos = np.array([3, 9, 15], np.int32)
    jx, tx = _pair(_np((3, 1, tcfg.d_model)))
    jout, jc = JA.attention_block(jp, jx, jcfg, positions=jnp.asarray(pos[:, None]), cache=jc,
                                  cache_pos=jnp.asarray(pos))
    tout, tc = TA.attention_block(tp, tx, tcfg, positions=torch.from_numpy(pos[:, None]),
                                  cache=tc, cache_pos=torch.from_numpy(pos))
    _close(tout, jout, 1e-5)
    for name in ("k", "v"):
        _close(tc[name], jc[name], 1e-5)


@pytest.mark.parametrize("prompt", [5, 12])
def test_attention_block_ring_cache_matches_reference(prompt):
    """local_attn with a window: prefill shorter and longer than the ring,
    then decode steps that wrap it."""
    jcfg, tcfg, jp, tp = _block_pair({"local_window": 8})
    jc, tc = _cache_pair(tcfg, 1, 8)
    jx, tx = _pair(_np((1, prompt, tcfg.d_model)))
    jpos, tpos = _positions(1, prompt)
    kw = dict(causal=True, window=8, ring=True)
    jout, jc = JA.attention_block(jp, jx, jcfg, positions=jpos, cache=jc,
                                  cache_pos=jnp.asarray(np.int32(0)), **kw)
    tout, tc = TA.attention_block(tp, tx, tcfg, positions=tpos, cache=tc,
                                  cache_pos=torch.tensor(0), **kw)
    _close(tout, jout, 1e-5)
    for step in range(prompt, prompt + 6):
        jx1, tx1 = _pair(_np((1, 1, tcfg.d_model)))
        jpos1, tpos1 = _positions(1, 1, step)
        jout, jc = JA.attention_block(jp, jx1, jcfg, positions=jpos1, cache=jc,
                                      cache_pos=jnp.asarray(np.int32(step)), **kw)
        tout, tc = TA.attention_block(tp, tx1, tcfg, positions=tpos1, cache=tc,
                                      cache_pos=torch.tensor(step), **kw)
        _close(tout, jout, 1e-5)
        for name in ("k", "v"):
            _close(tc[name], jc[name], 1e-5)


def test_decode_attention_matches_reference_with_window():
    q, k, v = _np((2, 4, 1, 16)), _np((2, 2, 12, 16)), _np((2, 2, 12, 16))
    pos = np.array([7, 11], np.int32)
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), window=4)
    got = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(pos), window=4)
    _close(got, want, 1e-5)


# ------------------------------------------- the bf16 tensor-core kernel's rounding
def _tensor_core_flash(q, k, v, *, causal=True, window=None, split=True):
    """What the bf16 flash kernel computes, step by step, on the CPU.

    Q K^T from bf16 inputs with fp32 sums (each product exact), 64-key tiles
    with the online update (m, l in fp32), P into P V as two bf16 parts (hi,
    its rounding, and lo, the rounding of the rest; one bf16 P with
    ``split=False``), O in fp32, divided once and rounded once. Masked scores
    are -1e30 with their probabilities 0, and a zero row sum divides as 1.
    """
    _, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    tile = 64
    kf = k.float().repeat_interleave(hq // hkv, 1)
    vf = v.float().repeat_interleave(hq // hkv, 1)
    qf = q.float()
    rows = torch.arange(sq)[:, None]
    m = torch.full((*q.shape[:3], 1), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for k0 in range(0, sk, tile):
        cols = torch.arange(k0, min(k0 + tile, sk))[None, :]
        live = torch.ones((sq, cols.shape[1]), dtype=torch.bool)
        if causal:
            live &= rows >= cols
        if window is not None:
            live &= rows - cols < window
        s = torch.matmul(qf, kf[:, :, k0:k0 + tile].transpose(-1, -2)) * d**-0.5
        s = torch.where(live, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(live, torch.exp(s - m_new), 0.0)
        l = alpha * l + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float() if split else torch.zeros_like(p)
        vt = vf[:, :, k0:k0 + tile]
        o = alpha * o + torch.matmul(hi, vt) + torch.matmul(lo, vt)
        m = m_new
    return (o / torch.where(l == 0.0, 1.0, l)).bfloat16()


def _element_rule(got, want):
    """chip_smoke.py's bf16 flash rule: every element within 2^-7 x (|want| +
    rms(want)). Returns the worst err/limit."""
    g, w = got.float(), want.float()
    limit = 2**-7 * (w.abs() + w.square().mean().sqrt())
    return ((g - w).abs() / limit).max().item()


@pytest.mark.parametrize("causal,window", [(True, None), (True, 256), (True, 17), (False, None)])
@pytest.mark.parametrize("against", ["plain", "pallas"])
def test_tensor_core_flash_rounding_holds_the_element_rule(causal, window, against):
    """A narrow phi4-like shape (Hq 6, Hkv 2, D 128, S 1000) through the bf16
    kernel's emulated rounding, against the port's fp32 plain version and
    against the JAX Pallas kernel in interpret mode on the same bf16 inputs."""
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_np(sh), "bf16") for sh in
                                    [(1, 6, 1000, 128), (1, 2, 1000, 128), (1, 2, 1000, 128)])
    got = _tensor_core_flash(tq, tk, tv, causal=causal, window=window)
    if against == "plain":
        want = flash_attention(tq, tk, tv, causal=causal, window=window)
    else:
        want = torch.from_numpy(np.asarray(
            jax_flash(jq, jk, jv, causal=causal, window=window, interpret=True), np.float32))
    assert got.shape == tq.shape and torch.isfinite(got.float()).all()
    worst = _element_rule(got, want)
    print(f"worst err/limit {worst:.3f} against {against}")
    assert worst <= 1.0


def test_one_bf16_p_would_break_the_element_rule():
    """Why the kernel splits P: with one bf16 P (2^-9 on each P V term) a row
    with few live keys whose terms cancel misses the rule, since its limit's
    rms floor is set by the long rows; with P = hi + lo it holds easily."""
    tq, tk, tv = (_pair(_np(sh), "bf16")[1] for sh in [(1, 6, 1000, 128), (1, 2, 1000, 128),
                                                        (1, 2, 1000, 128)])
    want = flash_attention(tq, tk, tv)
    one = _element_rule(_tensor_core_flash(tq, tk, tv, split=False), want)
    two = _element_rule(_tensor_core_flash(tq, tk, tv), want)
    print(f"worst err/limit: one bf16 P {one:.3f}, P = hi + lo {two:.3f}")
    assert one > 1.0 and two <= 0.75
