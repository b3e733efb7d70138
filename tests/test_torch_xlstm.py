"""Port parity: the xLSTM slice of repro_torch against repro, on the CPU.

The same seeded numpy inputs go through both packages in fp32:

* the sLSTM sequence: the port's plain version (``slstm_seq_ref``) and its
  op on a CPU tensor (``slstm_seq``) against the JAX Pallas kernel, run in
  interpret mode as ``tests/test_kernels_slstm.py`` runs it, and against the
  JAX scan oracle, at that test's shapes and tolerance (2e-5), plus the
  carried-state case;
* the mLSTM sequential scan (``_mlstm_step``) and the chunkwise form
  (chunks 4 and 8) against their JAX counterparts, at 1e-5;
* ``mlstm_block`` and ``slstm_block`` with and without a carried state, and
  the xlstm smoke model's logits through ``transformer.forward``, prefill
  and decode, at 1e-4 relative to the largest output (the JAX package's
  model tests hold fp32 paths at 1e-4).

In bf16, the blocks are held to the JAX blocks within a quarter of the
spread that one rounding placed elsewhere causes, and the whole model's
distance from its own fp32 logits to the JAX model's.

The sLSTM backward's plain version (``slstm_seq_bwd_ref``, fed the saving
forward's tensors) is held to ``torch.autograd`` through ``slstm_seq_ref``
and to ``jax.grad`` of the JAX oracle, each gradient normwise to 1e-5, from
a zero and a carried state, with and without final-state gradients, at
S = 1 and dh 48 (the m tie of the step against autograd alone), with the
kernel's affine step (``step_vjp_affine``) and the direct one
(``step_vjp``), which are also held to each other at both ties; ``SlstmSeq``
on the CPU gives autograd's gradients; and the backward kernel's launch plan
(``slstm_bwd_plan``: rows a pass, the exchange ring, shared memory) is
checked as the forward's is.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.slstm.ops import slstm_seq as jax_slstm_seq
from repro.kernels.slstm.ref import slstm_seq_ref as jax_slstm_seq_ref
from repro.models import model as JM
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.kernels.slstm import slstm as tsl
from repro_torch.kernels.slstm.ops import SlstmSeq, slstm_seq
from repro_torch.kernels.slstm.ref import _gates, slstm_seq_bwd_ref, slstm_seq_ref, step_vjp, step_vjp_affine
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX

RNG = np.random.default_rng(31)
SHIPPED_PATTERN = get_config("xlstm_1_3b").block_pattern  # 7 mLSTM + 1 sLSTM
SLSTM_SHAPES = [(1, 8, 1, 4), (2, 16, 2, 8), (2, 32, 4, 16)]
STATE = ("c", "n", "m", "h")


def _np(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return tensor_from_numpy(np.array(a), "cpu")


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().float().numpy(), want, atol=rel * scale, rtol=0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = _t(v)
    return out


def _slstm_inputs(b, s, h, dh, carried=False):
    """tests/test_kernels_slstm.py's inputs; ``carried`` draws a mid-sequence state."""
    wx, r = _np((b, s, 4, h, dh)), _np((4, h, dh, dh), 0.3)
    if carried:
        state = {"c": _np((b, h, dh)), "n": np.abs(_np((b, h, dh))) + 1.0,
                 "m": _np((b, h, dh)), "h": np.tanh(_np((b, h, dh)))}
    else:
        state = {k: np.zeros((b, h, dh), np.float32) for k in ("c", "n", "h")}
        state["m"] = np.full((b, h, dh), -1e30, np.float32)
    return wx, r, state


def _assert_slstm(got, want, atol=2e-5):
    (st_g, hs_g), (st_w, hs_w) = got, want
    np.testing.assert_allclose(hs_g.numpy(), np.asarray(hs_w), atol=atol, rtol=atol)
    for k in STATE:
        np.testing.assert_allclose(st_g[k].numpy(), np.asarray(st_w[k]), atol=atol, rtol=atol,
                                   err_msg=k)


# ------------------------------------------------------------------ sLSTM
@pytest.mark.parametrize("b,s,h,dh", SLSTM_SHAPES)
@pytest.mark.parametrize("carried", [False, True])
def test_slstm_seq_ref_matches_jax_kernel_and_oracle(b, s, h, dh, carried):
    wx, r, state = _slstm_inputs(b, s, h, dh, carried)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    got = slstm_seq_ref(_t(wx), _t(r), {k: _t(v) for k, v in state.items()})
    _assert_slstm(got, jax_slstm_seq(jnp.asarray(wx), jnp.asarray(r), jstate))
    _assert_slstm(got, jax_slstm_seq_ref(jnp.asarray(wx), jnp.asarray(r), jstate))


@pytest.mark.parametrize("b,s,h,dh", SLSTM_SHAPES)
def test_slstm_seq_op_on_cpu_matches_jax_kernel(b, s, h, dh):
    wx, r, state = _slstm_inputs(b, s, h, dh)
    tstate = {k: _t(v) for k, v in state.items()}
    n = tsl.slstm_seq_cuda.launches
    got = slstm_seq(_t(wx), _t(r), tstate)
    assert tsl.slstm_seq_cuda.launches == n  # a CPU tensor takes the plain version
    _assert_slstm(got, jax_slstm_seq(jnp.asarray(wx), jnp.asarray(r),
                                     {k: jnp.asarray(v) for k, v in state.items()}))
    for k in STATE:  # the op returns new state and leaves its input alone
        np.testing.assert_array_equal(tstate[k].numpy(), state[k])


def test_slstm_seq_state_carry():
    """Two halves with the carried state equal one pass, as the JAX kernel's test holds."""
    wx, r, state = _slstm_inputs(2, 16, 2, 8)
    wx, r, st = _t(wx), _t(r), {k: _t(v) for k, v in state.items()}
    st_full, hs_full = slstm_seq(wx, r, st)
    st_mid, hs_a = slstm_seq(wx[:, :8], r, st)
    st_end, hs_b = slstm_seq(wx[:, 8:], r, st_mid)
    np.testing.assert_allclose(torch.cat([hs_a, hs_b], 1).numpy(), hs_full.numpy(), atol=2e-5)
    for k in STATE:
        np.testing.assert_allclose(st_end[k].numpy(), st_full[k].numpy(), atol=2e-5, err_msg=k)
    _, hs_j = jax_slstm_seq(jnp.asarray(wx.numpy()[:, 8:]), jnp.asarray(r.numpy()),
                            {k: jnp.asarray(v.numpy()) for k, v in st_mid.items()})
    np.testing.assert_allclose(hs_b.numpy(), np.asarray(hs_j), atol=2e-5, rtol=2e-5)


def test_slstm_seq_cuda_rejects_bad_inputs():
    wx, r, state = _slstm_inputs(1, 4, 2, 8)
    st = {k: _t(v) for k, v in state.items()}
    with pytest.raises(ValueError, match="wx must be"):
        tsl.slstm_seq_cuda(_t(wx)[:, :, :3], _t(r), st)
    with pytest.raises(ValueError, match="r must be"):
        tsl.slstm_seq_cuda(_t(wx), _t(r)[:, :1], st)
    with pytest.raises(ValueError, match="state 'm'"):
        tsl.slstm_seq_cuda(_t(wx), _t(r), {**st, "m": st["m"][:, :1]})
    with pytest.raises(TypeError, match="float32"):
        tsl.slstm_seq_cuda(_t(wx).double(), _t(r), st)


# An H100's SM count and the shared memory a block may opt in to (227 KiB).
H100 = dict(sms=132, smem_per_block=232448)


def test_slstm_plan_keeps_r_resident_at_xlstm_width():
    """xlstm-1.3b's 4 heads of 512 on an H100: 128 blocks, 32 a head, each
    16 columns whose 128 KiB slice of r stays in shared memory over a
    prefill; a single decode step reads r once, straight from memory."""
    plan = tsl.slstm_plan(4, 512, 1024, **H100)
    assert (plan.blocks, plan.blocks_per_head, plan.cols_per_block) == (128, 32, 16)
    assert plan.resident == plan.tiles_per_block == 1 and plan.r_resident
    assert 128 * 1024 < plan.smem_bytes <= H100["smem_per_block"]
    step = tsl.slstm_plan(4, 512, 1, **H100)
    assert (step.blocks, step.resident, step.r_resident) == (128, 0, False)
    assert step.smem_bytes < 32 * 1024


def test_slstm_plan_streams_r_that_does_not_fit():
    """8 heads of 512 (32 MiB of r) on an H100: two tiles a block, one of
    them resident, the other read from L2 every step."""
    plan = tsl.slstm_plan(8, 512, 16, **H100)
    assert plan.blocks <= H100["sms"] and plan.blocks * plan.tiles_per_block >= 8 * 32
    assert plan.tiles_per_block == 2 and plan.resident == 1 and not plan.r_resident
    assert plan.smem_bytes <= H100["smem_per_block"]


@pytest.mark.parametrize("heads,dh", [(4, 16), (1, 4), (2, 8), (4, 4)])
def test_slstm_plan_gives_one_masked_tile_a_head_at_small_widths(heads, dh):
    """The smoke config's dh 16 and the JAX kernel test's dh 4 and 8: one
    tile of 16 columns a head (past dh masked), one block each, r resident."""
    plan = tsl.slstm_plan(heads, dh, 8, **H100)
    assert (plan.blocks, plan.tiles_per_block, plan.blocks_per_head) == (heads, 1, 1)
    assert plan.r_resident


def test_slstm_plan_covers_every_tile_with_at_most_one_block_an_sm():
    for heads, dh, sms in [(200, 4, 132), (5, 512, 132), (3, 48, 2), (1, 8192, 132), (7, 100, 16)]:
        plan = tsl.slstm_plan(heads, dh, 64, sms, H100["smem_per_block"])
        tiles = heads * -(-dh // tsl.COLS)
        assert plan.blocks <= sms and (plan.blocks - 1) * plan.tiles_per_block < tiles
        assert plan.blocks * plan.tiles_per_block >= tiles
        assert 0 <= plan.resident <= plan.tiles_per_block
        assert plan.smem_bytes <= H100["smem_per_block"]
    with pytest.raises(ValueError, match="shared memory"):
        tsl.slstm_plan(1, 100_000, 64, **H100)


# --------------------------------------------------------- sLSTM backward
# (b, s, h, dh, state, final-state gradients): a zero state (the first
# step's n' = 1 sits on max(n', 1)'s tie), a carried one, S = 1 and dh 48.
SLSTM_BWD_CASES = [(2, 8, 4, 16, "zero", False), (2, 8, 2, 16, "carried", False),
                   (2, 8, 2, 16, "carried", True), (3, 1, 2, 8, "carried", True),
                   (2, 5, 1, 48, "carried", True), (2, 6, 2, 8, "zero", True)]
BWD_REL = 1e-5


def _slstm_bwd_inputs(b, s, h, dh, kind, final):
    wx, r, state = _slstm_inputs(b, s, h, dh, carried=kind == "carried")
    if kind == "tie_m":
        # h0 = 0, so pre = wx at t = 0; log_sigmoid(-100) is -100 in fp32, and
        # -100 + 100.5 == 0.5 == pre_i exactly
        wx[:, 0, 1], wx[:, 0, 2], state["m"][:] = 0.5, -100.0, 100.5
    dhs = _np((b, s, h, dh))
    dfin = {k: _np((b, h, dh)) if final else np.zeros((b, h, dh), np.float32) for k in STATE}
    return wx, r, state, dhs, dfin


def _torch_grads(fn, wx, r, state, dhs, dfin):
    leaves = [_t(wx).requires_grad_(), _t(r).requires_grad_(), *(_t(state[k]).requires_grad_() for k in STATE)]
    st, hs = fn(leaves[0], leaves[1], dict(zip(STATE, leaves[2:])))
    loss = (hs * _t(dhs)).sum() + sum((st[k] * _t(dfin[k])).sum() for k in STATE)
    return torch.autograd.grad(loss, leaves)


def _jax_grads(wx, r, state, dhs, dfin):
    def loss(wx, r, state):
        st, hs = jax_slstm_seq_ref(wx, r, state)
        return jnp.sum(hs * dhs) + sum(jnp.sum(st[k] * dfin[k]) for k in STATE)

    gwx, gr, gst = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(wx), jnp.asarray(r),
                                                     {k: jnp.asarray(v) for k, v in state.items()})
    return [gwx, gr, *(gst[k] for k in STATE)]


def _assert_grads(got, want, names=("wx", "r", *STATE)):
    """Each gradient normwise within BWD_REL; one whose norm is below 1e-6 of
    all the gradients' (zero in exact arithmetic, left with fp32 roundoff:
    dm0 at the m tie) is held to that absolutely, as the training
    tests hold such a leaf."""
    want = [np.asarray(w, np.float64) for w in want]
    noise = 1e-6 * np.sqrt(sum(float(np.sum(w**2)) for w in want))
    for name, g, w in zip(names, got, want):
        err = np.linalg.norm(g.detach().double().numpy() - w)
        if np.linalg.norm(w) <= noise:
            assert err <= noise, (name, err)
        else:
            assert err <= BWD_REL * np.linalg.norm(w), (name, err / np.linalg.norm(w))


VJPS = {"affine": step_vjp_affine, "direct": step_vjp}


@pytest.mark.parametrize("form", list(VJPS))
@pytest.mark.parametrize("b,s,h,dh,kind,final", SLSTM_BWD_CASES)
def test_slstm_seq_bwd_ref_matches_autograd_and_jax(b, s, h, dh, kind, final, form):
    wx, r, state, dhs, dfin = _slstm_bwd_inputs(b, s, h, dh, kind, final)
    st = {k: _t(v) for k, v in state.items()}
    _, hs, saved = slstm_seq_ref(_t(wx), _t(r), st, save=True)
    if kind == "zero":  # the first step sits on max(n', 1)'s tie
        assert bool((saved["n"][:, 0] == 1.0).all())
    dwx, dr, d0 = slstm_seq_bwd_ref(_t(r), st, hs, saved, _t(dhs), {k: _t(v) for k, v in dfin.items()},
                                    vjp=VJPS[form])
    got = [dwx, dr, *(d0[k] for k in STATE)]
    _assert_grads(got, _torch_grads(slstm_seq_ref, wx, r, state, dhs, dfin))
    _assert_grads(got, _jax_grads(wx, r, state, dhs, dfin))


@pytest.mark.parametrize("form", list(VJPS))
def test_slstm_seq_bwd_ref_splits_the_m_tie_as_autograd_does(form):
    """log_f + m == pre_i exactly at the first step: the plain backward splits
    m''s gradient in halves there, as torch.maximum's does, in either form of
    the step. (The JAX oracle's gradient at this point gives all of it to
    pre_i, another subgradient of the same max: the two lie 4e-2 apart in
    dwx, so this case is held to PyTorch's autograd alone.)"""
    wx, r, state, dhs, dfin = _slstm_bwd_inputs(1, 4, 2, 8, "tie_m", True)
    st = {k: _t(v) for k, v in state.items()}
    _, hs, saved = slstm_seq_ref(_t(wx), _t(r), st, save=True)
    assert bool((saved["m"][:, 0] == 0.5).all())
    dwx, dr, d0 = slstm_seq_bwd_ref(_t(r), st, hs, saved, _t(dhs), {k: _t(v) for k, v in dfin.items()},
                                    vjp=VJPS[form])
    _assert_grads([dwx, dr, *(d0[k] for k in STATE)], _torch_grads(slstm_seq_ref, wx, r, state, dhs, dfin))


def _step_point(kind, b=2, h=2, dh=8):
    """One step's pre-activations (h_prev = 0, so pre = wx_t), the state
    before it and the cotangents of the state after: from a zero state (n' =
    1, m' = pre_i), at the m tie (log_f + m == pre_i, c and n carried) or
    from a carried state."""
    wx, _, state, _, _ = _slstm_bwd_inputs(b, 1, h, dh, kind, False)
    if kind == "tie_m":
        state["c"], state["n"] = _np((b, h, dh)), np.abs(_np((b, h, dh))) + 1.0
    cot = {k: _np((b, h, dh)) for k in STATE}
    return wx[:, 0], {k: state[k] for k in ("c", "n", "m")}, cot


@pytest.mark.parametrize("kind", ["zero", "tie_m", "carried"])
def test_step_vjp_affine_matches_step_vjp_and_autograd(kind):
    """One step's VJP in the kernel's affine form against the direct form (to
    rounding) and against autograd through the step: PyTorch's everywhere,
    and JAX's except at the m tie, where it takes another subgradient (see
    the test above). At the zero state pre_i's two terms cancel."""
    wx, st, cot = _step_point(kind)
    leaves = [_t(wx).requires_grad_(), *(_t(st[k]).requires_grad_() for k in ("c", "n", "m"))]
    new = _gates(leaves[0], dict(zip(("c", "n", "m"), leaves[1:])))
    if kind == "zero":
        assert bool((new["n"] == 1.0).all())
    if kind == "tie_m":
        assert bool((torch.nn.functional.logsigmoid(leaves[0][:, 2]) + leaves[3] == leaves[0][:, 1]).all())
    want = torch.autograd.grad(sum((new[k] * _t(cot[k])).sum() for k in STATE), leaves)
    args = (*(x.detach() for x in leaves), *(new[k].detach() for k in ("c", "n", "m")),
            _t(cot["h"]), *(_t(cot[k]) for k in ("c", "n", "m")))
    got, direct = step_vjp_affine(*args), step_vjp(*args)
    for g, d in zip(got, direct):
        _close(g, d.numpy(), rel=1e-6)
    _assert_grads(got, want, names=("wx", "c", "n", "m"))
    if kind != "tie_m":
        def step(wx, c, n, m):  # h_prev = 0: r plays no part
            r = jnp.zeros((4, *c.shape[1:], c.shape[-1]))
            return JX._slstm_step(r, {"c": c, "n": n, "m": m, "h": jnp.zeros_like(c)}, wx)[0]

        _, pull = jax.vjp(step, *(jnp.asarray(x) for x in (wx, st["c"], st["n"], st["m"])))
        _assert_grads(got, pull({k: jnp.asarray(cot[k]) for k in STATE}), names=("wx", "c", "n", "m"))


@pytest.mark.parametrize("b,s,h,dh,kind,final", SLSTM_BWD_CASES[:4])
def test_slstm_function_on_cpu_gives_autograds_gradients(b, s, h, dh, kind, final):
    wx, r, state, dhs, dfin = _slstm_bwd_inputs(b, s, h, dh, kind, final)
    n, nb = tsl.slstm_seq_cuda.launches, tsl.slstm_seq_bwd_cuda.launches
    got = _torch_grads(slstm_seq, wx, r, state, dhs, dfin)
    assert (tsl.slstm_seq_cuda.launches, tsl.slstm_seq_bwd_cuda.launches) == (n, nb)  # plain versions
    _assert_grads(got, _torch_grads(slstm_seq_ref, wx, r, state, dhs, dfin))


def test_slstm_op_runs_as_the_function_only_where_autograd_records():
    wx, r, state = _slstm_inputs(1, 3, 2, 8)
    leaves = [_t(wx).requires_grad_(), _t(r)]
    st, hs = slstm_seq(leaves[0], leaves[1], {k: _t(v) for k, v in state.items()})
    assert type(hs.grad_fn).__name__ == f"{SlstmSeq.__name__}Backward"
    with torch.no_grad():
        _, hs = slstm_seq(leaves[0], leaves[1], {k: _t(v) for k, v in state.items()})
    assert hs.grad_fn is None
    # r alone needs a gradient, as in training: dr only, and the input is untouched
    r_leaf = _t(r).requires_grad_()
    _, hs = slstm_seq(_t(wx), r_leaf, {k: _t(v) for k, v in state.items()})
    (g,) = torch.autograd.grad(hs.sum(), [r_leaf])
    assert g.shape == r_leaf.shape and bool(torch.isfinite(g).all())
    np.testing.assert_array_equal(r_leaf.detach().numpy(), r)


def test_slstm_bwd_cuda_rejects_bad_inputs():
    wx, r, state = _slstm_inputs(1, 4, 2, 8)
    st = {k: _t(v) for k, v in state.items()}
    _, hs, saved = slstm_seq_ref(_t(wx), _t(r), st, save=True)
    dst = {k: torch.zeros_like(v) for k, v in st.items()}
    with pytest.raises(ValueError, match="dhs must be"):
        tsl.slstm_seq_bwd_cuda(_t(r), st, hs, saved, hs[:, :2], dst)
    with pytest.raises(ValueError, match="dstate 'n'"):
        tsl.slstm_seq_bwd_cuda(_t(r), st, hs, saved, hs, {**dst, "n": dst["n"][:, :1]})
    with pytest.raises(TypeError, match="float32"):
        tsl.slstm_seq_bwd_cuda(_t(r).double(), st, hs, saved, hs, dst)


def test_slstm_bwd_plan_keeps_r_resident_at_xlstm_width():
    """xlstm-1.3b's training shape, 4 heads of 512 on an H100: the forward's
    grid (128 blocks, 32 a head, 16 columns of r's d index each), each
    block's 128 KiB slice of r resident beside four gates of dpre a row."""
    plan = tsl.slstm_bwd_plan(4, 512, 1024, **H100, batch=2)
    fwd = tsl.slstm_plan(4, 512, 1024, **H100)
    assert (plan.blocks, plan.blocks_per_head, plan.tiles_per_block) == (fwd.blocks, 32, 1)
    assert plan.r_resident and 128 * 1024 + plan.rows * 4 * 512 * 4 < plan.smem_bytes <= H100["smem_per_block"]
    assert plan.smem_bytes > fwd.smem_bytes
    step = tsl.slstm_bwd_plan(4, 512, 1, **H100, batch=2)  # one dot-product pass: r read once
    assert (step.blocks, step.resident) == (128, 0)


def test_slstm_bwd_plan_streams_r_that_does_not_fit():
    plan = tsl.slstm_bwd_plan(8, 512, 16, **H100, batch=2)
    assert plan.tiles_per_block == 2 and plan.resident == 1 and not plan.r_resident
    assert plan.smem_bytes <= H100["smem_per_block"]


@pytest.mark.parametrize("heads,dh", [(4, 48), (2, 40), (3, 100), (4, 16)])
def test_slstm_bwd_plan_masks_a_ragged_dh(heads, dh):
    plan = tsl.slstm_bwd_plan(heads, dh, 64, **H100, batch=4)
    tiles = heads * -(-dh // tsl.COLS)
    assert plan.blocks * plan.tiles_per_block >= tiles and plan.r_resident
    assert plan.smem_bytes == (tsl.BT * 4 * dh + 8 * tsl.BT * tsl.COLS + 4 * dh * tsl.COLS) * 4


def test_slstm_bwd_plan_covers_every_tile_with_at_most_one_block_an_sm():
    for heads, dh, sms in [(200, 4, 132), (5, 512, 132), (3, 48, 2), (1, 2048, 132), (7, 100, 16)]:
        plan = tsl.slstm_bwd_plan(heads, dh, 64, sms, H100["smem_per_block"], batch=4)
        tiles = heads * -(-dh // tsl.COLS)
        assert plan.blocks <= sms and (plan.blocks - 1) * plan.tiles_per_block < tiles
        assert plan.blocks * plan.tiles_per_block >= tiles
        assert 0 <= plan.resident <= plan.tiles_per_block
        assert plan.smem_bytes <= H100["smem_per_block"]
    with pytest.raises(ValueError, match="shared memory"):
        tsl.slstm_bwd_plan(1, 8192, 64, **H100, batch=4)  # four gates of 8192 a row, four rows: 512 KiB


@pytest.mark.parametrize("batch,rows", [(1, 1), (2, 2), (3, 4), (4, 4), (6, 4)])
def test_slstm_bwd_plan_picks_the_rows_template_for_the_batch(batch, rows):
    """One row a pass at B = 1, two at B = 2 (xlstm's training rows), BT
    otherwise (B = 6 takes two passes); the shared memory holds r's tile,
    the pass's staged rows and its reduction buffer."""
    plan = tsl.slstm_bwd_plan(4, 512, 64, **H100, batch=batch)
    assert plan.rows == rows and plan.tiles_per_block == 1
    assert plan.smem_bytes == (4 * 512 * tsl.COLS + rows * 4 * 512 + 8 * rows * tsl.COLS) * 4


@pytest.mark.parametrize("heads,dh,batch,dh_pad", [(4, 512, 2, 512), (2, 50, 3, 52), (1, 7, 1, 8), (3, 48, 6, 48)])
def test_slstm_bwd_plan_sizes_the_ring_and_the_staging_in_whole_16_bytes(heads, dh, batch, dh_pad):
    """The dpre ring holds 2 slots x H x B x 4 gates x dh_pad floats, dh
    rounded up to 4, so that a pass's rows are one 16-byte-aligned run of
    whole float4s (128 KiB at xlstm's training rows, which L2 keeps); the
    shared memory counts the staged rows at dh_pad too."""
    plan = tsl.slstm_bwd_plan(heads, dh, 64, **H100, batch=batch)
    assert plan.dh_pad == dh_pad and plan.ring_floats == 2 * heads * batch * 4 * dh_pad
    assert (plan.rows * 4 * plan.dh_pad * 4) % 16 == 0
    fixed = (plan.rows * 4 * dh_pad + 8 * plan.rows * tsl.COLS) * 4
    assert plan.smem_bytes == fixed + plan.resident * 4 * dh * tsl.COLS * 4
    if (heads, dh, batch) == (4, 512, 2):
        assert plan.ring_floats * 4 == 128 * 1024
    with pytest.raises(ValueError, match="batch"):
        tsl.slstm_bwd_plan(heads, dh, 64, **H100, batch=0)


# ------------------------------------------------------------------ mLSTM
def _mlstm_streams(b, s, h, dk, dv):
    """q, k (B, S, H, dk), v (B, S, H, dv), i, f (B, S, H) and a carried state."""
    q, k, v = _np((b, s, h, dk), dk**-0.5), _np((b, s, h, dk), dk**-0.5), _np((b, s, h, dv))
    i_pre, f_pre = _np((b, s, h)), _np((b, s, h)) + 2.0
    state = {"C": _np((b, h, dk, dv)), "n": _np((b, h, dk)), "m": _np((b, h))}
    return (q, k, v, i_pre, f_pre), state


@pytest.mark.parametrize("b,s,h,dk,dv", [(1, 6, 1, 4, 8), (2, 9, 4, 8, 16)])
def test_mlstm_step_scan_matches_reference(b, s, h, dk, dv):
    streams, state = _mlstm_streams(b, s, h, dk, dv)
    xs = tuple(jnp.moveaxis(jnp.asarray(t), 1, 0) for t in streams)
    jst, jhs = jax.lax.scan(JX._mlstm_step, {k: jnp.asarray(v) for k, v in state.items()}, xs)
    st, hs = {k: _t(v) for k, v in state.items()}, []
    for t in range(s):
        st, h_t = TX._mlstm_step(st, tuple(_t(x)[:, t] for x in streams))
        hs.append(h_t)
    np.testing.assert_allclose(torch.stack(hs, 1).numpy(), np.moveaxis(np.asarray(jhs), 0, 1),
                               atol=1e-5, rtol=1e-5)
    for k in ("C", "n", "m"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("chunk", [4, 8])
def test_mlstm_chunkwise_matches_reference(chunk):
    (q, k, v, i_pre, f_pre), state = _mlstm_streams(2, 16, 2, 8, 16)
    hf = lambda t: np.ascontiguousarray(np.moveaxis(t, 2, 1))  # (B, S, H, *) -> (B, H, S, *)
    args = [hf(t) for t in (q, k, v, i_pre, f_pre)]
    jst, jh = JX.mlstm_chunkwise(*map(jnp.asarray, args),
                                 {n: jnp.asarray(a) for n, a in state.items()}, chunk)
    st, h = TX.mlstm_chunkwise(*map(_t, args), {n: _t(a) for n, a in state.items()}, chunk)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)
    for n in ("C", "n", "m"):
        np.testing.assert_allclose(st[n].numpy(), np.asarray(jst[n]), atol=1e-5, rtol=1e-5,
                                   err_msg=n)


def test_mlstm_chunkwise_gradient_is_finite_where_the_reference_overflows():
    """Forget gates near 0 (f_pre -60): above the chunk's diagonal the decay
    exponent reaches 60 x 7, exp overflows, and the JAX chunkwise form
    (where(tri, exp(logw), 0)) returns NaN gradients. The port masks the
    exponent first: the same outputs, and gradients equal to the sequential
    scan's (the JAX package's own scan under jax.grad) normwise to 1e-5."""
    (q, k, v, i_pre, f_pre), state = _mlstm_streams(2, 16, 2, 8, 16)
    f_pre = (f_pre - 62.0).astype(np.float32)
    g_h = _np((2, 2, 16, 16))
    hf = lambda t: np.ascontiguousarray(np.moveaxis(t, 2, 1))  # (B, S, H, *) -> (B, H, S, *)
    args = [hf(t) for t in (q, k, v, i_pre, f_pre)]

    def jax_loss(form):
        def loss(q, k, v, i, f):
            st = {n: jnp.asarray(a) for n, a in state.items()}
            if form == "chunk":
                _, h = JX.mlstm_chunkwise(q, k, v, i, f, st, 8)
            else:
                xs = tuple(jnp.moveaxis(t, 2, 0) for t in (q, k, v, i, f))
                _, h = jax.lax.scan(JX._mlstm_step, st, xs)
                h = jnp.moveaxis(h, 0, 2)
            return jnp.sum(h * g_h)
        return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))

    assert any(np.isnan(np.asarray(g)).any() for g in jax_loss("chunk"))  # the reference's fault
    want = jax_loss("scan")
    leaves = [_t(a).requires_grad_() for a in args]
    _, h = TX.mlstm_chunkwise(*leaves, {n: _t(a) for n, a in state.items()}, 8)
    got = torch.autograd.grad((h * _t(g_h)).sum(), leaves)
    assert all(np.isfinite(g.numpy()).all() for g in got)
    # i's gradient is 0 in exact arithmetic here (with f near 0 each step's
    # output is invariant to the scale of its input gate): held absolutely
    _assert_grads(got, want, names=("q", "k", "v", "i", "f"))


# ----------------------------------------------------------------- blocks
def _block_pair(kind, cfg_overrides=None):
    jcfg = jax_smoke("xlstm_1_3b", **(cfg_overrides or {}))
    tcfg = get_smoke_config("xlstm_1_3b", **(cfg_overrides or {}))
    init_j = JX.init_mlstm if kind == "mlstm" else JX.init_slstm
    init_t = TX.init_mlstm if kind == "mlstm" else TX.init_slstm
    jp = init_j(jax.random.PRNGKey(3), jcfg, jnp.dtype(jcfg.dtype))
    tp = init_t(torch.Generator().manual_seed(0), tcfg, getattr(torch, tcfg.dtype))
    tp.load_state_dict(_flat(jax.tree.map(np.asarray, jp)), strict=True)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("with_state", [False, True])
def test_xlstm_block_matches_reference(kind, with_state):
    jcfg, tcfg, jp, tp = _block_pair(kind)
    x = _np((2, 7, jcfg.d_model))
    jblock, tblock = (JX.mlstm_block, TX.mlstm_block) if kind == "mlstm" else (JX.slstm_block, TX.slstm_block)
    jinit = JX.init_mlstm_state if kind == "mlstm" else JX.init_slstm_state
    jstate = tstate = None
    if with_state:  # a carried state: the block's own state after a first chunk of tokens
        _, jstate = jblock(jp, jnp.asarray(_np((2, 5, jcfg.d_model))), jcfg, state=jinit(jcfg, 2))
        tstate = {k: _t(v) for k, v in jstate.items()}
    want, jnew = jblock(jp, jnp.asarray(x), jcfg, state=jstate)
    got, tnew = tblock(tp, _t(x), tcfg, state=tstate)
    _close(got, want)
    assert (tnew is None) == (not with_state)
    for k in jnew or {}:
        assert tnew[k].dtype == torch.float32
        _close(tnew[k], jnew[k])


# In bf16 both packages round the same projections to bf16 and run the same
# fp32 recurrences, so a block's outputs agree but for the rare element whose
# fp32 sums, taken in another order, round to the neighbouring bf16 value.
# One rounding placed elsewhere (a projection kept in fp32, a gate or an
# output rounded to bf16 where the reference keeps fp32) moves about half the
# elements by one bf16 ulp, 2^-8 relative: about 3e-3 normwise on these
# shapes. 2^-10 lies a quarter of that below.
BF16_BLOCK_LIMIT = 2.0**-10


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("kind,chunk", [("mlstm", 0), ("mlstm", 4), ("slstm", 0)])
@pytest.mark.parametrize("with_state", [False, True])
def test_xlstm_block_bf16_rounds_where_the_reference_does(kind, chunk, with_state):
    """The bf16 sLSTM also projects x in fp32 through its bf16 ``w``, which the
    JAX package promotes to an fp32 product: the port's backend promotes too."""
    jcfg, tcfg, jp, tp = _block_pair(kind, dict(dtype="bfloat16", mlstm_chunk=chunk))
    if kind == "slstm":
        assert tp.w.w.dtype == torch.bfloat16 and tp.r.dtype == torch.float32
    jblock, tblock = (JX.mlstm_block, TX.mlstm_block) if kind == "mlstm" else (JX.slstm_block, TX.slstm_block)
    jinit = JX.init_mlstm_state if kind == "mlstm" else JX.init_slstm_state
    jstate = tstate = None
    if with_state:
        first = jnp.asarray(_np((2, 8, jcfg.d_model)), jnp.bfloat16)
        _, jstate = jblock(jp, first, jcfg, state=jinit(jcfg, 2))
        tstate = {k: _t(v) for k, v in jstate.items()}
    x = jnp.asarray(_np((2, 16, jcfg.d_model)), jnp.bfloat16)
    want, jnew = jblock(jp, x, jcfg, state=jstate)
    got, tnew = tblock(tp, _t(x.astype(jnp.float32)).bfloat16(), tcfg, state=tstate)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= BF16_BLOCK_LIMIT
    for k in jnew or {}:
        assert tnew[k].dtype == torch.float32
        _close(tnew[k], jnew[k])


# ------------------------------------------------------------ whole model
def _models(**overrides):
    jcfg = jax_smoke("xlstm_1_3b", **overrides)
    tcfg = get_smoke_config("xlstm_1_3b", **overrides)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(1))
    tp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu"), strict=True)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("chunk", [0, 4])
def test_forward_logits_match_reference(chunk):
    jcfg, tcfg, jp, tp = _models(mlstm_chunk=chunk)
    toks = RNG.integers(0, jcfg.vocab, (2, 12))
    want, _, _ = JT.forward(jp, jnp.asarray(toks), jcfg)
    got, cache, _ = TT.forward(tp, torch.from_numpy(toks), tcfg)
    assert cache is None
    _close(got, want)


def test_prefill_and_decode_logits_match_reference():
    jcfg, tcfg, jp, tp = _models()
    toks = RNG.integers(0, jcfg.vocab, (2, 9))
    jlog, jcache = JM.apply_prefill(jp, {"tokens": jnp.asarray(toks)}, JM.init_cache(jcfg, 2, 16), jcfg)
    tcache = TM.init_cache(tcfg, 2, 16, device="cpu")
    assert all(v.dtype == torch.float32 for layer in tcache["layers"] for v in layer.values())
    tlog, tcache = TM.apply_prefill(tp, {"tokens": torch.from_numpy(toks)}, tcache, tcfg)
    _close(tlog, jlog)
    for _ in range(3):
        nxt = np.array(jnp.argmax(jlog, -1))[:, None]
        jlog, jcache = JM.apply_decode(jp, jnp.asarray(nxt), jcache, jcfg)
        tlog, tcache = TM.apply_decode(tp, torch.from_numpy(nxt), tcache, tcfg)
        _close(tlog, jlog)
    assert int(tcache["pos"]) == 12


def test_bf16_model_keeps_fp32_recurrent_state():
    cfg = dataclasses.replace(get_smoke_config("xlstm_1_3b"), dtype="bfloat16")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    cache = TM.init_cache(cfg, 1, 16, device="cpu")
    logits, cache = TM.apply_prefill(params, {"tokens": torch.arange(5)[None]}, cache, cfg)
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits.float()).all())
    kinds = [cfg.block_kind(i) for i in range(cfg.n_layers)]
    assert sorted(set(kinds)) == ["mlstm", "slstm"]
    for kind, layer in zip(kinds, cache["layers"]):
        assert set(layer) == ({"C", "n", "m"} if kind == "mlstm" else set(STATE))
        assert all(v.dtype == torch.float32 for v in layer.values())


def _prefill_decode_logits(jax_side, params, cfg, toks, steps):
    """Prefill logits, then one decode step per token of ``steps``, stacked (fp32)."""
    b = toks.shape[0]
    if jax_side:
        logits, cache = JM.apply_prefill(params, {"tokens": jnp.asarray(toks)},
                                         JM.init_cache(cfg, b, 32), cfg)
    else:
        logits, cache = TM.apply_prefill(params, {"tokens": torch.from_numpy(toks)},
                                         TM.init_cache(cfg, b, 32, device="cpu"), cfg)
    out = [logits]
    for tok in steps:
        if jax_side:
            logits, cache = JM.apply_decode(params, jnp.asarray(tok), cache, cfg)
        else:
            logits, cache = TM.apply_decode(params, torch.from_numpy(tok), cache, cfg)
        out.append(logits)
    return np.stack([np.asarray(o, np.float32) if jax_side else o.float().numpy() for o in out])


@pytest.mark.parametrize("depth", [4, 48])
def test_bf16_model_spread_matches_reference(depth):
    """The bf16 model lies as far from its fp32 logits (the same weights,
    upcast) as the JAX model does, and its logits lie within that spread of
    the JAX model's. At 4 layers the smoke pattern, at 48 the shipped
    pattern (7 mLSTM + 1 sLSTM) at the smoke width: the spread grows with
    depth in both packages. The blocks' roundings are pinned above; here
    the fp32 sums' order flips some bf16 roundings, and depth amplifies the
    flips in both packages alike."""
    over = {} if depth == 4 else dict(n_layers=48, block_pattern=SHIPPED_PATTERN)
    jcfg16 = jax_smoke("xlstm_1_3b", dtype="bfloat16", **over)
    jp16 = JM.init_params(jcfg16, jax.random.PRNGKey(5))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp16)
    logits = {}
    for dtype, jp in (("bfloat16", jp16), ("float32", jp32)):
        jcfg = jax_smoke("xlstm_1_3b", dtype=dtype, **over)
        tcfg = get_smoke_config("xlstm_1_3b", dtype=dtype, **over)
        tp = TM.init_params(tcfg, torch.Generator().manual_seed(1))
        tp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu"), strict=True)
        toks = RNG.integers(0, jcfg.vocab, (2, 16)) if not logits else toks
        steps = [RNG.integers(0, jcfg.vocab, (2, 1)) for _ in range(3)] if not logits else steps
        logits[dtype] = (_prefill_decode_logits(True, jp, jcfg, toks, steps),
                         _prefill_decode_logits(False, tp, tcfg, toks, steps))
    (j16, t16), (j32, t32) = logits["bfloat16"], logits["float32"]
    assert np.isfinite(t16).all()
    assert _rel(t32, j32) <= 1e-4
    spread = _rel(j16, j32)  # the JAX bf16 model's own distance from fp32
    own, mutual = _rel(t16, t32), _rel(t16, j16)
    print(f"depth {depth}: bf16 to fp32 logits, JAX {spread:.4e}, port {own:.4e}; "
          f"port to JAX in bf16 {mutual:.4e}")  # shown by pytest -rP
    assert own <= 1.5 * spread
    assert mutual <= 2.0 * spread
