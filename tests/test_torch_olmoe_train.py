"""OLMoE's published training variant in the port against the benchmark's
plain reference (``bench/reference/moe_lm.py``), on the CPU in fp32.

The model is ``configs/olmoe_1b_7b.py``'s ``TRAIN_SMOKE_CONFIG``: QK-norm,
the top-4 gates of 16 experts not renormalised, dropless routing; as EP rank
1 of 4 (experts 4-7) unless a test says otherwise. Both sides compute in
fp32 from the same weights, in other orders of operations (the reference
materialises attention, loops over the held experts and adds each token's
terms in fp32), so they agree to round-off: the loss to 1e-5 relative, each
gradient leaf and each AdamW update to 1e-4 normwise (the port's other CPU
training tests' tolerance), each MoE output element to 1e-5 x max(1,
max|ref|) (``tests/test_torch_moe.py``'s fp32 tolerance).

Also: the four shares' MoE outputs add up to the uncut layer's; a router
biased past capacity, where the dropless route equals the reference and the
capacity route does not; the spans' attributes and the counters against
the picks counted from the router, twice under rematerialization, none
with the tracer off; and the new fields' defaults keeping the JAX
package's parameters.
"""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.configs import olmoe_1b_7b as O
from repro_torch.models import model as M
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "bench"))
from reference import moe_lm  # noqa: E402

OPT = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0,
       "warmup_steps": 2, "total_steps": 1000, "min_lr_ratio": 0.1}
CFG = O.share(O.TRAIN_SMOKE_CONFIG, 1, 4)
LOSS_TOL, LEAF_TOL, OUT_TOL = 1e-5, 1e-4, 1e-5


def model_of(cfg):
    """The reference's ``model`` sizes of a port config."""
    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "vocab", "n_experts",
            "expert_first", "top_k", "d_expert", "norm_eps", "rope_theta", "qk_norm",
            "norm_topk_prob", "dtype")
    return {**{k: getattr(cfg, k) for k in keys}, "experts_held": cfg.held_experts,
            "router_aux_coef": cfg.router_aux_coef}


def weights(cfg, seed=0):
    return moe_lm.make_weights(model_of(cfg), torch.Generator().manual_seed(seed), torch.float32)


def program(cfg, w):
    state = init_train_state(cfg, AdamWConfig(**OPT), torch.Generator().manual_seed(1))
    named = dict(state.params.named_parameters())
    assert {n: p.shape for n, p in named.items()} == {n: t.shape for n, t in w.items()}
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(w[n])
    return state


def tokens(rows, seq=9, seed=5):
    ids = torch.randint(0, CFG.vocab, (rows, seq), generator=torch.Generator().manual_seed(seed))
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def rel(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()


def test_loss_and_every_gradient_leaf_match_the_reference():
    w, batch = weights(CFG), tokens(2)
    state = program(CFG, w)
    loss, _ = M.loss_fn(state.params, batch, CFG)
    loss.backward()
    leaves = {n: t.detach().requires_grad_(True) for n, t in w.items()}
    want = moe_lm.MoeLM(model_of(CFG)).loss(leaves, batch["tokens"], batch["labels"])
    grads = dict(zip(leaves, torch.autograd.grad(want, list(leaves.values()))))
    assert abs(loss.item() - want.item()) <= LOSS_TOL * abs(want.item())
    for n, p in state.params.named_parameters():
        assert rel(p.grad, grads[n]) <= LEAF_TOL, n
    assert grads["layers.0.ffn.w_gate"].abs().sum() > 0  # the held experts were routed to


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_the_reference_trainer(accum):
    w, batch = weights(CFG), tokens(4)
    state = program(CFG, w)
    before = {n: t.clone() for n, t in w.items()}
    _, met = make_train_step(CFG, AdamWConfig(**OPT), accum_steps=accum)(state, batch)
    trainer = moe_lm.Trainer(model_of(CFG), OPT, w)
    rows = 4 // accum
    loss = trainer.step([{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                         for i in range(accum)])
    assert abs(met["loss"].item() - loss) <= LOSS_TOL * abs(loss)
    for n, p in state.params.named_parameters():
        assert rel(p.detach() - before[n], trainer.w[n].detach() - before[n]) <= LEAF_TOL, n


def _moe_of(cfg, w, prefix="layers.0."):
    """The port's MoE block of ``cfg`` holding its share of the uncut
    weights ``w``."""
    params = TMOE.init_moe(torch.Generator().manual_seed(2), cfg, torch.float32)
    held = slice(cfg.expert_first, cfg.expert_first + cfg.held_experts)
    with torch.no_grad():
        params.router.w.copy_(w[prefix + "ffn.router.w"])
        for name in ("w_gate", "w_up", "w_down"):
            getattr(params, name).copy_(w[prefix + "ffn." + name][held])
    return params


def _uncut_reference(w, h, capacity=None, prefix="layers.0."):
    full = O.TRAIN_SMOKE_CONFIG
    return moe_lm.MoeLM(model_of(full), capacity=capacity).moe(h, w, prefix)


def test_the_four_shares_add_up_to_the_uncut_layer():
    full = O.TRAIN_SMOKE_CONFIG
    w = weights(full)
    h = torch.randn(2, 8, full.d_model, generator=torch.Generator().manual_seed(3))
    want, want_aux = _uncut_reference(w, h)
    parts = [TMOE.moe_block(_moe_of(O.share(full, r, 4), w), h, O.share(full, r, 4))
             for r in range(4)]
    got = sum(out for out, _ in parts)
    assert (got - want).abs().max() <= OUT_TOL * max(1.0, want.abs().max().item())
    for _, aux in parts:  # every share routes over all 16 experts
        assert abs(aux.item() - want_aux.item()) <= LOSS_TOL * abs(want_aux.item())
    whole, _ = TMOE.moe_block(_moe_of(full, w), h, full)
    assert (whole - want).abs().max() <= OUT_TOL * max(1.0, want.abs().max().item())


def test_dropless_keeps_what_a_biased_router_sends_past_capacity():
    """Every token's feature 0 and the router's weight of it to expert 0 set
    to 5: expert 0 is every token's first pick, 4x what capacity 1.25 keeps."""
    full = O.TRAIN_SMOKE_CONFIG
    w = weights(full)
    w["layers.0.ffn.router.w"][0, 0] = 5.0
    h = torch.randn(1, 32, full.d_model, generator=torch.Generator().manual_seed(4))
    h[..., 0] = 5.0
    want, _ = _uncut_reference(w, h)
    tol = OUT_TOL * max(1.0, want.abs().max().item())
    _, idx, _ = TMOE._route(_moe_of(full, w), h.reshape(32, -1), full)
    assert (idx[:, 0] == 0).all() and 32 > 1.25 * 32 * full.top_k / full.n_experts
    dropless, _ = TMOE.moe_block(_moe_of(full, w), h, full)
    assert (dropless - want).abs().max() <= tol
    capped = dataclasses.replace(full, moe_dropless=False, capacity_factor=1.25)
    dropped, _ = TMOE.moe_block(_moe_of(capped, w), h, capped)
    assert (dropped - want).abs().max() > 100 * tol
    same, _ = _uncut_reference(w, h, capacity=1.25)  # the reference's own drop agrees
    assert (dropped - same).abs().max() <= tol


def _picks(cfg, params, h):
    _, idx, _ = TMOE._route(params, h.reshape(-1, cfg.d_model), cfg)
    return [int((idx == e).sum()) for e in range(cfg.expert_first, cfg.expert_first + cfg.held_experts)]


def test_spans_and_counters_count_the_routers_picks():
    w = weights(O.TRAIN_SMOKE_CONFIG)
    params = _moe_of(CFG, w)
    h = torch.randn(2, 8, CFG.d_model, generator=torch.Generator().manual_seed(6))
    loads = _picks(CFG, params, h)
    obs.configure(enabled=True)
    obs.reset_tracing()
    obs.reset_metrics()
    try:
        TMOE.moe_block(params, h, CFG, layer=3)
        spans = [s for s in obs.get_tracer().spans if s.name.startswith("moe.")]
        counts = obs.get_metrics().snapshot()["counters"]
    finally:
        obs.configure(enabled=False)
        obs.reset_tracing()
        obs.reset_metrics()
    assert [s.name for s in spans] == ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
    for s in spans:
        assert s.attrs == {"layer": 3, "tokens": 16, "held_assignments": sum(loads),
                           "max_expert_load": max(loads)}
    assert counts["moe.tokens_routed"] == 16
    assert counts["moe.assignments_held"] == sum(loads) > 0
    assert counts["moe.assignments_elsewhere"] == 16 * CFG.top_k - sum(loads)
    assert [counts[f"moe.expert_load.{e}"] for e in range(4, 8)] == loads


def test_nothing_is_counted_with_the_tracer_off():
    obs.reset_metrics()
    w = weights(O.TRAIN_SMOKE_CONFIG)
    TMOE.moe_block(_moe_of(CFG, w), torch.randn(2, 8, CFG.d_model), CFG)
    counters = obs.get_metrics().snapshot()["counters"]
    assert not any(v for n, v in counters.items() if n.startswith("moe."))
    assert obs.get_tracer().spans == []


def test_remat_counts_the_recompute_as_a_second_pass():
    """Under rematerialization the backward recomputes each layer's forward,
    expert products included, and the counters count it: twice the tokens."""
    cfg = dataclasses.replace(CFG, remat=True, block_pattern=("attn",) * 2)
    state = program(cfg, weights(cfg))
    obs.configure(enabled=True)
    obs.reset_metrics()
    try:
        make_train_step(cfg, AdamWConfig(**OPT))(state, tokens(2))
        counts = obs.get_metrics().snapshot()["counters"]
    finally:
        obs.configure(enabled=False)
        obs.reset_tracing()
        obs.reset_metrics()
    assert counts["moe.tokens_routed"] == 2 * cfg.n_layers * 2 * 8


def test_defaults_keep_the_jax_packages_layers():
    cfg = get_smoke_config("olmoe_1b_7b")
    assert (cfg.qk_norm, cfg.norm_topk_prob, cfg.moe_dropless) == (False, True, False)
    assert cfg.held_experts == cfg.n_experts and cfg.expert_first == 0
    params = TT.init_params(cfg, torch.Generator().manual_seed(0))
    names = dict(params.named_parameters())
    assert not any("q_norm" in n or "k_norm" in n for n in names)
    assert names["layers.0.ffn.w_gate"].shape == (cfg.n_experts, cfg.d_model, cfg.d_expert)


def test_a_share_needs_dropless_routing_and_experts_the_router_has():
    with pytest.raises(ValueError):
        dataclasses.replace(CFG, moe_dropless=False)
    with pytest.raises(ValueError):
        dataclasses.replace(CFG, expert_first=14)
