"""The port's serving engine and paged KV pool, on the CPU.

Mirrors the decoder-only parts of ``tests/test_serving.py``,
``tests/test_serve_pool.py`` and the serving fault tests of
``tests/test_recovery.py`` on ``repro_torch.serving``, and holds the port's
``Engine`` against the JAX ``Engine``: from the same converted parameters
(the phi4, qwen2-vl and xlstm smoke configs, fp32) both give the same greedy
tokens, and their prefill logits agree within 1e-4 relative.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.kv_pool import SCRATCH_PAGE, CacheLayout, PagePool, PoolExhausted


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("phi4_mini_3_8b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8))
    return cfg, params, prompts


def _engine(cfg, params, **kw):
    args = dict(max_seq=64, temperature=0.0, slots=3, page_size=8, sync_interval=2)
    args.update(kw)
    return Engine(cfg, params, ServeConfig(**args), device="cpu")


# ------------------------------------------------------------ against JAX
@pytest.fixture(scope="module", params=["phi4_mini_3_8b", "qwen2_vl_72b", "xlstm_1_3b"])
def jax_pair(request):
    """Both engines on the same parameters; qwen2-vl's text path runs M-RoPE
    with the engine's stub position streams, and xlstm has no paged layer:
    its mLSTM and sLSTM state is slot-indexed."""
    jcfg = jax_smoke(request.param)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = get_smoke_config(request.param)
    tparams = M.init_params(tcfg, torch.Generator().manual_seed(9))
    tparams.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu"))
    args = dict(max_seq=64, temperature=0.0, slots=3, page_size=8, sync_interval=2)
    prompts = [np.arange(5) % jcfg.vocab, (np.arange(9) * 7) % jcfg.vocab, np.arange(3) + 40]
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**args))
    jh = [jeng.submit(p, 6 + i) for i, p in enumerate(prompts)]
    jeng.run()
    return jcfg, jparams, tcfg, tparams, args, prompts, [h.tokens() for h in jh]


def test_engine_greedy_tokens_match_jax_engine(jax_pair):
    _, _, tcfg, tparams, args, prompts, want = jax_pair
    eng = Engine(tcfg, tparams, ServeConfig(**args), device="cpu")
    hs = [eng.submit(p, 6 + i) for i, p in enumerate(prompts)]
    eng.run()
    assert [h.tokens() for h in hs] == want
    assert all(h.finish_reason == "length" for h in hs)


def test_prefill_logits_match_jax(jax_pair):
    jcfg, jparams, tcfg, tparams, _, prompts, _ = jax_pair
    for p in prompts:
        want, _ = JM.apply_prefill(jparams, {"tokens": jnp.asarray(p[None])},
                                   JM.init_cache(jcfg, 1, 16), jcfg)
        got, _ = M.apply_prefill(tparams, {"tokens": torch.from_numpy(p[None].copy())},
                                 M.init_cache(tcfg, 1, 16, device="cpu"), tcfg)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------- static / shim
def test_greedy_generation_deterministic(setup):
    cfg, params, prompts = setup
    eng = _engine(cfg, params, slots=4)
    t1, s1 = eng.generate(prompts, 8)
    t2, _ = eng.generate(prompts, 8)
    assert torch.equal(t1, t2) and tuple(t1.shape) == (2, 8)
    assert s1["cache_pos"] == 8 + 8 - 1  # prompt + generated - last not written


def test_temperature_sampling_is_deterministic_per_seed_and_varies_across_seeds(setup):
    cfg, params, prompts = setup
    eng = _engine(cfg, params, temperature=5.0)
    t0, _ = eng.generate(prompts, 12, seed=0)
    t1, _ = eng.generate(prompts, 12, seed=1)
    again, _ = eng.generate(prompts, 12, seed=0)
    assert not torch.equal(t0, t1)
    assert torch.equal(t0, again)
    a = eng.submit(prompts[0], 10, temperature=5.0, seed=3).result()
    b = eng.submit(prompts[0], 10, temperature=5.0, seed=3).result()
    assert a == b


def test_greedy_matches_manual_argmax_rollout(setup):
    cfg, params, prompts = setup
    toks, _ = _engine(cfg, params).generate(prompts, 4)
    cur = torch.from_numpy(prompts)
    manual = []
    with torch.inference_mode():
        for _ in range(4):
            logits, _, _ = T.forward(params, cur, cfg)
            nxt = torch.argmax(logits[:, -1], -1)[:, None]
            manual.append(nxt)
            cur = torch.cat([cur, nxt], dim=1)
    assert torch.equal(toks, torch.cat(manual, dim=1))


def test_generate_shim_matches_static_path(setup):
    cfg, params, prompts = setup
    eng = _engine(cfg, params)
    t_old, s_old = eng._generate_static(prompts, 8)
    t_new, s_new = eng.generate(prompts, 8)
    assert torch.equal(t_old, t_new)
    assert s_new["cache_pos"] == s_old["cache_pos"]
    eos = int(t_old[0, 4])
    eng2 = _engine(cfg, params, eos_id=eos)
    t_old2, _ = eng2._generate_static(prompts, 8)
    t_new2, _ = eng2.generate(prompts, 8)
    assert torch.equal(t_old2, t_new2)


# ------------------------------------------------------- request engine API
def test_mid_decode_admission_keeps_survivor_tokens_exact(setup):
    cfg, params, _ = setup
    p0 = np.arange(5) % cfg.vocab
    p1 = (np.arange(9) * 3) % cfg.vocab
    want0 = _engine(cfg, params).submit(p0, 10).result()
    want1 = _engine(cfg, params).submit(p1, 6).result()
    eng = _engine(cfg, params)
    h0 = eng.submit(p0, 10)
    for _ in range(3):
        eng.step()
    h1 = eng.submit(p1, 6)
    eng.run()
    assert h0.tokens() == want0 and h1.tokens() == want1


def test_eviction_frees_pages_and_keeps_survivors(setup):
    cfg, params, _ = setup
    p = np.arange(6) % cfg.vocab
    want = _engine(cfg, params).submit(p, 12).result()
    eng = _engine(cfg, params)
    h_keep = eng.submit(p, 12)
    h_evict = eng.submit(p[::-1].copy(), 12)
    for _ in range(3):
        eng.step()
    pages_mid = eng.serve_stats()["pages_in_use"]
    assert pages_mid > 0
    h_evict.cancel()
    assert h_evict.state.value == "evicted" and h_evict.finish_reason == "evicted"
    assert eng.serve_stats()["pages_in_use"] < pages_mid
    eng.run()
    assert h_keep.tokens() == want
    assert eng.serve_stats()["pages_in_use"] == 0


def test_page_accounting_no_leak_over_churn(setup):
    cfg, params, _ = setup
    eng = _engine(cfg, params, slots=2)
    rng = np.random.default_rng(2)
    for cycle in range(4):
        hs = [eng.submit(rng.integers(0, cfg.vocab, size=4 + i), 5 + i) for i in range(3)]
        if cycle % 2:
            eng.step()
            hs[0].cancel()
        eng.run()
        st = eng.serve_stats()
        assert st["pages_in_use"] == 0, (cycle, st)
        assert st["pages_free"] == st["page_budget"], (cycle, st)
        assert st["slots_active"] == 0 and st["queue_depth"] == 0


def test_admission_reject_on_exhausted_budget(setup):
    cfg, params, _ = setup
    eng = _engine(cfg, params, slots=2, page_budget=2, admission="reject")
    h0 = eng.submit(np.arange(4), 8)  # needs ceil(11/8) = 2 pages
    h1 = eng.submit(np.arange(4), 8)
    assert h0.state.value != "rejected"
    assert h1.state.value == "rejected" and h1.finish_reason == "rejected"
    assert eng.serve_stats()["requests"]["rejected"] == 1
    eng.run()
    assert h0.finish_reason == "length"
    h2 = eng.submit(np.arange(4), 8)
    assert h2.state.value != "rejected"
    eng.run()
    assert h2.finish_reason == "length"


def test_admission_queue_waits_for_capacity(setup):
    cfg, params, _ = setup
    eng = _engine(cfg, params, slots=1)
    h0 = eng.submit(np.arange(4), 6)
    h1 = eng.submit(np.arange(4), 6)
    assert h1.state.value == "queued"
    assert eng.serve_stats()["queue_depth"] == 1
    eng.run()
    assert h0.finish_reason == "length" and h1.finish_reason == "length"
    assert len(h1.tokens()) == 6


def test_submit_never_fit_raises(setup):
    cfg, params, _ = setup
    eng = _engine(cfg, params)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.submit(np.arange(60), 10)
    with pytest.raises(ValueError, match="pool capacity"):
        _engine(cfg, params, page_budget=1).submit(np.arange(20), 4)


def test_streaming_callback_and_event_ordering(setup):
    cfg, params, _ = setup
    eng = _engine(cfg, params, slots=2, sync_interval=3)
    events = []
    hs = [eng.submit(np.arange(3 + i), 7, on_token=lambda h, ev: events.append(ev))
          for i in range(3)]
    streamed = list(eng.stream(hs))
    byreq = {}
    for ev in events:
        byreq.setdefault(ev.request_id, []).append(ev)
    assert set(byreq) == {h.id for h in hs}
    for h in hs:
        evs = byreq[h.id]
        assert [e.index for e in evs] == list(range(7))
        assert [e.token for e in evs] == h.tokens()
    assert sorted((e.request_id, e.index, e.token) for e in streamed) == sorted(
        (e.request_id, e.index, e.token) for e in events)
    ttft, gaps = hs[0].latency_stats()
    assert ttft is not None and ttft >= 0 and len(gaps) == 6
    hist = eng.metrics.histogram("serve.ttft_s")
    assert hist.count == 3
    snap = eng.stats()
    assert set(snap) == {"serve", "autotune", "obs"}
    assert snap["autotune"] == {"cache_hits": 0, "cache_misses": 0, "kinds": {},
                                "decisions": [], "calibration": None, "oot": []}


def test_autotune_stats_oot_is_the_engines_own_ring(setup):
    """``autotune_stats()["oot"]`` holds every out-of-core run since the
    engine was built — as the JAX engine's does — and each engine reads its
    own ring: clearing one leaves the other's runs in place."""
    import torch

    from repro_torch.blocks.scheduler import strassen_oot_matmul
    from repro_torch.core.backend import MatmulBackend

    cfg, params, _ = setup
    first = _engine(cfg, params)
    assert first.autotune_stats()["oot"] == []
    t = torch.randn(64, 64)
    _, stats = strassen_oot_matmul(t, t, depth=1, budget_bytes=1 << 20,
                                   backend=MatmulBackend(kind="naive"), device="cpu")
    second = _engine(cfg, params)
    strassen_oot_matmul(t, t, depth=2, budget_bytes=1 << 20, backend=MatmulBackend(kind="naive"),
                        device="cpu")
    runs = first.autotune_stats()["oot"]
    assert [r["depth"] for r in runs] == [1, 2] and runs[0] == stats.to_dict()
    assert [r["depth"] for r in second.autotune_stats()["oot"]] == [2]
    second._oot_ring.clear()
    assert len(first.autotune_stats()["oot"]) == 2


def test_static_gang_batching_mode(setup):
    cfg, params, _ = setup
    prompts = [np.arange(4), np.arange(5), np.arange(6)]
    want = [_engine(cfg, params).submit(p, 6).result() for p in prompts]
    eng = _engine(cfg, params, slots=2, batching="static")
    hs = [eng.submit(p, 6) for p in prompts]
    assert hs[2].state.value == "queued"
    eng.step()
    assert hs[2].state.value == "queued"
    eng.run()
    assert [h.tokens() for h in hs] == want
    assert eng.serve_stats()["requests"]["finished"] == 3


def test_serve_config_apply_to_and_validation(setup):
    cfg, _, _ = setup
    sc = ServeConfig(tuning_cache="/tmp/tc.json")
    auto_cfg = dataclasses.replace(cfg, matmul_backend=dataclasses.replace(cfg.matmul_backend, kind="auto"))
    assert sc.apply_to(auto_cfg).matmul_backend.tuning_cache == "/tmp/tc.json"
    assert sc.apply_to(cfg).matmul_backend.tuning_cache == cfg.matmul_backend.tuning_cache
    for bad in (dict(admission="maybe"), dict(batching="dynamic"), dict(slots=0),
                dict(request_timeout_s=-1.0)):
        with pytest.raises(ValueError):
            ServeConfig(**bad)
    assert dataclasses.asdict(ServeConfig()) == dataclasses.asdict(JaxServeConfig())


def test_engine_refuses_the_auto_kind(setup, monkeypatch):
    """The engine once refused kind 'auto'; it now serves an auto config on
    the CPU with the same greedy tokens as the naive one (the smoke widths
    lie below min_dim, so every projection resolves to naive), and
    autotune_stats() reports the resolutions of its warm-up and its run."""
    from repro_torch.core import autotune, backend

    calib = autotune.Calibration(t_flop=1e-11, t_elem=1e-9, device_kind="cpu")
    monkeypatch.setattr(autotune, "_CALIBRATIONS", {"cpu": calib})
    monkeypatch.setattr(autotune, "_PROCESS_CACHES", {})
    backend.resolve_auto.cache_clear()
    cfg, params, prompts = setup
    auto_cfg = dataclasses.replace(cfg, matmul_autotune=True)
    assert auto_cfg.matmul_backend.kind == "auto"
    eng = _engine(auto_cfg, params)
    warmed = eng.autotune_stats()
    sites = autotune.model_call_sites(auto_cfg)
    # max_seq 64: prefill and decode M of {1, 8} x {1, 64}, one resolution per site each
    assert warmed["cache_hits"] + warmed["cache_misses"] == len(sites) * len({1, 8, 64, 512})
    hs = [eng.submit(p, 5) for p in prompts]
    eng.run()
    st = eng.autotune_stats()  # before the next engine resets the process log
    # the decode bucket (M = 3 slots) lies outside the warmed grid
    assert len(st["decisions"]) > len(warmed["decisions"])
    assert st["kinds"] == {"naive": len(st["decisions"])}
    assert {d["site"] for d in st["decisions"]} >= {"attn.wq", "mlp.up"}
    assert st["calibration"] == calib.to_dict() and st["oot"] == []
    ref = _engine(cfg, params)
    want = [ref.submit(p, 5) for p in prompts]
    ref.run()
    assert [h.tokens() for h in hs] == [h.tokens() for h in want]


def test_engine_and_launcher_without_a_card_do_not_run_on_the_cpu(setup, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    from repro_torch.launch import serve

    cfg, params, _ = setup
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        Engine(cfg, params)
    assert serve.main(["--arch", "phi4_mini_3_8b"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert serve.main(["--arch", "phi4_mini_3_8b", "--device", "cpu", "--batch", "2",
                       "--new-tokens", "3"]) == 0
    assert "served 2 requests" in capsys.readouterr().out


# ------------------------------------------------------- fault isolation
def test_poisoned_decode_evicts_only_culprit(setup):
    cfg, params, _ = setup
    p0, p1 = np.arange(5) % cfg.vocab, (np.arange(9) * 3) % cfg.vocab
    want0 = _engine(cfg, params).submit(p0, 10).result()
    want1 = _engine(cfg, params).submit(p1, 8).result()
    eng = _engine(cfg, params)
    h0 = eng.submit(p0, 10)
    h_bad = eng.submit(p1[::-1].copy(), 12, _inject_fault_at=2)
    h1 = eng.submit(p1, 8)
    eng.run()
    assert h_bad.finish_reason == "error" and h_bad.state.value == "evicted"
    assert len(h_bad.tokens()) == 2
    assert h0.tokens() == want0 and h1.tokens() == want1
    st = eng.serve_stats()
    assert st["pages_in_use"] == 0 and st["requests"]["errors"] == 1
    snap = eng.metrics.snapshot()["counters"]
    assert snap["fault.injected_faults"] >= 1.0 and snap["fault.evicted_requests"] >= 1.0


def test_prefill_fault_isolated_from_survivor(setup):
    cfg, params, _ = setup
    p = np.arange(6) % cfg.vocab
    want = _engine(cfg, params).submit(p, 8).result()
    eng = _engine(cfg, params)
    h_bad = eng.submit(p[::-1].copy(), 8, _inject_fault_at=0)
    h_ok = eng.submit(p, 8)
    eng.run()
    assert h_bad.finish_reason == "error" and h_bad.tokens() == []
    assert h_ok.tokens() == want
    assert eng.serve_stats()["pages_in_use"] == 0


def test_request_timeout_watchdog_evicts(setup):
    cfg, params, _ = setup
    eng = _engine(cfg, params, request_timeout_s=1e-4)
    h = eng.submit(np.arange(5) % cfg.vocab, 50)
    eng.run()
    assert h.finish_reason == "timeout" and h.state.value == "evicted"
    st = eng.serve_stats()
    assert st["pages_in_use"] == 0 and st["requests"]["timeouts"] == 1


def test_ring_local_attention_serves_like_the_static_path():
    """A config mixing full and ring (local_attn) layers: paged and
    slot-indexed state in one engine."""
    cfg = get_smoke_config("phi4_mini_3_8b", block_pattern=("attn", "local_attn"), local_window=8)
    params = M.init_params(cfg, torch.Generator().manual_seed(3))
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (2, 11))
    eng = _engine(cfg, params)
    t_old, _ = eng._generate_static(prompts, 9)
    t_new, _ = eng.generate(prompts, 9)
    assert torch.equal(t_old, t_new)
    assert eng.serve_stats()["pages_in_use"] == 0


# ------------------------------------------------------------- PagePool
def test_pool_alloc_free_roundtrip():
    pool = PagePool(capacity=8, page_size=16)
    a, b = pool.alloc(3), pool.alloc(2)
    assert not set(a) & set(b) and SCRATCH_PAGE not in a + b
    assert pool.available == 3 and pool.in_use == 5
    pool.free(a)
    c = pool.alloc(6)
    assert pool.available == 0
    pool.free(b + c)
    assert pool.available == 8 and pool.in_use == 0


def test_pool_exhaustion_and_double_free_guards():
    pool = PagePool(capacity=4, page_size=16)
    pages = pool.alloc(3)
    with pytest.raises(PoolExhausted):
        pool.alloc(2)
    assert pool.available == 1
    pool.free(pages)
    with pytest.raises(ValueError):
        pool.free(pages)
    with pytest.raises(ValueError):
        pool.free([SCRATCH_PAGE])
    assert [pool.pages_for_tokens(n) for n in (0, 1, 16, 17)] == [0, 1, 1, 2]


# ----------------------------------------------------------- CacheLayout
def _layout(**kw):
    cfg = get_smoke_config("phi4_mini_3_8b", **kw.pop("cfg", {}))
    args = dict(cfg=cfg, n_slots=2, page_size=8, max_seq=32, device="cpu")
    args.update(kw)
    return CacheLayout(**args)


def test_layout_classifies_each_layer():
    lay = _layout()
    assert lay.has_paged and all(n.paged and n.kind == "attn" for n in lay.nodes)
    assert len(lay.nodes) == lay.cfg.n_layers
    ring = _layout(cfg=dict(block_pattern=("attn", "local_attn"), local_window=8))
    assert [n.paged for n in ring.nodes] == [True, False]
    full = _layout(cfg=dict(block_pattern=("local_attn",), local_window=0))
    assert all(n.paged for n in full.nodes)


def test_gather_scatter_insert_roundtrip():
    lay = _layout()
    pool = PagePool(capacity=lay.table_width * 2, page_size=8)
    kv = lay.init_kv_state(pool.capacity)
    pre = lay.init_prefill_cache(16)
    gen = torch.Generator().manual_seed(0)
    for entry in pre["layers"]:
        for name in entry:
            entry[name].normal_(generator=gen)
    pages = pool.alloc(2)
    lay.insert_request(kv, pre, 0, torch.tensor(pages))
    table = torch.zeros((2, lay.table_width), dtype=torch.long)
    table[0, :2] = torch.tensor(pages)
    pos = torch.tensor([12, 0])
    dense = lay.gather(kv, table, pos, bucket_pages=2)
    for got, want in zip(dense["layers"], pre["layers"]):
        for name in ("k", "v"):
            assert torch.equal(got[name][0], want[name][0])
    before = [{n: t.clone() for n, t in e.items()} for e in kv]
    new = {"pos": pos + 1, "layers": [{n: t + 1.0 for n, t in e.items()} for e in dense["layers"]]}
    lay.scatter_token(kv, new, table, pos, torch.tensor([True, False]))
    for old, now in zip(before, kv):
        for name in ("k", "v"):
            diff = now[name][pages[1]] != old[name][pages[1]]
            assert diff.any() and not diff[:, :4].any() and not diff[:, 5:].any()
            untouched = [p for p in range(1, now[name].shape[0]) if p != pages[1]]
            assert torch.equal(now[name][untouched], old[name][untouched])


def test_scatter_freezes_dead_slot_ring_state():
    lay = _layout(n_slots=3, cfg=dict(block_pattern=("local_attn",), local_window=8))
    kv = lay.init_kv_state(0)
    gen = torch.Generator().manual_seed(1)
    for entry in kv:
        for name in entry:
            entry[name].normal_(generator=gen)
    before = [{n: t.clone() for n, t in e.items()} for e in kv]
    new = {"pos": torch.ones(3, dtype=torch.long),
           "layers": [{n: t + 1.0 for n, t in e.items()} for e in kv]}
    lay.scatter_token(kv, new, torch.zeros((3, 4), dtype=torch.long), torch.zeros(3, dtype=torch.long),
                      torch.tensor([True, False, True]))
    for old, now in zip(before, kv):
        for name in now:
            assert torch.equal(now[name][1], old[name][1])
            assert torch.equal(now[name][0], old[name][0] + 1.0)


def test_scatter_freezes_dead_slot_recurrent_state():
    """xlstm's mLSTM and sLSTM state is slot-indexed and fp32; a real decode
    step advances the live slots' state and leaves a dead slot's as it was."""
    lay = CacheLayout(cfg=get_smoke_config("xlstm_1_3b"), n_slots=3, page_size=8, max_seq=32,
                      device="cpu")
    assert not lay.has_paged and {n.kind for n in lay.nodes} == {"mlstm", "slstm"}
    params = M.init_params(lay.cfg, torch.Generator().manual_seed(2))
    kv = lay.init_kv_state(0)
    gen = torch.Generator().manual_seed(3)
    for entry in kv:
        for name, t in entry.items():
            assert t.dtype == torch.float32 and t.shape[0] == 3
            t.copy_(torch.rand(t.shape, generator=gen) if name != "m" else torch.randn(t.shape, generator=gen))
    before = [{n: t.clone() for n, t in e.items()} for e in kv]
    table = torch.zeros((3, lay.table_width), dtype=torch.long)
    pos = torch.tensor([4, 9, 2])
    dense = lay.gather(kv, table, pos, bucket_pages=1)
    _, new = M.apply_decode(params, torch.tensor([[3], [5], [7]]), dense, lay.cfg)
    for old, now in zip(before, kv):  # the decode itself wrote no state in place
        for name in now:
            assert torch.equal(now[name], old[name])
    lay.scatter_token(kv, new, table, pos, torch.tensor([True, False, True]))
    for old, now, step in zip(before, kv, new["layers"]):
        for name in now:
            assert torch.equal(now[name][1], old[name][1])
            assert torch.equal(now[name][[0, 2]], step[name][[0, 2]])
            assert not torch.equal(now[name][0], old[name][0])


def test_xlstm_survivor_tokens_exact_across_admission_and_finish():
    """A request admitted into, and one finishing beside, a resident xlstm
    request leave its greedy tokens as they are when it runs alone."""
    cfg = get_smoke_config("xlstm_1_3b")
    params = M.init_params(cfg, torch.Generator().manual_seed(4))
    p0, p1 = np.arange(5) % cfg.vocab, (np.arange(9) * 3) % cfg.vocab
    alone = _engine(cfg, params).submit(p0, 12).result()
    eng = _engine(cfg, params, sync_interval=1)
    h0 = eng.submit(p0, 12)
    for _ in range(3):
        eng.step()
    h1 = eng.submit(p1, 3)
    eng.run()
    assert h0.tokens() == alone and len(h1.tokens()) == 3
    st = eng.serve_stats()
    assert st["page_budget"] == 0 and st["pages_in_use"] == 0
