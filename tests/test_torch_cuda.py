"""The CUDA kernels of repro_torch against their plain versions, on the card.

These tests need an NVIDIA Hopper GPU and the CUDA toolkit, and skip with a
reason elsewhere; they import no JAX, so they run where the port runs.
Tolerances, as in chip_smoke.py: max|kernel - plain| <= tol * max(1,
max|plain|); divide/combine are bit-exact (the same sums in the same
order, each add rounded to the storage type); the products accumulate in
another order than cuBLAS, hence 2e-5 in fp32 and 8e-3 (about two bf16
ulps) in bf16. RMSNorm and flash
attention use the JAX tests' tolerances in fp32 (1e-5 and 2e-5). In bf16
they compute in fp32 and round once, as their plain versions do, so each
element is held to 2^-7 x (|plain| + rms(plain)): one bf16 ulp of itself,
with a floor for elements near 0 (the bf16 flash kernel feeds P to its
tensor-core P V product as two bf16 parts, so that it holds this rule). The
sLSTM kernel takes the JAX kernel test's 2e-5 in fp32. Smoke-config engine
runs on the card launch the serving kernels.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config
from repro_torch.core.coefficients import get_scheme
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.matmul import ops as tmm
from repro_torch.kernels.matmul import ref as tmm_ref
from repro_torch.kernels.strassen import ref as tref
from repro_torch.kernels.rmsnorm import rmsnorm as trn
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.slstm import slstm as tsl
from repro_torch.kernels.slstm.ref import slstm_seq_ref
from repro_torch.kernels.strassen import strassen as tst
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine, ServeConfig

SCHEMES = ["strassen", "winograd", "naive8"]
RNG = np.random.default_rng(17)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(device, shape, dtype):
    x = RNG.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme_name", SCHEMES)
def test_cuda_signed_sum_kernels_are_bit_exact(cuda, scheme_name, dtype):
    s = get_scheme(scheme_name)
    for shape in [(1, 4, 64, 64), (3, 4, 5, 7), (2, 4, 16, 24)]:
        x = _on(cuda, shape, dtype)
        n = tst.divide_cuda.launches
        assert torch.equal(tst.divide_cuda(x, s.a_coef), tref.divide_ref(x, s.a_coef))
        assert tst.divide_cuda.launches == n + 1
        p = _on(cuda, (shape[0], s.rank, *shape[2:]), dtype)
        assert torch.equal(tst.combine_cuda(p, s.c_coef), tref.combine_ref(p, s.c_coef))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("scheme_name", SCHEMES)
def test_cuda_strassen1_matches_plain(cuda, scheme_name, dtype, tol):
    # aligned (the TMA path), ragged in every dimension (element loads), K2
    # below one K step, mb > 1
    for mb, m2, k2, n2 in [(1, 64, 64, 64), (3, 33, 65, 17), (2, 128, 256, 128),
                           (1, 8, 192, 8), (2, 130, 72, 200), (2, 64, 8, 64)]:
        aq, bq = _on(cuda, (mb, 4, m2, k2), dtype), _on(cuda, (mb, 4, k2, n2), dtype)
        got = tst.strassen1_matmul_cuda(aq, bq, scheme=scheme_name)
        want = tref.strassen1_matmul_ref(aq, bq, scheme_name)
        scale = max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 8e-3)])
def test_cuda_matmul_kernels_match_plain(cuda, dtype, tol):
    # Against the kernel's 128 x 256 tiles and K steps (32 fp32, 64 bf16): M
    # and N edges above and below a tile (N ending in each of the four
    # 64-column boxes of a bf16 tile); K below one step; rows of whole 16-byte
    # chunks (the TMA) in both dtypes, in fp32 only (K 36, N 68 or 260) or in
    # neither (K 65 or 70, N 17); K long enough to wrap the ring of stages.
    shapes = [(7, 64, 64, 64), (3, 100, 70, 130), (1, 8, 192, 8), (2, 130, 72, 200),
              (1, 257, 520, 136), (3, 33, 65, 17), (2, 64, 8, 64), (2, 64, 36, 100),
              (2, 96, 64, 68), (2, 256, 1024, 384), (1, 200, 1000, 260)]
    for mb, m, k, n in shapes:
        a, b = _on(cuda, (mb, m, k), dtype), _on(cuda, (mb, k, n), dtype)
        for got, want in (
            (tmm.batched_matmul(a, b), tmm_ref.batched_matmul_ref(a, b)),
            (tmm.matmul(a[0], b[0]), tmm_ref.matmul_ref(a[0], b[0])),
        ):
            scale = max(1.0, want.float().abs().max().item())
            assert (got.float() - want.float()).abs().max().item() <= tol * scale
    # bases off 16 bytes take element loads whatever the shape
    mb, m, k, n = 2, 130, 264, 200
    a = _on(cuda, (mb * m * k + 1,), dtype)[1:].view(mb, m, k)
    b = _on(cuda, (mb * k * n + 1,), dtype)[1:].view(mb, k, n)
    want = tmm_ref.batched_matmul_ref(a, b)
    scale = max(1.0, want.float().abs().max().item())
    assert (tmm.batched_matmul(a, b).float() - want.float()).abs().max().item() <= tol * scale
    a, b = _on(cuda, (1, 8, 192), dtype), _on(cuda, (1, 192, 8), dtype)
    with pytest.raises(ValueError, match="contiguous"):
        tmm.batched_matmul(a.transpose(1, 2), b.transpose(1, 2))


def _within(got, want, tol):
    """fp32: max|got - want| <= tol * max(1, max|want|). bf16: every element
    within tol * (|want| + rms(want)), since kernel and plain version compute
    in fp32 and round once (one bf16 ulp is at most 2^-7 of the value)."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return False
    if got.dtype == torch.bfloat16:
        return bool(((g - w).abs() <= tol * (w.abs() + w.square().mean().sqrt())).all())
    return (g - w).abs().max().item() <= tol * max(1.0, w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_cuda_matmul_kernels_out_dtype(cuda, out_dtype):
    # the other out_dtype than the operands': the fp32 accumulator stored as
    # it is, or rounded once to bf16; tiled matmul and strassen1, ragged too
    dtype = torch.bfloat16 if out_dtype == torch.float32 else torch.float32
    tol = 2e-5 if out_dtype == torch.float32 else 8e-3
    for mb, m, k, n in [(2, 130, 72, 200), (1, 256, 512, 384), (3, 33, 65, 17)]:
        a, b = _on(cuda, (mb, m, k), dtype), _on(cuda, (mb, k, n), dtype)
        for got, want in (
            (tmm.batched_matmul(a, b, out_dtype=out_dtype), tmm_ref.batched_matmul_ref(a, b, out_dtype)),
            (tmm.matmul(a[0], b[0], out_dtype=out_dtype), tmm_ref.matmul_ref(a[0], b[0], out_dtype)),
        ):
            scale = max(1.0, want.float().abs().max().item())
            assert got.dtype == out_dtype
            assert (got.float() - want.float()).abs().max().item() <= tol * scale
    for scheme_name in SCHEMES:
        for mb, m2, k2, n2 in [(2, 128, 128, 128), (3, 33, 65, 17)]:
            aq, bq = _on(cuda, (mb, 4, m2, k2), dtype), _on(cuda, (mb, 4, k2, n2), dtype)
            got = tst.strassen1_matmul_cuda(aq, bq, scheme=scheme_name, out_dtype=out_dtype)
            want = tref.strassen1_matmul_ref(aq, bq, scheme_name, out_dtype)
            scale = max(1.0, want.float().abs().max().item())
            assert got.dtype == out_dtype
            assert (got.float() - want.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2**-7)])
def test_cuda_rmsnorm_matches_plain(cuda, dtype, tol):
    # a warp a row up to 4096 bf16 or 2048 fp32 (xLSTM 2048, phi4 3072),
    # a block a row above (qwen1.5 5120, internlm2 6144, qwen2-vl 8192)
    wide = [(r, d) for d in (2048, 5120, 6144, 8192) for r in (4, 1024)]
    for r, d in [(1, 3072), (7, 3072), (64, 1000), (33, 128), (5, 250), *wide]:
        x = _on(cuda, (r, d), dtype)
        for w in (_on(cuda, (d,), dtype), _on(cuda, (d,), torch.float32)):
            n = trn.rmsnorm_cuda.launches
            got = trn.rmsnorm_cuda(x, w, eps=1e-6)
            assert trn.rmsnorm_cuda.launches == n + 1
            assert got.dtype == dtype and _within(got, rmsnorm_ref(x, w, 1e-6), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2**-7)])
def test_cuda_flash_attention_matches_plain(cuda, dtype, tol):
    cases = [
        ((2, 4, 2, 128, 32), dict(causal=True)),
        ((1, 8, 1, 64, 16), dict(causal=False)),
        ((1, 4, 4, 100, 64), dict(causal=True)),
        ((1, 6, 2, 77, 128), dict(causal=True, window=16)),
        ((1, 2, 2, 70, 256), dict(causal=True)),
        ((1, 2, 1, 33, 128), dict(causal=True, window=1)),
        # against the 64-row query and 64-key tiles: one row, one short of a
        # tile, one past it; GQA group 3; a window below one key tile
        ((1, 6, 2, 1, 128), dict(causal=True)),
        ((1, 6, 2, 63, 128), dict(causal=True)),
        ((1, 6, 2, 65, 128), dict(causal=True)),
        ((2, 6, 2, 200, 64), dict(causal=True, window=17)),
        ((1, 6, 2, 300, 128), dict(causal=False)),
    ]
    for (b, hq, hkv, s, d), kw in cases:
        q = _on(cuda, (b, hq, s, d), dtype)
        k, v = _on(cuda, (b, hkv, s, d), dtype), _on(cuda, (b, hkv, s, d), dtype)
        n = tfa.flash_attention_cuda.launches
        got = tfa.flash_attention_cuda(q, k, v, **kw)
        assert tfa.flash_attention_cuda.launches == n + 1
        assert got.dtype == dtype and _within(got, attention_ref(q, k, v, **kw), tol), (s, d, kw)
    # more queries than keys under a window: rows with no live key are 0
    q, k = _on(cuda, (1, 2, 64, 16), dtype), _on(cuda, (1, 2, 16, 16), dtype)
    got = tfa.flash_attention_cuda(q, k, k, causal=True, window=8)
    assert _within(got, attention_ref(q, k, k, causal=True, window=8), tol)
    assert torch.count_nonzero(got[:, :, 23:]) == 0
    # more keys than queries, no mask
    q, k = _on(cuda, (1, 4, 100, 128), dtype), _on(cuda, (1, 2, 700, 128), dtype)
    v = _on(cuda, (1, 2, 700, 128), dtype)
    got = tfa.flash_attention_cuda(q, k, v, causal=False)
    assert _within(got, attention_ref(q, k, v, causal=False), tol)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention_cuda(*(_on(cuda, (1, 1, 8, 48), dtype),) * 3)


@pytest.mark.cuda
def test_cuda_engine_serves_through_both_kernels(cuda):
    cfg = get_smoke_config("phi4_mini_3_8b")
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    eng = Engine(cfg, params, ServeConfig(max_seq=64, slots=2, page_size=8), device=cuda)
    trn.rmsnorm_cuda.launches = tfa.flash_attention_cuda.launches = 0
    hs = [eng.submit(np.arange(5 + 3 * i) % cfg.vocab, 6) for i in range(3)]
    eng.run()
    st = eng.serve_stats()
    assert [h.finish_reason for h in hs] == ["length"] * 3 and st["pages_in_use"] == 0
    forwards = st["prefills"] + st["decode_steps"]
    assert tfa.flash_attention_cuda.launches == cfg.n_layers * st["prefills"]
    assert trn.rmsnorm_cuda.launches == (2 * cfg.n_layers + 1) * forwards
    cpu = Engine(cfg, params.cpu(), ServeConfig(max_seq=64, slots=2, page_size=8), device="cpu")
    want = [cpu.submit(np.arange(5 + 3 * i) % cfg.vocab, 6) for i in range(3)]
    cpu.run()
    assert [h.tokens() for h in hs] == [h.tokens() for h in want]


def _slstm_state(device, b, h, dh, carried):
    if not carried:
        z = lambda: torch.zeros((b, h, dh), device=device)
        return {"c": z(), "n": z(), "m": torch.full((b, h, dh), -1e30, device=device), "h": z()}
    st = {k: _on(device, (b, h, dh), torch.float32) for k in ("c", "m", "h")}
    st["n"] = _on(device, (b, h, dh), torch.float32).abs() + 1.0
    st["h"] = torch.tanh(st["h"])
    return st


def _slstm_device_kernels(fn):
    """Names of the device kernels that one call of fn runs whose name holds 'slstm'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA and "slstm" in e.name.lower()]


@pytest.mark.cuda
def test_cuda_slstm_matches_plain(cuda):
    # the JAX kernel test's shapes (dh 4 and 8 fill part of a tile's 16
    # columns), dh 48, batches past a pass's 4 rows, xlstm's decode shape, a
    # 1024-step prefill from zero state at full width, 8 heads whose r does
    # not fit the SMs' shared memory, and 6 rows at full width
    cases = [(1, 8, 1, 4, False), (2, 16, 2, 8, False), (2, 32, 4, 16, True),
             (1, 40, 2, 48, False), (6, 3, 4, 64, True), (4, 1, 4, 512, True),
             (1, 1024, 4, 512, False), (2, 16, 8, 512, True), (6, 64, 4, 512, True)]
    for b, s, h, dh, carried in cases:
        wx = _on(cuda, (b, s, 4, h, dh), torch.float32)
        r = _on(cuda, (4, h, dh, dh), torch.float32) * dh**-0.5
        state = _slstm_state(cuda, b, h, dh, carried)
        before = {k: v.clone() for k, v in state.items()}
        n = tsl.slstm_seq_cuda.launches
        st, hs = tsl.slstm_seq_cuda(wx, r, state)
        assert tsl.slstm_seq_cuda.launches == n + 1
        # one device launch a call, whatever S
        assert len(_slstm_device_kernels(lambda: tsl.slstm_seq_cuda(wx, r, state))) == 1
        st_ref, hs_ref = slstm_seq_ref(wx, r, state)
        for got, want in [(hs, hs_ref)] + [(st[k], st_ref[k]) for k in ("c", "n", "m", "h")]:
            assert got.shape == want.shape and _within(got, want, 2e-5), (b, s, h, dh)
        assert all(torch.equal(state[k], before[k]) for k in state)  # inputs are not written
    wx = _on(cuda, (2, 16, 4, 2, 8), torch.float32)
    r, state = _on(cuda, (4, 2, 8, 8), torch.float32), _slstm_state(cuda, 2, 2, 8, False)
    st_full, hs_full = tsl.slstm_seq_cuda(wx, r, state)
    st_mid, hs_a = tsl.slstm_seq_cuda(wx[:, :8].contiguous(), r, state)
    st_end, hs_b = tsl.slstm_seq_cuda(wx[:, 8:].contiguous(), r, st_mid)
    assert _within(torch.cat([hs_a, hs_b], 1), hs_full, 2e-5)
    assert all(_within(st_end[k], st_full[k], 2e-5) for k in st_full)
    with pytest.raises(TypeError, match="float32"):
        tsl.slstm_seq_cuda(wx.bfloat16(), r, state)


@pytest.mark.cuda
def test_cuda_engine_serves_xlstm_through_the_slstm_kernel(cuda):
    cfg = get_smoke_config("xlstm_1_3b")
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    eng = Engine(cfg, params, ServeConfig(max_seq=64, slots=2, page_size=8), device=cuda)
    trn.rmsnorm_cuda.launches = tsl.slstm_seq_cuda.launches = 0
    hs = [eng.submit(np.arange(5 + 3 * i) % cfg.vocab, 6) for i in range(3)]
    eng.run()
    st = eng.serve_stats()
    assert [h.finish_reason for h in hs] == ["length"] * 3 and st["page_budget"] == 0
    forwards = st["prefills"] + st["decode_steps"]
    n_slstm = sum(cfg.block_kind(i) == "slstm" for i in range(cfg.n_layers))
    assert tsl.slstm_seq_cuda.launches == n_slstm * forwards
    assert trn.rmsnorm_cuda.launches == (cfg.n_layers + 1) * forwards
    # The engine hands a slot pool's recurrent state to the decode step
    # without a copy, so a step on the card must write none of it in place.
    cache = M.init_cache(cfg, 2, 16, device=cuda)
    toks = torch.arange(10, device=cuda).reshape(2, 5) % cfg.vocab
    _, cache = M.apply_prefill(params, {"tokens": toks}, cache, cfg)
    held = [dict(layer) for layer in cache["layers"]]
    before = [{k: v.clone() for k, v in layer.items()} for layer in held]
    n = tsl.slstm_seq_cuda.launches
    M.apply_decode(params, torch.tensor([[3], [5]], device=cuda), cache, cfg)
    assert tsl.slstm_seq_cuda.launches == n + n_slstm
    assert all(torch.equal(layer[k], old[k]) for layer, old in zip(held, before) for k in layer)
    cpu = Engine(cfg, params.cpu(), ServeConfig(max_seq=64, slots=2, page_size=8), device="cpu")
    want = [cpu.submit(np.arange(5 + 3 * i) % cfg.vocab, 6) for i in range(3)]
    cpu.run()
    assert [h.tokens() for h in hs] == [h.tokens() for h in want]


@pytest.mark.cuda
def test_cuda_auto_gate_and_fused_candidates(cuda, monkeypatch):
    """On the card the leaf-mode gate launches strassen1 ('compiled'); every
    enumerated candidate executes within the autotune tests' 3e-3, the fused
    ones through the kernel; a pinned calibration under which strassen_fused
    wins routes kind 'auto' through it."""
    from repro_torch.core import autotune, backend, compat

    assert compat.fused_leaf_mode(cuda) == "compiled"
    calib = autotune.Calibration(t_flop=1e-9, t_elem=1e-12, device_kind="gpu")
    monkeypatch.setattr(autotune, "_CALIBRATIONS", {"cuda": calib})
    monkeypatch.setattr(autotune, "_PROCESS_CACHES", {})
    backend.resolve_auto.cache_clear()
    x, w = _on(cuda, (256, 512), torch.float32), _on(cuda, (512, 384), torch.float32)
    want = torch.matmul(x.double(), w.double()).float()
    cands = autotune.enumerate_candidates(256, 512, 384, min_dim=64, max_depth=2, device=cuda)
    assert {c.kind for c in cands} == {"naive", "strassen", "winograd", "strassen_fused"}
    for cand in cands:
        n = tst.strassen1_matmul_cuda.launches
        got = autotune.execute(cand, x, w)
        assert tst.strassen1_matmul_cuda.launches == n + (cand.kind == "strassen_fused")
        torch.testing.assert_close(got, want, atol=3e-3, rtol=3e-3)
    n = tst.strassen1_matmul_cuda.launches
    be = backend.MatmulBackend(kind="auto", depth=2, min_dim=64)
    got = backend.matmul(x, w, be)
    assert backend.resolve_auto(256, 512, 384, "float32", be, None, "cuda").kind == "strassen_fused"
    assert tst.strassen1_matmul_cuda.launches == n + 1
    torch.testing.assert_close(got, want, atol=3e-3, rtol=3e-3)
    backend.resolve_auto.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("leaf", ["naive", "strassen_fused"])
def test_cuda_oot_pipelined_and_sync_are_bit_identical(cuda, leaf):
    """2048^2 at depth 2 with waves of 2: the copy-stream pipeline gives the
    synchronous loop's bits (the leaves run on one stream in both), in at
    least 4 waves, with the fused leaf launching strassen1 once per leaf."""
    from repro_torch.blocks.scheduler import pipelined_leaf_bytes, strassen_oot_matmul
    from repro_torch.core.backend import MatmulBackend

    n = 2048
    a, b = _on("cpu", (n, n), torch.float32), _on("cpu", (n, n), torch.float32)
    budget = 2 * pipelined_leaf_bytes(n, n, n, 2, torch.float32)
    be = MatmulBackend(kind=leaf, depth=1, min_dim=1)
    tst.strassen1_matmul_cuda.launches = 0
    pipe, st_pipe = strassen_oot_matmul(a, b, depth=2, budget_bytes=budget, backend=be,
                                        device=cuda)
    launches = tst.strassen1_matmul_cuda.launches
    sync, st_sync = strassen_oot_matmul(a, b, depth=2, budget_bytes=budget, backend=be,
                                        prefetch=False, device=cuda)
    assert st_pipe.prefetch and st_pipe.waves >= 4 and not st_sync.prefetch
    assert torch.equal(pipe, sync)
    assert launches == (49 if leaf == "strassen_fused" else 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = (a.to(cuda) @ b.to(cuda)).cpu()
    assert ((pipe - ref).norm() / ref.norm()).item() < 1e-4
    assert st_pipe.overlap_efficiency > 0.0 and st_pipe.peak_device_bytes <= budget


@pytest.mark.cuda
def test_cuda_is_oom_error_on_a_real_allocation(cuda):
    from repro_torch.core.backend import is_oom_error

    total = torch.cuda.get_device_properties(cuda).total_memory
    with pytest.raises(torch.cuda.OutOfMemoryError) as err:
        torch.empty(2 * total, dtype=torch.uint8, device=cuda)
    assert is_oom_error(err.value)
