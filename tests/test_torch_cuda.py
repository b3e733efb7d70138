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
runs on the card launch the serving kernels; an fp8 KV cache and whisper's
generate path run as on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config
from repro_torch.core.coefficients import get_scheme
from repro_torch.kernels.flash_attention import flash_attention as tfa
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
from repro_torch.kernels.matmul import ops as tmm
from repro_torch.kernels.matmul import ref as tmm_ref
from repro_torch.kernels.strassen import ref as tref
from repro_torch.kernels.rmsnorm import rmsnorm as trn
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref
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


def _einsum_level(monkeypatch, x, coef, divide):
    """A level as core/strassen.py forms it on the CPU, run on the card:
    split_quadrants, one einsum with TF32 off, and for a combine
    merge_quadrants."""
    from repro_torch.core import strassen as core_strassen

    with monkeypatch.context() as m:
        m.setattr(core_strassen, "on_cuda", lambda *t: False)
        if divide:
            return core_strassen.divide_level(x, coef)
        return core_strassen.combine_level(x, coef)


def _level_close(got, want, terms, dtype):
    """bf16: within one ulp of the einsum route's (expected bit for bit: up to
    four bf16 terms sum exactly in fp32, and both round once). fp32: within 4
    ulps of the terms' absolute sum, since the einsum may add the same terms
    in another order and each reordered add may round differently."""
    d = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        return bool((d <= 2**-7 * want.float().abs()).all())
    return bool((d <= 4 * 2**-23 * terms).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scheme_name", SCHEMES)
def test_cuda_strassen_level_kernels_match_the_einsum_route(cuda, scheme_name, dtype,
                                                             monkeypatch):
    """The level kernels against their plain versions (bit for bit: the same
    fp32 sums in the same order, rounded once) and against split + einsum
    (+ merge) (see _level_close). hc 64 and 24 take 16-byte chunks in both
    dtypes, hc 4 in fp32 only, hc 6 in neither; m is 1 and 7; one input is
    transposed (not contiguous). Each call launches its kernel once."""
    s = get_scheme(scheme_name)
    for m, r, c in [(1, 64, 128), (7, 40, 48), (7, 18, 8), (1, 10, 12)]:
        x, xt = _on(cuda, (m, r, c), dtype), _on(cuda, (m, c, r), dtype).transpose(1, 2)
        p = _on(cuda, (m * s.rank, r // 2, c // 2), dtype)
        cases = [(tst.divide_level_cuda, tref.divide_level_ref, x, s.a_coef, True),
                 (tst.divide_level_cuda, tref.divide_level_ref, xt, s.b_coef, True),
                 (tst.combine_level_cuda, tref.combine_level_ref, p, s.c_coef, False)]
        for fn, plain, inp, coef, divide in cases:
            n = fn.launches
            got = fn(inp, coef)
            assert fn.launches == n + 1
            assert torch.equal(got, plain(inp, coef)), (fn.__name__, m, r, c)
            terms = _einsum_level(monkeypatch, inp.float().abs(), np.abs(coef), divide)
            want = _einsum_level(monkeypatch, inp, coef, divide)
            assert _level_close(got, want, terms, dtype), (
                fn.__name__, m, r, c)


@pytest.mark.cuda
def test_cuda_kind_strassen_runs_the_level_kernels_alone(cuda, monkeypatch):
    """Kind strassen at depth 2 on a 1024^2 multiply: one level launch per
    operand and level, no quadrant copy, einsum or GEMV under backend.matmul
    (the leaf's bmm aside); its fp32 product and gradients through
    backend.matmul match the einsum route's (the same code with the levels
    taken as on the CPU) within 1e-5 normwise (the sums add in another order)."""
    from repro_torch.core import strassen as core_strassen
    from repro_torch.core.backend import MatmulBackend, matmul

    be = MatmulBackend(kind="strassen", depth=2, min_dim=256)
    a, b = _on(cuda, (1024, 1024), torch.float32), _on(cuda, (1024, 1024), torch.float32)
    n_div, n_comb = tst.divide_level_cuda.launches, tst.combine_level_cuda.launches
    matmul(a, b, be)
    torch.cuda.synchronize()
    assert tst.divide_level_cuda.launches - n_div == 4
    assert tst.combine_level_cuda.launches - n_comb == 2
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        matmul(a, b, be)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not {"aten::copy_", "aten::einsum", "aten::clone"} & set(names), sorted(set(names))
    assert sum("strassen_level_kernel" in k for k in kernels) == 6, kernels
    others = [k for k in kernels if "strassen_level_kernel" not in k]
    assert others and not [k for k in others if "gemv" in k.lower() or "gemmSN" in k
                           or "elementwise" in k.lower()], others

    def run(x, y):
        xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
        out = matmul(xg, yg, be)
        out.backward(g)
        return out.detach(), xg.grad, yg.grad

    g = _on(cuda, (1024, 1024), torch.float32)
    n_div, n_comb = tst.divide_level_cuda.launches, tst.combine_level_cuda.launches
    got = run(a, b)
    # forward 4 + 2; backward: each combine's gradient is a divide launch, each divide's a combine
    assert tst.divide_level_cuda.launches - n_div == 4 + 2
    assert tst.combine_level_cuda.launches - n_comb == 2 + 4
    monkeypatch.setattr(core_strassen, "on_cuda", lambda *t: False)
    want = run(a, b)
    for x, y in zip(got, want):
        assert ((x - y).norm() / y.norm()).item() <= 1e-5


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
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2**-7)])
def test_cuda_flash_attention_recurrentgemma_shape(cuda, dtype, tol):
    """recurrentgemma's local attention: head dim 256, MQA with 16 query heads
    on 1 KV head, and a window shorter than the sequence."""
    for s, window in ((300, 128), (1100, 1024)):
        q = _on(cuda, (1, 16, s, 256), dtype)
        k, v = _on(cuda, (1, 1, s, 256), dtype), _on(cuda, (1, 1, s, 256), dtype)
        got = tfa.flash_attention_cuda(q, k, v, causal=True, window=window)
        want = attention_ref(q, k, v, causal=True, window=window)
        assert got.dtype == dtype and _within(got, want, tol), (s, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2**-7)])
def test_cuda_flash_attention_whisper_shapes(cuda, dtype, tol):
    """whisper's attention, head dim 64, 6 heads: the encoder (Sq = Sk = 1500,
    no mask; 1500 is not a multiple of the key tile), the decoder's causal
    prefill, and cross-attention at a decode step (Sq = 1 against 1500 frames)."""
    for (b, sq, sk), causal in (((1, 1500, 1500), False), ((2, 4, 4), True),
                                ((2, 1, 1500), False), ((2, 4, 1500), False)):
        q = _on(cuda, (b, 6, sq, 64), dtype)
        k, v = _on(cuda, (b, 6, sk, 64), dtype), _on(cuda, (b, 6, sk, 64), dtype)
        got = tfa.flash_attention_cuda(q, k, v, causal=causal)
        want = attention_ref(q, k, v, causal=causal)
        assert got.dtype == dtype and _within(got, want, tol), (sq, sk, causal)


# FP8_FLIP_LIMIT of tests/test_torch_models.py: the logit movement that one
# e4m3 rounding flip can cause, where fp32 results that differ in their last
# bits (here the card's and the CPU's) straddle a rounding boundary.
FP8_FLIP_LIMIT = 4e-3


@torch.inference_mode()
def _fp8_flips_then_load(cache, want):
    """Cached fp8 elements whose bits differ from ``want``'s (each within one
    e4m3 ulp of it); then copies every leaf of ``want`` into ``cache``."""
    flips = 0
    for layer, ref in zip(cache["layers"], want["layers"]):
        for name, t in layer.items():
            r = ref[name]
            if t.dtype == torch.float8_e4m3fn:
                got, exp = t.float().cpu(), r.float()
                assert bool(((got - exp).abs() <= 2**-3 * exp.abs() + 2**-9).all())
                bits = r.view(torch.uint8).to(t.device)
                flips += int((t.view(torch.uint8) != bits).sum())
                t.view(torch.uint8).copy_(bits)
            else:
                t.copy_(r)
    return flips


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "recurrentgemma_9b"])
def test_cuda_fp8_cache_prefill_and_decode_like_the_cpu_port(cuda, arch):
    """An fp8 KV cache (fp32 smoke config): prefill + 3 decode steps on the
    card are finite and within the CPU parity tests' bounds of the CPU port:
    1e-4, or FP8_FLIP_LIMIT where an e4m3 flip can reach the logits (a decode
    step, a prefill whose caches differ, or one whose ring dropped K/V). The
    CPU cache is loaded into the card's before each step."""
    cfg = get_smoke_config(arch, cache_dtype="float8_e4m3fn")
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    cpu_params = M.init_params(cfg, torch.Generator().manual_seed(0))
    cpu_params.load_state_dict({k: v.cpu() for k, v in params.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (2, 21)))
    dropped = "local_attn" in cfg.block_pattern and toks.shape[1] > cfg.local_window
    caches = {dev: M.init_cache(cfg, 2, 32, device=dev) for dev in (cuda, "cpu")}
    for step in range(4):
        logits = {}
        for dev, p in ((cuda, params), ("cpu", cpu_params)):
            if step:
                logits[dev], caches[dev] = M.apply_decode(p, toks[:, step - 1:step].to(dev),
                                                          caches[dev], cfg)
            else:
                logits[dev], caches[dev] = M.apply_prefill(p, {"tokens": toks.to(dev)},
                                                           caches[dev], cfg)
        got, want = logits[cuda].cpu(), logits["cpu"]
        flips = _fp8_flips_then_load(caches[cuda], caches["cpu"])
        limit = FP8_FLIP_LIMIT if step or flips or dropped else 1e-4
        assert bool(torch.isfinite(got).all())
        assert (got - want).abs().max() <= limit * max(1.0, want.abs().max().item()), (step, flips)


@pytest.mark.cuda
def test_cuda_whisper_generate_like_the_cpu_port(cuda):
    """The whisper smoke config (fp32) through generate on the card gives the
    CPU port's greedy tokens; flash runs in every encoder layer and every
    self- and cross-attention of the prefill, and in every cross-attention
    of a decode step."""
    from repro_torch.models.frontends import make_stub_frames

    cfg = get_smoke_config("whisper_tiny")
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    frames = make_stub_frames(cfg, 2, device=cuda)
    prompts = np.arange(8).reshape(2, 4) % cfg.vocab
    tfa.flash_attention_cuda.launches = 0
    got, _ = Engine(cfg, params, ServeConfig(max_seq=32), device=cuda).generate(
        prompts, 6, frames=frames)
    assert tfa.flash_attention_cuda.launches == cfg.enc_layers + 2 * cfg.n_layers + 5 * cfg.n_layers
    want, _ = Engine(cfg, params.cpu(), ServeConfig(max_seq=32), device="cpu").generate(
        prompts, 6, frames=frames.cpu())
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "recurrentgemma_9b"])
def test_cuda_engine_serves_moe_and_rglru_like_the_cpu_port(cuda, arch):
    """The smoke configs (fp32) served on the card give the CPU port's greedy tokens."""
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    serve = ServeConfig(max_seq=64, slots=2, page_size=8)
    prompts = [np.arange(5 + 7 * i) % cfg.vocab for i in range(3)]  # 19 > recurrentgemma's window
    eng = Engine(cfg, params, serve, device=cuda)
    hs = [eng.submit(p, 6) for p in prompts]
    eng.run()
    assert [h.finish_reason for h in hs] == ["length"] * 3
    cpu = Engine(cfg, params.cpu(), serve, device="cpu")
    want = [cpu.submit(p, 6) for p in prompts]
    cpu.run()
    assert [h.tokens() for h in hs] == [h.tokens() for h in want]


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


MESH_RUNS = [
    ("strassen_bfs_sharded", (4, 2), ("data", "model"), dict(depth=2)),
    ("strassen_bfs_sharded", (8,), ("data",), dict(depth=2, batch_axes=("data",))),
    ("strassen_2d", (4, 2), ("data", "model"), dict(depth=1)),
    ("strassen_shardmap", (7,), ("mult",), {}),
    ("strassen_shardmap_2d", (2, 7), ("rows", "mult"), {}),
    ("strassen_shardmap_3d", (2, 2, 7), ("rb", "cb", "mult"), dict(merge=False)),
    ("strassen_fused_sharded", (4, 2), ("data", "model"), dict(depth=2)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,names,kw", MESH_RUNS, ids=lambda v: str(v))
def test_cuda_mesh_strategy_matches_its_cpu_run(cuda, name, shape, names, kw):
    """Each strategy on a mesh of CUDA positions against the same strategy
    on CPU positions, within the fused-sharded parity bound 3e-3; the same
    collectives and logical bytes, no physical bytes on one card, and
    strassen_fused_sharded launches strassen1 once per position."""
    from repro_torch.core import distributed as td
    from repro_torch.core.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = _on("cpu", (256, 256), torch.float32), _on("cpu", (256, 256), torch.float32)
    cpu_mesh = make_mesh(shape, names, device="cpu")
    want = td.get_strategy(name)(a, b, mesh=cpu_mesh, **kw)
    mesh = make_mesh(shape, names, device=cuda)
    n = tst.strassen1_matmul_cuda.launches
    got = td.get_strategy(name)(a.to(cuda), b.to(cuda), mesh=mesh, **kw)
    torch.cuda.synchronize()
    launched = tst.strassen1_matmul_cuda.launches - n
    assert launched == (mesh.size if name == "strassen_fused_sharded" else 0)
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, atol=3e-3, rtol=3e-3)
    assert {k: (t.count, t.logical_bytes) for k, t in mesh.traffic.items()} == {
        k: (t.count, t.logical_bytes) for k, t in cpu_mesh.traffic.items()}
    if torch.cuda.device_count() == 1:
        assert mesh.physical_bytes == 0


# ------------------------------------------------------------ backward kernels
# The backward kernels against their plain backwards (ref.py). fp32: max|d| <=
# 1e-4 x max(1, max|plain|) (five fp32 products and an atomic dQ sum in
# another order). bf16: each element within 2^-5 x (|plain| + rms(plain)) and
# normwise within 1e-2: the kernel rounds P and dS to bf16 before its
# tensor-core products (2^-9 each), where the plain version keeps them fp32.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2**-5}


def _grad_within(got, want, dtype):
    if dtype == torch.float32:
        return _within(got, want, BWD_TOL[dtype])
    rel = ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()
    return _within(got, want, BWD_TOL[dtype]) and rel <= 1e-2


FLASH_BWD_CASES = [
    ((2, 6, 2, 130, 130), dict(causal=True)),               # GQA 3, ragged tiles
    ((1, 4, 1, 150, 150), dict(causal=True, window=17)),    # MQA, a window
    ((1, 4, 2, 40, 100), dict(causal=True)),                # Sq < Sk, top-left causal
    ((1, 4, 2, 100, 40), dict(causal=True)),                # Sq > Sk
    ((2, 3, 3, 37, 150), dict(causal=False)),               # cross-attention
    ((1, 2, 2, 64, 16), dict(causal=True, window=8)),       # rows with no live key
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
def test_cuda_flash_attention_bwd_matches_plain(cuda, dtype, d):
    assert d in tfa.BWD_HEAD_DIMS[dtype]  # bf16 D = 256 too, on wgmma
    for (b, hq, hkv, sq, sk), kw in FLASH_BWD_CASES:
        q = _on(cuda, (b, hq, sq, d), dtype)
        k, v = _on(cuda, (b, hkv, sk, d), dtype), _on(cuda, (b, hkv, sk, d), dtype)
        out, lse = tfa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        assert torch.equal(out, tfa.flash_attention_cuda(q, k, v, **kw))  # lse moves nothing
        want_out, want_lse = attention_ref(q, k, v, return_lse=True, **kw)
        live = torch.isfinite(want_lse)
        assert torch.equal(torch.isfinite(lse), live)
        assert (lse[live] - want_lse[live]).abs().max().item() <= 1e-4 * max(1.0, want_lse[live].abs().max().item())
        do = _on(cuda, (b, hq, sq, d), dtype)
        n = tfa.flash_attention_bwd_cuda.launches
        got = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
        assert tfa.flash_attention_bwd_cuda.launches == n + 1
        want = attention_bwd_ref(q, k, v, out, lse, do, **kw)
        for name, g, w in zip("qkv", got, want):
            assert g.dtype == dtype and g.shape == w.shape
            assert _grad_within(g, w, dtype), (name, (b, hq, hkv, sq, sk, d), kw)
        if kw.get("window") == 8:  # rows past 23 have no live key: their dq is 0
            assert torch.count_nonzero(got[0][:, :, 23:]) == 0
        again = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
        assert all(torch.equal(g, a) for g, a in zip(got, again))  # ordered sums: the same bits


# The training shapes of the D = 256 models: gemma-7b (MHA 16/16) and
# recurrentgemma-9b (MQA 16/1, window 2048), whose bf16 backward needs the
# wgmma kernel's split accumulators and, at one KV head, its split of the
# query heads into parts.
MODEL_BWD_CASES = {
    "gemma_7b": ((1, 16, 16, 2048, 2048), dict(causal=True)),
    "recurrentgemma_9b": ((1, 16, 1, 4096, 4096), dict(causal=True, window=2048)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model", sorted(MODEL_BWD_CASES))
def test_cuda_flash_attention_bwd_at_d256_model_shapes(cuda, model, dtype):
    (b, hq, hkv, sq, sk), kw = MODEL_BWD_CASES[model]
    q = _on(cuda, (b, hq, sq, 256), dtype)
    k, v = _on(cuda, (b, hkv, sk, 256), dtype), _on(cuda, (b, hkv, sk, 256), dtype)
    out, lse = tfa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    do = _on(cuda, (b, hq, sq, 256), dtype)
    got = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    want = attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for name, g, w in zip("qkv", got, want):
        assert _grad_within(g, w, dtype), (model, name)
    again = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_bwd_plan_matches_the_kernel(cuda, dtype):
    from repro_torch.kernels import _build

    sms, smem = _build.device_limits(cuda)
    code = _build.dtype_code(torch.empty(0, dtype=dtype))
    for d in tfa.HEAD_DIMS:
        plan = tfa.flash_bwd_plan(1, 16, 1, 4096, 4096, d, True, 2048, sms, smem, dtype=dtype)
        assert plan.smem_bytes == _build.build().repro_flash_bwd_smem(code, d), d


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_autograd_runs_the_kernels(cuda, dtype):
    q = _on(cuda, (2, 4, 70, 64), dtype).requires_grad_()
    k = _on(cuda, (2, 2, 70, 64), dtype).requires_grad_()
    v = _on(cuda, (2, 2, 70, 64), dtype).requires_grad_()
    do = _on(cuda, (2, 4, 70, 64), dtype)
    n = tfa.flash_attention_bwd_cuda.launches
    out = flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert tfa.flash_attention_bwd_cuda.launches == n + 1
    o, lse = attention_ref(q.detach(), k.detach(), v.detach(), return_lse=True)
    want = attention_bwd_ref(q.detach(), k.detach(), v.detach(), o, lse, do)
    assert all(_grad_within(g, w, dtype) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,wdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.float32),
                                          (torch.bfloat16, torch.bfloat16)])
def test_cuda_rmsnorm_bwd_matches_plain_and_is_deterministic(cuda, dtype, wdtype):
    # 1000 and 4099 rows: more than one turn of the persistent blocks, and a
    # row count that their number does not divide
    for r, d in [(1, 3072), (7, 3072), (300, 48), (64, 1000), (5, 250), (2048, 3072),
                 (33, 8192), (4, 2048), (1000, 3072), (4099, 2048), (4099, 8192)]:
        x, dy = _on(cuda, (r, d), dtype), _on(cuda, (r, d), dtype)
        w = 1.0 + _on(cuda, (d,), wdtype)
        n = trn.rmsnorm_bwd_cuda.launches
        dx, dw = trn.rmsnorm_bwd_cuda(x, w, dy, eps=1e-6)
        assert trn.rmsnorm_bwd_cuda.launches == n + 1
        want_dx, want_dw = rmsnorm_bwd_ref(x, w, dy, 1e-6)
        assert dx.dtype == dtype and dw.dtype == wdtype
        assert _grad_within(dx, want_dx, dtype), (r, d)
        rel = ((dw.float() - want_dw.float()).norm() / want_dw.float().norm()).item()
        assert rel <= (1e-5 if wdtype == torch.float32 else 1e-2), (r, d, rel)
        dx2, dw2 = trn.rmsnorm_bwd_cuda(x, w, dy, eps=1e-6)
        assert torch.equal(dx, dx2) and torch.equal(dw, dw2)  # ordered sums: the same bits


@pytest.mark.cuda
def test_cuda_fused_and_slstm_raise_under_grad(cuda):
    """strassen_fused has no gradient (nor has the reference's Pallas level).
    The sLSTM op no longer raises: it has a backward kernel, held by
    test_cuda_xlstm_loss_backward_runs_the_slstm_backward_kernel."""
    from repro_torch.core.backend import MatmulBackend, matmul

    a = _on(cuda, (64, 64), torch.float32).requires_grad_()
    with pytest.raises(NotImplementedError, match="no gradient"):
        matmul(a, _on(cuda, (64, 64), torch.float32),
               MatmulBackend(kind="strassen_fused", depth=1, min_dim=16))


# (b, s, h, dh, carried, final-state gradients) of the sLSTM backward: xlstm's
# training rows from zero state, a carried state with final-state gradients,
# S = 1, 6 rows (two passes over a tile), 8 heads whose r is streamed (two
# tiles a block), dh 48 and a dh that is not a multiple of 16; each ROWS
# template (B = 1, 2, 3, 4) at odd and even S (the ring's slot parity); dh
# 10, whose ring rows are padded to 12 floats and whose r is read without
# float4 loads.
SLSTM_BWD_CASES = [(2, 256, 4, 512, False, False), (2, 64, 4, 512, True, True), (2, 1, 4, 512, True, True),
                   (6, 32, 4, 512, True, True), (2, 16, 8, 512, True, True), (2, 64, 4, 48, True, True),
                   (3, 9, 2, 40, True, True), (1, 40, 2, 8, False, True), (2, 63, 4, 512, True, True),
                   (1, 33, 4, 512, True, False), (4, 18, 2, 64, False, True), (2, 7, 2, 10, True, True)]


@pytest.mark.cuda
def test_cuda_slstm_bwd_matches_plain_and_is_deterministic(cuda):
    """The backward kernel fed the saving forward's tensors against its plain
    version fed the same (the fp32 backward rule, 1e-4 x max(1, max|plain|)),
    the saved tensors against the plain forward's, the same bits on a rerun,
    one launch and one device kernel a call."""
    from repro_torch.kernels.slstm.ref import slstm_seq_bwd_ref

    for b, s, h, dh, carried, final in SLSTM_BWD_CASES:
        wx = _on(cuda, (b, s, 4, h, dh), torch.float32)
        r = _on(cuda, (4, h, dh, dh), torch.float32) * dh**-0.5
        state = _slstm_state(cuda, b, h, dh, carried)
        fin, hs, saved = tsl.slstm_seq_cuda(wx, r, state, save=True)
        fin2, hs2 = tsl.slstm_seq_cuda(wx, r, state)
        assert torch.equal(hs, hs2) and all(torch.equal(fin[k], fin2[k]) for k in fin)
        _, _, saved_ref = slstm_seq_ref(wx, r, state, save=True)
        assert all(_within(saved[k], saved_ref[k], 2e-5) for k in saved), (b, s, h, dh)
        dhs = _on(cuda, (b, s, h, dh), torch.float32)
        dfin = {k: _on(cuda, (b, h, dh), torch.float32) if final else torch.zeros((b, h, dh), device=cuda)
                for k in ("c", "n", "m", "h")}
        n = tsl.slstm_seq_bwd_cuda.launches
        dwx, dr, d0 = tsl.slstm_seq_bwd_cuda(r, state, hs, saved, dhs, dfin)
        assert tsl.slstm_seq_bwd_cuda.launches == n + 1
        want = slstm_seq_bwd_ref(r, state, hs, saved, dhs, dfin)
        pairs = [(dwx, want[0]), (dr, want[1])] + [(d0[k], want[2][k]) for k in d0]
        assert all(g.shape == w.shape and _within(g, w, 1e-4) for g, w in pairs), (b, s, h, dh)
        again = tsl.slstm_seq_bwd_cuda(r, state, hs, saved, dhs, dfin)
        assert torch.equal(dwx, again[0]) and torch.equal(dr, again[1])
        assert all(torch.equal(d0[k], again[2][k]) for k in d0)
    names = _slstm_device_kernels(lambda: tsl.slstm_seq_bwd_cuda(r, state, hs, saved, dhs, dfin))
    assert len(names) == 1 and "bwd" in names[0]


@pytest.mark.cuda
def test_cuda_xlstm_loss_backward_runs_the_slstm_backward_kernel(cuda):
    """The xlstm smoke model's loss and gradients on the card, where the sLSTM
    layers run the saving forward and the backward kernel (once a layer),
    against the CPU port's: loss to 1e-5 relative, each leaf (r included)
    normwise to 1e-4."""
    import copy

    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    cfg = get_smoke_config("xlstm_1_3b")
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0))
    for p in cpu.parameters():
        p.requires_grad_(True)
    dev = copy.deepcopy(cpu).to(cuda)
    batch = SyntheticLM(cfg, DataConfig(batch=2, seq_len=32, seed=3), device="cpu")(0)
    n_slstm = sum(cfg.block_kind(i) == "slstm" for i in range(cfg.n_layers))
    n, nf = tsl.slstm_seq_bwd_cuda.launches, tsl.slstm_seq_cuda.launches
    dloss, _ = M.loss_fn(dev, {k: t.to(cuda) for k, t in batch.items()}, cfg)
    dloss.backward()
    torch.cuda.synchronize()
    assert tsl.slstm_seq_bwd_cuda.launches == n + n_slstm
    assert tsl.slstm_seq_cuda.launches == nf + n_slstm
    closs, _ = M.loss_fn(cpu, batch, cfg)
    closs.backward()
    assert abs(dloss.item() - closs.item()) <= 1e-5 * abs(closs.item())
    want = {name: p.grad.double() for name, p in cpu.named_parameters()}
    # a leaf below 1e-6 of the whole gradient (the mLSTM input-gate bias, zero
    # in exact arithmetic) is held to that absolutely, as the CPU tests hold it
    noise = 1e-6 * torch.sqrt(sum(w.square().sum() for w in want.values())).item()
    for name, p in dev.named_parameters():
        w, diff = want[name], (p.grad.cpu().double() - want[name]).norm().item()
        if w.norm().item() <= noise:
            assert diff <= noise, (name, diff)
        else:
            assert diff <= 1e-4 * w.norm().item(), (name, diff / w.norm().item())


def _state_on(state, device):
    import copy

    from repro_torch.optim.adamw import OptState
    from repro_torch.training.train_step import TrainState

    opt = state.opt
    return TrainState(copy.deepcopy(state.params).to(device),
                      OptState(opt.step.to(device), {k: t.to(device) for k, t in opt.m.items()},
                               {k: t.to(device) for k, t in opt.v.items()}))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "olmoe_1b_7b", "recurrentgemma_9b"])
def test_cuda_train_step_matches_the_cpu_port(cuda, arch):
    """One fp32 train step of a smoke config on the card (flash and RMSNorm
    forward and backward kernels; recurrentgemma's windowed MQA attention,
    olmoe's routed experts) against the same step of the CPU port: loss and
    grad norm to 1e-5 relative, each first moment (the clipped gradient
    times 1 - b1) normwise to 1e-4, each update normwise to 1e-3."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.train_step import init_train_state, make_train_step

    cfg = get_smoke_config(arch)
    opt = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50)
    cpu = init_train_state(cfg, opt, torch.Generator().manual_seed(0))
    dev = _state_on(cpu, cuda)
    before = {n: p.detach().clone() for n, p in cpu.params.named_parameters()}
    batch = SyntheticLM(cfg, DataConfig(batch=2, seq_len=32, seed=3), device="cpu")(0)
    step = make_train_step(cfg, opt)
    tfa.flash_attention_bwd_cuda.launches = trn.rmsnorm_bwd_cuda.launches = 0
    dev, dm = step(dev, {k: t.to(cuda) for k, t in batch.items()})
    cpu, cm = step(cpu, batch)
    assert tfa.flash_attention_bwd_cuda.launches == sum(
        cfg.block_kind(i) in ("attn", "local_attn") for i in range(cfg.n_layers))
    assert trn.rmsnorm_bwd_cuda.launches == 2 * cfg.n_layers + 1
    for key in ("loss", "grad_norm", "lr"):
        assert abs(dm[key].item() - cm[key].item()) <= 1e-5 * abs(cm[key].item()), key

    def rel(a, b):
        return ((a.cpu().double() - b.double()).norm() / b.double().norm().clamp_min(1e-30)).item()

    for name, p in cpu.params.named_parameters():
        assert rel(dev.opt.m[name], cpu.opt.m[name]) <= 1e-4, name
        pd = dict(dev.params.named_parameters())[name]
        assert rel(pd.detach() - before[name].to(cuda), p.detach() - before[name]) <= 1e-3, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,loss_tol,leaf_tol", [("float32", 1e-5, 1e-4),
                                                     ("bfloat16", 2.0**-7, 2.0**-4)])
def test_cuda_olmoe_dropless_train_step_matches_the_cpu_port(cuda, dtype, loss_tol, leaf_tol):
    """One train step (accumulate 2) of OLMoE's published training variant
    at a smoke size, as EP rank 1 of 4 (QK-norm on the RMSNorm kernels, the
    top-4 gates unnormalised, dropless grouped expert products), on the card
    against the same step of the CPU port. The routers' weights are scaled
    by 8, so that no top-k pick lies within bf16 noise of the next: a
    flipped pick moves a token's output by a whole expert's term. fp32: the
    loss and grad norm to 1e-5 relative, each first moment (the clipped
    gradient) normwise to 1e-4, as the other train steps here. bf16 rounds
    each activation to 2^-8 of itself, on the two devices in other orders:
    the loss and grad norm to 2^-7; a held expert's gradient sums about 16
    rows here, whose bf16 terms cancel, and its first moment read up to
    3.4e-2 normwise on the H100, so 2^-4."""
    import dataclasses

    from repro_torch.configs import olmoe_1b_7b as O
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.train_step import init_train_state, make_train_step

    cfg = dataclasses.replace(O.share(O.TRAIN_SMOKE_CONFIG, 1, 4), dtype=dtype)
    opt = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50)
    cpu = init_train_state(cfg, opt, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in cpu.params.layers:
            layer.ffn.router.w.mul_(8.0)
    dev = _state_on(cpu, cuda)
    batch = SyntheticLM(cfg, DataConfig(batch=4, seq_len=32, seed=3), device="cpu")(0)
    step = make_train_step(cfg, opt, accum_steps=2)
    trn.rmsnorm_bwd_cuda.launches = 0
    dev, dm = step(dev, {k: t.to(cuda) for k, t in batch.items()})
    cpu, cm = step(cpu, batch)
    # per micro-batch: ln1, q_norm, k_norm and ln2 of each layer, and the final norm
    assert trn.rmsnorm_bwd_cuda.launches == 2 * (4 * cfg.n_layers + 1)
    for key in ("loss", "grad_norm"):
        gap = abs(dm[key].item() - cm[key].item()) / abs(cm[key].item())
        print(f"olmoe {dtype} step {key}: {gap!r}")
        assert gap <= loss_tol, key
    worst = 0.0
    for name in cpu.opt.m:
        a, b = dev.opt.m[name].cpu().double(), cpu.opt.m[name].double()
        gap = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
        worst = max(worst, gap)
        assert gap <= leaf_tol, (name, gap)
    print(f"olmoe {dtype} step worst first moment: {worst!r}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("kind", ["naive", "strassen", "strassen_fused"])
@pytest.mark.parametrize("w_logical", [("fsdp", "heads"), ("d_ff", "fsdp")])
def test_cuda_sharded_projection_matches_the_cpu_port(cuda, kind, dtype, tol, w_logical):
    """chip_smoke's s1 at a small size: backend.matmul with w_logical under a
    (data 2, model 2) mesh of positions on the card against the same call on
    a CPU mesh; strassen_fused launches strassen1 once per distinct slab pair."""
    from repro_torch.core.backend import MatmulBackend, matmul, sharded_layouts
    from repro_torch.core.mesh import distinct_slabs
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.sharding import DEFAULT_RULES, use_sharding

    m, k, n = 512, 768, 384
    x, w = _on(cuda, (m, k), dtype), _on(cuda, (k, n), dtype)
    be = MatmulBackend(kind=kind, depth=1, min_dim=128)
    card, host = make_mesh_for(4, 2, device="cuda"), make_mesh_for(4, 2, device="cpu")
    tst.strassen1_matmul_cuda.launches = 0
    with use_sharding(card):
        got = matmul(x, w, be, w_logical=w_logical)
    launched = tst.strassen1_matmul_cuda.launches
    with use_sharding(host):
        want = matmul(x.cpu(), w.cpu(), be, w_logical=w_logical)
    scale = max(1.0, want.float().abs().max().item())
    assert got.device.type == "cuda" and got.dtype == want.dtype
    assert (got.cpu().float() - want.float()).abs().max().item() <= tol * scale
    _, wg_spec, x_spec, _ = sharded_layouts(card, DEFAULT_RULES, m, k, n, w_logical)
    pairs = distinct_slabs(card, (x_spec, (m, k)), (wg_spec, (k, n)))
    assert launched == (pairs if kind == "strassen_fused" else 0)
    assert card.traffic == host.traffic and card.physical_bytes == 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "xlstm_1_3b"])
def test_cuda_dryrun_traces_a_train_cell(cuda, arch, monkeypatch):
    """On a PyTorch with CUDA autograd runs the backward over fake cuda:0
    tensors: a smoke train cell on a (2, 2) mesh records the backward
    kernels and launches none."""
    from repro_torch import configs
    from repro_torch.core.mesh import make_mesh
    from repro_torch.launch import dryrun

    monkeypatch.setattr(configs, "get_config", get_smoke_config)
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    monkeypatch.setattr(dryrun, "_mesh", lambda kind: make_mesh((2, 2), ("data", "model"), device="cuda:0"))
    # 64 tokens a row: the sequential mLSTM traces one Python step per token
    monkeypatch.setitem(configs.SHAPES, "train_64", configs.Shape("train_64", 64, 8, "train"))
    before = trn.rmsnorm_bwd_cuda.launches
    r = dryrun.run_cell(arch, "train_64", "single", accum=2)
    assert not r.get("skipped"), r
    assert r["accum"] == 2 and r["launches"]["rmsnorm_bwd_cuda"] > 0
    want = "slstm_seq_bwd_cuda" if arch == "xlstm_1_3b" else "flash_attention_bwd_cuda"
    assert r["launches"][want] > 0 and r["roofline"]["bound_s"] > 0
    assert trn.rmsnorm_bwd_cuda.launches == before


@pytest.mark.cuda
def test_cuda_dryrun_resolves_kind_auto(cuda, monkeypatch):
    """--backend auto calibrates on the card before the trace, then decides
    per shape while tracing fake tensors."""
    from repro_torch import configs
    from repro_torch.core.backend import MatmulBackend
    from repro_torch.core.mesh import make_mesh
    from repro_torch.launch import dryrun

    monkeypatch.setattr(configs, "get_config", get_smoke_config)
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    monkeypatch.setattr(dryrun, "_mesh", lambda kind: make_mesh((2, 2), ("data", "model"), device="cuda:0"))
    monkeypatch.setitem(configs.SHAPES, "prefill_256", configs.Shape("prefill_256", 256, 4, "prefill"))
    r = dryrun.run_cell("phi4_mini_3_8b", "prefill_256", "single",
                        backend=MatmulBackend(kind="auto", depth=1, min_dim=64))
    assert r["backend"] == "auto" and r["roofline"]["bound_s"] > 0
