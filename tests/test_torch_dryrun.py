"""The dry-run tooling of the port (``repro_torch.launch.{dryrun, op_analysis,
roofline, matmul_cell, perf, summarize}``, ``kernels/cost.py`` and the cell
half of ``launch/specs.py``) against the JAX package's, on the CPU.

The port traces a step on fake ``cuda:0`` tensors (no card, no
allocation) where the JAX package compiles it for placeholder devices. Its
counts are held to the JAX analyzer's on the same programs: a matmul's and
a loop's dot FLOPs, the naive sharded matmul's per-position FLOPs and
``strassen_shardmap_2d``'s all-reduce bytes on conftest's host devices,
and the cells' leaves, layouts and argument bytes.
"""
import dataclasses
import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.launch import matmul_cell as jmatmul_cell  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.launch import summarize as jsummarize  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models import frontends as jfrontends  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core.coefficients import get_scheme  # noqa: E402
from repro_torch.core.mesh import make_mesh  # noqa: E402
from repro_torch.kernels import _build, common, cost  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.matmul.matmul import batched_matmul_cuda, matmul_cuda  # noqa: E402
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda  # noqa: E402
from repro_torch.kernels.slstm.slstm import slstm_seq_bwd_cuda, slstm_seq_cuda  # noqa: E402
from repro_torch.kernels.strassen.strassen import (  # noqa: E402
    combine_cuda,
    combine_level_cuda,
    divide_cuda,
    divide_level_cuda,
    strassen1_matmul_cuda,
)
from repro_torch.launch import dryrun, perf, roofline, summarize  # noqa: E402
from repro_torch.launch import matmul_cell as tmatmul_cell  # noqa: E402
from repro_torch.launch import op_analysis as OA  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.models import frontends as tfrontends  # noqa: E402
from repro_torch.models.sharding import NamedSharding  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402

DEV = "cuda:0"


def fake(*shape, dtype=torch.float32):
    with OA.fake_mode():
        return torch.empty(shape, dtype=dtype, device=DEV)


def _jmesh(shape, names):
    n = int(np.prod(shape))
    if jax.device_count() < n:
        pytest.skip("needs the conftest multi-device host platform")
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


# ------------------------------------------------------------------ roofline
def test_hardware_defaults_are_the_h100s():
    hw = roofline.Hardware()
    assert hw.name == "h100-sxm-80gb-700w"
    assert hw.peak("float32") == hw.peak(torch.float32) == 67e12
    assert hw.peak(torch.bfloat16) == 989e12
    assert hw.peak(torch.int8) == 67e12  # a dtype the table lacks: fp32's rate
    assert (hw.hbm_bw, hw.ici_bw) == (3.35e12, 450e9)
    assert roofline.bound_ms(67e9, 0, torch.float32) == (1.0, "operations")
    assert roofline.bound_ms(0, 3.35e9, torch.bfloat16) == (1.0, "bytes")


@pytest.mark.parametrize("per_device", [True, False])
@pytest.mark.parametrize("flops,nbytes,coll", [(1e15, 1e9, 1e6), (1e9, 1e12, 1e6), (1e9, 1e6, 1e12)])
def test_roofline_terms_equal_the_jax_functions(flops, nbytes, coll, per_device):
    jhw = jroofline.Hardware(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)
    thw = roofline.Hardware(peak_flops={"float32": 1.0, "bfloat16": 197e12}, hbm_bw=819e9, ici_bw=50e9)
    kw = dict(hlo_bytes=nbytes, coll_bytes=coll, chips=256, per_device=per_device)
    want = jroofline.roofline_terms(hlo_flops=flops, hw=jhw, **kw)
    assert roofline.roofline_terms(hlo_flops=flops, hw=thw, **kw) == want
    assert roofline.roofline_terms(hlo_flops={"bfloat16": flops}, hw=thw, **kw) == want


def test_roofline_terms_sum_over_dtypes():
    t = roofline.roofline_terms(hlo_flops={"float32": 67e12, "bfloat16": 989e12}, hlo_bytes=0,
                                coll_bytes=0, chips=1, per_device=True)
    assert t["compute_s"] == 2.0 and t["bottleneck"] == "compute"


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_equal_the_jax_function(kind):
    assert roofline.model_flops(10, 7, 3, kind) == jroofline.model_flops(10, 7, 3, kind)


def test_collective_bytes_by_xla_kind():
    got = roofline.collective_bytes([("psum", 64), ("all_gather", 8), ("psum", 1), ("reshard", 5)])
    assert got == {"all-gather": 8, "all-reduce": 65, "reduce-scatter": 0, "all-to-all": 0,
                   "collective-permute": 5, "total": 78}
    assert roofline.collective_bytes({"psum_scatter": 3})["reduce-scatter"] == 3


# ------------------------------------------------------------------ analyzer
def test_analyzer_counts_plain_matmul_exactly():
    m, n, k = 128, 256, 512
    a, b = fake(m, k), fake(k, n)
    _, costs = OA.analyze(lambda: a @ b)
    assert costs.dot_flops == 2 * m * n * k
    assert costs.flops_by_dtype == {"float32": 2 * m * n * k}
    assert costs.hbm_bytes == 4 * (m * k + k * n + m * n)


def test_analyzer_multiplies_loop_trip_counts():
    d, trips = 32, 9
    x = fake(d, d)

    def step():
        y = x
        for _ in range(trips):
            y = y @ y
        return y

    assert OA.analyze(step)[1].dot_flops == trips * 2 * d**3


def test_analyzer_nested_loops():
    d = 16
    x = fake(d, d)

    def step():
        y = x
        for _ in range(5):
            for _ in range(7):
                y = y @ y
        return y

    assert OA.analyze(step)[1].dot_flops == 35 * 2 * d**3


def test_analyzer_counts_composites_under_inference_mode():
    """matmul and einsum reach the mode whole under inference mode; their mm/bmm count."""
    a, b = fake(4, 8, 16, dtype=torch.bfloat16), fake(4, 16, 2, dtype=torch.bfloat16)

    def step():
        with torch.inference_mode():
            torch.matmul(a, b)
            torch.einsum("bij,bjk->bik", a, b)

    assert OA.analyze(step)[1].flops_by_dtype == {"bfloat16": 2 * 2 * 4 * 8 * 16 * 2}


def test_analyzer_peak_live_bytes():
    x = fake(256, 256)

    def step():
        y = x + 1  # 256 KiB
        z = y * 2  # 512 KiB live
        del y
        w = z + 1  # 512 KiB live again
        return w

    _, costs = OA.analyze(step)
    assert costs.peak_live_bytes == 2 * 256 * 256 * 4
    assert costs.temp_bytes == costs.peak_live_bytes


def test_analyzer_attributes_positions_and_unpinned_work():
    """Per device = busiest position's pinned work + unpinned / chips; a
    map call that replicas share counts on each of them."""
    mesh = make_mesh((2, 2), ("data", "model"), device=DEV)
    from repro_torch.core.mesh import P, shard

    a, b = fake(8, 16), fake(16, 4)

    def step():
        rows = shard(a, mesh, P("data", None))  # two distinct slabs, each held twice
        mesh.map(lambda x: x @ b, rows.locals)
        a @ b  # global: unpinned

    _, costs = OA.analyze(step, chips=4)
    local = 2 * 4 * 16 * 4
    assert costs.pinned["flops_by_dtype"] == {"float32": local}
    assert costs.unpinned["flops_by_dtype"] == {"float32": 2 * 8 * 16 * 4}
    assert costs.dot_flops == local + 2 * 8 * 16 * 4 / 4
    assert costs.busiest == (0, 0)


def test_analyzer_attributes_the_backward_to_the_forward_phase():
    """Autograd runs a phase's backward later, outside the phase: its ops
    count where the forward's nodes were made, and a movement's gradient
    counts nowhere. Fake CPU tensors: a CPU-only build runs their backward."""
    from repro_torch.core.mesh import P, Sharded, gather, shard

    mesh = make_mesh((2,), ("data",), device="cpu")
    with OA.fake_mode():
        a = torch.empty(8, 16, requires_grad=True)
        b = torch.empty(16, 4, requires_grad=True)

    def step():
        rows = shard(a, mesh, P("data", None))
        outs = mesh.map(lambda x: x @ b, rows.locals)
        gather(Sharded(mesh, P("data", None), (8, 4), outs, a.dtype)).sum().backward()

    _, costs = OA.analyze(step, chips=2)
    # x @ b forward, then g @ b^T and x^T @ g, each 2 * 4 * 16 * 4
    assert costs.pinned["flops_by_dtype"] == {"float32": 3 * 2 * 4 * 16 * 4}
    assert costs.unpinned["flops_by_dtype"] == {}


# ------------------------------------------------------------------ kernels
def _records(monkeypatch):
    """Fail any launch; collect what the analysis records."""
    def no_launch(*_a, **_k):
        raise AssertionError("a kernel was launched on fake tensors")

    monkeypatch.setattr(_build, "launch", no_launch)
    monkeypatch.setattr(_build, "device_limits", no_launch)
    seen = []
    real = OA.OpAnalysis.kernel
    monkeypatch.setattr(OA.OpAnalysis, "kernel", lambda self, name, c: (seen.append((name, c)),
                                                                         real(self, name, c)))
    return seen


S = get_scheme("strassen")
W = get_scheme("winograd")


def _case(name):
    """(call, wrapper, expected cost, expected (shape, dtype) of each output)."""
    f32, b16 = torch.float32, torch.bfloat16
    if name == "matmul":
        a, b = fake(70, 33, dtype=b16), fake(33, 129, dtype=b16)
        return (lambda: matmul_cuda(a, b, out_dtype=f32), matmul_cuda,
                cost.matmul(1, 70, 33, 129, b16, f32), [((70, 129), f32)])
    if name == "batched_matmul":
        a, b = fake(7, 64, 32), fake(7, 32, 16)
        return (lambda: batched_matmul_cuda(a, b), batched_matmul_cuda,
                cost.matmul(7, 64, 32, 16, f32), [((7, 64, 16), f32)])
    if name == "divide":
        x = fake(2, 4, 8, 8, dtype=b16)
        return (lambda: divide_cuda(x, W.a_coef), divide_cuda,
                cost.signed_sum(W.a_coef, 2, 64, b16), [((2, 7, 8, 8), b16)])
    if name == "combine":
        p = fake(3, 7, 16, 4)
        return (lambda: combine_cuda(p, S.c_coef), combine_cuda,
                cost.signed_sum(S.c_coef, 3, 64, f32), [((3, 4, 16, 4), f32)])
    if name == "divide_level":
        x = fake(2, 16, 8, dtype=b16)
        return (lambda: divide_level_cuda(x, W.a_coef), divide_level_cuda,
                cost.signed_sum(W.a_coef, 2, 32, b16), [((14, 8, 4), b16)])
    if name == "combine_level":
        p = fake(21, 16, 4)
        return (lambda: combine_level_cuda(p, S.c_coef), combine_level_cuda,
                cost.signed_sum(S.c_coef, 3, 64, f32), [((3, 32, 8), f32)])
    if name == "strassen1":
        aq, bq = fake(2, 4, 16, 8), fake(2, 4, 8, 32)
        return (lambda: strassen1_matmul_cuda(aq, bq, out_dtype=b16), strassen1_matmul_cuda,
                cost.strassen1(2, 16, 8, 32, 7, f32, b16), [((2, 4, 16, 32), b16)])
    if name == "rmsnorm":
        x, w = fake(10, 256, dtype=b16), fake(256)
        return (lambda: rmsnorm_cuda(x, w), rmsnorm_cuda, cost.rmsnorm(10, 256, b16, f32),
                [((10, 256), b16)])
    if name == "rmsnorm_bwd":
        x, w, dy = fake(10, 256, dtype=b16), fake(256), fake(10, 256, dtype=b16)
        return (lambda: rmsnorm_bwd_cuda(x, w, dy), rmsnorm_bwd_cuda,
                cost.rmsnorm_bwd(10, 256, b16, f32), [((10, 256), b16), ((256,), f32)])
    if name in ("flash", "flash_lse"):
        q, k, v = fake(2, 8, 100, 64, dtype=b16), fake(2, 2, 100, 64, dtype=b16), fake(2, 2, 100, 64, dtype=b16)
        lse = name == "flash_lse"
        outs = [((2, 8, 100, 64), b16)] + ([((2, 8, 100), f32)] if lse else [])
        return (lambda: flash_attention_cuda(q, k, v, window=17, return_lse=lse), flash_attention_cuda,
                cost.flash(2, 8, 2, 100, 100, 64, True, 17, b16, lse), outs)
    if name == "flash_bwd":
        q, k, v = fake(1, 4, 50, 128, dtype=b16), fake(1, 4, 70, 128, dtype=b16), fake(1, 4, 70, 128, dtype=b16)
        o, lse, do = fake(1, 4, 50, 128, dtype=b16), fake(1, 4, 50), fake(1, 4, 50, 128, dtype=b16)
        return (lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=False), flash_attention_bwd_cuda,
                cost.flash_bwd(1, 4, 4, 50, 70, 128, False, None, b16),
                [((1, 4, 50, 128), b16), ((1, 4, 70, 128), b16), ((1, 4, 70, 128), b16)])
    b, s, h, dh = 2, 5, 4, 16
    wx, r = fake(b, s, 4, h, dh), fake(4, h, dh, dh)
    state = {k: fake(b, h, dh) for k in ("c", "n", "m", "h")}
    if name in ("slstm", "slstm_save"):
        save = name == "slstm_save"
        outs = [((b, s, h, dh), f32)] + ([((b, s, 4, h, dh), f32)] if save else [])
        return (lambda: (lambda o: [o[1]] + ([o[2]["pre"]] if save else []))(slstm_seq_cuda(wx, r, state, save=save)),
                slstm_seq_cuda, cost.slstm(b, s, h, dh, save), outs)
    hs, dhs = fake(b, s, h, dh), fake(b, s, h, dh)
    saved = {"pre": fake(b, s, 4, h, dh), **{k: fake(b, s, h, dh) for k in ("c", "n", "m")}}
    return (lambda: slstm_seq_bwd_cuda(r, state, hs, saved, dhs, dict(state))[:2], slstm_seq_bwd_cuda,
            cost.slstm_bwd(b, s, h, dh, dr=False), [((b, s, 4, h, dh), f32), ((4, h, dh, dh), f32)])


KERNEL_CASES = ["matmul", "batched_matmul", "divide", "combine", "strassen1", "rmsnorm", "flash",
                "flash_lse", "slstm", "slstm_save", "rmsnorm_bwd", "flash_bwd", "slstm_bwd",
                "divide_level", "combine_level"]


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_wrapper_records_its_cost_on_fake_tensors(name, monkeypatch):
    seen = _records(monkeypatch)
    call, fn, want, outs = _case(name)
    before = fn.launches
    with OA.OpAnalysis() as analysis:
        got = call()
    got = got if isinstance(got, (tuple, list)) else [got]
    assert seen == [(fn.__name__, want)]
    assert analysis.costs().launches == {fn.__name__: 1}
    assert [(tuple(t.shape), t.dtype) for t in got] == outs
    assert all(t.device == torch.device(DEV) for t in got)
    assert fn.launches == before  # the real run's count is the card's alone


def test_fake_tensor_with_no_analysis_raises():
    a = fake(8, 8)
    with OA.fake_mode(), pytest.raises(RuntimeError, match="fake tensor with no analysis"):
        matmul_cuda(a, a)


def test_real_tensor_under_an_analysis_raises():
    real = torch.ones(2, 2)  # made before the analysis's fake mode
    with OA.OpAnalysis(), pytest.raises(RuntimeError, match="real tensor under an analysis"):
        common.traced(matmul_cuda, cost.matmul(1, 2, 2, 2, torch.float32), real)
    assert common.traced(matmul_cuda, None, real) is False  # no analysis: launch


# The bounds chip_smoke.py printed before it read kernels/cost.py, at the shapes of its time lines.
N, H = 16384, 8192


@pytest.mark.parametrize("got,ops,nbytes", [
    (cost.strassen1(1, H, H, H, 7, torch.float32), 2 * 7 * H**3, 12 * H * H * 4),
    (cost.strassen1(7, H // 2, H // 2, H // 2, 7, torch.bfloat16), 2 * 7 * 7 * (H // 2) ** 3,
     3 * 7 * 4 * (H // 2) ** 2 * 2),
    (cost.strassen1(1, 512, 4096, 4096, 7, torch.float32),
     2 * 7 * 512 * 4096 * 4096, 4 * 4 * (512 * 4096 + 4096 * 4096) + 4 * 512 * 4096 * 4),
    (cost.signed_sum(S.a_coef, 1, H * H, torch.float32), 5 * H * H, 11 * H * H * 4),
    (cost.signed_sum(S.c_coef, 1, H * H, torch.bfloat16), 8 * H * H, 11 * H * H * 2),
    (cost.matmul(49, H // 2, H // 2, H // 2, torch.float32), 2 * 49 * (H // 2) ** 3, 3 * 49 * (H // 2) ** 2 * 4),
    (cost.matmul(1, H, H, H, torch.bfloat16), 2 * H**3, 3 * H * H * 2),
    (cost.rmsnorm(1024, 3072, torch.bfloat16, torch.float32), 3 * 1024 * 3072, 2 * 1024 * 3072 * 2 + 3072 * 4),
    (cost.rmsnorm_bwd(4096, 3072, torch.bfloat16, torch.float32), 10 * 4096 * 3072,
     3 * 4096 * 3072 * 2 + 2 * 3072 * 4),
    (cost.flash(1, 24, 8, 1024, 1024, 128, True, None, torch.bfloat16), 4 * 24 * 128 * 1024 * 1025 // 2,
     2 * 24 * 1024 * 128 * 2 + 2 * 8 * 1024 * 128 * 2),
    (cost.flash(1, 16, 1, 4096, 4096, 256, True, 2048, torch.bfloat16),
     4 * 16 * 256 * (2048 * 2049 // 2 + 2048 * 2048), 2 * 16 * 4096 * 256 * 2 + 2 * 4096 * 256 * 2),
    (cost.flash(4, 6, 6, 448, 1500, 64, False, None, torch.bfloat16), 4 * 4 * 6 * 448 * 1500 * 64,
     2 * 4 * 6 * 448 * 64 * 2 + 2 * 4 * 6 * 1500 * 64 * 2),
    (cost.flash_bwd(2, 24, 8, 4096, 4096, 128, True, None, torch.bfloat16),
     2.5 * (4 * 2 * 24 * 128 * (4096 * 4097 // 2)),
     (4 * 2 * 24 * 4096 * 128 + 4 * 2 * 8 * 4096 * 128) * 2 + 4 * 2 * 24 * 4096),
    (cost.slstm(1, 1024, 4, 512), 2 * 1024 * 4 * 4 * 512 * 512,
     4 * (1024 * 4 * 4 * 512 + 4 * 4 * 512 * 512 + 8 * 4 * 512 + 1024 * 4 * 512)),
    (cost.slstm_bwd(2, 1024, 4, 512), 2 * 2 * 4 * 2 * 1024 * 4 * 512 * 512,
     4 * (2 * 4 * 4 * 512 * 512 + 5 * 2048 * 4 * 512 + 2 * 2 * 1024 * 4 * 4 * 512 + 12 * 2 * 4 * 512)),
])
def test_cost_matches_the_bound_formulas(got, ops, nbytes):
    assert (got.ops, got.bytes) == (ops, nbytes)


def test_live_pairs_against_the_mask():
    for sq, sk, causal, window in [(7, 7, True, None), (9, 9, True, 3), (5, 8, True, None),
                                   (8, 5, True, 2), (6, 4, False, None)]:
        i, j = np.arange(sq)[:, None], np.arange(sk)[None, :]
        live = np.ones((sq, sk), bool)
        if causal:
            live &= i >= j
        if window is not None:
            live &= i - j < window
        assert cost.live_pairs(sq, sk, causal, window) == live.sum()


# ------------------------------------------------------------- against JAX
def test_naive_per_position_flops_equal_the_hlo_analyzer():
    n = 256
    jmesh = _jmesh((2, 4), ("data", "model"))
    shard = JNamedSharding(jmesh, JP(("data",), None))
    spec = jax.ShapeDtypeStruct((n, n), jnp.float32)
    text = jax.jit(functools.partial(jmatmul_cell._naive, mesh=jmesh), in_shardings=(shard, shard)
                   ).lower(spec, spec).compile().as_text()
    want = analyze_hlo(text).dot_flops
    assert want == 2 * n**3 / 8
    mesh = make_mesh((2, 4), ("data", "model"), device=DEV)
    a, b = fake(n, n), fake(n, n)
    _, costs = OA.analyze(tmatmul_cell.strategy_fn("naive", mesh), a, b, chips=8)
    assert sum(costs.pinned["flops_by_dtype"].values()) == want == costs.dot_flops


def test_shardmap_2d_all_reduce_bytes_equal_the_hlo_analyzer():
    n = 256
    jmesh = _jmesh((1, 7), ("rows", "mult"))
    spec = jax.ShapeDtypeStruct((n, n), jnp.float32)
    text = jax.jit(functools.partial(jdist.strassen_shardmap_2d, mesh=jmesh)).lower(spec, spec).compile().as_text()
    want = analyze_hlo(text).collective_by_kind
    mesh = make_mesh((1, 7), ("rows", "mult"), device=DEV)
    _, costs = OA.analyze(functools.partial(tdist.strassen_shardmap_2d, mesh=mesh), fake(n, n), fake(n, n),
                          chips=7)
    got = costs.collectives()
    assert got["all-reduce"] == want["all-reduce"] == 4 * (n // 2) * (n // 2) * 4
    assert got["total"] == got["all-reduce"]


def _port_leaves(path, shape, spec, cfg):
    """(port path, shape, spec) of a JAX leaf: a scan-stacked leaf
    (``groups/posJ/...``) is one per layer without its leading dim, a tail
    leaf is the layer after the groups'."""
    parts = path.split("/")
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    if cfg.is_encdec or not ({"groups", "tail"} & set(parts)):
        return [(path, shape, spec)]
    period = len(cfg.block_pattern)
    n_groups = cfg.n_layers // period
    if "groups" in parts:
        i = parts.index("groups")
        j = int(parts[i + 1][3:])
        return [("/".join(parts[:i] + ["layers", str(g * period + j)] + parts[i + 2:]), shape[1:], spec[1:])
                for g in range(shape[0])]
    i = parts.index("tail")
    return [("/".join(parts[:i] + ["layers", str(n_groups * period + int(parts[i + 1]))] + parts[i + 2:]),
             shape, spec)]


def _jax_leaves(shapes, shardings, cfg):
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    specs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda s: isinstance(s, JNamedSharding))
    for (key_path, leaf), sh in zip(flat, specs):
        for path, shape, spec in _port_leaves(JS.path_of(key_path), tuple(leaf.shape), sh.spec, cfg):
            out[path] = (shape, str(leaf.dtype), spec)
    return out


def _port_view(leaves, shardings):
    return {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."),
                tuple(shardings[p].spec) + (None,) * (t.ndim - len(shardings[p].spec)))
            for p, t in leaves.items()}


CELL_ARCHS = ["phi4_mini_3_8b", "olmoe_1b_7b", "xlstm_1_3b", "recurrentgemma_9b", "whisper_tiny",
              "qwen2_vl_72b"]


def _meshes():
    return _jmesh((4, 2), ("data", "model")), make_mesh((4, 2), ("data", "model"), device=DEV)


@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_train_cell_specs_match_jax(arch):
    jmesh, tmesh = _meshes()
    jcfg, tcfg = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    shape = "train_4k"
    js, jb, jssh, jbsh = JS.train_cell_specs(jcfg, jconfigs.SHAPES[shape], jmesh, JAdamWConfig())
    ts, tb, tssh, tbsh = TS.train_cell_specs(tcfg, tconfigs.SHAPES[shape], tmesh, AdamWConfig())
    assert _port_view(TS.named_leaves(ts), tssh) == _jax_leaves(js, jssh, tcfg)
    assert _port_view(TS.named_leaves(tb), tbsh) == _jax_leaves(jb, jbsh, tcfg)
    assert all(t.device == torch.device(DEV) for t in TS.named_leaves(ts).values())
    # parameter plus optimizer bytes a position holds == XLA's argument size per device
    compiled = jax.jit(lambda s: s, in_shardings=(jssh,), out_shardings=jssh).lower(js).compile()
    assert OA.argument_bytes(TS.named_leaves(ts), tssh) == compiled.memory_analysis().argument_size_in_bytes


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_serve_cell_specs_match_jax(arch, shape):
    jmesh, tmesh = _meshes()
    jcfg, tcfg = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    jp, jc, jb, jpsh, jcsh, jbsh = JS.serve_cell_specs(jcfg, jconfigs.SHAPES[shape], jmesh)
    tp, tc, tb, tpsh, tcsh, tbsh = TS.serve_cell_specs(tcfg, tconfigs.SHAPES[shape], tmesh)
    assert _port_view(TS.named_leaves(tp), tpsh) == _jax_leaves(jp, jpsh, tcfg)
    assert _port_view(TS.named_leaves(tb), tbsh) == _jax_leaves(jb, jbsh, tcfg)
    want = _jax_leaves(jc, jcsh, tcfg)
    got = _port_view(TS.named_leaves(tc), tcsh)
    # the port's cache position is int64, torch's index type, where JAX's is int32
    assert got.pop("pos") == ((), "int64", ()) and want.pop("pos") == ((), "int32", ())
    assert got == want


def test_mrope_positions_spec_matches():
    want = jfrontends.mrope_positions_spec(3, 17)
    got = tfrontends.mrope_positions_spec(3, 17)
    assert tuple(got.shape) == want.shape and str(got.dtype) == f"torch.{want.dtype}"
    assert got.device.type == "meta"


def test_argument_bytes_takes_the_largest_slab():
    mesh = make_mesh((4, 2), ("data", "model"), device=DEV)
    from repro_torch.core.mesh import P

    leaves = {"a": fake(343, 8), "b": fake(16, dtype=torch.bfloat16)}
    shardings = {"a": NamedSharding(mesh, P("data", "model")), "b": NamedSharding(mesh, P())}
    assert OA.argument_bytes(leaves, shardings) == 86 * 4 * 4 + 16 * 2


# --------------------------------------------------------------- the cells
def test_dryrun_cell_whisper_decode_single_pod():
    t0 = time.perf_counter()
    r = dryrun.run_cell("whisper_tiny", "decode_32k", "single")
    assert time.perf_counter() - t0 < 60
    assert not r.get("skipped")
    assert r["chips"] == 256
    t = r["roofline"]
    assert t["compute_s"] > 0 and t["memory_s"] > 0
    assert t["bottleneck"] in ("compute", "memory", "collective")
    assert r["cost_analysis"]["flops_per_device"] > 0
    # decode of a 39M-param model must be far below HBM capacity
    mem = r["memory"]
    assert mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] < 4 * 2**30
    assert r["hardware"]["name"] == "h100-sxm-80gb-700w"


def test_skip_policy_cell_returns_skip_record():
    r = dryrun.run_cell("gemma_7b", "long_500k", "single")
    assert r.get("skipped"), r


@pytest.fixture
def smoke_cells(monkeypatch, tmp_path):
    """Dry-run cells on the smoke configs over a 2 x 2 mesh, written under tmp_path."""
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(summarize, "DRYRUN_DIR", str(tmp_path))
    monkeypatch.setattr(tconfigs, "get_config", tconfigs.get_smoke_config)
    monkeypatch.setattr(dryrun, "get_config", tconfigs.get_smoke_config)
    monkeypatch.setattr(dryrun, "_mesh", lambda kind: make_mesh((2, 2), ("data", "model"), device=DEV))


@pytest.mark.parametrize("name", list(perf.VARIANTS))
def test_every_perf_variant_runs_on_a_smoke_cell(name, smoke_cells):
    arch = "xlstm_1_3b" if name.startswith("mlstm") else "olmoe_1b_7b"
    r = perf.run_variant(arch, "decode_32k", "single", perf.VARIANTS[name])
    assert r["tag"] == name and r["hypothesis"] == perf.VARIANTS[name].hypothesis
    assert r["roofline"]["bound_s"] > 0 and r["launches"]["rmsnorm_cuda"] > 0


def test_summarize_rows_have_the_jax_columns(smoke_cells):
    r = dryrun.run_cell("phi4_mini_3_8b", "prefill_32k", "single")
    dryrun.save_result(r)
    skip = dryrun.run_cell("gemma_7b", "long_500k", "single")
    dryrun.save_result(skip)
    cells = summarize.load("single")
    assert [c["shape"] for c in cells] == ["long_500k", "prefill_32k"]
    as_jax = {**r, "compile_seconds": r["trace_seconds"]}
    assert summarize.fmt_row(r) == jsummarize.fmt_row(as_jax)
    assert summarize.fmt_row(r, md=True) == jsummarize.fmt_row(as_jax, md=True)
    assert summarize.fmt_row(skip) == jsummarize.fmt_row(skip)
    assert len(summarize.HEADER) == len(summarize.fmt_row(r).split("  "))


def test_matmul_cell_writes_a_roofline(monkeypatch, tmp_path):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    r = tmatmul_cell.run_cell(1024, "2d_d1", "single")
    assert r["chips"] == 256 and r["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert (tmp_path / "matmul__n1024__2d_d1__single.json").exists()
    assert r["memory"]["argument_size_in_bytes"] == 2 * 1024 * 1024 * 2 // 16


@pytest.mark.parametrize("strategy", ["naive", "shardmap1", "shardmap3d", "bfs_d1", "bfs_d2",
                                      "bfsrep_d1", "2d_d1", "2d_d2"])
def test_every_matmul_cell_strategy_traces(strategy, monkeypatch, tmp_path):
    """Each strategy of strategy_fn on a 4 x 4 mesh of fake positions; the
    explicit grids take as many rows (sides) of 7 as divide a quadrant."""
    monkeypatch.setattr(tmatmul_cell, "make_production_mesh",
                        lambda multi_pod, device: make_mesh((4, 4), ("data", "model"), device=device))
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    r = tmatmul_cell.run_cell(768, strategy, "single")
    assert r["chips"] == {"shardmap1": 14, "shardmap3d": 7}.get(strategy, 16)
    assert r["flops_per_device"] > 0 and r["roofline"]["bound_s"] > 0


def test_cli_writes_the_cell(smoke_cells, tmp_path, capsys):
    dryrun.main(["--arch", "whisper_tiny", "--shape", "decode_32k", "--mesh", "single"])
    assert "all requested cells OK" in capsys.readouterr().out
    assert (tmp_path / "whisper_tiny__decode_32k__single.json").exists()


def test_configs_fields_the_variants_touch_exist():
    fields = {f.name for f in dataclasses.fields(tconfigs.get_config("phi4_mini_3_8b"))}
    for v in perf.VARIANTS.values():
        assert set(v.cfg_overrides) <= fields, v.name
