"""The port's stage and phase spans, and the tracer's clock, on the CPU.

The Strassen pipelines record ``strassen.divide``/``leaf``/``combine`` under
``backend.matmul``; the training step records ``train.forward``,
``train.backward``, ``train.accumulate`` and ``train.optimizer`` under
``train.step.body``, registers no hook and queues no callback with the
tracer off, and computes the same bits either way; each span's times map
onto ``torch.profiler``'s clock within 100 µs of its range.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs
from repro_torch import obs
from repro_torch.core import backend as tb
from repro_torch.kernels.strassen.ops import strassen_matmul_fused, strassen_matmul_stages
from repro_torch.obs import export as obs_export
from repro_torch.obs import tracer as obs_tracer
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step

M, K, N = 32, 24, 16
PHASES = ("train.forward", "train.backward", "train.accumulate", "train.optimizer")


@pytest.fixture
def tracing():
    obs.reset_tracing()
    obs.configure(enabled=True)
    yield obs.get_tracer()
    obs.configure(enabled=False)
    obs.reset_tracing()


def _operands():
    rng = np.random.default_rng(3)
    return (torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)),
            torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32)))


def _stages(tracer, root=None):
    """The strassen.* spans in time order, as (name, attrs), each checked to
    lie inside ``root`` and to have it as parent when given."""
    spans = sorted((s for s in tracer.snapshot() if s.name.startswith("strassen.")),
                   key=lambda s: s.t0)
    if root is not None:
        for s in spans:
            assert s.parent_id == root.span_id and root.t0 <= s.t0 <= s.t1 <= root.t1
    return [(s.name, s.attrs) for s in spans]


def _plane(level, rows, cols):
    half = 2 ** (level + 1)
    return (rows // half) * (cols // half)


# The depth-2 tree: level l divides rank^l blocks into quadrants of the
# level's plane (A's and B's), the leaf multiplies 49 blocks, combine level
# l takes rank^(l+1) products of the level's quadrant plane.
DEPTH2 = [
    ("strassen.divide", dict(level=0, blocks=1, plane=_plane(0, M, K) + _plane(0, K, N))),
    ("strassen.divide", dict(level=1, blocks=7, plane=_plane(1, M, K) + _plane(1, K, N))),
    ("strassen.leaf", dict(batch=49, m=M // 4, k=K // 4, n=N // 4)),
    ("strassen.combine", dict(level=1, blocks=49, plane=_plane(1, M, N))),
    ("strassen.combine", dict(level=0, blocks=7, plane=_plane(0, M, N))),
]


def test_strassen_stage_spans_under_backend_matmul(tracing):
    a, b = _operands()
    out = tb.matmul(a, b, tb.MatmulBackend(kind="strassen", depth=2, min_dim=4))
    (root,) = tracing.find("backend.matmul")
    assert _stages(tracing, root) == DEPTH2
    torch.testing.assert_close(out, a @ b, rtol=1e-4, atol=1e-4)


def test_stage_spans_on_the_kernel_pipeline(tracing):
    a, b = _operands()
    with tracing.span("caller") as root:
        out = strassen_matmul_stages(a, b, depth=2)
    assert _stages(tracing, root) == DEPTH2
    torch.testing.assert_close(out, a @ b, rtol=1e-4, atol=1e-4)


def test_fused_pipeline_gives_its_last_level_one_leaf_span(tracing):
    a, b = _operands()
    with tracing.span("caller") as root:
        out = strassen_matmul_fused(a, b, depth=2)
    assert _stages(tracing, root) == [
        DEPTH2[0],
        ("strassen.leaf", dict(batch=7, m=M // 2, k=K // 2, n=N // 2, fused=True)),
        DEPTH2[-1],
    ]
    torch.testing.assert_close(out, a @ b, rtol=1e-4, atol=1e-4)


def test_no_stage_spans_with_the_tracer_off():
    obs.reset_tracing()
    a, b = _operands()
    tb.matmul(a, b, tb.MatmulBackend(kind="strassen", depth=2, min_dim=4))
    strassen_matmul_stages(a, b, depth=2)
    assert obs.get_tracer().snapshot() == []


def _train(accum, steps=1, seed=0):
    cfg = dataclasses.replace(tconfigs.get_smoke_config("phi4_mini_3_8b"), remat=True)
    gen = torch.Generator().manual_seed(seed)
    state = init_train_state(cfg, AdamWConfig(), gen)
    step_fn = make_train_step(cfg, AdamWConfig(), accum_steps=accum)
    losses = []
    for _ in range(steps):
        tok = torch.randint(0, cfg.vocab, (4, 17), generator=gen)
        state, met = step_fn(state, {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
        losses.append(met["loss"])
    return state, losses


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_span_tree(tracing, accum):
    state, _ = _train(accum)
    spans = tracing.snapshot()
    (body,) = [s for s in spans if s.name == "train.step.body"]
    assert body.attrs == dict(accum=accum, step=1)
    by_name = {p: [s for s in spans if s.name == p] for p in PHASES}
    assert [len(by_name[p]) for p in PHASES] == [accum, accum, accum + 2 if accum > 1 else 0, 1]
    n_leaves = len(list(state.params.parameters()))
    elements = sum(p.numel() for p in state.params.parameters())
    for p in PHASES:
        for s in by_name[p]:
            assert s.parent_id == body.span_id and s.attrs["step"] == 1, p
            assert body.t0 <= s.t0 <= s.t1 <= body.t1, p
    for name in ("train.forward", "train.backward"):
        assert [s.attrs["mb"] for s in by_name[name]] == list(range(accum))
        assert all(s.attrs["tokens"] == 4 * 16 // accum for s in by_name[name])
    for s in by_name["train.accumulate"] + by_name["train.optimizer"]:
        assert (s.attrs["leaves"], s.attrs["elements"]) == (n_leaves, elements)
    # Each backward follows its forward, and remat's recompute nests in it.
    for fwd, bwd in zip(by_name["train.forward"], by_name["train.backward"]):
        assert fwd.t1 <= bwd.t0
    bwd_ids = {s.span_id for s in by_name["train.backward"]}
    assert any(s.name == "backend.matmul" and s.parent_id in bwd_ids for s in spans)
    assert tracing.current() is None


def test_tracer_on_and_off_give_the_same_bits():
    obs.reset_tracing()
    off_state, off_losses = _train(2, steps=2, seed=5)
    obs.configure(enabled=True)
    try:
        on_state, on_losses = _train(2, steps=2, seed=5)
    finally:
        obs.configure(enabled=False)
        obs.reset_tracing()
    assert all(torch.equal(a, b) for a, b in zip(off_losses, on_losses))
    for (name, p), q in zip(off_state.params.named_parameters(), on_state.params.parameters()):
        assert torch.equal(p, q), name
    for name in ("m", "v"):
        for a, b in zip(getattr(off_state.opt, name).values(),
                        getattr(on_state.opt, name).values()):
            assert torch.equal(a, b), name


class _CountingEngine:
    """Autograd's engine, counting the callbacks queued on it."""

    def __init__(self, engine):
        self.engine, self.queued = engine, 0

    def queue_callback(self, fn):
        self.queued += 1
        return self.engine.queue_callback(fn)

    def __getattr__(self, name):
        return getattr(self.engine, name)


def test_tracer_off_registers_no_hook_and_queues_no_callback(monkeypatch):
    engine = _CountingEngine(torch.autograd.Variable._execution_engine)
    monkeypatch.setattr(torch.autograd.Variable, "_execution_engine", engine)
    hooks = []
    real = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda self, fn: hooks.append(fn) or real(self, fn))
    obs.reset_tracing()
    _train(2)
    assert (len(hooks), engine.queued) == (0, 0)
    obs.configure(enabled=True)
    try:
        _train(2)
    finally:
        obs.configure(enabled=False)
        obs.reset_tracing()
    assert (len(hooks), engine.queued) == (2, 2)


def test_span_with_a_parent_closed_on_another_thread():
    tr = obs_tracer.Tracer(enabled=True)
    root = tr.begin("root")
    opened = []
    worker = threading.Thread(target=lambda: opened.append(tr.begin("child", parent=root)))
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive() and tr.current() is root
    tr.end(opened[0])  # closed on this thread, opened on the worker's
    assert tr.current() is root and tr._stacks[opened[0].thread] == []
    tr.end(root)
    child = tr.find("child")[0]
    assert child.parent_id == root.span_id and child.thread != root.thread
    assert tr.current() is None


def test_span_times_map_onto_the_profiler_clock():
    tr = obs_tracer.Tracer(enabled=True, profiler_annotations=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):  # the first range sets the profiler up
            pass
        with tr.span("clock.outer"):
            for _ in range(3):
                with tr.span("clock.inner"):
                    torch.ones(256, 256) @ torch.ones(256, 256)
    ranges = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("clock."))
    spans = sorted((tr.to_profiler_ns(s.t0), tr.to_profiler_ns(s.t1)) for s in tr.snapshot())
    assert len(ranges) == len(spans) == 4
    for (r0, r1), (s0, s1) in zip(ranges, spans):
        assert abs(s0 - r0) < 100_000 and abs(s1 - r1) < 100_000
    doc = obs_export.to_chrome_trace(tr)
    assert doc["otherData"]["clock"]["profiler_ns_at_ts_0"] == tr.profiler_epoch_ns
    first = min(tr.snapshot(), key=lambda s: s.t0)
    ts = min(e["ts"] for e in doc["traceEvents"] if e["ph"] == "X")
    assert abs(tr.profiler_epoch_ns + ts * 1e3 - tr.to_profiler_ns(first.t0)) < 1e3
