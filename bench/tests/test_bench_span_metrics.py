"""The readers of the program's stage and phase spans on hand-built digests:
the idle gaps each phase takes, the bytes the Strassen and accumulation
rooflines count against ``cost``, the leaf read under its span against the
leaf read by its shapes, and None when the trace holds no op under the
reader's span."""
import json
from types import SimpleNamespace

import pytest

from conftest import BENCH, ROOT
from harness import cost, peaks, spec
from harness.trace import Digest, DeviceOp

STARK = json.loads((BENCH / "configs" / "stark-16384.json").read_text())
PHI4 = json.loads((BENCH / "configs" / "phi4-mini-3.8b.json").read_text())["model"]
ACC8 = json.loads((BENCH / "traffic" / "train.s2048acc8.json").read_text())
NEW = ["strassen.leaf_roofline", "strassen.divide_roofline", "strassen.combine_roofline",
       "train.accumulate_roofline", "train.forward_idle", "train.backward_idle",
       "train.optimizer_idle"]
LEAF_SHAPES = ((49, 4096, 4096), (49, 4096, 4096))


def op(start, dur, *spans, shapes=()):
    return DeviceOp(name="k", start_ns=start, dur_ns=dur, cpu_op="", shapes=shapes,
                    spans=frozenset(spans))


def ctx_of(ops, config=None, **facts):
    digest = Digest(ops=ops, window_s=1.0, busy_s=1.0, breakdown={})
    return SimpleNamespace(cell=SimpleNamespace(config=config or STARK), digest=digest,
                           facts=facts, cost=cost, peaks=peaks)


def read(name, ctx):
    return spec.reader(BENCH, name)(ctx)


def test_new_metrics_are_entries_with_readers():
    entries = {m["name"]: m for m in spec.load(ROOT)["per_layer"]}
    for name in NEW:
        assert (BENCH / "metrics" / f"{name}.py").exists()
        assert entries[name]["better"] == ("lower" if name.endswith("_idle") else "higher")


def test_idle_gaps_go_to_the_op_that_ends_them():
    # Out of start order on purpose. Gaps: 10-15 (forward), 28-40 (backward),
    # 50-60 (an op under no phase), 100-130 (optimizer); 45 starts inside
    # 40-50 and takes none. Extent 0-140.
    ops = [op(40, 10, "train.backward"), op(0, 10, "train.forward"),
           op(15, 5, "train.forward", "bench.step"), op(18, 10, "train.backward"),
           op(130, 10, "train.optimizer"), op(45, 2, "train.optimizer"), op(60, 40)]
    ctx = ctx_of(ops)
    assert read("train.forward_idle", ctx) == pytest.approx(100 * 5 / 140)
    assert read("train.backward_idle", ctx) == pytest.approx(100 * 12 / 140)
    assert read("train.optimizer_idle", ctx) == pytest.approx(100 * 30 / 140)


def test_idle_with_no_gap_reads_zero():
    ops = [op(0, 10, "train.forward"), op(10, 10, "train.backward")]
    assert read("train.backward_idle", ctx_of(ops)) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_divide_and_combine_bytes_add_up_to_the_levels(dtype):
    ops = [op(0, 1_000_000_000, "backend.matmul", "strassen.divide"),
           op(2_000_000_000, 500_000_000, "backend.matmul", "strassen.combine")]
    ctx = ctx_of(ops, dtype=dtype, traced_multiplies=4)
    moved = {name: read(f"strassen.{name}_roofline", ctx) / 100 * secs
             * peaks.HBM_BYTES_PER_S / 4 for name, secs in (("divide", 1.0), ("combine", 0.5))}
    n = STARK["m"]
    assert moved["divide"] + moved["combine"] == pytest.approx(
        cost.strassen_level_bytes(n, n, n, 2, "strassen", dtype))
    # Every level moves 11 planes a block: A and B divide, C combines.
    assert moved["divide"] == pytest.approx(2 * moved["combine"])


def test_fp32_divide_least_time():
    # PERF.md's prediction: the fp32 divides' least bytes take 4.84 ms a multiply.
    ctx = ctx_of([op(0, 1_000_000_000, "strassen.divide")], dtype="float32", traced_multiplies=1)
    assert read("strassen.divide_roofline", ctx) / 100 == pytest.approx(4.84e-3, rel=2e-3)


def test_leaf_under_its_span_reads_as_the_leaf_by_its_shapes():
    ops = [op(0, 250_000_000, "backend.matmul", "strassen.leaf", shapes=LEAF_SHAPES),
           op(300_000_000, 30_000_000, "backend.matmul", "strassen.divide")]
    ctx = ctx_of(ops, dtype="float32", traced_multiplies=2)
    got = read("strassen.leaf_roofline", ctx)
    assert got == pytest.approx(read("multiply.leaf_roofline", ctx))
    assert got == pytest.approx(100 * 2 * 2 * 49 * 4096**3 / 67e12 / 0.25)


def test_accumulate_counts_zeroing_adds_and_divide():
    n = cost.dense_lm_params(PHI4)
    ctx = ctx_of([op(0, 200_000_000, "train.accumulate")], config={"model": PHI4},
                 model=PHI4, traffic=ACC8, traced_steps=2)
    moved = n * (4 + 8 * (2 + 4 + 4) + 8) * 2
    assert read("train.accumulate_roofline", ctx) == pytest.approx(
        100 * moved / peaks.HBM_BYTES_PER_S / 0.2)
    # The floor of one acc8 step's passes: about 106 ms.
    assert 0.105 < moved / 2 / peaks.HBM_BYTES_PER_S < 0.106


@pytest.mark.parametrize("name", NEW)
def test_none_without_an_op_under_the_span(name):
    facts = dict(dtype="float32", traced_multiplies=1, model=PHI4, traffic=ACC8, traced_steps=1)
    elsewhere = [op(0, 10, "backend.matmul", "train.step.body", shapes=LEAF_SHAPES)]
    assert read(name, ctx_of(elsewhere, **facts)) is None
    assert read(name, ctx_of([], **facts)) is None
