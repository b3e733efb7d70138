"""repro_torch.obs: the tracer and metrics parts of tests/test_obs.py, on the port.

The wall-clock overhead guard of test_obs.py is left out so that no
timing-dependent test joins the count; the disabled fast path is checked by
identity with NULL_SPAN instead.
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import metrics as jmetrics
from repro_torch import obs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracer as obs_tracer


@pytest.fixture
def tracer():
    """A private enabled tracer (no global state)."""
    return obs_tracer.Tracer(enabled=True)


# -- tracer core -----------------------------------------------------------


def test_span_nesting_and_parents(tracer):
    with tracer.span("outer"):
        with tracer.span("mid", tag="012") as mid:
            with tracer.span("inner") as inner:
                assert tracer.current() is inner
            assert tracer.current() is mid
    assert tracer.current() is None
    spans = {sp.name: sp for sp in tracer.snapshot()}
    assert spans["inner"].parent_id == spans["mid"].span_id
    assert spans["mid"].parent_id == spans["outer"].span_id
    assert spans["outer"].parent_id is None
    assert spans["mid"].tag == "012"
    assert all(sp.t1 >= sp.t0 for sp in spans.values())


def test_end_tolerates_exception_unwinding(tracer):
    outer = tracer.begin("outer")
    tracer.begin("orphan")  # left open, as if an exception skipped its end
    tracer.end(outer)
    assert tracer.current() is None
    assert [sp.name for sp in tracer.snapshot()] == ["outer"]


def test_add_span_and_event_record_explicit_times(tracer):
    t = time.perf_counter()
    parent = tracer.begin("root")
    tracer.add_span("phase", t, t + 0.25, track="lane", parent=parent)
    tracer.event("mark")
    tracer.end(parent)
    phase = tracer.find("phase")[0]
    assert phase.duration == pytest.approx(0.25)
    assert phase.parent_id == parent.span_id
    mark = tracer.find("mark")[0]
    assert mark.cat == "instant" and mark.duration == 0.0
    assert mark.parent_id == parent.span_id


def test_disabled_mode_is_null_and_records_nothing():
    tr = obs_tracer.Tracer(enabled=False)
    s1 = tr.span("a")
    s2 = tr.span("b", tag="0", x=1)
    assert s1 is obs_tracer.NULL_SPAN and s2 is obs_tracer.NULL_SPAN
    with tr.span("c"):
        pass
    assert tr.add_span("d", 0.0, 1.0) is None
    assert tr.event("e") is None
    sp = tr.begin("f")
    tr.end(sp)
    assert sp.duration >= 0.0 and sp.t1 is not None
    assert tr.snapshot() == []


def test_max_spans_drops_and_counts(tracer):
    tracer.max_spans = 3
    for i in range(5):
        with tracer.span(f"s{i}"):
            pass
    assert len(tracer.snapshot()) == 3
    assert tracer.dropped == 2


def test_configure_is_identity_stable():
    tr = obs.get_tracer()
    assert obs.configure(enabled=True) is tr
    try:
        assert tr.enabled
    finally:
        obs.configure(enabled=False)


def test_profiler_annotations_open_record_function_ranges():
    tr = obs_tracer.Tracer(enabled=True, profiler_annotations=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("backend.matmul"):
            torch.ones(4) + 1
    assert "backend.matmul" in {e.key for e in prof.key_averages()}
    assert [sp.name for sp in tr.snapshot()] == ["backend.matmul"]
    assert obs.configure(profiler_annotations=True).profiler_annotations
    obs.configure(profiler_annotations=False)


# -- histogram math --------------------------------------------------------


def test_bucket_constants_match_reference():
    assert obs_metrics.TIME_BUCKETS_S == jmetrics.TIME_BUCKETS_S
    assert obs_metrics.BYTES_BUCKETS == jmetrics.BYTES_BUCKETS


def test_histogram_boundary_value_lands_in_bounding_bucket():
    h = obs_metrics.Histogram("t", bounds=(1.0, 2.0, 4.0))
    for v in (2.0, 1.0, 4.0, 5.0):
        h.record(v)
    snap = h.snapshot()
    by_le = {b["le"]: b["count"] for b in snap["buckets"]}
    assert by_le[1.0] == by_le[2.0] == by_le[4.0] == by_le["inf"] == 1
    assert snap["count"] == 4 and snap["min"] == 1.0 and snap["max"] == 5.0


def test_histogram_percentile_matches_numpy_exactly():
    rng = np.random.default_rng(7)
    xs = rng.exponential(0.05, size=257)
    h = obs_metrics.Histogram("t")
    for x in xs:
        h.record(float(x))
    for q in (0, 25, 50, 90, 99, 100):
        assert h.percentile(q) == float(np.percentile(xs, q))
    assert h.snapshot()["exact"] is True


def test_histogram_overflow_degrades_to_bucket_interpolation():
    h = obs_metrics.Histogram("t", bounds=(1.0, 2.0), max_samples=4)
    for v in (0.5, 0.6, 1.5, 1.6, 1.7, 1.8):
        h.record(v)
    assert h.snapshot()["exact"] is False
    assert 0.5 <= h.percentile(50) <= 2.0
    assert h.percentile(0) <= h.percentile(50) <= h.percentile(100)


def test_histogram_empty_and_reset():
    h = obs_metrics.Histogram("t")
    assert h.percentile(50) is None
    h.record(1.0)
    h.reset()
    assert h.count == 0 and h.percentile(50) is None


def test_histogram_snapshot_matches_reference():
    xs = np.random.default_rng(9).exponential(0.3, size=50)
    got, want = obs_metrics.Histogram("t"), jmetrics.Histogram("t")
    for x in xs:
        got.record(float(x))
        want.record(float(x))
    assert got.snapshot() == want.snapshot()


def test_metrics_registry_snapshot_is_jsonable():
    m = obs_metrics.Metrics()
    m.counter("c").inc(3)
    m.gauge("g").set(2.0)
    m.gauge("g").set(1.0)
    m.histogram("h").record(0.1)
    snap = m.snapshot()
    json.dumps(snap)
    assert snap["counters"]["c"] == 3
    assert snap["gauges"]["g"] == {"value": 1.0, "max": 2.0}
    assert snap["histograms"]["h"]["count"] == 1
    assert m.counter("c") is m.counter("c")
    m.reset()
    assert m.snapshot()["counters"]["c"] == 0
    assert obs.get_metrics() is obs.get_metrics()
