"""repro_torch.obs.export: the Perfetto export tests of tests/test_obs.py, on the port.

Also: the same spans give the same Chrome events as the reference exporter
(timestamps aside), ``torch.profiler`` starts and stops beside the spans, and
``launch/serve.py --backend auto --trace-out`` on the CPU writes a trace that
``validate_trace`` accepts, with the autotune resolutions in it.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.obs import export as jexport
from repro.obs import tracer as jtracer
from repro_torch import obs
from repro_torch.core import autotune, backend
from repro_torch.obs import export as obs_export
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracer as obs_tracer


@pytest.fixture
def tracer():
    """A private enabled tracer (no global state)."""
    return obs_tracer.Tracer(enabled=True)


def _record(tr):
    with tr.span("outer", cat="oot"):
        with tr.span("leaf", tag="03", track="oot.stage", m=4):
            pass
        tr.event("mark", tag="1")


def test_chrome_trace_schema(tracer, tmp_path):
    _record(tracer)
    path = str(tmp_path / "trace.json")
    obs_export.write_trace(path, tracer)
    assert obs_export.validate_trace(path) == []
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    ms = [e for e in events if e["ph"] == "M"]
    assert xs and ms
    for e in xs:
        assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0
        assert isinstance(e["dur"], (int, float)) and e["dur"] >= 0
        assert e["pid"] == obs_export.PID and isinstance(e["tid"], int)
    # the tag is folded into the event name (recursion-tree flame view)
    assert any(e["name"] == "leaf [03]" for e in xs)
    assert any(e.get("args", {}).get("tag") == "03" for e in xs)
    # named tracks get their own labeled lane
    lanes = {e["args"]["name"]: e["tid"] for e in ms}
    assert "oot.stage" in lanes
    leaf_ev = next(e for e in xs if e["name"] == "leaf [03]")
    outer_ev = next(e for e in xs if e["name"] == "outer")
    assert leaf_ev["tid"] == lanes["oot.stage"] != outer_ev["tid"]


def test_events_equal_reference_exporter():
    """The same spans in both packages' tracers give the same events and
    document, up to timestamps, durations and thread ids."""
    t_tr, j_tr = obs_tracer.Tracer(enabled=True), jtracer.Tracer(enabled=True)
    _record(t_tr)
    _record(j_tr)
    metrics = obs_metrics.Metrics()
    metrics.counter("c").inc(3)

    def strip(doc):
        evs = [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in doc["traceEvents"]]
        for e in evs:
            if e["ph"] == "M" and e["args"]["name"].startswith("thread-"):
                e["args"] = {"name": "thread"}
        return {**doc, "traceEvents": evs}

    got = obs_export.to_chrome_trace(t_tr, metrics)
    want = jexport.to_chrome_trace(j_tr)
    assert strip(got)["traceEvents"] == strip(want)["traceEvents"]
    assert got["displayTimeUnit"] == want["displayTimeUnit"] == "ms"
    assert got["otherData"]["metrics"]["counters"]["c"] == 3
    assert obs_export.PID == jexport.PID


def test_validate_trace_flags_malformed():
    assert obs_export.validate_trace({"traceEvents": []}) == ["empty traceEvents"]
    errs = obs_export.validate_trace(
        {"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": 0}]}
    )
    assert any("X without 'dur'" in e for e in errs)
    errs = obs_export.validate_trace({"traceEvents": [{"ph": "?", "name": "x"}]})
    assert any("unknown ph" in e for e in errs)
    assert obs_export.validate_trace({}) == ["no traceEvents array"]


def test_export_cli_roundtrip(tracer, tmp_path):
    with tracer.span("a"):
        pass
    good = str(tmp_path / "good.json")
    bad = str(tmp_path / "bad.json")
    obs_export.write_trace(good, tracer)
    with open(bad, "w") as f:
        json.dump({"traceEvents": [{"ph": "X"}]}, f)
    assert obs_export.main([good]) == 0
    assert obs_export.main([good, bad]) == 1


def test_write_jsonl(tracer, tmp_path):
    with tracer.span("a", tag="1"):
        pass
    path = str(tmp_path / "spans.jsonl")
    obs_export.write_jsonl(path, tracer)
    rows = [json.loads(line) for line in open(path)]
    assert rows[0]["name"] == "a" and rows[0]["tag"] == "1"
    assert rows[0]["dur"] >= 0.0


def test_profiler_trace_starts_and_stops(tmp_path):
    """The torch.profiler passthrough writes a Chrome trace into logdir; a
    second start while one runs, or a stop with none, returns False."""
    logdir = str(tmp_path / "prof")
    assert obs_export.start_profiler_trace(logdir)
    try:
        assert not obs_export.start_profiler_trace(logdir)
        torch.ones(64, 64) @ torch.ones(64, 64)
    finally:
        assert obs_export.stop_profiler_trace()
    assert not obs_export.stop_profiler_trace()
    files = os.listdir(logdir)
    assert files and all(f.endswith(".json") for f in files)
    with open(os.path.join(logdir, files[0])) as f:
        assert json.load(f)["traceEvents"]


def test_serve_backend_auto_trace_out_on_cpu(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve

    calib = autotune.Calibration(t_flop=1e-11, t_elem=1e-9, device_kind="cpu")
    monkeypatch.setattr(autotune, "_CALIBRATIONS", {"cpu": calib})
    monkeypatch.setattr(autotune, "_PROCESS_CACHES", {})
    backend.resolve_auto.cache_clear()
    obs.reset_tracing()
    path = str(tmp_path / "t.json")
    try:
        rc = serve.main(["--arch", "phi4_mini_3_8b", "--backend", "auto", "--trace-out", path,
                         "--device", "cpu", "--batch", "2", "--new-tokens", "3"])
    finally:
        obs.configure(enabled=False)
        obs.reset_tracing()
        backend.resolve_auto.cache_clear()
    assert rc == 0
    out = capsys.readouterr().out
    assert "served 2 requests" in out and f"wrote {path}" in out
    assert obs_export.validate_trace(path) == []
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"autotune.resolve", "backend.matmul"} <= names
