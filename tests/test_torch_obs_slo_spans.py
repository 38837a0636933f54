"""The port's SLO burn rates, spans and trace context, held to the JAX
package's: the same injected clocks and seeded request streams give the
same windowed counts, burn rates, budgets, alerts and fast-burn signal;
the same span scenario assembles into the same tree; the same headers
parse to the same contexts. Each package keeps its own span recorder and
metrics registry, read separately."""

import json
import os
import threading
import time

import numpy as np
import pytest

from spark_rapids_ml_tpu.obs import get_registry as jax_registry
from spark_rapids_ml_tpu.obs import slo as jax_slo
from spark_rapids_ml_tpu.obs import spans as jax_spans
from spark_rapids_ml_tpu.obs import tracectx as jax_tracectx
from spark_rapids_ml_tpu_torch.obs import slo, spans, tracectx
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry


class _FakeClock:
    def __init__(self, t: float = 50_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _slo_sets(mod, clock):
    return mod.SloSet([
        mod.SLO("avail", target=0.999, kind="availability", clock=clock),
        mod.SLO("lat", target=0.99, kind="latency",
                latency_threshold_seconds=0.05, clock=clock),
    ], clock=clock)


# -- SLOs --------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_burn_rates_match_jax(seed):
    """Hours of seeded traffic (bursts of failures and slow requests)
    through both packages' SloSets on injected clocks: every burn rate,
    budget, alert and fast-burn reading is equal."""
    rng = np.random.default_rng(seed)
    clocks = (_FakeClock(), _FakeClock())
    sets = (_slo_sets(slo, clocks[0]), _slo_sets(jax_slo, clocks[1]))
    fired = set()
    for step in range(3000):
        dt = float(rng.exponential(4.0))
        bad = 0.3 if (step // 400) % 3 == 1 else 0.002
        ok = bool(rng.random() >= bad)
        latency = float(rng.exponential(0.02))
        n = int(rng.integers(1, 4))
        for s, c in zip(sets, clocks):
            c.advance(dt)
            s.record_request(ok, latency, n=n)
        if step % 50 == 0:
            ours, theirs = (s.snapshot() for s in sets)
            assert ours == theirs
            assert sets[0].fast_burn_rate() == sets[1].fast_burn_rate()
            assert sets[0].fast_burn_rate(min_total=0.0) == \
                sets[1].fast_burn_rate(min_total=0.0)
            assert sets[0].firing() == sets[1].firing()
            fired.update(a["severity"] for a in ours["alerts"])
    assert "page_fast" in fired  # the bursts did page


def test_windowed_counts_match_jax():
    rng = np.random.default_rng(5)
    clocks = (_FakeClock(), _FakeClock())
    counts = (slo.WindowedCounts(horizon_seconds=600.0, bucket_seconds=10.0,
                                 clock=clocks[0]),
              jax_slo.WindowedCounts(horizon_seconds=600.0,
                                     bucket_seconds=10.0, clock=clocks[1]))
    for _ in range(2000):
        dt = float(rng.exponential(2.0))
        good = bool(rng.random() < 0.9)
        for w, c in zip(counts, clocks):
            c.advance(dt)
            w.record(good)
        window = float(rng.choice([30.0, 300.0, 600.0]))
        assert counts[0].counts(window) == counts[1].counts(window)
    assert len(counts[0]._buckets) == len(counts[1]._buckets) <= 62


def test_fast_burn_floor_and_idle_service():
    clock = _FakeClock()
    s = _slo_sets(slo, clock)
    assert s.fast_burn_rate() == 0.0  # idle burns nothing
    for _ in range(5):
        s.record_request(False, 0.01)
    assert s.fast_burn_rate() == 0.0  # below the 20-request floor
    assert s.fast_burn_rate(min_total=0.0) == pytest.approx(1000.0)


def test_publish_writes_the_ports_registry_only():
    clock = _FakeClock()
    s = slo.SloSet([slo.SLO("port_only_slo", clock=clock)], clock=clock)
    for i in range(100):
        s.record_request(i % 10 != 0, 0.01)
    snap = s.publish()
    gauges = get_registry().snapshot()
    burn = {sm["labels"]["window"]: sm["value"]
            for sm in gauges["sparkml_slo_burn_rate"]["samples"]
            if sm["labels"]["slo"] == "port_only_slo"}
    assert burn == snap["slos"][0]["burn_rates"]
    assert burn["5m"] == pytest.approx(100.0)
    budget = [sm["value"] for sm in
              gauges["sparkml_slo_budget_remaining"]["samples"]
              if sm["labels"]["slo"] == "port_only_slo"]
    assert budget == [snap["slos"][0]["budget_remaining"]]
    firing = {sm["labels"]["severity"]: sm["value"] for sm in
              gauges["sparkml_slo_alert_firing"]["samples"]
              if sm["labels"]["slo"] == "port_only_slo"}
    assert firing == {"page_fast": 1.0, "page_slow": 1.0}
    theirs = jax_registry().snapshot().get("sparkml_slo_burn_rate",
                                           {"samples": []})
    assert not any(sm["labels"]["slo"] == "port_only_slo"
                   for sm in theirs["samples"])


@pytest.mark.parametrize("rate", [0.0, 0.5, 1.0, 5.9, 6.0, 14.39, 14.4, 99])
def test_severity_for_burn_matches_jax(rate):
    assert slo.severity_for_burn(rate) == jax_slo.severity_for_burn(rate)


def test_default_slos_read_the_port_prefix(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_SLO_AVAILABILITY_TARGET", "0.99")
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_SLO_LATENCY_TARGET", "0")
    monkeypatch.setenv("SPARK_RAPIDS_ML_TPU_SLO_WINDOW_HOURS", "1")
    s = slo.default_slos()
    assert [x.name for x in s] == ["serve_availability"]
    assert s.get("serve_availability").target == 0.99
    assert s.get("serve_availability").window_seconds == 6 * 3600.0
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_SLO_AVAILABILITY_TARGET")
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_SLO_LATENCY_TARGET")
    names = [x.name for x in slo.default_slos()]
    assert names == [x.name for x in jax_slo.default_slos()]


@pytest.mark.parametrize("kwargs", [
    {"target": 1.0}, {"target": 0.0}, {"kind": "throughput"},
    {"kind": "latency"},
])
def test_slo_rejects_bad_objectives(kwargs):
    with pytest.raises(ValueError):
        slo.SLO("x", **kwargs)
    with pytest.raises(ValueError):
        jax_slo.SLO("x", **kwargs)


# -- trace context -----------------------------------------------------------

HEADERS = [
    None, "", "garbage",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-00",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-03",
]


@pytest.mark.parametrize("header", HEADERS)
def test_parse_traceparent_matches_jax(header):
    ours = tracectx.parse_traceparent(header)
    theirs = jax_tracectx.parse_traceparent(header)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert ours.as_dict() == theirs.as_dict()
        assert ours.traceparent() == theirs.traceparent()


def test_context_plumbing_and_threads():
    ctx = tracectx.new_context(model="m")
    assert len(ctx.trace_id) == 32 and len(ctx.span_id) == 16
    child = ctx.child(hop="queue")
    assert child.trace_id == ctx.trace_id and child.span_id != ctx.span_id
    assert dict(child.baggage) == {"model": "m", "hop": "queue"}
    assert tracectx.capture() is None
    seen = {}
    with tracectx.activate(ctx):
        assert tracectx.ensure_context() is ctx
        inherit = tracectx.traced_thread(
            lambda: seen.setdefault("copy", tracectx.current_context()))
        fresh = tracectx.traced_thread(
            lambda: seen.setdefault("fresh", tracectx.current_context()),
            fresh=True)
        for t in (inherit, fresh):
            t.start()
            t.join(10)
        with tracectx.inflight_request(ctx, model="m") as handle:
            table = tracectx.inflight_requests()
            assert any(e["trace_id"] == ctx.trace_id
                       and e["info"] == {"model": "m"} for e in table)
    assert handle not in [e.get("seq") for e in
                          tracectx.inflight_requests()]
    assert seen == {"copy": ctx, "fresh": None}
    assert tracectx.current_context() is None
    with tracectx.activate(None) as none:
        assert none is None
    # the two packages' contextvars are distinct
    with tracectx.activate(ctx):
        assert jax_tracectx.current_context() is None


# -- spans -------------------------------------------------------------------


def _scenario(tc, sp):
    """A request root with a child span, a recorded admission event, a
    queue event filed by another thread, and a batch trace fanning in the
    request. Returns the request's trace id."""
    ctx = tc.new_context()
    with tc.activate(ctx), sp.span("serve:http:predict",
                                   trace_id=ctx.trace_id):
        with sp.span("serve:request:m", trace_id=ctx.trace_id, model="m"):
            t0 = time.perf_counter()
            sp.record_event("serve:admission", t0, time.perf_counter(),
                            trace_id=ctx.trace_id,
                            parent_span_id=sp.current_span_id(),
                            decision="admit_over_quota")
            handoff = tc.TraceContext(trace_id=ctx.trace_id,
                                      span_id=sp.current_span_id())

            def worker():
                sp.record_event("serve:queue:m", t0, time.perf_counter(),
                                trace_id=handoff.trace_id,
                                parent_span_id=handoff.span_id, rows=3)
                batch = tc.new_context()
                with tc.activate(batch), sp.span(
                        "serve:batch:m", trace_id=batch.trace_id,
                        links=(ctx.trace_id,), requests=1):
                    with sp.span("transform"):
                        pass

            t = threading.Thread(target=worker)
            t.start()
            t.join(10)
        with pytest.raises(KeyError):
            with sp.span("serve:retry:m"):
                raise KeyError("boom")
    return ctx.trace_id


def _shape(nodes):
    return [(n["name"], n.get("link", False),
             {k: v for k, v in n.get("args", {}).items()},
             _shape(n["children"])) for n in nodes]


def test_assembled_trace_matches_jax():
    ours = spans.assemble_trace(_scenario(tracectx, spans))
    theirs = jax_spans.assemble_trace(_scenario(jax_tracectx, jax_spans))
    assert ours["span_count"] == theirs["span_count"] == 7
    assert _shape(ours["spans"]) == _shape(theirs["spans"])
    (root,) = ours["spans"]
    assert root["name"] == "serve:http:predict"
    names = [c["name"] for c in root["children"]]
    assert names == ["serve:request:m", "serve:retry:m", "serve:batch:m"]
    retry = root["children"][1]
    assert retry["args"]["error"] == "KeyError"


def test_recorders_are_separate_and_traces_summarize():
    tid = _scenario(tracectx, spans)
    assert spans.get_recorder().events(tid)
    assert jax_spans.get_recorder().events(tid) == []
    summaries = spans.recent_traces(limit=50,
                                    name_prefix=("serve:http", "serve:req"))
    mine = [s for s in summaries if s["trace_id"] == tid]
    assert len(mine) == 1 and mine[0]["root"] == "serve:http:predict"
    batch = [s for s in spans.recent_traces(limit=50)
             if tid in s["links"]]
    assert batch and batch[0]["root"] == "serve:batch:m"


def test_open_span_shows_in_an_assembled_tree():
    ctx = tracectx.new_context()
    with tracectx.activate(ctx), spans.span("serve:http:predict"):
        spans.record_event("serve:admission", time.perf_counter(),
                           time.perf_counter(),
                           trace_id=ctx.trace_id,
                           parent_span_id=spans.current_span_id())
        tree = spans.assemble_trace(ctx.trace_id)
        assert spans.current_trace_id() == ctx.trace_id
    (root,) = tree["spans"]
    assert root["args"] == {"open": True}
    assert [c["name"] for c in root["children"]] == ["serve:admission"]
    assert spans.current_span_id() is None


# -- the span ring's Chrome-trace export ----------------------------------------


def _events(mod):
    """One fixed set of recorded events, in either package's SpanEvent."""
    return [
        mod.SpanEvent(name="serve:http:predict", ts_us=1000.123456,
                      dur_us=2500.98765, trace_id="a" * 16, depth=0, tid=7,
                      color="GREEN", args={"path": "/predict"},
                      span_id="s1", parent_span_id=None),
        mod.SpanEvent(name="serve:batch:m", ts_us=1500.0, dur_us=800.5,
                      trace_id="b" * 16, depth=1, tid=9, args={"rows": 3},
                      span_id="s2", parent_span_id="s1",
                      links=("a" * 16, "c" * 16)),
        mod.SpanEvent(name="untraced", ts_us=0.0004, dur_us=0.0, trace_id=None,
                      depth=0, tid=1),
    ]


@pytest.mark.parametrize("trace_id", [None, "a" * 16, "b" * 16, "missing"])
def test_chrome_trace_equals_the_jax_export(trace_id):
    """The same recorded events through both recorders: the same Chrome
    trace, the pid aside and the category naming each package."""
    docs = []
    for mod in (spans, jax_spans):
        rec = mod.SpanRecorder()
        for event in _events(mod):
            rec.record(event)
        doc = rec.chrome_trace(trace_id)
        for ev in doc["traceEvents"]:
            assert ev.pop("pid") > 0
            assert ev.pop("cat") == mod.__name__.split(".")[0]
        docs.append(doc)
    assert docs[0] == docs[1]


def test_chrome_trace_export_valid(tmp_path):
    rec = spans.SpanRecorder()
    ctx_tid = tracectx.new_trace_id()
    with spans.span("root", trace_id=ctx_tid, phase="demo") as tid:
        with spans.span("child"):
            pass
    for event in spans.get_recorder().events(tid):
        rec.record(event)
    path = rec.export_chrome_trace(str(tmp_path / "t.json"), trace_id=tid)
    doc = json.loads(open(path).read())
    events = doc["traceEvents"]
    assert len(events) == 2 and doc["displayTimeUnit"] == "ms"
    for ev in events:
        assert ev["ph"] == "X" and ev["cat"] == "spark_rapids_ml_tpu_torch"
        assert isinstance(ev["ts"], (int, float)) and ev["dur"] >= 0
        assert ev["args"]["trace_id"] == tid
    root = [e for e in events if e["name"] == "root"][0]
    child = [e for e in events if e["name"] == "child"][0]
    assert root["args"]["phase"] == "demo" and root["args"]["depth"] == 0
    assert child["args"]["parent_span_id"] == root["args"]["span_id"]
    assert root["dur"] >= child["dur"]
    rec.clear()
    assert rec.events() == []


def test_maybe_export_trace_env_gated(tmp_path, monkeypatch):
    # gate unset: no file, returns None
    monkeypatch.delenv(spans.TRACE_DIR_ENV, raising=False)
    with spans.span("gated") as tid:
        pass
    assert spans.trace_dir() is None
    assert spans.maybe_export_trace(tid, "algo") is None
    assert list(tmp_path.iterdir()) == []
    # gate set: file written, loadable, label sanitised
    monkeypatch.setenv(spans.TRACE_DIR_ENV, str(tmp_path / "traces"))
    path = spans.maybe_export_trace(tid, "algo/../x")
    assert path == str(tmp_path / "traces" / f"trace_algo____x_{tid}.json")
    doc = json.load(open(path))
    assert [e["name"] for e in doc["traceEvents"]] == ["gated"]
    # the JAX gate is a different variable, and names the file alike
    assert spans.TRACE_DIR_ENV == jax_spans.TRACE_DIR_ENV.replace(
        "SPARK_RAPIDS_ML_TPU_", "SPARK_RAPIDS_ML_TORCH_")
    monkeypatch.setenv(jax_spans.TRACE_DIR_ENV, str(tmp_path / "jax"))
    with jax_spans.span("gated") as jax_tid:
        pass
    jax_path = jax_spans.maybe_export_trace(jax_tid, "algo/../x")
    assert os.path.basename(jax_path).replace(jax_tid, tid) == \
        os.path.basename(path)


def test_maybe_export_trace_never_raises(tmp_path, monkeypatch):
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    monkeypatch.setenv(spans.TRACE_DIR_ENV, str(blocker / "traces"))
    assert spans.maybe_export_trace("t" * 16, "x") is None


def test_utcnow_iso_has_the_jax_shape():
    import re

    shape = re.compile(r"^\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\.\d{6}Z$")
    assert shape.match(spans.utcnow_iso())
    assert shape.match(jax_spans.utcnow_iso())
