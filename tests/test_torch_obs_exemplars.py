"""Trace-id exemplars on the port's ``Summary`` against the JAX package's.

Both summaries take the same seeded observations with trace ids: the
slowest-5 rings, the snapshot's exemplars and the ``# exemplar:``
exposition line are equal, leaving out the wall-clock ``unix_ts``. The
history sampler reads a summary child's sketch into the store exactly as
the JAX sampler does. And a request served over HTTP files its trace id
in the request and HTTP latency summaries, where ``/debug/traces``
resolves it.
"""

import http.client
import json
import re
import time

import numpy as np
import pytest

from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu.obs import tsdb as jax_tsdb
from spark_rapids_ml_tpu_torch import PCAModel
from spark_rapids_ml_tpu_torch.obs import devmon, metrics, tracectx, tsdb
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
from spark_rapids_ml_tpu_torch.serve import (
    ModelRegistry,
    ServeEngine,
    start_serve_server,
)

N_FEAT = 13  # no JAX test compiles this width
TIMEOUT = 30.0
_TS_FIELD = re.compile(r" [0-9.]+$")


def _observations(seed, n=60):
    rng = np.random.default_rng(seed)
    values = rng.lognormal(-4.0, 1.0, size=n)
    # ties and repeats: the ring's eviction order must still agree
    values[rng.integers(0, n, size=n // 6)] = float(values.max())
    labels = [{"model": f"m{rng.integers(0, 2)}"} for _ in range(n)]
    tids = [f"{int(t):032x}" if rng.random() > 0.1 else None
            for t in rng.integers(1, 2 ** 62, size=n)]
    return [(float(v), tid, lab) for v, tid, lab in zip(values, tids, labels)]


def _both(seed):
    ours = metrics.MetricsRegistry()
    theirs = jax_metrics.MetricsRegistry()
    families = []
    for reg in (ours, theirs):
        families.append(reg.summary("sparkml_serve_request_latency_seconds",
                                    "per-request latency", ("model",)))
    for value, tid, labels in _observations(seed):
        for family in families:
            family.observe(value, trace_id=tid, **labels)
    return ours, theirs, families


def _no_ts(exemplars):
    return [{k: v for k, v in e.items() if k != "unix_ts"}
            for e in exemplars]


@pytest.mark.parametrize("seed", range(5))
def test_exemplar_rings_equal_the_reference(seed):
    ours, theirs, (s_ours, s_theirs) = _both(seed)
    assert metrics.Summary.EXEMPLAR_CAPACITY == \
        jax_metrics.Summary.EXEMPLAR_CAPACITY == 5
    for model in ("m0", "m1"):
        got = s_ours.exemplars(model=model)
        want = s_theirs.exemplars(model=model)
        assert _no_ts(got) == _no_ts(want)
        assert len(got) == 5
        assert [e["value"] for e in got] == sorted(
            (e["value"] for e in got), reverse=True)
        snap_ours = s_ours.snapshot_child(model=model)
        snap_theirs = s_theirs.snapshot_child(model=model)
        assert _no_ts(snap_ours.pop("exemplars")) == _no_ts(
            snap_theirs.pop("exemplars"))
        assert snap_ours == snap_theirs
    sample_ours = ours.snapshot()[s_ours.name]["samples"]
    sample_theirs = theirs.snapshot()[s_theirs.name]["samples"]
    assert [_no_ts(s["exemplars"]) for s in sample_ours] == \
        [_no_ts(s["exemplars"]) for s in sample_theirs]


@pytest.mark.parametrize("seed", range(3))
def test_exemplar_exposition_line_equals_the_reference(seed):
    ours, theirs, _ = _both(seed)

    def exemplar_lines(text):
        return [_TS_FIELD.sub("", line) for line in text.splitlines()
                if line.startswith("# exemplar:")]

    got = exemplar_lines(ours.prometheus_text())
    want = exemplar_lines(theirs.prometheus_text())
    assert got == want and len(got) == 2
    assert all(line.startswith(
        "# exemplar: sparkml_serve_request_latency_seconds{model=")
        for line in got)
    # the line sits after the child's quantile lines, before its _sum
    lines = ours.prometheus_text().splitlines()
    at = next(i for i, line in enumerate(lines)
              if line.startswith("# exemplar:"))
    assert 'quantile="0.99"' in lines[at - 1]
    assert lines[at + 1].startswith(
        "sparkml_serve_request_latency_seconds_sum")


def test_observe_without_trace_id_keeps_no_exemplar():
    reg = metrics.MetricsRegistry()
    summary = reg.summary("lat", "", ("model",))
    summary.observe(0.5, model="a")
    summary.observe(0.7, trace_id="", model="a")
    assert summary.exemplars(model="a") == []
    assert "# exemplar:" not in reg.prometheus_text()
    assert summary.sketch(model="a").count == 2


def test_sampler_reads_the_summary_sketch_as_the_reference_does():
    """The sampler records a summary's quantiles and ``_count`` from the
    child's sketch: the same observations give the same history as the
    JAX sampler's, before and after more observations arrive."""
    ours, theirs, (s_ours, s_theirs) = _both(7)
    samplers = [
        tsdb.MetricsSampler(tsdb.TimeSeriesStore(tiers=((1.0, 600.0),)),
                            registry=ours, interval_seconds=1.0),
        jax_tsdb.MetricsSampler(
            jax_tsdb.TimeSeriesStore(tiers=((1.0, 600.0),)),
            registry=theirs, interval_seconds=1.0),
    ]
    for sampler in samplers:
        sampler.sample_once(now=1000.0)
    for value, tid, labels in _observations(8, n=20):
        s_ours.observe(value * 10.0, trace_id=tid, **labels)
        s_theirs.observe(value * 10.0, trace_id=tid, **labels)
    for sampler in samplers:
        sampler.sample_once(now=1001.0)
    name = "sparkml_serve_request_latency_seconds"
    for metric in (name, f"{name}_count"):
        got = samplers[0].store.range_query(metric, window=60.0, now=1001.0)
        want = samplers[1].store.range_query(metric, window=60.0, now=1001.0)
        assert got == want
        assert got and all(len(s["points"]) == 2 for s in got)
    p99 = samplers[0].store.range_query(name, {"quantile": "0.99"},
                                        window=60.0, now=1001.0)
    assert {s["labels"]["model"] for s in p99} == {"m0", "m1"}
    for series in p99:
        sketch = s_ours.sketch(model=series["labels"]["model"])
        assert series["points"][-1][1] == sketch.quantile(0.99)


@pytest.fixture
def served(rng, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    # a registry of its own: the rings keep the 5 slowest observations,
    # and slower requests served earlier in this process (another test
    # file on the same worker) would otherwise crowd this request out
    monkeypatch.setattr(metrics, "_default_registry",
                        metrics.MetricsRegistry())
    tsdb.reset_tsdb()
    devmon.reset_device_monitor()
    basis = np.linalg.qr(rng.normal(size=(N_FEAT, 3)))[0]
    model = PCAModel.from_numpy(basis, [0.5, 0.3, 0.2]).setDtype("float64")
    registry = ModelRegistry()
    registry.register("pca_ex", model)
    engine = ServeEngine(registry, max_batch_rows=32, max_wait_ms=1)
    server = start_serve_server(engine, port=0)
    try:
        yield server.server_address[1], rng.normal(size=(8, N_FEAT))
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        tsdb.reset_tsdb()
        devmon.reset_device_monitor()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_served_request_files_its_trace_id_as_an_exemplar(served):
    port, x = served
    trace_id = tracectx.new_trace_id()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/predict", body=json.dumps(
            {"model": "pca_ex", "rows": x.tolist()}).encode(),
            headers={"Content-Type": "application/json",
                     "traceparent": f"00-{trace_id}-"
                                    f"{tracectx.new_span_id()}-01"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
    finally:
        conn.close()
    assert resp.status == 200 and body["trace_id"] == trace_id
    reg = get_registry()
    request = reg.summary("sparkml_serve_request_latency_seconds", "",
                          ("model",))
    assert trace_id in [e["trace_id"]
                        for e in request.exemplars(model="pca_ex")]
    stage = reg.summary("sparkml_serve_stage_latency_seconds", "",
                        ("model", "stage"))
    assert trace_id in [e["trace_id"] for e in
                        stage.exemplars(model="pca_ex", stage="queue")]
    # the HTTP summary is observed once the handler's reply is written
    http_summary = reg.summary("sparkml_http_request_latency_seconds", "",
                               ("path", "status"))
    end = time.monotonic() + TIMEOUT
    while trace_id not in [e["trace_id"] for e in http_summary.exemplars(
            path="/predict", status="200")]:
        assert time.monotonic() < end, "no HTTP exemplar"
        time.sleep(0.001)
    status, text = _get(port, "/metrics")
    assert status == 200
    assert "# exemplar: sparkml_serve_request_latency_seconds" \
        '{model="pca_ex"} trace_id="' in text.decode()
    status, doc = _get(port, f"/debug/traces?trace_id={trace_id}")
    assert status == 200 and json.loads(doc)["span_count"] >= 1
