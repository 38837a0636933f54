"""The port's serving debug plane: ``/debug/traces``, ``/debug/slo``,
``/debug/history`` and ``/debug/profile`` behind a CPU port engine, and
the history sampler that ``start_serve_server`` starts.

Each route is held to the JAX package's functions and engine methods
called directly — never the JAX HTTP server, whose requests would mint
``path=`` children in the JAX registry that the JAX package's own tests
count. Every test that starts a server stops the sampler thread in its
teardown, and every profile capture is drained (``profiler.wait``); the
tests synchronise on ``sample_once``, the span ring and the capture's
state, never on sleeps."""

import http.client
import inspect
import json
import os
import re
import time

import numpy as np
import pytest

from spark_rapids_ml_tpu.obs import profiler as jax_profiler
from spark_rapids_ml_tpu.obs import spans as jax_spans
from spark_rapids_ml_tpu.obs import tracectx as jax_tracectx
from spark_rapids_ml_tpu.obs import tsdb as jax_tsdb
from spark_rapids_ml_tpu.serve import ModelRegistry as JaxRegistry
from spark_rapids_ml_tpu.serve import ServeEngine as JaxEngine
from spark_rapids_ml_tpu.serve import server as jax_server
from spark_rapids_ml_tpu.serve.breaker import CircuitBreaker as JaxBreaker
from spark_rapids_ml_tpu.serve.faults import FaultSpec as JaxFaultSpec
from spark_rapids_ml_tpu_torch import PCAModel
from spark_rapids_ml_tpu_torch.obs import (
    accounting,
    devmon,
    fitmon,
    profiler,
    spans,
    tracectx,
    tsdb,
)
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
from spark_rapids_ml_tpu_torch.serve import (
    ModelRegistry,
    ServeEngine,
    fault_plane,
    reset_fault_plane,
    start_serve_server,
)
from spark_rapids_ml_tpu_torch.serve import engine as engine_mod
from spark_rapids_ml_tpu_torch.serve import server as server_mod

TIMEOUT = 30.0
N_FEAT = 20  # no JAX test compiles this width
UNPORTED_SECTIONS = {"replicas", "rollout", "autoscale"}


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    reset_fault_plane()
    yield
    reset_fault_plane()


@pytest.fixture
def served(rng):
    """A float64 PCA model behind a port engine and server on an ephemeral
    port; the sampler the server started is stopped and dropped after,
    and the monitors it sweeps (devmon, fitmon's watchdog) are made anew,
    bound to the current registry."""
    tsdb.reset_tsdb()
    devmon.reset_device_monitor()
    fitmon.reset_fitmon()
    basis = np.linalg.qr(rng.normal(size=(N_FEAT, 4)))[0]
    model = PCAModel.from_numpy(basis, [0.4, 0.3, 0.2, 0.1]).setDtype(
        "float64")
    registry = ModelRegistry()
    registry.register("pca", model)
    engine = ServeEngine(registry, max_batch_rows=64, max_wait_ms=1)
    server = start_serve_server(engine, port=0)
    try:
        yield engine, server.server_address[1], rng.normal(size=(64, N_FEAT))
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        tsdb.reset_tsdb()
        devmon.reset_device_monitor()
        fitmon.reset_fitmon()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _predict(port, rows, trace_id=None, model="pca"):
    headers = {"Content-Type": "application/json"}
    if trace_id is not None:
        headers["traceparent"] = (f"00-{trace_id}-"
                                  f"{tracectx.new_span_id()}-01")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/predict", body=json.dumps(
            {"model": model, "rows": np.asarray(rows).tolist()}).encode(),
            headers=headers)
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200, body
        return body
    finally:
        conn.close()


def _until(predicate, timeout=TIMEOUT):
    end = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > end:
            raise AssertionError("condition not reached")
        time.sleep(0.001)


def _recorded(trace_id):
    """The HTTP span is filed when its handler exits, just after the reply
    was written: wait for it in the ring."""
    _until(lambda: any(e.name == "serve:http:predict"
                       for e in spans.get_recorder().events(trace_id)))


def _walk(nodes, depth=0):
    for node in nodes:
        yield depth, node
        yield from _walk(node["children"], depth + 1)


# -- /debug/traces -------------------------------------------------------------


def test_debug_traces_returns_trees_that_link_the_batch_span(served):
    _, port, x = served
    tid = tracectx.new_trace_id()
    _predict(port, x[:4], trace_id=tid)
    _recorded(tid)
    for i in range(3):  # more traces than the limit below
        _predict(port, x[i:i + 2])
    status, doc = _get(port, "/debug/traces?limit=3")
    assert status == 200 and len(doc["traces"]) == 3
    for tree in doc["traces"]:
        assert tree["spans"][0]["name"].startswith(
            server_mod._TRACE_ROOT_PREFIXES)
    status, doc = _get(port, "/debug/traces?limit=200")
    ours = [t for t in doc["traces"] if t["trace_id"] == tid]
    assert status == 200 and len(ours) == 1
    tree = ours[0]
    assert tree["spans"][0]["name"] == "serve:http:predict"
    nodes = [(d, n["name"], n.get("link", False), n.get("links", []))
             for d, n in _walk(tree["spans"])]
    assert (1, "serve:request:pca", False, []) in nodes
    assert (2, "serve:queue:pca", False, []) in nodes
    batch = [n for n in nodes if n[1] == "serve:batch:pca"]
    assert len(batch) == 1 and batch[0][2] is True and tid in batch[0][3]
    assert tree["span_count"] == len(nodes)
    # a bad limit falls back to the default, a small one is honoured
    assert len(_get(port, "/debug/traces?limit=junk")[1]["traces"]) <= 20
    assert len(_get(port, "/debug/traces?limit=0")[1]["traces"]) == 1


def test_debug_traces_by_id_and_after_eviction(served, monkeypatch):
    _, port, x = served
    ring = spans.SpanRecorder(capacity=64)
    monkeypatch.setattr(spans, "_recorder", ring)
    tid = tracectx.new_trace_id()
    _predict(port, x[:3], trace_id=tid)
    _recorded(tid)
    status, doc = _get(port, f"/debug/traces?trace_id={tid}")
    assert status == 200 and doc["trace_id"] == tid
    assert doc == json.loads(json.dumps(spans.assemble_trace(tid)))
    assert doc["spans"][0]["name"] == "serve:http:predict"
    for i in range(64):  # roll the ring over
        spans.record_event("filler", 0.0, 1e-6,
                           trace_id=tracectx.new_trace_id())
    status, doc = _get(port, f"/debug/traces?trace_id={tid}")
    assert status == 404 and doc["trace_id"] == tid
    assert "evicted" in doc["error"]
    assert _get(port, "/debug/traces?trace_id="
                + tracectx.new_trace_id())[0] == 404


class _Double:
    def transform(self, x):
        return np.asarray(x) * 2.0


def test_trace_tree_and_slo_match_the_jax_engine(monkeypatch):
    """One request through each package's engine (no server) under a
    trace context: the same tree below the request span, and the same
    SLO document. The JAX batch also files a ``serve:sync`` span, which
    the port's batcher does not."""
    monkeypatch.setenv("SPARK_RAPIDS_ML_TPU_SERVE_REPLICAS", "1")
    # a latency threshold no request misses, however loaded the machine
    for prefix in ("SPARK_RAPIDS_ML_TPU_SLO_", "SPARK_RAPIDS_ML_TORCH_SLO_"):
        monkeypatch.setenv(prefix + "LATENCY_THRESHOLD_MS", "600000")
    rows = np.arange(12.0).reshape(3, 4)
    shapes, slos = [], []
    for registry_cls, engine_cls, tc, sp in (
            (JaxRegistry, JaxEngine, jax_tracectx, jax_spans),
            (ModelRegistry, ServeEngine, tracectx, spans)):
        registry = registry_cls()
        registry.register("debug_twin", _Double())
        engine = engine_cls(registry, max_wait_ms=1)
        try:
            ctx = tc.new_context()
            with tc.activate(ctx):
                out = engine.predict("debug_twin", rows)
            assert np.array_equal(out, rows * 2.0)
            tree = sp.assemble_trace(ctx.trace_id)
            shapes.append([(d, n["name"], n.get("link", False))
                           for d, n in _walk(tree["spans"])
                           if not n["name"].startswith("serve:sync:")])
            slos.append(json.loads(json.dumps(engine.slo_snapshot())))
        finally:
            engine.shutdown()
    assert shapes[1] == shapes[0]
    assert shapes[1] == [(0, "serve:request:debug_twin", False),
                         (1, "serve:queue:debug_twin", False),
                         (1, "serve:batch:debug_twin", True)]
    assert slos[1] == slos[0]


# -- /debug/slo ----------------------------------------------------------------


def _jax_slo_sections():
    """The keys the JAX route adds to ``engine.slo_snapshot()``, read from
    its handler's source (the JAX server is never started here)."""
    source = inspect.getsource(jax_server.make_handler)
    return set(re.findall(r'snap\["(\w+)"\] =', source))


def test_debug_slo_is_the_jax_document_minus_the_unported_tiers(served):
    engine, port, x = served
    _predict(port, x[:4])
    spec = fault_plane().inject("ghost", "raise", count=3, start=2)
    status, doc = _get(port, "/debug/slo")
    assert status == 200
    added = _jax_slo_sections()
    assert UNPORTED_SECTIONS <= added
    assert set(doc) == (set(engine.slo_snapshot()) | added) - UNPORTED_SECTIONS
    assert set(doc) - added == {"slos", "alerts"}
    assert doc["models"] == ["pca"] and doc["closed"] is False
    assert doc["queue_depth"] == 0
    assert set(doc["breakers"]["pca"]) == set(JaxBreaker("pca").snapshot())
    assert doc["breakers"]["pca"]["state"] == "closed"
    want = JaxFaultSpec("ghost", "raise", count=3, start=2).as_dict()
    assert doc["faults"] == [spec.as_dict()]
    assert doc["faults"] == [{k: want[k] for k in spec.as_dict()}]
    reg = get_registry()
    for key, family in (("degraded_total", "sparkml_serve_degraded_total"),
                        ("retries_total", "sparkml_serve_retries_total"),
                        ("worker_restarts_total",
                         "sparkml_serve_worker_restarts_total")):
        assert doc[key] == reg.counter(family, "", ("model",)).total()
    assert set(doc["overload"]) == set(engine.overload_state())
    assert {s["name"] for s in doc["slos"]} == {"serve_availability",
                                                "serve_latency"}


def test_counter_total_sums_every_child():
    reg = get_registry()
    family = reg.counter("sparkml_debug_test_total", "", ("a",))
    before = family.total()
    family.inc(2, a="x")
    family.inc(0.5, a="y")
    assert family.total() == before + 2.5


# -- /debug/history ------------------------------------------------------------


def test_debug_history_serves_the_batch_seconds_after_sample_once(served):
    engine, port, x = served
    sampler = tsdb.get_sampler()
    assert sampler.running
    sampler.stop()  # own the cadence: sweeps at injected times only
    sweeps = sampler.sweeps
    # a model of its own: its series is born after the background
    # sweeps, so every point below is an injected sweep's
    engine.registry.register("pca_hist", engine.registry.resolve("pca"))
    t_base = time.time() - 20.0
    counter = get_registry().counter(
        "sparkml_serve_device_batch_seconds_total", "", ("model", "device"))
    for i in range(4):
        _predict(port, x[i * 8:i * 8 + 5], model="pca_hist")
        sampler.sample_once(now=t_base + i)
    path = ("/debug/history?name=sparkml_serve_device_batch_seconds_total"
            "&rate=1&model=pca_hist&window=60")
    status, doc = _get(port, path)
    assert status == 200 and doc["name"] == (
        "sparkml_serve_device_batch_seconds_total")
    assert [s["labels"] for s in doc["series"]] == [
        {"model": "pca_hist", "device": "cpu"}]
    points = doc["series"][0]["points"]
    assert [ts for ts, _ in points] == [float(int(t_base + i))
                                        for i in range(4)]
    assert points[-1][1] == counter.value(model="pca_hist",
                                          device="cpu") > 0
    assert doc["delta"] == pytest.approx(points[-1][1] - points[0][1])
    assert doc["rate_per_sec"] == pytest.approx(doc["delta"] / 3.0)
    assert len(doc["rate_series"][0]["points"]) == 3
    # the same series, as the store serves it
    assert doc["series"] == json.loads(json.dumps(tsdb.get_tsdb().range_query(
        "sparkml_serve_device_batch_seconds_total", {"model": "pca_hist"},
        60.0)))
    # no federated series yet: any host matches nothing
    assert _get(port, path + "&host=peer-1")[1]["series"] == []
    status, bundle = _get(port, "/debug/history?window=60")
    assert status == 200
    assert bundle["sampler"]["sweeps"] == sweeps + 4
    assert bundle["sampler"]["running"] is False
    mem = bundle["key"]["device_mem_bytes_in_use"]
    assert [s["labels"] for s in mem] == [{"device": "cpu",
                                           "source": "host_rss"}]
    busy = [s for s in bundle["key"]["device_busy_rate"]
            if s["labels"]["model"] == "pca_hist"]
    assert len(busy) == 1 and len(busy[0]["points"]) == 3
    assert any(s["labels"].get("model") == "pca_hist"
               for s in bundle["key"]["queue_depth"])


HISTORY_PARAMS = {
    "bundle": {},
    "bundle_window": {"window": ["60"]},
    "bad_window": {"window": ["junk"]},
    "huge_window": {"window": ["1e9"]},
    "tiny_window": {"window": ["0.01"]},
    "name": {"name": ["sparkml_serve_requests_total"]},
    "name_rate": {"name": ["sparkml_serve_requests_total"], "rate": ["1"]},
    "name_model": {"name": ["sparkml_serve_requests_total"],
                   "model": ["a"], "rate": ["true"]},
    "name_host": {"name": ["sparkml_serve_requests_total"],
                  "host": ["peer-1"]},
    "unknown_name": {"name": ["nope"], "rate": ["1"]},
    "gauge": {"name": ["sparkml_device_mem_bytes_in_use"], "window": ["30"]},
}


@pytest.mark.parametrize("case", sorted(HISTORY_PARAMS))
def test_history_document_equals_the_jax_document(case, monkeypatch):
    """The same records in both packages' process-wide stores, both read
    at one fixed instant: the two documents are equal."""
    now = 5000.5
    stores = []
    for module in (jax_tsdb, tsdb):
        module.reset_tsdb()
        store = module.get_tsdb()
        monkeypatch.setattr(store, "clock", lambda: now)
        stores.append(store)
    rng = np.random.default_rng(11)
    total = {"a": 0.0, "b": 0.0}
    try:
        for i in range(120):
            ts = now - 119 + i
            for store in stores:
                for model in ("a", "b"):
                    store.record("sparkml_serve_requests_total",
                                 {"model": model, "outcome": "ok"},
                                 total[model], kind="counter", now=ts)
                    store.record("sparkml_serve_queue_depth",
                                 {"model": model}, i % 5, now=ts)
                store.record("sparkml_device_mem_bytes_in_use",
                             {"device": "cuda:0", "source": "cuda"},
                             1e9 + i, now=ts)
                store.record("sparkml_serve_request_latency_seconds",
                             {"model": "a", "quantile": "0.99"}, 0.01 * i,
                             now=ts)
            total["a"] += float(rng.integers(0, 4))
            total["b"] = (0.0 if i == 60
                          else total["b"] + float(rng.integers(0, 2)))
        params = HISTORY_PARAMS[case]
        want = jax_server.history_document(params)
        got = server_mod.history_document(params)
        assert got == want
        assert set(got) == set(want)
    finally:
        jax_tsdb.reset_tsdb()
        tsdb.reset_tsdb()


# -- the sampler start_serve_server starts -------------------------------------


def test_server_starts_the_sampler_with_its_collectors(served):
    engine, port, x = served
    sampler = tsdb.get_sampler()
    assert sampler.running
    sampler.stop()
    names = [getattr(fn, "__name__", "") for fn in sampler._collectors]
    assert names == ["sample", "watchdog_collector", "publish_all_slos",
                     "publish", "_publish_queue_wait"]
    assert accounting.get_ledger().publish in sampler._collectors
    _predict(port, x[:4])
    sampler.sample_once()
    store = tsdb.get_tsdb()
    for name in ("sparkml_slo_budget_remaining",
                 server_mod.QUEUE_WAIT_SERIES,
                 "sparkml_device_mem_bytes_in_use",
                 "sparkml_fit_backend_ok",
                 "sparkml_obs_overhead_seconds_total"):
        assert store.range_query(name, window=60.0), name
    # the sweep republished the engine's (decaying) queue-wait estimate
    waited = store.range_query(server_mod.QUEUE_WAIT_SERIES, window=60.0)
    assert waited[0]["points"][-1][1] == get_registry().gauge(
        server_mod.QUEUE_WAIT_SERIES).value() > 0.0
    # a closed engine stops publishing: the queue-wait collector leaves
    engine.shutdown()
    sampler.sample_once()
    assert [getattr(fn, "__name__", "") for fn in sampler._collectors] == [
        "sample", "watchdog_collector", "publish_all_slos", "publish"]


def test_publish_all_slos_publishes_live_engines_only(monkeypatch):
    registry = ModelRegistry()
    registry.register("slo_pub", _Double())
    live, closed = (ServeEngine(registry, max_wait_ms=1) for _ in range(2))
    calls = []
    for label, eng in (("live", live), ("closed", closed)):
        monkeypatch.setattr(eng.slo, "publish",
                            lambda reg, _l=label: calls.append(_l))
    closed.shutdown()
    try:
        assert live in engine_mod._live_engines
        engine_mod.publish_all_slos()
        assert calls.count("live") == 1 and "closed" not in calls
    finally:
        live.shutdown()


# -- /debug/profile ----------------------------------------------------------------


def _post(port, path, body=b""):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Length": str(len(body))})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture
def profiling(served, tmp_path, monkeypatch):
    """The served engine with the profile dir in ``tmp_path``; every
    capture drained after."""
    monkeypatch.setenv(profiler.PROFILE_DIR_ENV, str(tmp_path / "profiles"))
    profiler.wait(TIMEOUT)
    yield served
    profiler.stop_capture()
    profiler.wait(TIMEOUT)


def test_debug_profile_get_has_the_jax_route_keys(profiling):
    _, port, _ = profiling
    status, doc = _get(port, "/debug/profile")
    # the JAX route's body, from the JAX functions it calls
    jax_doc = {"active": jax_profiler.capture_active(),
               "last": jax_profiler.last_capture(),
               "dir": jax_profiler.profile_dir()}
    assert status == 200 and set(doc) == set(jax_doc)
    assert doc["dir"] == profiler.profile_dir()
    assert doc["active"] is None


def test_debug_profile_post_runs_a_single_flight_cpu_capture(profiling):
    """POST starts a real CPU capture (200), a second POST while it runs
    gets 409 naming it, and once drained GET reports ``ok`` with both
    traces."""
    _, port, x = profiling
    counter = get_registry().counter("sparkml_http_requests_total", "",
                                     ("path", "status"))
    before = counter.value(path="/debug/profile", status="409")
    status, doc = _post(port, "/debug/profile?seconds=60&label=http")
    assert status == 200, doc
    info = doc["started"]
    assert info["id"].startswith("http_") and info["seconds"] == 60.0
    assert set(info) == {k.replace("jax_", "torch_") for k in (
        "id", "path", "seconds", "jax_enabled", "fit_run_id")}
    status, busy = _post(port, "/debug/profile?seconds=1")
    assert status == 409 and busy["active"]["id"] == info["id"]
    # the handler counts a request after writing its reply
    _until(lambda: counter.value(path="/debug/profile",
                                 status="409") == before + 1)
    # the first start in a process takes seconds: stop once it runs
    _until(lambda: (profiler.capture_active() or {}).get("torch_trace"))
    _predict(port, x[:4])
    profiler.stop_capture()
    profiler.wait(TIMEOUT)
    status, doc = _get(port, "/debug/profile")
    last = doc["last"]
    assert status == 200 and doc["active"] is None
    assert last["id"] == info["id"]
    assert last["torch_outcome"] == "ok" and last["torch_trace"] is True
    names = sorted(os.path.basename(a["path"]) for a in last["artifacts"])
    assert names == sorted([f"spans_{info['id']}.json",
                            f"torch_{info['id']}.json"])
    for artifact in last["artifacts"]:
        with open(artifact["path"]) as f:
            assert json.load(f)["traceEvents"]


def test_debug_profile_post_drains_its_body(profiling, monkeypatch):
    """Parameters ride the query string; a body is read and discarded,
    so the same keep-alive connection serves the next request."""
    import torch

    monkeypatch.setattr(torch.profiler, "profile", _InstantProfile)
    _, port, _ = profiling
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/debug/profile?seconds=0.05&label=body",
                     body=b'{"ignored": true}',
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()
        resp.read()
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["status"]
    finally:
        conn.close()
    profiler.wait(TIMEOUT)
    assert profiler.last_capture()["id"].startswith("body_")


def test_debug_profile_post_without_a_device_is_500(profiling, monkeypatch):
    import torch

    _, port, _ = profiling
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    status, doc = _post(port, "/debug/profile?seconds=1")
    assert status == 500 and "no CUDA device" in doc["error"]
    assert profiler.capture_active() is None


class _InstantProfile:
    """``torch.profiler.profile`` with an instant start and stop."""

    def __init__(self, **_):
        pass

    def start(self):
        pass

    def stop(self):
        pass

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": [{"ph": "X", "cat": "cpu_op",
                                        "name": "aten::mm", "ts": 0,
                                        "dur": 1}]}, f)
