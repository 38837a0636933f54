"""The port's incident drill over its HTTP server, twin of the JAX
package's ``tests/test_serve_incidents.py``.

With the process-wide sampler driven by ``sample_once`` on an injected
clock, a ``latency`` fault opens exactly one ``serve_p99_spike`` incident
two sweeps after it starts; its bundle holds the implicated series'
history, a flight dump and a trace tree seeded from an exemplar; and it
resolves after the fault clears, with the detector sweep's cost counted
and no thread of its own. Then ``/debug/incidents``' catalog and keys
against the JAX engine's, the kill switch, and the fault plane's
``latency`` kind. No sleeps and no waits on wall time: every step waits
on a response or runs a sweep itself.
"""

import gc
import http.client
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from spark_rapids_ml_tpu.obs import anomaly as jax_anomaly
from spark_rapids_ml_tpu.obs import incidents as jax_incidents
from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu.obs import tsdb as jax_tsdb
from spark_rapids_ml_tpu.serve.faults import FaultSpec as JaxFaultSpec
from spark_rapids_ml_tpu_torch import PCAModel
from spark_rapids_ml_tpu_torch.obs import (
    accounting,
    devmon,
    flight,
    incidents,
    metrics,
    profiler,
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
from spark_rapids_ml_tpu_torch.serve import faults as faults_mod

N_FEAT = 17  # no JAX test compiles this width
TIMEOUT = 60.0
MODEL = "pca_inc"
LATENCY = "sparkml_serve_request_latency_seconds"


def _fresh_singletons():
    """Objects that bind metric families when first built: dropped, so
    the next one binds to whichever registry is current."""
    tsdb.reset_tsdb()
    devmon.reset_device_monitor()
    reset_fault_plane()
    accounting.reset_ledger()
    incidents.reset_incident_engine()


@pytest.fixture
def served_incident_pca(rng, tmp_path, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    monkeypatch.setenv(flight.DUMP_DIR_ENV, str(tmp_path / "dumps"))
    monkeypatch.delenv(profiler.PROFILE_DIR_ENV, raising=False)
    monkeypatch.delenv(incidents.ENABLED_ENV, raising=False)
    # No guarded capture here: a CPU torch.profiler whose first start
    # outlasts its window under load ends wedged and holds its helper
    # thread into the next test. The card's drill (chip_smoke.py phase 11,
    # tests/test_torch_gpu.py) captures; the single-flight guard is held
    # in tests/test_torch_obs_incidents.py.
    monkeypatch.setenv(incidents.CAPTURE_ENV, "0")
    # A registry of the drill's own, as a fresh server process has: the
    # bundle's trace trees start from the slowest exemplars in the
    # registry, and another test's slow requests must not be those.
    monkeypatch.setattr(metrics, "_default_registry",
                        metrics.MetricsRegistry())
    gc.collect()  # dead engines from other tests publish no SLO gauges
    _fresh_singletons()
    basis = np.linalg.qr(rng.normal(size=(N_FEAT, 4)))[0]
    model = PCAModel.from_numpy(basis, [0.4, 0.3, 0.2, 0.1]).setDtype(
        "float64")
    registry = ModelRegistry()
    registry.register(MODEL, model)
    engine = ServeEngine(registry, max_batch_rows=64, max_wait_ms=2)
    server = start_serve_server(engine, port=0)  # sampler + incidents
    try:
        yield engine, server.server_address[1], rng.normal(size=(512, N_FEAT))
    finally:
        fault_plane().clear()
        server.shutdown()
        server.server_close()
        engine.shutdown()
        profiler.wait(30.0)
        flight.unregister_dump_section("metrics_history")
        _fresh_singletons()


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _get(port, path):
    status, body = _request(port, "GET", path)
    assert status == 200, body
    return json.loads(body)


def _predict(port, x, i, n=8):
    start = (i * 13) % (x.shape[0] - n)
    status, body = _request(
        port, "POST", "/predict",
        body=json.dumps({"model": MODEL,
                         "rows": x[start:start + n].tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    assert status == 200, body
    return json.loads(body)


def _walk(nodes):
    for node in nodes:
        yield node
        yield from _walk(node["children"])


# Healthy requests served before the drill's first sweep. The p99 spike
# detector compares the newest p99 in its lookback with the oldest, and the
# p99 is a sketch quantile over every request served so far: drawn from the
# first sweep's two requests, that anchor is a cold sample, and on a loaded
# machine the baseline's own tail then climbed past 2× it and +20 ms, so the
# detector fired during the baseline and the incident opened a sweep early
# (ten 8-thread matmul processes beside the drill reproduced it). A server
# in service has a history; with one of 120 requests the anchor carries the
# load's tail too. 120 + 40 baseline + 4 slow requests keeps the 4 slow ones
# above the p99 (at most 301 requests do).
WARMUP_REQUESTS = 120


# A CPU-bound child's body: multithreaded matmuls until it is stopped (or
# for two minutes at most).
BURN = """
import time, torch
torch.set_num_threads(4)
a = torch.randn(1024, 1024)
end = time.monotonic() + 120.0
while time.monotonic() < end:
    a @ a
"""


def test_latency_fault_opens_one_incident_with_bundle_then_resolves(
        served_incident_pca):
    _latency_drill(*served_incident_pca)


def test_latency_drill_holds_beside_a_cpu_bound_process(served_incident_pca):
    """The same drill, as strict, beside two CPU-bound processes of its own
    (multithreaded matmuls) for its whole length."""
    burners = [subprocess.Popen([sys.executable, "-c", BURN],
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
               for _ in range(2)]
    try:
        _latency_drill(*served_incident_pca)
    finally:
        for p in burners:
            p.kill()
        for p in burners:
            p.wait(30.0)


def _latency_drill(engine, port, x):
    # Own the cadence: stop the background thread and drive the SAME
    # process-wide sampler (the incident engine on its post-sweep hook)
    # under an injected clock, in the past so every point lies inside
    # the windows a flight dump reads on the wall clock.
    sampler = tsdb.get_sampler()
    sampler.stop()
    inc_engine = incidents.get_incident_engine()
    store = tsdb.get_tsdb()
    t_base = time.time() - 120.0
    overhead = get_registry().counter(
        "sparkml_obs_overhead_seconds_total", "", ("component",))
    injected = get_registry().counter(
        "sparkml_serve_faults_injected_total", "", ("model", "kind"))
    anomaly_cost_before = overhead.value(component="anomaly")

    # -- warm-up, then the baseline: healthy traffic, two requests a sweep,
    # 20 sweeps --------------------------------------------------------------
    for i in range(WARMUP_REQUESTS):
        _predict(port, x, 200 + i)
    for i in range(20):
        _predict(port, x, 2 * i)
        _predict(port, x, 2 * i + 1)
        sampler.sample_once(now=t_base + i)
    assert inc_engine.sweeps >= 20  # detection ran inside every sweep
    assert _get(port, "/debug/incidents")["open"] == []
    (p99,) = store.range_query(LATENCY, {"model": MODEL, "quantile": "0.99"},
                               60.0, now=t_base + 19)
    baseline_p99 = p99["points"][-1][1]

    # -- the fault: a delay read off the store's own baseline p99 --------
    # This sizes the fault against test load, not around a defect: under
    # a loaded machine the baseline p99 itself grows, and a fixed 150 ms
    # could then sit inside the noise of a healthy tail.
    delay = max(3.0 * baseline_p99, 0.15)
    fault_plane().inject(MODEL, "latency", count=None, seconds=delay)
    slow = [_predict(port, x, 100 + i) for i in range(4)]
    assert injected.value(model=MODEL, kind="latency") == 4

    # exactly two sweep cadences later the incident is open
    sampler.sample_once(now=t_base + 21)
    assert _get(port, "/debug/incidents")["open"] == []  # hysteresis
    sampler.sample_once(now=t_base + 22)
    doc = _get(port, "/debug/incidents")
    assert len(doc["open"]) == 1, doc["open"]
    assert doc["opened_total"] == 1
    incident = doc["open"][0]
    assert incident["detector"] == "serve_p99_spike"
    assert incident["kind"] == "latency"
    assert incident["labels"]["model"] == MODEL
    assert incident["opened_ts"] == t_base + 22
    # the p99 is a sketch quantile, within its relative error alpha
    assert incident["value"] >= delay * (1 - 0.01) > incident["baseline"]

    # continued firing dedups into the same incident
    sampler.sample_once(now=t_base + 23)
    doc = _get(port, "/debug/incidents")
    assert len(doc["open"]) == 1 and doc["opened_total"] == 1
    assert doc["open"][0]["id"] == incident["id"]
    assert doc["open"][0]["updates"] == 1

    # -- the evidence bundle ---------------------------------------------
    evidence = incident["evidence"]
    bundle = evidence["dir"]
    assert os.path.isdir(bundle)
    with open(os.path.join(bundle, "history.json")) as f:
        history = json.load(f)
    implicated = history["implicated"]
    assert implicated["metric"] == LATENCY
    assert implicated["series"], "implicated series history missing"
    assert all(s["points"] for s in implicated["series"])
    assert evidence["flight_dump"] and os.path.isfile(
        evidence["flight_dump"])
    with open(os.path.join(bundle, "traces.json")) as f:
        traces = json.load(f)
    assert traces["trees"], "bundle carries no assembled trace tree"
    names = [node["name"] for node in _walk(traces["trees"][0]["spans"])]
    assert any(name.startswith("serve:") for name in names), names
    # the trees are seeded from exemplars: the slowest is an injected
    # request, and its trace resolves through /debug/traces
    exemplar_ids = [e["trace_id"] for e in traces["exemplars"]]
    assert traces["trees"][0]["trace_id"] in exemplar_ids
    slowest = traces["exemplars"][0]
    assert slowest["value"] >= delay
    assert slowest["trace_id"] in {r["trace_id"] for r in slow}
    tree = _get(port, f"/debug/traces?trace_id={slowest['trace_id']}")
    assert tree["span_count"] >= 1
    status, text = _request(port, "GET", "/metrics")
    assert status == 200
    assert f'# exemplar: {LATENCY}{{model="{MODEL}"}} trace_id=' \
        in text.decode()
    assert evidence["profile"] == {"skipped": "disabled"}

    # -- cost and threading contracts ------------------------------------
    assert overhead.value(component="anomaly") > anomaly_cost_before
    assert not [t for t in threading.enumerate()
                if "incident" in t.name.lower()
                or "anomaly" in t.name.lower()]

    # -- recovery: fault cleared, p99 plateaus, incident auto-resolves ---
    fault_plane().clear()
    for i in range(70):  # age the jump out of the 60 s lookback
        sampler.sample_once(now=t_base + 24 + i)
    doc = _get(port, "/debug/incidents")
    assert doc["open"] == []
    assert doc["resolved_total"] == 1
    (resolved,) = [r for r in doc["recent"] if r["id"] == incident["id"]]
    assert resolved["state"] == "resolved"
    assert resolved["resolved_ts"] > resolved["opened_ts"]
    with open(os.path.join(bundle, "incident.json")) as f:
        assert json.load(f)["state"] == "resolved"


def _jax_snapshot_keys():
    reg = jax_metrics.MetricsRegistry()
    engine = jax_incidents.IncidentEngine(
        store=jax_tsdb.TimeSeriesStore(tiers=((1.0, 60.0),)),
        registry=reg,
        manager=jax_incidents.IncidentManager(registry=reg,
                                              capture_seconds=0.0))
    return set(engine.snapshot())


def test_incidents_endpoint_catalog_and_keys(served_incident_pca,
                                             monkeypatch):
    engine, port, x = served_incident_pca
    doc = _get(port, "/debug/incidents")
    assert set(doc) == _jax_snapshot_keys()
    monkeypatch.delenv(jax_anomaly.WINDOW_ENV, raising=False)
    assert doc["detectors"] == [
        d.describe() for d in jax_anomaly.builtin_detectors()]
    assert {d["name"] for d in doc["detectors"]} == {
        "serve_p99_spike", "serve_queue_depth", "serve_error_rate",
        "device_mem_in_use", "breaker_flap", "slo_fast_burn",
        "serve_replica_degraded", "serve_canary_regressed",
        "fit_backend_degraded", "fleet_host_down",
    }
    assert doc["open_after"] >= 1 and doc["resolve_after"] >= 1
    assert doc["evidence_root"] == os.path.join(flight.dump_dir(),
                                                "incidents")
    # the engine is installed on the server's sampler, after its
    # collectors, and owns the incidents dump section
    sampler = tsdb.get_sampler()
    inc_engine = incidents.get_incident_engine()
    assert sampler._post_hooks == [inc_engine._post_sweep]
    assert "incidents" in flight._dump_sections


def test_incident_engine_disabled_by_env(rng, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    monkeypatch.setenv(incidents.ENABLED_ENV, "0")
    tsdb.reset_tsdb()
    devmon.reset_device_monitor()
    incidents.reset_incident_engine()
    model = PCAModel.from_numpy(np.eye(N_FEAT)[:, :2], [0.6, 0.4])
    reg = ModelRegistry()
    reg.register("pca_off", model)
    engine = ServeEngine(reg, max_batch_rows=16)
    server = start_serve_server(engine, port=0)
    try:
        sampler = tsdb.get_sampler()
        sampler.stop()
        inc_engine = incidents.get_incident_engine()
        before = inc_engine.sweeps
        sampler.sample_once(now=time.time())
        assert inc_engine.sweeps == before  # not installed
        assert sampler._post_hooks == []
        # the route still answers, from the uninstalled engine
        doc = _get(server.server_address[1], "/debug/incidents")
        assert doc["open"] == [] and doc["sweeps"] == before
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        flight.unregister_dump_section("metrics_history")
        incidents.reset_incident_engine()
        tsdb.reset_tsdb()
        devmon.reset_device_monitor()


# -- the fault plane's latency kind ---------------------------------------------


@pytest.fixture
def plane(monkeypatch):
    reset_fault_plane()
    slept = []
    monkeypatch.setattr(faults_mod.time, "sleep", slept.append)
    yield fault_plane(), slept
    reset_fault_plane()


def test_latency_fires_on_the_chosen_calls_and_sleeps_its_seconds(plane):
    fp, slept = plane
    counter = get_registry().counter(
        "sparkml_serve_faults_injected_total", "", ("model", "kind"))
    before = counter.value(model="lat_m", kind="latency")
    spec = fp.inject("lat_m", "latency", count=2, start=1, seconds=0.25)
    fired = []
    for _ in range(5):
        got = fp.begin_call("lat_m")
        fired.append(got is not None)
        if got is not None:
            faults_mod.apply_pre(got)
    assert fp.begin_call("other_model") is None
    assert fired == [False, True, True, False, False]
    assert slept == [0.25, 0.25]
    assert spec.fired == 2
    assert counter.value(model="lat_m", kind="latency") == before + 2
    # the worker-loop site never fires a transform-site kind
    assert fp.worker_fault("lat_m") is None


@pytest.mark.parametrize("kwargs", [
    dict(kind="latency"),
    dict(kind="latency", seconds=0.3, count=None, start=2),
    dict(kind="raise", count=3),
    dict(kind="nan", seconds=1.5),
    dict(kind="crash_worker"),
])
def test_fault_spec_dict_equals_the_reference(kwargs):
    ours = faults_mod.FaultSpec("m", **kwargs).as_dict()
    theirs = JaxFaultSpec("m", **kwargs).as_dict()
    assert ours == {k: theirs[k] for k in ours}
    assert set(theirs) - set(ours) == {"every", "device", "version"}
    if kwargs["kind"] == "latency" and "seconds" not in kwargs:
        assert ours["seconds"] == 0.05


def test_latency_fault_slows_a_served_request(plane, rng, monkeypatch):
    fp, slept = plane
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    model = PCAModel.from_numpy(np.eye(N_FEAT)[:, :3], [0.5, 0.3, 0.2])
    reg = ModelRegistry()
    reg.register("lat_served", model)
    engine = ServeEngine(reg, max_batch_rows=16, max_wait_ms=1)
    try:
        x = rng.normal(size=(4, N_FEAT))
        fp.inject("lat_served", "latency", count=1, seconds=0.125)
        first = engine.predict_detailed("lat_served", x)
        second = engine.predict_detailed("lat_served", x)
        assert slept == [0.125]  # one call, its seconds
        np.testing.assert_allclose(np.asarray(first.outputs),
                                   np.asarray(second.outputs))
        assert not first.degraded and first.retries == 0
        assert fp.active()[0]["fired"] == 1
    finally:
        engine.shutdown()
