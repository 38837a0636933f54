"""The port's HTTP front end: the contract the JAX package's server keeps
(JSON and binary ``POST /predict``, ``/healthz``, ``/readyz``,
``/metrics``, 404 unknown model, 400 bad body, the connection still
serving after a bad frame), and its overload surface (``X-Tenant`` /
``X-Priority`` over body fields, the pre-parse fast shed, 503 with
``"shed": true`` and ``Retry-After``, 429 with ``Retry-After``,
``/readyz`` while shedding and its recovery, ``traceparent`` and
``X-Trace-Id``), on ephemeral ports, with every server and engine
closed."""

import http.client
import json
import threading
import time

import numpy as np
import pytest

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu.serve import wire as jwire
from spark_rapids_ml_tpu_torch import PCAModel
from spark_rapids_ml_tpu_torch.obs import tsdb
from spark_rapids_ml_tpu_torch.serve import (
    ModelRegistry,
    ServeEngine,
    start_serve_server,
    wire,
)

TIMEOUT = 30


@pytest.fixture(autouse=True)
def _stop_the_sampler():
    """``start_serve_server`` starts the process-wide history sampler;
    no test leaves its thread running."""
    yield
    tsdb.reset_tsdb()


@pytest.fixture
def served(rng, monkeypatch):
    """A float64 PCA model (fit in the JAX package, carried across) behind
    a port engine and server on an ephemeral port."""
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    x = rng.normal(size=(200, 12)) * (1.0 + np.arange(12)) ** -0.5
    ref = JaxPCA().setK(3).setDtype("float64").fit(x)
    model = PCAModel.from_numpy(ref.pc, ref.explained_variance,
                                ref.mean).setDtype("float64")
    registry = ModelRegistry()
    registry.register("pca", model)
    engine = ServeEngine(registry, max_batch_rows=64, max_wait_ms=1)
    server = start_serve_server(engine, port=0)
    try:
        yield engine, server.server_address[1], model, x
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()


def _conn(port):
    return http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)


def _post(conn, body, content_type="application/json", accept=None):
    headers = {"Content-Type": content_type}
    if accept:
        headers["Accept"] = accept
    conn.request("POST", "/predict", body=body, headers=headers)
    resp = conn.getresponse()
    return resp, resp.read()


def _get(port, path):
    conn = _conn(port)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _json_body(model, rows, **extra):
    return json.dumps({"model": model, "rows": np.asarray(rows).tolist(),
                       **extra}).encode()


@pytest.mark.parametrize("n", [1, 5, 33])
def test_json_predict_equals_the_direct_transform(served, n):
    _, port, model, x = served
    conn = _conn(port)
    try:
        resp, data = _post(conn, _json_body("pca", x[:n]))
    finally:
        conn.close()
    assert resp.status == 200
    doc = json.loads(data)
    assert doc["model"] == "pca" and doc["version"] == 1
    assert doc["degraded"] is False and doc["retries"] == 0
    direct = np.asarray(model.transform(x[:n]).column("pca_features"))
    np.testing.assert_allclose(np.asarray(doc["outputs"]), direct,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_binary_predict_round_trips_and_equals_json(served, dtype):
    _, port, _, x = served
    rows = x[:7].astype(dtype)
    conn = _conn(port)
    try:
        resp, data = _post(conn, jwire.encode_request("pca", rows),
                           wire.BINARY_CONTENT_TYPE)
        assert resp.status == 200
        assert resp.getheader("Content-Type") == wire.BINARY_CONTENT_TYPE
        assert resp.getheader("X-Model-Version") == "1"
        assert resp.getheader("X-Degraded") == "0"
        binary = jwire.decode_response(data)  # the JAX client decodes it
        resp, data = _post(conn, _json_body("pca", rows))
        as_json = np.asarray(json.loads(data)["outputs"])
    finally:
        conn.close()
    np.testing.assert_array_equal(binary, as_json)


def test_binary_request_with_a_json_accept_gets_json(served):
    _, port, _, x = served
    conn = _conn(port)
    try:
        resp, data = _post(conn, wire.encode_request("pca", x[:3]),
                           wire.BINARY_CONTENT_TYPE, accept="application/json")
    finally:
        conn.close()
    assert resp.status == 200 and json.loads(data)["model"] == "pca"


def test_healthz_readyz_and_metrics(served):
    engine, port, _, x = served
    engine.predict("pca", x[:4])
    status, body = _get(port, "/healthz")
    health = json.loads(body)
    assert status == 200 and health["status"] == "ok"
    assert health["models"] == ["pca"] and health["queue_depth"] == 0
    status, body = _get(port, "/readyz")
    assert status == 200 and json.loads(body)["ready"] is True
    status, metrics = _get(port, "/metrics")
    assert status == 200
    assert "sparkml_serve_queue_depth" in metrics
    assert "sparkml_transform_latency_seconds" in metrics
    assert 'sparkml_serve_program_runs_total{algo="pca",precision="native",' \
           'device="cpu"}' in metrics


@pytest.mark.parametrize("path", ["/nope", "/debug/nope"])
def test_unknown_paths_are_404(served, path):
    _, port, _, _ = served
    assert _get(port, path)[0] == 404


def test_unknown_model_is_404(served):
    _, port, _, _ = served
    conn = _conn(port)
    try:
        resp, _ = _post(conn, _json_body("ghost", [[1.0]]))
        assert resp.status == 404
        resp, _ = _post(conn, wire.encode_request("ghost", np.ones((1, 12))),
                        wire.BINARY_CONTENT_TYPE)
        assert resp.status == 404
    finally:
        conn.close()


@pytest.mark.parametrize("body", [b"not json", b'{"rows": [[1.0]]}'])
def test_bad_json_body_is_400(served, body):
    _, port, _, _ = served
    conn = _conn(port)
    try:
        resp, data = _post(conn, body)
    finally:
        conn.close()
    assert resp.status == 400 and "bad request" in json.loads(data)["error"]


def test_oversize_request_is_400(served):
    _, port, _, x = served
    conn = _conn(port)
    try:
        resp, data = _post(conn, _json_body("pca", np.zeros((65, 12))))
    finally:
        conn.close()
    assert resp.status == 400
    assert "exceeds max_batch_rows" in json.loads(data)["error"]


@pytest.mark.parametrize("mutate,reason,status", [
    (lambda b: b"XXXX" + b[4:], "bad_magic", 400),
    (lambda b: b[:4] + bytes([7]) + b[5:], "bad_version", 415),
    (lambda b: b[:5] + bytes([42]) + b[6:], "bad_dtype", 415),
    (lambda b: b[:-16], "truncated", 400),
    (lambda b: b + b"\x00" * 8, "size_mismatch", 400),
])
def test_bad_frame_keeps_the_connection_serving(served, mutate, reason,
                                                status):
    """The reply carries the same status and reason the JAX package's
    decoder gives, and the same keep-alive connection serves the next
    request."""
    _, port, _, x = served
    good = wire.encode_request("pca", x[:2])
    bad = mutate(good)
    with pytest.raises(jwire.WireError) as want:
        jwire.decode_request(bad)
    assert (want.value.reason, want.value.status) == (reason, status)
    conn = _conn(port)
    try:
        resp, data = _post(conn, bad, wire.BINARY_CONTENT_TYPE)
        assert resp.status == status
        assert json.loads(data)["reason"] == reason
        resp, data = _post(conn, good, wire.BINARY_CONTENT_TYPE)
        assert resp.status == 200
        assert wire.decode_response(data).shape == (2, 3)
    finally:
        conn.close()


def test_closed_engine_replies_503_and_not_ready(served):
    engine, port, _, x = served
    engine.shutdown()
    conn = _conn(port)
    try:
        resp, _ = _post(conn, _json_body("pca", x[:2]))
    finally:
        conn.close()
    assert resp.status == 503
    assert _get(port, "/readyz")[0] == 503
    assert json.loads(_get(port, "/healthz")[1])["status"] == "draining"


def test_concurrent_mixed_format_traffic(served):
    """Eight clients, alternating JSON and binary, each on its own
    keep-alive connection: every response is its own rows' product."""
    _, port, model, x = served
    wrong, failures = [], []

    def client(t):
        conn = _conn(port)
        try:
            for i in range(12):
                start = (t * 12 + i) % 150
                rows = x[start:start + 1 + (t + i) % 20]
                if i % 2:
                    resp, data = _post(conn, wire.encode_request("pca", rows),
                                       wire.BINARY_CONTENT_TYPE)
                    out = wire.decode_response(data)
                else:
                    resp, data = _post(conn, _json_body("pca", rows))
                    out = np.asarray(json.loads(data)["outputs"])
                if resp.status != 200 or np.abs(
                        out - rows @ model.pc).max() > 1e-12:
                    wrong.append((t, i))
        except Exception as exc:  # noqa: BLE001 - asserted below
            failures.append(repr(exc))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert failures == [] and wrong == []


# -- the multi-tenant overload surface ----------------------------------------


class _Echo:
    def transform(self, matrix):
        return np.asarray(matrix)


class _Gate:
    """A model whose transform blocks on ``release`` (a full queue)."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def transform(self, matrix):
        self.entered.set()
        assert self.release.wait(TIMEOUT)
        return np.asarray(matrix)


def _forced_shed():
    """A shed controller pinned at level 2."""
    from spark_rapids_ml_tpu_torch.serve import ShedController

    shed = ShedController(refresh_seconds=1e9, hold_seconds=1e9)
    shed.note_signals(burn=100.0, queue_wait_s=10.0, depth_frac=1.0)
    return shed


@pytest.fixture
def overloaded(monkeypatch):
    """An engine at shed level 2 behind a server; tenant ``g`` has a dry
    one-row bucket."""
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    registry = ModelRegistry()
    registry.register("echo", _Echo())
    engine = ServeEngine(registry, max_batch_rows=8, max_wait_ms=1,
                         retries=0, shed=_forced_shed(),
                         tenant_quotas={"g": (1e-6, 1e-6)})
    engine.admission._bucket_for("g").take(1)
    server = start_serve_server(engine, port=0)
    try:
        yield engine, server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()


def _post_json(port, payload, headers=None):
    conn = _conn(port)
    try:
        conn.request("POST", "/predict", body=json.dumps(payload).encode(),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def _metric(name, field="value", **labels):
    from spark_rapids_ml_tpu_torch.obs.metrics import get_registry

    family = get_registry().snapshot().get(name, {"samples": []})
    return sum(s[field] for s in family["samples"]
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def test_shed_replies_503_with_retry_after_and_the_shed_flag(overloaded):
    _, port = overloaded
    rows = [[1.0, 2.0]] * 4
    before = _metric("sparkml_serve_shed_total", tenant="g")
    # headers: the pre-parse fast shed answers before the body decode
    status, headers, doc = _post_json(
        port, {"model": "echo", "rows": rows},
        {"X-Tenant": "g", "X-Priority": "batch"})
    assert status == 503 and doc["shed"] is True and doc["retryable"]
    assert doc["reason"] == "over_quota"
    assert int(headers["Retry-After"]) >= 1
    assert "traceparent" in headers
    # body fields serve header-less clients through the full admission
    status, headers, doc = _post_json(
        port, {"model": "echo", "rows": rows, "tenant": "g",
               "priority": "batch"})
    assert status == 503 and doc["shed"] is True
    assert int(headers["Retry-After"]) >= 1
    assert _metric("sparkml_serve_shed_total", tenant="g") == before + 2
    # default traffic (unlimited quota) is served at level 2
    status, headers, doc = _post_json(port, {"model": "echo", "rows": rows})
    assert status == 200 and len(doc["trace_id"]) == 32
    assert headers["traceparent"].split("-")[1] == doc["trace_id"]
    _, metrics = _get(port, "/metrics")
    assert 'error="load_shed"' in metrics
    assert 'decision="shed"' in metrics
    assert "sparkml_serve_shed_level 2" in metrics


def test_headers_win_over_body_fields(overloaded):
    _, port = overloaded
    rows = [[1.0, 2.0]] * 2
    # the body names the dry tenant, the header an unlimited one: served
    status, _, doc = _post_json(
        port, {"model": "echo", "rows": rows, "tenant": "g",
               "priority": "batch"}, {"X-Tenant": "someone-else"})
    assert status == 200
    # and the other way round: shed
    status, _, doc = _post_json(
        port, {"model": "echo", "rows": rows, "tenant": "someone-else"},
        {"X-Tenant": "g", "X-Priority": "batch"})
    assert status == 503 and doc["shed"] is True


def test_binary_fast_shed_never_decodes_the_body(overloaded):
    _, port = overloaded
    parsed = _metric("sparkml_serve_parse_seconds", "count",
                     format="binary")
    body = wire.encode_request("echo", np.ones((4, 2)))
    conn = _conn(port)
    try:
        conn.request("POST", "/predict", body=body, headers={
            "Content-Type": wire.BINARY_CONTENT_TYPE,
            "X-Tenant": "g", "X-Priority": "batch"})
        resp = conn.getresponse()
        doc = json.loads(resp.read())
        assert resp.status == 503 and doc["shed"] is True
        assert int(resp.getheader("Retry-After")) >= 1
        # the body was drained unread: the same connection still serves
        conn.request("POST", "/predict", body=body,
                     headers={"Content-Type": wire.BINARY_CONTENT_TYPE})
        resp = conn.getresponse()
        data = resp.read()
        assert resp.status == 200
        assert len(resp.getheader("X-Trace-Id")) == 32
        np.testing.assert_array_equal(wire.decode_response(data),
                                      np.ones((4, 2)))
    finally:
        conn.close()
    # only the served request was decoded
    assert _metric("sparkml_serve_parse_seconds", "count",
                   format="binary") == parsed + 1


def test_inbound_traceparent_is_continued(served):
    _, port, _, x = served
    parent = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
    status, headers, doc = _post_json(
        port, {"model": "pca", "rows": x[:2].tolist()},
        {"traceparent": parent})
    assert status == 200
    assert doc["trace_id"] == "4bf92f3577b34da6a3ce929d0e0e4736"
    assert headers["traceparent"].startswith(
        "00-4bf92f3577b34da6a3ce929d0e0e4736-")


def test_healthz_and_readyz_report_shedding(overloaded):
    _, port = overloaded
    status, body = _get(port, "/healthz")
    health = json.loads(body)
    assert status == 200 and health["status"] == "shedding"
    assert health["shed_level"] == 2
    conn = _conn(port)
    try:
        conn.request("GET", "/readyz")
        resp = conn.getresponse()
        ready = json.loads(resp.read())
        assert resp.status == 503 and ready["status"] == "shedding"
        assert not ready["ready"] and ready["shed_level"] == 2
        assert int(resp.getheader("Retry-After")) >= 1
    finally:
        conn.close()


def test_readyz_recovers_without_predict_traffic(monkeypatch):
    """Once a load balancer drains a shedding replica no predict traffic
    arrives; the probes themselves walk the hold down."""
    from spark_rapids_ml_tpu_torch.serve import ShedController

    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    # a hold of 0.5 s: with 0.05 s, a pause of that length between the
    # first two probes under a parallel suite let the hold lapse before
    # the loop's first probe, which then read 200
    shed = ShedController(refresh_seconds=0.0, hold_seconds=0.5)
    registry = ModelRegistry()
    registry.register("echo", _Echo())
    engine = ServeEngine(registry, max_wait_ms=1, shed=shed)
    server = start_serve_server(engine, port=0)
    port = server.server_address[1]
    try:
        shed.note_signals(burn=100.0, queue_wait_s=10.0, depth_frac=1.0)
        assert _get(port, "/readyz")[0] == 503
        statuses = []
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline:
            statuses.append(_get(port, "/readyz")[0])
            if statuses[-1] == 200:
                break
        assert statuses[-1] == 200 and statuses[0] == 503
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()


def test_queue_full_replies_429_with_retry_after(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    gate = _Gate()
    registry = ModelRegistry()
    registry.register("blk", gate)
    engine = ServeEngine(registry, max_batch_rows=4, max_wait_ms=1,
                         max_queue_depth=1, retries=0,
                         fair_scheduling=False)
    server = start_serve_server(engine, port=0)
    port = server.server_address[1]
    rows = [[1.0, 2.0]] * 4
    hangers = [threading.Thread(
        target=_post_json, args=(port, {"model": "blk", "rows": rows}))
        for _ in range(2)]
    try:
        hangers[0].start()
        assert gate.entered.wait(TIMEOUT)  # the worker holds one batch
        hangers[1].start()
        end = time.monotonic() + TIMEOUT
        while engine.queue_depth() < 1 and time.monotonic() < end:
            time.sleep(0.001)
        assert engine.queue_depth() == 1  # the queue is full
        status, headers, doc = _post_json(port, {"model": "blk",
                                                 "rows": rows})
        assert status == 429 and "queue depth" in doc["error"]
        assert int(headers["Retry-After"]) >= 1
    finally:
        gate.release.set()
        for t in hangers:
            t.join(TIMEOUT)
        server.shutdown()
        server.server_close()
        engine.shutdown()
    assert not any(t.is_alive() for t in hangers)
