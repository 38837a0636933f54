"""``GET /dashboard``: the port serves the JAX package's page byte for byte,
as ``text/html; charset=utf-8``, and every URL the page fetches answers —
200 for the routes the port serves (``/debug/fit`` among them), 404 for
``/debug/fleet``, whose tiles stay empty until that route is ported."""

import http.client
import json
import re

import numpy as np
import pytest

from spark_rapids_ml_tpu.serve.server import DASHBOARD_HTML as JAX_HTML
from spark_rapids_ml_tpu_torch import PCAModel
from spark_rapids_ml_tpu_torch.obs import tsdb
from spark_rapids_ml_tpu_torch.serve import (
    ModelRegistry,
    ServeEngine,
    start_serve_server,
)
from spark_rapids_ml_tpu_torch.serve.dashboard import DASHBOARD_HTML

TIMEOUT = 30
SERVED = ("/debug/slo", "/healthz", "/debug/history", "/debug/incidents",
          "/debug/traces?limit=10", "/debug/fit")
NOT_YET = ("/debug/fleet",)


@pytest.fixture(scope="module")
def port():
    """One engine and server for the module (the page's routes only read)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    model = PCAModel.from_numpy(np.eye(6)[:, :2], [0.6, 0.4])
    registry = ModelRegistry()
    registry.register("pca_dash", model)
    engine = ServeEngine(registry, max_batch_rows=16, max_wait_ms=1)
    server = start_serve_server(engine, port=0)
    try:
        engine.predict("pca_dash", np.ones((3, 6)))
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        tsdb.reset_tsdb()
        mp.undo()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def test_the_page_is_the_jax_page():
    assert DASHBOARD_HTML == JAX_HTML
    assert DASHBOARD_HTML.encode("utf-8") == JAX_HTML.encode("utf-8")


def test_get_dashboard_serves_the_page_byte_for_byte(port):
    status, content_type, body = _get(port, "/dashboard")
    assert status == 200
    assert content_type == "text/html; charset=utf-8"
    assert body == JAX_HTML.encode("utf-8")
    text = body.decode("utf-8")
    for marker in ("/debug/history", "sparkSvg", "svg.spark",
                   'id="history"'):
        assert marker in text


def test_the_page_fetches_exactly_these_urls():
    fetched = set(re.findall(r'fetch\("([^"]+)"\)', DASHBOARD_HTML))
    assert fetched == set(SERVED) | set(NOT_YET)


@pytest.mark.parametrize("url", SERVED + ("/debug/costs",))
def test_each_url_the_page_reads_answers(port, url):
    status, content_type, body = _get(port, url)
    assert status == 200, url
    assert content_type == "application/json"
    assert isinstance(json.loads(body), dict)


@pytest.mark.parametrize("url", NOT_YET)
def test_the_unported_tiles_get_404(port, url):
    status, _, body = _get(port, url)
    assert status == 404
    assert "unknown path" in json.loads(body)["error"]
