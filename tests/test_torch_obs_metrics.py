"""The port's Prometheus exposition with a NaN sample: a NaN gauge renders
as ``NaN`` (the exposition format's spelling), a summary that observed a
NaN still renders, every other family still renders, and ``GET /metrics``
on the port's server answers 200 with the ``NaN`` sample. (The JAX
package's ``_format_value`` raises on NaN, so one diverging fit's gauge
would fail every later scrape; the port departs from it only there.)"""

import http.client

import numpy as np
import pytest

from spark_rapids_ml_tpu_torch import PCAModel
from spark_rapids_ml_tpu_torch.obs import devmon, fitmon, metrics, tsdb
from spark_rapids_ml_tpu_torch.serve import (
    ModelRegistry,
    ServeEngine,
    start_serve_server,
)

TIMEOUT = 30


def _nan_families(reg):
    reg.gauge("nan_gauge", "a gauge set to NaN", ("fit",)).set(
        float("nan"), fit="diverged")
    reg.gauge("nan_gauge", "a gauge set to NaN", ("fit",)).set(
        0.25, fit="settled")
    summary = reg.summary("nan_summary", "a summary that observed NaN")
    summary.observe(2.0)
    summary.observe(float("nan"))
    reg.counter("after_nan_total", "a family after the NaN ones").inc(3)
    reg.histogram("after_nan_seconds", "a histogram after them").observe(0.02)


def test_prometheus_text_renders_nan_and_every_other_family():
    reg = metrics.MetricsRegistry()
    _nan_families(reg)
    lines = reg.prometheus_text().splitlines()
    assert 'nan_gauge{fit="diverged"} NaN' in lines
    assert 'nan_gauge{fit="settled"} 0.25' in lines
    assert 'nan_summary{quantile="0.5"} 2' in lines
    assert "nan_summary_count 1" in lines
    assert "after_nan_total 3" in lines
    assert "after_nan_seconds_count 1" in lines
    # and it keeps rendering on the next scrape
    assert reg.prometheus_text().splitlines() == lines


@pytest.fixture
def served(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_OBS_INCIDENTS", "0")
    # a registry of this test's own: the NaN gauge stays out of the
    # process-wide one; the singletons that bind families are made anew
    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_default_registry", reg)
    tsdb.reset_tsdb()
    devmon.reset_device_monitor()
    fitmon.reset_fitmon()
    basis = np.linalg.qr(np.random.default_rng(0).normal(size=(6, 2)))[0]
    registry = ModelRegistry()
    registry.register("pca_nan", PCAModel.from_numpy(basis, [0.6, 0.4]))
    engine = ServeEngine(registry, max_batch_rows=8, max_wait_ms=1)
    server = start_serve_server(engine, port=0)
    try:
        yield reg, server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        tsdb.reset_tsdb()
        devmon.reset_device_monitor()
        fitmon.reset_fitmon()


def test_get_metrics_answers_200_with_a_nan_gauge(served):
    reg, port = served
    _nan_families(reg)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        status, text = resp.status, resp.read().decode()
    finally:
        conn.close()
    assert status == 200
    lines = text.splitlines()
    assert 'nan_gauge{fit="diverged"} NaN' in lines
    assert "after_nan_total 3" in lines
