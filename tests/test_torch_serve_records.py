"""The served batch's record, held to the JAX engine's on the same traffic.

The same seeded requests go through both packages' ``ServeEngine`` on the
CPU, one request at a time (so both see the same batches), each package
with a metrics registry of its own. Pipelined (depth 2) and blocking
(depth 1) alike:

* the transform and numerics families the traffic touches have the same
  names, label sets and quantile labels in ``/metrics`` text
  (``sparkml_transform_latency_seconds``: 0.5, 0.95 and 0.99), move by the
  same amounts (one transform, one histogram observation and one numerics
  check per batch; the blocking path counts the padded rows its decorated
  transform sees, as the JAX one does), and carry a ``# exemplar:`` line
  whose trace holds a ``transform:pca`` span;
* each batch files a ``TransformReport`` with the JAX report's keys and
  phase split (stage / dispatch / sync when pipelined) and a
  ``transform:pca`` span under its batch span;
* a ``nan`` fault on two calls is answered alike (two retries, no
  degraded answer) and moves the same counters: two ``NumericsError`` transform
  errors, no numerics anomaly (the NaN guard fails the batch before the
  sentinel sees it), one numerics check per answered batch.
"""

import re

import numpy as np
import pytest

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu.obs import devmon as jax_devmon
from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu.obs import serving as jax_serving
from spark_rapids_ml_tpu.obs import spans as jax_spans
from spark_rapids_ml_tpu.obs import tracectx as jax_tracectx
from spark_rapids_ml_tpu.serve import ModelRegistry as JaxRegistry
from spark_rapids_ml_tpu.serve import ServeEngine as JaxEngine
from spark_rapids_ml_tpu.serve import fault_plane as jax_fault_plane
from spark_rapids_ml_tpu.serve import reset_fault_plane as jax_reset_faults
from spark_rapids_ml_tpu_torch import PCAModel
from spark_rapids_ml_tpu_torch.obs import (
    devmon,
    metrics,
    serving,
    spans,
    tracectx,
)
from spark_rapids_ml_tpu_torch.serve import (
    ModelRegistry,
    ServeEngine,
    fault_plane,
    reset_fault_plane,
)

N_FEAT = 11  # no other serving test compiles this width
SIZES = (3, 17, 1, 40, 9, 64, 5)
# the families of the transform record
RECORD_PREFIXES = ("sparkml_transform", "sparkml_rows_transformed_total",
                   "sparkml_numerics_")
# the JAX record's compile counters: nothing compiles in eager PyTorch
COMPILE_FAMILIES = {"sparkml_transform_compiles_total",
                    "sparkml_transform_recompiles_total"}
PACKAGES = ("jax", "port")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    monkeypatch.setenv("SPARK_RAPIDS_ML_TPU_SERVE_REPLICAS", "1")
    monkeypatch.setattr(metrics, "_default_registry",
                        metrics.MetricsRegistry())
    monkeypatch.setattr(jax_metrics, "_default_registry",
                        jax_metrics.MetricsRegistry())
    # each package's device monitor binds its counters to the registry
    # current when it is made: drop it on both sides of the swap, so no
    # later test reads a registry this one's monitor never writes
    reset_fault_plane()
    jax_reset_faults()
    devmon.reset_device_monitor()
    jax_devmon.reset_device_monitor()
    yield
    reset_fault_plane()
    jax_reset_faults()
    devmon.reset_device_monitor()
    jax_devmon.reset_device_monitor()


@pytest.fixture
def models(rng):
    x = rng.normal(size=(300, N_FEAT)) * (1.0 + np.arange(N_FEAT)) ** -0.5
    ref = JaxPCA().setK(4).setDtype("float64").fit(x)
    port = PCAModel.from_numpy(ref.pc, ref.explained_variance,
                               ref.mean).setDtype("float64")
    return {"jax": ref, "port": port}, x


SIDES = {
    "jax": (JaxEngine, JaxRegistry, jax_metrics, jax_serving, jax_tracectx,
            jax_spans, jax_fault_plane),
    "port": (ServeEngine, ModelRegistry, metrics, serving, tracectx, spans,
             fault_plane),
}


def _serve(side, model, x, depth, fault_count=0):
    """The traffic through one package's engine: per request (trace id,
    outcome), plus the registry and the last transform report."""
    engine_cls, registry_cls, metrics_mod, serving_mod, tc, _, plane = \
        SIDES[side]
    engine = engine_cls(registry_cls(), max_batch_rows=64, max_wait_ms=1,
                        pipeline_depth=depth)
    engine.registry.register("pca", model)
    if fault_count:
        plane().inject("pca", "nan", count=fault_count)
    outcomes, traces = [], []
    try:
        start = 0
        for n in SIZES:
            ctx = tc.new_context()
            with tc.activate(ctx):
                res = engine.predict_detailed("pca", x[start:start + n])
            start += n
            outcomes.append((res.outputs.shape, res.retries, res.degraded))
            traces.append(ctx.trace_id)
            np.testing.assert_allclose(
                res.outputs, x[start - n:start] @ np.asarray(model.pc),
                atol=1e-12)
    finally:
        engine.shutdown()
    return {"outcomes": outcomes, "traces": traces,
            "registry": metrics_mod.get_registry(),
            "report": serving_mod.last_transform_report("pca")}


def _record_families(reg):
    """{family: (type, sorted label sets)} of the record's families."""
    out = {}
    for name, family in reg.snapshot().items():
        if name.startswith(RECORD_PREFIXES) and name not in COMPILE_FAMILIES:
            out[name] = (family["type"],
                         sorted({tuple(sorted(s["labels"].items()))
                                 for s in family["samples"]}))
    return out


def _value(reg, name, **labels):
    family = reg.snapshot().get(name, {"samples": []})
    for sample in family["samples"]:
        if sample["labels"] == labels:
            return sample.get("value", sample.get("count"))
    return 0


def _quantile_labels(text, name):
    return sorted(set(re.findall(rf'^{name}\{{[^}}]*quantile="([^"]+)"\}}',
                                 text, flags=re.M)))


@pytest.mark.parametrize("depth", [2, 1])
def test_the_record_families_equal_the_jax_engines(models, depth):
    by_side, x = models
    got = {side: _serve(side, by_side[side], x, depth) for side in PACKAGES}
    assert got["port"]["outcomes"] == got["jax"]["outcomes"]
    ours, theirs = got["port"]["registry"], got["jax"]["registry"]
    assert _record_families(ours) == _record_families(theirs)
    assert {"sparkml_transforms_total", "sparkml_transform_seconds",
            "sparkml_transform_latency_seconds",
            "sparkml_numerics_checks_total"} <= set(_record_families(ours))
    batches = len(SIZES)
    for reg in (ours, theirs):
        for name in ("sparkml_transforms_total", "sparkml_transform_seconds",
                     "sparkml_numerics_checks_total"):
            assert _value(reg, name, algo="pca") == batches, name
    # the blocking path's decorated transform sees the padded batch
    rows = _value(ours, "sparkml_rows_transformed_total", algo="pca")
    assert rows == _value(theirs, "sparkml_rows_transformed_total",
                          algo="pca")
    if depth > 1:
        assert rows == sum(SIZES)
    else:
        assert rows > sum(SIZES)
    name = "sparkml_transform_latency_seconds"
    texts = {side: got[side]["registry"].prometheus_text()
             for side in PACKAGES}
    assert _quantile_labels(texts["port"], name) == \
        _quantile_labels(texts["jax"], name) == ["0.5", "0.95", "0.99"]
    for side in PACKAGES:
        match = re.search(rf'^# exemplar: {name}\{{algo="pca"\}} '
                          r'trace_id="([0-9a-f]+)"', texts[side], flags=re.M)
        assert match, side
    # the port's exemplar names a batch (pipelined) or a request (blocking)
    # trace: one whose tree holds a transform:pca span
    tid = re.search(rf'^# exemplar: {name}\{{algo="pca"\}} '
                    r'trace_id="([0-9a-f]+)"', texts["port"],
                    flags=re.M).group(1)
    assert "transform:pca" in _names(spans.assemble_trace(tid)["spans"])


def _names(nodes):
    out = []
    for node in nodes:
        out.append(node["name"])
        out.extend(_names(node.get("children", [])))
    return out


def _walk(nodes, depth=0):
    for node in nodes:
        yield depth, node
        yield from _walk(node.get("children", []), depth + 1)


def test_a_pipelined_batch_files_the_jax_report_and_span(models):
    by_side, x = models
    got = {side: _serve(side, by_side[side], x, 2) for side in PACKAGES}
    ours, theirs = got["port"]["report"], got["jax"]["report"]
    assert set(ours.as_dict()) == set(theirs.as_dict())
    assert set(ours.phases) == set(theirs.phases) == \
        {"stage", "dispatch", "sync", "total"}
    last = SIZES[-1]
    for rep in (ours, theirs):
        assert (rep.algo, rep.rows, rep.features) == ("pca", last, N_FEAT)
        assert rep.extra == {"pipelined": True}
        assert rep.numerics["checked_rows"] == last
        assert rep.numerics["nan_rows"] == rep.numerics["inf_rows"] == 0
    # staged at the same bucket, in the same dtype
    assert ours.bytes_in == theirs.bytes_in
    assert ours.bytes_out == theirs.bytes_out == last * 4 * 8
    # the request trees: the batch grafted in through its link, with the
    # transform span under it (the JAX batch also files serve:sync)
    shapes = {}
    for side in PACKAGES:
        sp = SIDES[side][5]
        tree = sp.assemble_trace(got[side]["traces"][-1])
        shapes[side] = [(d, n["name"], n.get("link", False))
                        for d, n in _walk(tree["spans"])
                        if not n["name"].startswith("serve:sync:")]
    assert shapes["port"] == shapes["jax"]
    batch = [i for i, s in enumerate(shapes["port"])
             if s[1] == "serve:batch:pca"]
    assert len(batch) == 1
    depth = shapes["port"][batch[0]][0]
    assert (depth + 1, "transform:pca", True) in shapes["port"]
    # the report's span is the one in the tree, under the batch span
    span = [n for _, n in _walk(spans.assemble_trace(
        got["port"]["traces"][-1])["spans"]) if n["name"] == "transform:pca"]
    assert span and span[0]["span_id"] == ours.span_id


def test_a_nan_fault_is_answered_and_counted_as_the_jax_engine_does(models):
    by_side, x = models
    got = {side: _serve(side, by_side[side], x, 2, fault_count=2)
           for side in PACKAGES}
    assert got["port"]["outcomes"] == got["jax"]["outcomes"]
    # the first request is retried past both corrupted batches
    assert got["port"]["outcomes"][0][1:] == (2, False)
    assert all(o[1:] == (0, False) for o in got["port"]["outcomes"][1:])
    batches = len(SIZES)
    for side in PACKAGES:
        reg = got[side]["registry"]
        assert _value(reg, "sparkml_transform_errors_total", algo="pca",
                      error="NumericsError") == 2, side
        assert _value(reg, "sparkml_transforms_total", algo="pca") == batches
        assert _value(reg, "sparkml_numerics_checks_total",
                      algo="pca") == batches
        assert "sparkml_numerics_anomalies_total" not in reg.snapshot() or \
            _value(reg, "sparkml_numerics_anomalies_total", algo="pca",
                   kind="nan") == 0
    assert _record_families(got["port"]["registry"]) == \
        _record_families(got["jax"]["registry"])


def test_a_degraded_nan_answer_names_the_sentinels_counts(models):
    """With the breaker open, the degraded CPU fallback's output goes
    through the numerics sentinel in both engines: a fallback whose rows
    carry NaN fails with the same ``NumericsError`` naming its NaN / Inf
    row counts, and counts ``degraded_numerics``."""
    by_side, x = models
    rows = x[:6].copy()
    rows[[1, 4], 0] = np.nan  # two NaN rows in, two NaN rows out
    messages = {}
    for side in PACKAGES:
        engine_cls, registry_cls, metrics_mod, *_, plane = SIDES[side]
        engine = engine_cls(registry_cls(), max_wait_ms=1, retries=0,
                            breaker_failures=1, breaker_cooldown_ms=60_000)
        engine.registry.register("pca", by_side[side])
        plane().inject("pca", "raise", count=None)
        try:
            # failures until the breaker opens (the JAX engine may
            # already answer the opening request degraded)
            for _ in range(3):
                if engine.breaker_snapshot().get("pca", {}).get(
                        "state") == "open":
                    break
                try:
                    engine.predict("pca", x[:3], timeout=30)
                except Exception as exc:  # noqa: BLE001 - the fault
                    assert "injected" in str(exc)
            assert engine.breaker_snapshot()["pca"]["state"] == "open"
            with pytest.raises(Exception) as caught:
                engine.predict("pca", rows, timeout=30)
            assert type(caught.value).__name__ == "NumericsError"
            messages[side] = str(caught.value)
            assert _value(metrics_mod.get_registry(),
                          "sparkml_serve_errors_total", model="pca",
                          error="degraded_numerics") == 1
        finally:
            engine.shutdown()
    assert messages["port"] == messages["jax"]
    assert "2 NaN / 0 Inf rows" in messages["port"]
