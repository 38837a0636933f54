"""The port's instrumented transform path (``obs.serving``) against the JAX
package's: the twins of ``tests/test_obs_serving.py`` that concern PCA and
the decorator, the numerics sentinel's verdicts on the same seeded arrays
(NaN, Inf and all-zero rows, above the 65,536-row stride cap), and every
public ``fit`` / ``transform`` of ``spark_rapids_ml_tpu_torch/models/``
carrying ``__obs_instrumented__`` (the port's counterpart of
``scripts/check_instrumentation.py``).

Counters are read as deltas, or from a registry of the test's own: the
default registry is process-wide.
"""

import ast
import glob
import json
import os
import time

import numpy as np
import pytest

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu.obs import serving as jax_serving
from spark_rapids_ml_tpu_torch import PCA
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
from spark_rapids_ml_tpu_torch.obs import flight, metrics, serving
from spark_rapids_ml_tpu_torch.obs.serving import (
    TransformReport,
    check_output_numerics,
    last_transform_report,
    latency_quantiles,
    observed_transform,
    transform_phase,
)

MODELS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "spark_rapids_ml_tpu_torch", "models")


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


@pytest.fixture
def reg(monkeypatch):
    """A metrics registry of this test's own."""
    fresh = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_default_registry", fresh)
    return fresh


def _value(reg, name, **labels):
    family = reg.snapshot().get(name, {"samples": []})
    for sample in family["samples"]:
        if sample["labels"] == labels:
            return sample.get("value", sample.get("count"))
    return 0.0


# -- the PCA transform report against the JAX package's ---------------------


@pytest.mark.parametrize("use_device", [True, False])
def test_pca_transform_report_matches_the_jax_report(rng, use_device):
    x = rng.normal(size=(256, 12))
    reports = []
    for cls in (JaxPCA, PCA):
        model = cls().setK(4).setDtype("float64").setUseXlaDot(
            use_device).fit(x)
        out = model.transform(x)
        rep = model.transform_report_
        # the output frame carries the same report
        assert getattr(out, "transform_report_", None) is rep
        reports.append((rep, out))
    (theirs, t_out), (ours, o_out) = reports
    assert isinstance(ours, TransformReport)
    np.testing.assert_allclose(np.asarray(o_out.column("pca_features")),
                               np.asarray(t_out.column("pca_features")),
                               rtol=1e-9, atol=1e-12)
    doc = json.loads(json.dumps(ours.as_dict()))
    assert set(doc) == set(theirs.as_dict())
    for key in ("algo", "rows", "features", "batches", "bytes_in",
                "bytes_out", "numerics", "nested_in"):
        assert getattr(ours, key) == getattr(theirs, key), key
    # nothing compiles in eager PyTorch (the JAX call may compile)
    assert (ours.compiles, ours.recompiles, ours.analytic_flops) == \
        (0, 0, None)
    assert (ours.algo, ours.rows, ours.features) == ("pca", 256, 12)
    assert ours.bytes_in == x.nbytes
    want = {"device_put", "compute", "host_sync", "total"} if use_device \
        else {"compute", "total"}
    assert set(ours.phases) == set(theirs.phases) == want
    assert ours.phases["total"] >= ours.phases["compute"]
    assert ours.numerics == {"checked_rows": 256, "nan_rows": 0,
                             "inf_rows": 0, "all_zero": False,
                             "columns": ["pca_features"]}
    assert last_transform_report("pca") is ours
    q = ours.latency_quantiles
    assert set(q) == set(theirs.latency_quantiles) == {"p50", "p95", "p99"}
    assert 0 < q["p50"] <= q["p95"] <= q["p99"]


def test_transform_metrics_side_effects(rng, reg):
    x = rng.normal(size=(64, 6))
    model = PCA().setK(2).fit(x)
    model.transform(x)
    model.transform(x[:10])
    assert _value(reg, "sparkml_transforms_total", algo="pca") == 2
    assert _value(reg, "sparkml_rows_transformed_total", algo="pca") == 74
    assert _value(reg, "sparkml_transform_seconds", algo="pca") == 2
    assert _value(reg, "sparkml_numerics_checks_total", algo="pca") == 2
    assert _value(reg, "sparkml_transform_bytes_in_total",
                  algo="pca") == x.nbytes + x[:10].nbytes
    text = reg.prometheus_text()
    assert 'sparkml_transform_seconds_count{algo="pca"} 2' in text
    assert 'sparkml_transform_latency_seconds{algo="pca",quantile="0.95"}' \
        in text
    assert 'quantile="0.9"' not in text
    assert '# exemplar: sparkml_transform_latency_seconds{algo="pca"} ' \
        'trace_id="' in text


def test_a_nan_in_the_input_counts_only_the_output_column(rng, reg):
    x = rng.normal(size=(64, 6))
    model = PCA().setK(2).fit(x)
    bad = x.copy()
    bad[0, 0] = np.nan
    model.transform(bad)
    rep = model.transform_report_
    assert rep.numerics["columns"] == [model.getOutputCol()]
    assert rep.numerics["nan_rows"] == 1
    assert _value(reg, "sparkml_numerics_anomalies_total", algo="pca",
                  kind="nan") == 1


# -- the decorator, twin for twin ----------------------------------------------


def _both(make):
    """``make(observed_transform)`` in each package: (jax, port)."""
    return make(jax_serving.observed_transform), make(observed_transform)


def test_latency_quantiles_accumulate_per_algo(reg):
    def make(ot):
        class _Doubler:
            @ot("qtest_doubler")
            def transform(self, x):
                return np.asarray(x) * 2.0
        return _Doubler()

    _, model = _both(make)
    for _ in range(20):
        model.transform(np.ones((10, 2)))
    q = latency_quantiles("qtest_doubler")
    assert q["p50"] is not None and q["p50"] <= q["p95"] <= q["p99"]
    summary = reg.summary("sparkml_transform_latency_seconds", "",
                          ("algo",))
    assert summary.sketch(algo="qtest_doubler").count == 20
    assert summary.quantiles == (0.5, 0.95, 0.99)
    text = reg.prometheus_text()
    assert 'sparkml_transform_latency_seconds{algo="qtest_doubler"' in text


def test_injected_nan_column_is_counted_as_the_jax_sentinel_counts_it(rng,
                                                                        reg):
    def make(ot):
        class _Poisoned:
            @ot("numerics_nan_algo")
            def transform(self, x):
                out = np.asarray(x, dtype=np.float64).copy()
                out[:3, 0] = np.nan
                out[5, 1] = np.inf
                return out
        return _Poisoned()

    x = rng.normal(size=(50, 4))
    theirs, ours = _both(make)
    theirs.transform(x)
    ours.transform(x)
    assert ours.transform_report_.numerics == \
        theirs.transform_report_.numerics
    assert ours.transform_report_.numerics["nan_rows"] == 3
    assert _value(reg, "sparkml_numerics_anomalies_total",
                  algo="numerics_nan_algo", kind="nan") == 3
    assert _value(reg, "sparkml_numerics_anomalies_total",
                  algo="numerics_nan_algo", kind="inf") == 1


def test_numerics_sample_rate_env_disables(monkeypatch, reg):
    monkeypatch.setenv(serving.NUMERICS_SAMPLE_ENV, "0")

    class _Quiet:
        @observed_transform("numerics_gated_algo")
        def transform(self, x):
            return np.full(np.shape(x), np.nan)

    model = _Quiet()
    model.transform(np.ones((10, 2)))
    assert model.transform_report_.numerics is None
    assert _value(reg, "sparkml_numerics_checks_total",
                  algo="numerics_gated_algo") == 0


@pytest.mark.parametrize("value,want", [("0.25", 0.25), ("7", 1.0),
                                        ("-1", 0.0), ("junk", 1.0)])
def test_numerics_sample_rate_parses_as_the_jax_rate(monkeypatch, value,
                                                     want):
    monkeypatch.setenv(serving.NUMERICS_SAMPLE_ENV, value)
    monkeypatch.setenv(jax_serving.NUMERICS_SAMPLE_ENV, value)
    assert serving.numerics_sample_rate() == \
        jax_serving.numerics_sample_rate() == want


def test_check_numerics_false_opts_out(reg):
    class _Contract:
        @observed_transform("nan_contract_algo", check_numerics=False)
        def transform(self, x):
            return np.full(np.shape(x), np.nan)

    model = _Contract()
    model.transform(np.ones((3, 2)))
    assert model.transform_report_.numerics is None
    assert _value(reg, "sparkml_numerics_anomalies_total",
                  algo="nan_contract_algo", kind="nan") == 0


def test_delegation_shim_is_not_double_counted(reg):
    def make(ot):
        class _ShimModel:
            @ot
            def transform(self, dataset):
                return self._transform(dataset)

            @ot
            def _transform(self, dataset):
                return np.asarray(dataset) + 1.0
        return _ShimModel()

    theirs, ours = _both(make)
    theirs.transform(np.ones((7, 2)))
    ours.transform(np.ones((7, 2)))
    assert _value(reg, "sparkml_transforms_total", algo="shim") == 1
    assert ours.transform_report_.rows == 7
    assert ours.transform_report_.algo == theirs.transform_report_.algo


def test_a_labelled_inner_method_refines_the_derived_label(reg):
    class ThingModel:
        @observed_transform
        def transform(self, dataset):
            return self._transform(dataset)

        @observed_transform("thing_v2")
        def _transform(self, dataset):
            return np.asarray(dataset)

    model = ThingModel()
    model.transform(np.ones((2, 2)))
    assert model.transform_report_.algo == "thing_v2"
    assert _value(reg, "sparkml_transforms_total", algo="thing_v2") == 1


def test_nested_distinct_models_each_report():
    class _Inner:
        @observed_transform("nest_inner")
        def transform(self, dataset):
            return np.asarray(dataset) * 2.0

    class _Outer:
        def __init__(self):
            self.stage = _Inner()

        @observed_transform("nest_outer")
        def transform(self, dataset):
            return self.stage.transform(dataset)

    model = _Outer()
    model.transform(np.ones((5, 2)))
    assert model.stage.transform_report_.nested_in == "nest_outer"
    assert model.transform_report_.nested_in is None


@pytest.mark.parametrize("name", ["StandardScalerModel", "PCAModel",
                                  "_KMeansAdapter", "Model", "ALS"])
def test_derived_algo_labels_match_the_jax_labels(name):
    obj = type(name, (), {})()
    assert serving._derive_algo(obj) == jax_serving._derive_algo(obj)


def test_transform_phase_is_noop_outside_an_instrumented_call():
    with transform_phase("compute"):
        pass
    assert serving.current_transform().algo == "_unobserved"


def test_report_as_dict_round_trips_and_quantiles_are_live():
    class _Lazy:
        @observed_transform("lazy_q_algo")
        def transform(self, x):
            return np.asarray(x)

    model = _Lazy()
    model.transform(np.ones((3, 2)))
    first = model.transform_report_
    for _ in range(10):
        model.transform(np.ones((2, 2)))
    doc = json.loads(json.dumps(first.as_dict()))
    assert doc["algo"] == "lazy_q_algo" and doc["rows"] == 3
    assert "total" in doc["phases"]
    assert first.p50 <= first.p95 <= first.p99
    assert doc["latency_quantiles"]["p99"] == first.p99


def test_raising_transform_counts_an_error_and_propagates(reg):
    class _Broken:
        @observed_transform("error_test_algo")
        def transform(self, x):
            raise ValueError("schema mismatch")

    with pytest.raises(ValueError, match="schema mismatch"):
        _Broken().transform(np.ones((3, 2)))
    assert _value(reg, "sparkml_transform_errors_total",
                  algo="error_test_algo", error="ValueError") == 1
    assert _value(reg, "sparkml_transforms_total",
                  algo="error_test_algo") == 0


def test_all_zero_is_informational_not_an_anomaly(reg):
    class _AllZero:
        @observed_transform("allzero_algo")
        def transform(self, x):
            return np.zeros_like(np.asarray(x, dtype=np.float64))

    _AllZero().transform(np.ones((10, 3)))
    assert _value(reg, "sparkml_numerics_all_zero_total",
                  algo="allzero_algo") == 1
    assert _value(reg, "sparkml_numerics_anomalies_total",
                  algo="allzero_algo", kind="all_zero") == 0


def test_a_raising_report_assembly_still_returns_the_output(rng, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("telemetry broke")

    x = rng.normal(size=(20, 4))
    model = PCA().setK(2).fit(x)
    monkeypatch.setattr(serving, "_build_report", boom)
    out = model.transform(x)
    assert np.asarray(out.column("pca_features")).shape == (20, 2)


def test_transform_budget_arms_the_watchdog(tmp_path, monkeypatch):
    monkeypatch.setenv(flight.DUMP_DIR_ENV, str(tmp_path))
    monkeypatch.setenv(flight.TRANSFORM_BUDGET_ENV, "0.15")

    class _Stalled:
        @observed_transform("watchdog_stall_algo")
        def transform(self, x):
            deadline = time.monotonic() + 30.0
            while not glob.glob(str(tmp_path / "flightdump_*.json")):
                assert time.monotonic() < deadline, "no flight dump"
                time.sleep(0.01)
            return np.asarray(x)

    _Stalled().transform(np.ones((2, 2)))
    files = glob.glob(str(tmp_path / "flightdump_*.json"))
    doc = json.load(open(files[0]))
    assert doc["reason"] == "budget_exceeded:transform:watchdog_stall_algo"


# -- the sentinel core on the same arrays --------------------------------------


def _seeded(rng, rows, cols, nan=(), inf=(), zero_rows=()):
    out = rng.normal(size=(rows, cols))
    for r in nan:
        out[r, rng.integers(cols)] = np.nan
    for r in inf:
        out[r, rng.integers(cols)] = -np.inf if r % 2 else np.inf
    for r in zero_rows:
        out[r] = 0.0
    return out


CASES = {
    "clean": dict(rows=100, cols=5),
    "nan_rows": dict(rows=100, cols=5, nan=(0, 7, 99)),
    "inf_rows": dict(rows=100, cols=5, inf=(3, 4)),
    "nan_and_inf_in_one_row": dict(rows=40, cols=3, nan=(1, 2), inf=(2,)),
    "zero_rows": dict(rows=30, cols=4, zero_rows=(0, 5, 6)),
    "one_column": dict(rows=50, cols=1, nan=(10,)),
    # above the cap: strided to ceil(n / 65536) — these rows land on and
    # off the stride
    "above_the_cap": dict(rows=65536 * 2 + 5, cols=2,
                          nan=(0, 1, 2, 4, 131072), inf=(65535, 65537)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_check_output_numerics_equals_the_jax_verdict(rng, case):
    x = _seeded(rng, **CASES[case])
    ours = check_output_numerics(x)
    theirs = jax_serving.check_output_numerics(x)
    assert ours == theirs
    assert ours["checked_rows"] == min(len(x), len(x[::-(-len(x) // 65536)]))
    if case == "above_the_cap":
        assert ours["checked_rows"] == 43693  # ceil(131077 / 3)
        assert ours["nan_rows"] == 1 and ours["inf_rows"] == 1


def test_check_output_numerics_all_zero_and_integer_outputs(rng):
    for arr in (np.zeros((8, 3)), np.zeros(8, dtype=np.int64),
                np.arange(6).reshape(3, 2)):
        assert check_output_numerics(arr) == \
            jax_serving.check_output_numerics(arr)
    assert check_output_numerics(np.zeros((8, 3)))["all_zero"] is True


def test_check_output_numerics_on_frames_matches_jax(rng):
    from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxFrame

    x = rng.normal(size=(20, 3))
    for name, col in (("pred", np.zeros((20, 2))),
                      ("pred", np.array([[np.inf]] * 20)),
                      ("tokens", [["a", "b"]] * 20),
                      ("vec", [list(r) for r in x])):
        ours = check_output_numerics(
            VectorFrame({"features": x}).with_column(name, col),
            input_columns=["features"])
        theirs = jax_serving.check_output_numerics(
            JaxFrame({"features": x}).with_column(name, col),
            input_columns=["features"])
        assert ours == theirs
    assert check_output_numerics(None) is None
    assert check_output_numerics("text") is None


def test_dataset_stats_match_the_jax_stats(rng):
    from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxFrame

    x = rng.normal(size=(10, 100))
    rows = [list(r) for r in x]
    assert serving._dataset_stats(x) == jax_serving._dataset_stats(x)
    assert serving._dataset_stats(VectorFrame({"f": rows})) == \
        jax_serving._dataset_stats(JaxFrame({"f": rows})) == \
        {"rows": 10, "features": None, "nbytes": 10 * 100 * 8}


# -- every public fit / transform of the port's models is instrumented ---------

ENTRY_POINTS = ("fit", "transform", "predict", "predict_proba")


def _public_entry_points():
    """(module, class, method) for every public fit / transform / predict
    defined on a class in ``spark_rapids_ml_tpu_torch/models/``."""
    found = []
    for path in sorted(glob.glob(os.path.join(MODELS_DIR, "*.py"))):
        tree = ast.parse(open(path).read())
        module = "spark_rapids_ml_tpu_torch.models." + \
            os.path.basename(path)[:-3]
        for node in tree.body:
            if not isinstance(node, ast.ClassDef) or \
                    node.name.startswith("_"):
                continue
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and \
                        item.name in ENTRY_POINTS:
                    found.append((module, node.name, item.name))
    return found


def test_every_public_fit_and_transform_is_instrumented():
    import importlib

    found = _public_entry_points()
    assert ("spark_rapids_ml_tpu_torch.models.pca", "PCA", "fit") in found
    assert ("spark_rapids_ml_tpu_torch.models.pca", "PCAModel",
            "transform") in found
    for module, cls, method in found:
        fn = getattr(getattr(importlib.import_module(module), cls), method)
        assert getattr(fn, "__obs_instrumented__", None), \
            f"{cls}.{method} carries no observability decorator"
