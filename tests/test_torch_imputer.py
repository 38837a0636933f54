"""Imputer in the port against the JAX package's, on the same seeded numpy
inputs.

``models/imputer.py``, the Imputer partial of ``spark/aggregate.py``
(``partition_imputer_stats``) and the Imputer front end of
``spark/moments_estimator.py``. Both packages' fits and transforms are
host numpy float64, so every comparison is exact:

* surrogates and transforms equal to JAX's for mean, median and mode,
  a mode tie (the smallest value wins), a ``missingValue`` sentinel beside
  NaN, and the "no non-missing values" error;
* ``Pipeline([Imputer, RobustScaler, LogisticRegression])`` as
  ``tests/test_pipeline.py:130`` composes it, the port's predictions equal
  to JAX's (LogisticRegression at float64 in both), and again after save
  and load;
* the front end on 4 local-engine partitions: the mean within 1e-12 of
  the in-memory fit (the partials are exact missing-aware (count, Σx)
  sums), the median exact (the sample keeps every row at this size), both
  without a driver collect; the mode through the adapter collect, as
  ``tests/test_spark_local_lane.py:870-910`` specifies; the partial equal
  to JAX's on the same batches.
"""

import numpy as np
import pytest

from spark_rapids_ml_tpu_torch import Imputer, ImputerModel
from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame

FRONT_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """The CPU requested, and metrics registries of this test's own in both
    packages (the transforms' ``observed_transform`` write into them)."""
    from spark_rapids_ml_tpu.obs import devmon as jax_devmon
    from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
    from spark_rapids_ml_tpu.obs import metrics as jax_metrics
    from spark_rapids_ml_tpu_torch.obs import devmon, fitmon, metrics

    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    monkeypatch.setattr(metrics, "_default_registry",
                        metrics.MetricsRegistry())
    monkeypatch.setattr(jax_metrics, "_default_registry",
                        jax_metrics.MetricsRegistry())
    resets = (devmon.reset_device_monitor, jax_devmon.reset_device_monitor,
              fitmon.reset_fitmon, jax_fitmon.reset_fitmon)
    for reset in resets:
        reset()
    yield
    for reset in resets:
        reset()


def _missing_rows(seed=0, rows=200, d=4, rate=0.2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d))
    # a few repeated values, so a mode is not simply the smallest entry
    x[: rows // 4, 1] = np.round(x[: rows // 4, 1], 1)
    miss = rng.random(x.shape) < rate
    x_miss = np.array(x)
    x_miss[miss] = np.nan
    return x, miss, x_miss


def _jax_fit(x, **params):
    from spark_rapids_ml_tpu import Imputer as J
    from spark_rapids_ml_tpu.data.frame import as_vector_frame as jframe

    est = J()
    for name, value in params.items():
        est.set(name, value)
    return est.fit(jframe(x, "features")), jframe(x, "features")


def _port_fit(x, **params):
    est = Imputer()
    for name, value in params.items():
        est.set(name, value)
    frame = as_vector_frame(x, "features")
    return est.fit(frame), frame


def _imputed(model, frame):
    return np.stack(list(model.transform(frame).column(
        model.getOutputCol())))


@pytest.mark.parametrize("strategy", ["mean", "median", "mode"])
def test_surrogates_and_transform_equal_jax(strategy):
    x, miss, x_miss = _missing_rows()
    port, pframe = _port_fit(x_miss, strategy=strategy)
    ref, jframe = _jax_fit(x_miss, strategy=strategy)
    np.testing.assert_array_equal(port.surrogates, ref.surrogates)
    got, want = _imputed(port, pframe), _imputed(ref, jframe)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[~miss], x[~miss])
    if strategy != "mode":
        fn = np.mean if strategy == "mean" else np.median
        for j in range(x.shape[1]):
            assert port.surrogates[j] == fn(x[~miss[:, j], j])


def test_mode_tie_breaks_to_the_smallest_value_as_jax():
    xm = np.array([[1.0, 5.0], [2.0, 5.0], [2.0, 4.0], [3.0, 4.0],
                   [3.0, np.nan], [np.nan, 7.0]])
    port, _ = _port_fit(xm, strategy="mode")
    ref, _ = _jax_fit(xm, strategy="mode")
    np.testing.assert_array_equal(port.surrogates, [2.0, 4.0])
    np.testing.assert_array_equal(port.surrogates, ref.surrogates)


@pytest.mark.parametrize("strategy", ["mean", "median", "mode"])
def test_sentinel_beside_nan_is_missing_as_jax(strategy):
    xs = np.array([[1.0, -1.0], [-1.0, 2.0], [3.0, np.nan], [np.nan, 2.0],
                   [3.0, 6.0]])
    port, pframe = _port_fit(xs, strategy=strategy, missingValue=-1.0)
    ref, jframe = _jax_fit(xs, strategy=strategy, missingValue=-1.0)
    np.testing.assert_array_equal(port.surrogates, ref.surrogates)
    got = _imputed(port, pframe)
    np.testing.assert_array_equal(got, _imputed(ref, jframe))
    assert not (got == -1.0).any() and np.isfinite(got).all()


def test_a_feature_with_no_value_raises_as_jax():
    from spark_rapids_ml_tpu import Imputer as J
    from spark_rapids_ml_tpu.data.frame import as_vector_frame as jframe

    x = np.array([[1.0, np.nan], [2.0, np.nan]])
    with pytest.raises(ValueError, match="feature 1 has no non-missing"):
        Imputer().fit(as_vector_frame(x, "features"))
    with pytest.raises(ValueError, match="feature 1 has no non-missing"):
        J().fit(jframe(x, "features"))
    with pytest.raises(ValueError, match="unfitted"):
        ImputerModel().transform(as_vector_frame(x, "features"))


def test_pipeline_imputer_robust_logreg_equals_jax(tmp_path):
    """``tests/test_pipeline.py:130``'s pipeline through both packages."""
    import spark_rapids_ml_tpu as jax_pkg
    from spark_rapids_ml_tpu.data.frame import as_vector_frame as jframe

    import spark_rapids_ml_tpu_torch as port_pkg

    rng = np.random.default_rng(130)
    n = 240
    x = rng.normal(size=(n, 4))
    y = (x[:, 0] > 0).astype(float)
    x_miss = np.array(x)
    x_miss[::9, 2] = np.nan

    def pipeline(pkg):
        lr = pkg.LogisticRegression().setInputCol("scaled").setRegParam(0.05)
        if pkg is port_pkg:
            lr.setDtype("float64")
        return pkg.Pipeline(stages=[
            pkg.Imputer().setStrategy("median").setOutputCol("imp"),
            pkg.RobustScaler().setInputCol("imp").setWithCentering(True)
            .setOutputCol("scaled"),
            lr,
        ])

    pframe = as_vector_frame(x_miss, "features").with_column(
        "label", y.tolist())
    jf = jframe(x_miss, "features").with_column("label", y.tolist())
    port = pipeline(port_pkg).fit(pframe)
    ref = pipeline(jax_pkg).fit(jf)
    pred = np.asarray(list(port.transform(pframe).column("prediction")))
    want = np.asarray(list(ref.transform(jf).column("prediction")))
    np.testing.assert_array_equal(pred, want)
    assert (pred == y).mean() > 0.9
    path = str(tmp_path / "pipe4")
    port.save(path)
    loaded = port_pkg.PipelineModel.load(path)
    np.testing.assert_array_equal(
        np.asarray(list(loaded.transform(pframe).column("prediction"))),
        pred)


# -- the partial and the front end ---------------------------------------------

def test_partition_imputer_stats_equal_jax():
    from spark_rapids_ml_tpu.spark import aggregate as jagg

    from spark_rapids_ml_tpu_torch.spark import aggregate as pagg

    _x, _miss, x_miss = _missing_rows(seed=3, rows=90)
    batches = [x_miss[:40], x_miss[40:40], x_miss[40:]]
    for missing in (float("nan"), 0.0):
        got = list(pagg.partition_imputer_stats(iter(batches), "f",
                                                 missing))
        want = list(jagg.partition_imputer_stats(iter(batches), "f",
                                                 missing))
        assert got == want
    assert list(pagg.partition_imputer_stats(iter([]), "f", 0.0)) == []
    assert pagg.imputer_stats_spark_ddl() == jagg.imputer_stats_spark_ddl()
    assert pagg.imputer_stats_arrow_schema() == \
        jagg.imputer_stats_arrow_schema()


def _frame_df(x_miss, partitions=4):
    from spark_rapids_ml_tpu_torch.spark.local_engine import (
        DenseVector,
        LocalSparkSession,
    )

    spark = LocalSparkSession(n_partitions=partitions)
    return spark.createDataFrame([{"features": DenseVector(r)}
                                  for r in x_miss])


def test_front_end_mean_and_median_on_the_plane(monkeypatch):
    """Mean and median never collect rows to the driver; the mode does."""
    import spark_rapids_ml_tpu_torch.spark as port_spark
    from spark_rapids_ml_tpu_torch.spark import adapter

    def boom(self, dataset):
        raise AssertionError("driver-collect fired on a plane family")

    x, miss, x_miss = _missing_rows(seed=5, rows=150, d=3, rate=0.15)
    df = _frame_df(x_miss)
    local_mean, _ = _port_fit(x_miss, strategy="mean")
    local_mode, _ = _port_fit(x_miss, strategy="mode")
    monkeypatch.setattr(adapter._AdapterEstimator, "_collect_frame", boom)
    m_mean = port_spark.Imputer(strategy="mean").fit(df)
    np.testing.assert_allclose(m_mean._local.surrogates,
                               local_mean.surrogates, rtol=FRONT_RTOL,
                               atol=0)
    m_med = port_spark.Imputer(strategy="median").fit(df)
    for j in range(3):
        assert m_med._local.surrogates[j] == np.median(x[~miss[:, j], j])
    with pytest.raises(AssertionError, match="driver-collect"):
        port_spark.Imputer(strategy="mode").fit(df)
    monkeypatch.undo()
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    m_mode = port_spark.Imputer(strategy="mode").fit(df)
    np.testing.assert_array_equal(m_mode._local.surrogates,
                                  local_mode.surrogates)
    # the model's transform through the adapter equals the local one
    rows = m_mean.transform(df).collect()
    got = np.stack([r["imputed_features"].toArray() for r in rows])
    np.testing.assert_array_equal(
        got, _imputed(m_mean._local, as_vector_frame(x_miss, "features")))


def test_front_end_raises_on_an_all_missing_feature():
    import spark_rapids_ml_tpu_torch.spark as port_spark

    x = np.array([[1.0, np.nan], [2.0, np.nan], [3.0, np.nan]])
    for strategy in ("mean", "median"):
        with pytest.raises(ValueError, match="no non-missing"):
            port_spark.Imputer(strategy=strategy).fit(_frame_df(x, 2))


def test_front_end_mean_on_numpy_partitions():
    """The mean's partial job through ``forest_estimator.PartitionFrame``
    (numpy partitions, no pyarrow), as every moments-plane job runs."""
    import spark_rapids_ml_tpu_torch.spark as port_spark
    from spark_rapids_ml_tpu_torch.spark.forest_estimator import (
        PartitionFrame,
    )

    _x, _miss, x_miss = _missing_rows(seed=6, rows=160, d=5)
    parts = [[x_miss[i * 40:(i + 1) * 40]] for i in range(4)]
    model = port_spark.Imputer(strategy="mean", missingValue=0.0)._fit(
        PartitionFrame(parts))
    local, _ = _port_fit(x_miss, strategy="mean", missingValue=0.0)
    np.testing.assert_allclose(model._local.surrogates, local.surrogates,
                               rtol=FRONT_RTOL, atol=0)
