"""Model selection in the port against the JAX package's, on the same
seeded numpy rows: ``models/tuning.py`` (in memory) and
``spark/tuning_front.py`` (the DataFrame Pipeline and tuning front end).

Both packages draw folds with ``np.random.default_rng(seed).permutation``
(in memory) or the local engine's ``randomSplit`` (DataFrames), so a
seeded search sees the same folds in both. Every inner fit here is
float64, and each search is held to the bar of its family's own parity
test: ``bestIndex`` equal, and avgMetrics / validationMetrics within

* LinearRegression (normal equations, float64): 1e-9 relative
  (``tests/test_torch_linreg.py`` holds coefficients to 1e-10);
* LogisticRegression (Newton, float64): 1e-8 relative
  (``tests/test_torch_logreg.py``'s float64 bar);
* KMeans (the host route, seeded from numpy in both) with
  ``ClusteringEvaluator``: 1e-10;
* front ends on the host float64 plane (``executorDevice='off'``): 1e-12;
  on the port's device plane (float32 on the CPU): 1e-4
  (``tests/test_torch_spark_plane.py``'s ``FIT_F32_RTOL``).

Persistence is held both ways, in memory and at the DataFrame layer; the
CV over ALS of ``tests/test_tuning.py`` waits for ALS (ROADMAP queue 1
item 7f).
"""

import numpy as np
import pytest

from spark_rapids_ml_tpu.obs import devmon as jax_devmon
from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu_torch import spark as S
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
from spark_rapids_ml_tpu_torch.models import tuning as pt
from spark_rapids_ml_tpu_torch.obs import devmon, fitmon, metrics
from spark_rapids_ml_tpu_torch.spark import local_engine as le

LINREG_RTOL = 1e-9
LOGREG_RTOL = 1e-8
CLUSTER_RTOL = 1e-10
HOST_PLANE_RTOL = 1e-12
DEVICE_PLANE_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """The CPU requested, and metrics registries of this test's own in both
    packages (fits and transforms report into them)."""
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


def _jax():
    import spark_rapids_ml_tpu as J
    from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxFrame

    return J, JaxFrame


def _port():
    import spark_rapids_ml_tpu_torch as P

    return P, VectorFrame


def _rel(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _reg_cols(seed=42, n=240, d=6, noise=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    return {"features": x,
            "label": x @ rng.normal(size=d) + noise * rng.normal(size=n)}


def _both(fn):
    """``fn(package, frame class)`` through the port and the JAX package."""
    return fn(*_port()), fn(*_jax())


def _lr(M, dtype="float64"):
    est = M.LinearRegression()
    return est.setDtype(dtype) if M.__name__.endswith("_torch") else est


# -- the in-memory layer -------------------------------------------------------

def test_param_grid_builder_equals_jax():
    def grid(M, _):
        return (M.ParamGridBuilder().addGrid("regParam", [0.0, 0.1, 1.0])
                .addGrid("fitIntercept", [True, False])
                .baseOn({"maxIter": 7}).build())

    ours, ref = _both(grid)
    assert ours == ref and len(ours) == 6
    assert all(m["maxIter"] == 7 for m in ours)


@pytest.mark.parametrize("kind", ["ndarray", "list"])
def test_select_rows_equals_jax(kind):
    x = np.arange(24.0).reshape(8, 3)
    cols = {"features": x if kind == "ndarray" else list(x),
            "label": list(range(8))}
    idx = [5, 0, 3]
    got = VectorFrame(cols).select_rows(idx)
    want = _jax()[1](cols).select_rows(idx)
    assert got.columns == want.columns and len(got) == len(want) == 3
    np.testing.assert_array_equal(got.vectors_as_matrix("features"),
                                  want.vectors_as_matrix("features"))
    assert got.column("label") == want.column("label") == [5, 0, 3]


def test_cross_validator_linear_regression_matches_jax():
    cols = _reg_cols()

    def run(M, F):
        cv = M.CrossValidator(
            estimator=_lr(M),
            estimatorParamMaps=M.ParamGridBuilder()
            .addGrid("regParam", [1e-6, 1e4]).build(),
            evaluator=M.RegressionEvaluator(), numFolds=3)
        return cv.fit(F(cols))

    ours, ref = _both(run)
    assert ours.bestIndex == ref.bestIndex == 0
    assert ours.avgMetrics[0] < ours.avgMetrics[1]
    assert _rel(ours.avgMetrics, ref.avgMetrics) <= LINREG_RTOL
    assert _rel(ours.bestModel.coefficients,
                ref.bestModel.coefficients) <= LINREG_RTOL
    pred = np.asarray(ours.transform(VectorFrame(cols)).column("prediction"))
    assert float(np.sqrt(((pred - cols["label"]) ** 2).mean())) < 0.2
    assert ours.fit_report_.algo == "cross_validator"


def test_train_validation_split_logistic_regression_matches_jax():
    rng = np.random.default_rng(42)
    x = rng.normal(size=(600, 6))
    p = 1.0 / (1.0 + np.exp(-(x @ (rng.normal(size=6) * 2.0))))
    cols = {"features": x, "label": (rng.uniform(size=600) < p).astype(float)}

    def run(M, F):
        est = M.LogisticRegression().setMaxIter(25)
        if M.__name__.endswith("_torch"):
            est = est.setDtype("float64")
        return M.TrainValidationSplit(
            estimator=est, estimatorParamMaps=M.ParamGridBuilder()
            .addGrid("regParam", [1e-4, 1e3]).build(),
            evaluator=M.BinaryClassificationEvaluator(),
            trainRatio=0.7).fit(F(cols))

    ours, ref = _both(run)
    assert ours.bestIndex == ref.bestIndex == 0
    assert ours.validationMetrics[0] > 0.8
    assert _rel(ours.validationMetrics, ref.validationMetrics) <= LOGREG_RTOL
    assert ours.fit_report_.algo == "train_validation_split"


def test_cross_validator_over_pipeline_matches_jax():
    cols = _reg_cols()

    def run(M, F):
        return M.CrossValidator(
            estimator=M.Pipeline(stages=[
                M.StandardScaler().setOutputCol("scaled"),
                _lr(M).setInputCol("scaled")]),
            estimatorParamMaps=M.ParamGridBuilder()
            .addGrid("1.regParam", [1e-6, 1e4]).build(),
            evaluator=M.RegressionEvaluator(), numFolds=3).fit(F(cols))

    ours, ref = _both(run)
    assert ours.bestIndex == ref.bestIndex == 0
    assert _rel(ours.avgMetrics, ref.avgMetrics) <= LINREG_RTOL
    assert "prediction" in ours.transform(VectorFrame(cols)).columns

    # an unknown plain name raises with the pinning hint, in both
    def bad(M, F):
        with pytest.raises(ValueError, match="stage") as err:
            M.CrossValidator(
                estimator=M.Pipeline(stages=[M.LinearRegression()]),
                estimatorParamMaps=[{"nosuchparam": 1}],
                evaluator=M.RegressionEvaluator(), numFolds=2).fit(F(cols))
        return str(err.value)

    mine, theirs = _both(bad)
    assert mine == theirs


def test_cross_validator_multiclass_matches_jax():
    rng = np.random.default_rng(42)
    k, d, n = 3, 4, 360
    centers = rng.normal(scale=3, size=(k, d))
    y = rng.integers(0, k, size=n).astype(float)
    x = rng.normal(size=(n, d)) + centers[y.astype(int)]

    def run(M, F):
        est = M.LogisticRegression()
        if M.__name__.endswith("_torch"):
            est = est.setDtype("float64")
        return M.CrossValidator(
            estimator=est, estimatorParamMaps=M.ParamGridBuilder()
            .addGrid("regParam", [0.01, 1.0]).build(),
            evaluator=M.MulticlassClassificationEvaluator(),
            numFolds=3, seed=7).fit(F({"features": x, "label": list(y)}))

    ours, ref = _both(run)
    assert ours.bestIndex == ref.bestIndex
    assert _rel(ours.avgMetrics, ref.avgMetrics) <= LOGREG_RTOL
    pred = np.asarray(ours.transform(VectorFrame({"features": x}))
                      .column("prediction"))
    assert (pred == y).mean() > 0.85


def test_cross_validator_kmeans_silhouette_matches_jax():
    rng = np.random.default_rng(5)
    truth = rng.integers(0, 3, size=240)
    x = rng.normal(size=(240, 3)) + 20.0 * np.eye(3)[truth]

    def run(M, F):
        # the host route: both packages seed k-means++ from numpy alike, so
        # k = 2 and 5 (no blob-aligned partition) pick the same centres
        est = M.KMeans().setSeed(3).setUseXlaDot(False)
        return M.CrossValidator(
            estimator=est, estimatorParamMaps=M.ParamGridBuilder()
            .addGrid("k", [2, 3, 5]).build(),
            evaluator=M.ClusteringEvaluator(), numFolds=3,
            seed=11).fit(F({"features": x}))

    ours, ref = _both(run)
    assert ours.bestIndex == ref.bestIndex == 1
    assert _rel(ours.avgMetrics, ref.avgMetrics) <= CLUSTER_RTOL


def test_cross_validator_fold_col_matches_jax():
    rng = np.random.default_rng(42)
    n = 120
    x = rng.normal(size=(n, 3))
    cols = {"features": x, "label": x[:, 0] * 2 + 0.1 * rng.normal(size=n),
            "fold": (np.arange(n) % 3).astype(float)}

    def run(M, F):
        return M.CrossValidator(
            estimator=_lr(M),
            estimatorParamMaps=[{"regParam": 0.0}, {"regParam": 10.0}],
            evaluator=M.RegressionEvaluator(), numFolds=3,
            foldCol="fold").fit(F(cols))

    ours, ref = _both(run)
    assert ours.avgMetrics[0] < ours.avgMetrics[1]
    assert _rel(ours.avgMetrics, ref.avgMetrics) <= LINREG_RTOL

    def errors(M, F):
        out = []
        for fold, folds in (((np.arange(n) % 5).astype(float), 3),
                            ((np.arange(n) % 3) + 0.5, 3),
                            (np.zeros(n), 2)):
            with pytest.raises(ValueError) as err:
                M.CrossValidator(
                    estimator=M.LinearRegression(), estimatorParamMaps=[{}],
                    evaluator=M.RegressionEvaluator(), numFolds=folds,
                    foldCol="fold").fit(F({**cols, "fold": fold}))
            out.append(str(err.value))
        return out

    mine, theirs = _both(errors)
    assert mine == theirs
    assert "lie in" in mine[0] and "integer" in mine[1]


def test_validation_errors_equal_jax():
    cols = _reg_cols(n=4)

    def errors(M, F):
        out = []
        for fit in (lambda: M.CrossValidator(
                        estimator=M.LinearRegression(),
                        evaluator=M.RegressionEvaluator(),
                        numFolds=5).fit(F(cols)),
                    lambda: M.CrossValidator().fit(F(cols)),
                    lambda: M.TrainValidationSplit(
                        estimator=M.LinearRegression(),
                        evaluator=M.RegressionEvaluator(),
                        trainRatio=0.1).fit(F(cols))):
            with pytest.raises(ValueError) as err:
                fit()
            out.append(str(err.value))
        return out

    mine, theirs = _both(errors)
    assert mine == theirs
    assert "folds" in mine[0] and "estimator and evaluator" in mine[1]


@pytest.mark.parametrize("metrics,larger", [
    ([0.3, float("nan"), 0.1], False), ([0.3, float("nan"), 0.1], True),
    ([float("inf"), 2.0], False), ([1.0, 1.0], True),
    ([float("nan"), float("nan")], True)])
def test_best_index_is_nan_safe_as_jax(metrics, larger):
    from spark_rapids_ml_tpu.models import tuning as jt

    if all(not np.isfinite(m) for m in metrics):
        for fn in (pt._best_index, jt._best_index):
            with pytest.raises(ValueError, match="non-finite"):
                fn(metrics, larger)
        return
    assert pt._best_index(metrics, larger) == jt._best_index(metrics, larger)


def test_collect_sub_models():
    rng = np.random.default_rng(42)
    x = rng.normal(size=(60, 3))
    frame = VectorFrame({"features": x, "label": x @ [1.0, -2.0, 0.5]})
    grid = [{"regParam": 1e-6}, {"regParam": 1.0}]
    P, _ = _port()
    cv = P.CrossValidator(estimator=_lr(P), estimatorParamMaps=grid,
                          evaluator=P.RegressionEvaluator(), numFolds=3,
                          collectSubModels=True, parallelism=4)
    model = cv.fit(frame)
    assert len(model.subModels) == 3
    assert all(len(fold) == 2 for fold in model.subModels)
    assert all(m.coefficients is not None
               for fold in model.subModels for m in fold)
    assert model.copy().subModels is model.subModels
    assert P.CrossValidator(estimator=_lr(P), estimatorParamMaps=grid,
                            evaluator=P.RegressionEvaluator(),
                            numFolds=3).fit(frame).subModels is None
    tm = P.TrainValidationSplit(estimator=_lr(P), estimatorParamMaps=grid,
                                evaluator=P.RegressionEvaluator(),
                                collectSubModels=True).fit(frame)
    assert len(tm.subModels) == 2


# -- in-memory persistence -----------------------------------------------------

def _cv(M, cols):
    return M.CrossValidator(
        estimator=_lr(M),
        estimatorParamMaps=[{"regParam": 1e-6}, {"regParam": 0.5}],
        evaluator=M.RegressionEvaluator(), numFolds=3, seed=5)


def test_tuning_persistence_roundtrip(tmp_path):
    P, _ = _port()
    cols = _reg_cols(n=40, d=3)
    frame = VectorFrame(cols)
    cv = _cv(P, cols)
    cv.save(str(tmp_path / "cv"))
    cv2 = P.CrossValidator.load(str(tmp_path / "cv"))
    assert cv2.getNumFolds() == 3 and cv2.getSeed() == 5
    assert cv2.estimatorParamMaps == cv.estimatorParamMaps
    assert type(cv2.estimator) is P.LinearRegression
    assert type(cv2.evaluator) is P.RegressionEvaluator
    m1, m2 = cv.fit(frame), cv2.fit(frame)
    np.testing.assert_allclose(m1.avgMetrics, m2.avgMetrics, atol=1e-10)
    m1.save(str(tmp_path / "cvm"))
    loaded = P.CrossValidatorModel.load(str(tmp_path / "cvm"))
    assert loaded.bestIndex == m1.bestIndex
    assert loaded.avgMetrics == m1.avgMetrics
    assert loaded.estimatorParamMaps == cv.estimatorParamMaps
    np.testing.assert_array_equal(loaded.bestModel.coefficients,
                                  m1.bestModel.coefficients)
    np.testing.assert_array_equal(
        np.asarray(loaded.transform(frame).column("prediction")),
        np.asarray(m1.transform(frame).column("prediction")))
    tvs = P.TrainValidationSplit(estimator=_lr(P),
                                 estimatorParamMaps=cv.estimatorParamMaps,
                                 evaluator=P.RegressionEvaluator(),
                                 trainRatio=0.6).fit(frame)
    tvs.save(str(tmp_path / "tvsm"))
    back = P.TrainValidationSplitModel.load(str(tmp_path / "tvsm"))
    assert back.validationMetrics == tvs.validationMetrics
    assert back.bestIndex == tvs.bestIndex and back.getTrainRatio() == 0.6


@pytest.mark.parametrize("what", ["CrossValidator", "CrossValidatorModel",
                                  "TrainValidationSplitModel"])
def test_jax_saved_tuning_loads_in_port(tmp_path, what):
    from spark_rapids_ml_tpu_torch.io.persistence import load_model

    J, JaxFrame = _jax()
    P, _ = _port()
    cols = _reg_cols(n=40, d=3)
    cv = _cv(J, cols)
    if what == "CrossValidator":
        obj = cv
    elif what == "CrossValidatorModel":
        obj = cv.fit(JaxFrame(cols))
    else:
        obj = J.TrainValidationSplit(
            estimator=J.LinearRegression(),
            estimatorParamMaps=cv.estimatorParamMaps,
            evaluator=J.RegressionEvaluator()).fit(JaxFrame(cols))
    path = str(tmp_path / "jax")
    obj.save(path)
    for loaded in (getattr(P, what).load(path), load_model(path)):
        assert type(loaded) is getattr(P, what)
        assert type(loaded.estimator) is P.LinearRegression
        assert type(loaded.evaluator) is P.RegressionEvaluator
        assert loaded.estimatorParamMaps == cv.estimatorParamMaps
        if what == "CrossValidator":
            continue
        assert loaded.bestIndex == obj.bestIndex
        metric = ("avgMetrics" if what == "CrossValidatorModel"
                  else "validationMetrics")
        assert getattr(loaded, metric) == getattr(obj, metric)
        assert type(loaded.bestModel) is P.LinearRegressionModel
        np.testing.assert_array_equal(loaded.bestModel.coefficients,
                                      np.asarray(obj.bestModel.coefficients))
        # 'auto' is float64 in the JAX suite (x64) and float32 in the port
        loaded.bestModel.setDtype("float64")
        got = np.asarray(loaded.transform(VectorFrame(cols))
                         .column("prediction"))
        want = np.asarray(obj.transform(JaxFrame(cols)).column("prediction"))
        assert _rel(got, want) <= LINREG_RTOL


def test_port_saved_cv_model_loads_in_jax(tmp_path):
    """The JAX reader imports the classes the metadata records, so its
    nested stages come back as the port's (a shared behaviour, ROADMAP
    queue 3 item 7); the nested best model also loads with the JAX class's
    own reader."""
    J, JaxFrame = _jax()
    P, _ = _port()
    cols = _reg_cols(n=40, d=3)
    ours = _cv(P, cols).fit(VectorFrame(cols))
    path = str(tmp_path / "port")
    ours.save(path)
    back = J.CrossValidatorModel.load(path)
    assert back.bestIndex == ours.bestIndex
    assert back.avgMetrics == ours.avgMetrics
    assert back.estimatorParamMaps == ours.estimatorParamMaps
    best = J.LinearRegressionModel.load(str(tmp_path / "port" / "bestModel"))
    np.testing.assert_array_equal(np.asarray(best.coefficients),
                                  ours.bestModel.coefficients)
    assert best.intercept == ours.bestModel.intercept


# -- the DataFrame front end ---------------------------------------------------

def _frames(cols, n_partitions=3):
    """The same rows as a JAX and a port local DataFrame."""
    from spark_rapids_ml_tpu.spark import local_engine as jle

    def build(module):
        n = len(cols["label"])
        rows = [{k: (module.DenseVector(v[i]) if np.ndim(v[i]) else
                     float(v[i])) for k, v in cols.items()}
                for i in range(n)]
        return module.LocalSparkSession(n_partitions=n_partitions) \
            .createDataFrame(rows)

    return build(le), build(jle)


def _js():
    import spark_rapids_ml_tpu.spark as JS

    return JS


def _front_lr(Sx, device="off", features="features"):
    return Sx.LinearRegression(featuresCol=features, labelCol="label",
                               predictionCol="prediction",
                               executorDevice=device)


def _preds(model, df):
    return np.asarray([r["prediction"] for r in model.transform(df).collect()])


@pytest.mark.parametrize("device", ["off", "on"])
def test_front_cross_validator_matches_jax(device):
    JS = _js()
    cols = _reg_cols(seed=7, n=150, d=4, noise=0.01)
    pdf, jdf = _frames(cols)

    def run(Sx, df, dev):
        return Sx.CrossValidator(
            estimator=_front_lr(Sx, dev),
            estimatorParamMaps=Sx.ParamGridBuilder()
            .addGrid("regParam", [0.0, 100.0]).build(),
            evaluator=Sx.RegressionEvaluator(metricName="rmse"),
            numFolds=3, seed=7).fit(df)

    ours, ref = run(S, pdf, device), run(JS, jdf, "off")
    bar = HOST_PLANE_RTOL if device == "off" else DEVICE_PLANE_RTOL
    assert ours.bestIndex == ref.bestIndex == 0
    assert _rel(ours.avgMetrics, ref.avgMetrics) <= bar
    assert _rel(_preds(ours, pdf), _preds(ref, jdf)) <= bar
    assert type(ours) is S.CrossValidatorModel


def test_front_fold_col_matches_jax():
    JS = _js()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(30, 2))
    cols = {"features": x, "label": x @ [1.0, 1.0],
            "fold": [float(i % 3) for i in range(30)]}
    pdf, jdf = _frames(cols)

    def run(Sx, df, folds):
        return Sx.CrossValidator(
            estimator=_front_lr(Sx), estimatorParamMaps=[{}],
            evaluator=Sx.RegressionEvaluator(), numFolds=folds,
            foldCol="fold").fit(df)

    ours, ref = run(S, pdf, 3), run(JS, jdf, 3)
    assert len(ours.avgMetrics) == 1
    assert _rel(ours.avgMetrics, ref.avgMetrics) <= HOST_PLANE_RTOL
    for Sx, df in ((S, pdf), (JS, jdf)):
        with pytest.raises(ValueError, match="fold"):
            run(Sx, df, 4)


def test_front_train_validation_split_matches_jax():
    JS = _js()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(120, 3))
    pdf, jdf = _frames({"features": x, "label": x @ [2.0, 0.0, -1.0]})

    def run(Sx, df):
        return Sx.TrainValidationSplit(
            estimator=_front_lr(Sx), estimatorParamMaps=Sx.ParamGridBuilder()
            .addGrid("regParam", [0.0, 50.0]).build(),
            evaluator=Sx.RegressionEvaluator(metricName="r2"),
            trainRatio=0.75, seed=9, collectSubModels=True).fit(df)

    ours, ref = run(S, pdf), run(JS, jdf)
    assert ours.bestIndex == ref.bestIndex == 0
    assert len(ours.subModels) == 2
    assert _rel(ours.validationMetrics, ref.validationMetrics) <= \
        HOST_PLANE_RTOL


def _front_pipe(Sx, device="off"):
    return Sx.Pipeline(stages=[
        Sx.StandardScaler(featuresCol="features", outputCol="scaled"),
        _front_lr(Sx, device, features="scaled")])


def test_front_pipeline_compose_and_tune_matches_jax():
    """``tests/test_spark_front_ends.py``'s compose-and-tune case with a
    StandardScaler stage (VectorAssembler's front end waits for ROADMAP
    queue 1 item 7d)."""
    JS = _js()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(90, 3))
    cols = {"features": x,
            "label": x @ [1.0, 0.5, -1.0] + 0.01 * rng.normal(size=90)}
    pdf, jdf = _frames(cols)
    pm, jpm = _front_pipe(S).fit(pdf), _front_pipe(JS).fit(jdf)
    assert type(pm) is S.PipelineModel
    got = _preds(pm, pdf)
    assert _rel(got, _preds(jpm, jdf)) <= HOST_PLANE_RTOL
    assert np.abs(got - cols["label"]).max() < 0.5

    def tune(Sx, df):
        return Sx.CrossValidator(
            estimator=_front_pipe(Sx), estimatorParamMaps=Sx.ParamGridBuilder()
            .addGrid("regParam", [0.0, 100.0]).build(),
            evaluator=Sx.RegressionEvaluator(), numFolds=3, seed=1).fit(df)

    ours, ref = tune(S, pdf), tune(JS, jdf)
    assert ours.bestIndex == ref.bestIndex == 0
    assert _rel(ours.avgMetrics, ref.avgMetrics) <= HOST_PLANE_RTOL


@pytest.mark.parametrize("saved_by", ["port", "jax"])
def test_front_pipeline_persistence(tmp_path, saved_by):
    """A fitted front PipelineModel saved by either package loads in the
    port at the DataFrame layer (the ``front_class.json`` sidecar, resolved
    by simple name)."""
    JS = _js()
    rng = np.random.default_rng(6)
    x = rng.normal(size=(40, 3))
    pdf, jdf = _frames({"features": x, "label": x @ [1.0, -1.0, 2.0]})
    pm = (_front_pipe(S).fit(pdf) if saved_by == "port"
          else _front_pipe(JS).fit(jdf))
    path = str(tmp_path / "pipe")
    pm.save(path)
    loaded = S.PipelineModel.load(path)
    assert [type(s) for s in loaded.stages] == [S.StandardScalerModel,
                                                S.LinearRegressionModel]
    want = _preds(pm, pdf if saved_by == "port" else jdf)
    np.testing.assert_allclose(_preds(loaded, pdf), want, rtol=1e-12)
    if saved_by == "port":
        back = JS.PipelineModel.load(path)
        assert [type(s).__name__ for s in back.stages] == [
            "StandardScalerModel", "LinearRegressionModel"]


@pytest.mark.parametrize("saved_by", ["port", "jax"])
def test_front_cv_model_persistence(tmp_path, saved_by):
    JS = _js()
    rng = np.random.default_rng(8)
    x = rng.normal(size=(60, 3))
    cols = {"features": x, "label": x @ [1.0, -1.0, 2.0]}
    pdf, jdf = _frames(cols)

    def cv(Sx):
        return Sx.CrossValidator(
            estimator=_front_lr(Sx), estimatorParamMaps=Sx.ParamGridBuilder()
            .addGrid("regParam", [0.0, 10.0]).build(),
            evaluator=Sx.RegressionEvaluator(), numFolds=3, seed=7)

    fitted = cv(S).fit(pdf) if saved_by == "port" else cv(JS).fit(jdf)
    path = str(tmp_path / "cvm")
    fitted.save(path)
    loaded = S.CrossValidatorModel.load(path)
    assert type(loaded.bestModel) is S.LinearRegressionModel
    assert type(loaded.estimator) is S.LinearRegression
    assert loaded.avgMetrics == fitted.avgMetrics
    assert loaded.bestIndex == fitted.bestIndex
    out = loaded.transform(pdf)
    assert hasattr(out, "withColumn")
    want = _preds(fitted, pdf if saved_by == "port" else jdf)
    np.testing.assert_allclose(_preds(loaded, pdf), want, rtol=1e-12)
    if saved_by == "port":
        back = JS.CrossValidatorModel.load(path)
        assert back.avgMetrics == fitted.avgMetrics
        best = JS.LinearRegressionModel.load(str(tmp_path / "cvm" /
                                                 "bestModel"))
        np.testing.assert_array_equal(best.coefficients.toArray(),
                                      fitted.bestModel.coefficients.toArray())
    # the unfitted front estimator round-trips too
    cv(S).save(str(tmp_path / "cv"))
    cv2 = S.CrossValidator.load(str(tmp_path / "cv"))
    assert type(cv2.estimator) is S.LinearRegression
    assert cv2.getNumFolds() == 3


def test_tuned_pipeline_keeps_prefit_stage_state():
    JS = _js()
    rng = np.random.default_rng(9)
    x = rng.normal(size=(60, 3))
    pdf, jdf = _frames({"features": x, "label": x @ [1.0, -1.0, 2.0]})

    def run(Sx, df):
        pca_model = Sx.PCA(k=2, inputCol="features", outputCol="p",
                           executorDevice="off").fit(df)
        pipe = Sx.Pipeline(stages=[pca_model,
                                   _front_lr(Sx, features="p")])
        return Sx.CrossValidator(
            estimator=pipe, estimatorParamMaps=[{}],
            evaluator=Sx.RegressionEvaluator(), numFolds=2, seed=2).fit(df)

    ours, ref = run(S, pdf), run(JS, jdf)
    assert len(ours.avgMetrics) == 1 and np.isfinite(ours.avgMetrics[0])
    # the port's PCA projects in float32 ('auto'), held at the spark plane
    # tests' PCA transform bar
    assert _rel(ours.avgMetrics, ref.avgMetrics) <= 1e-5
