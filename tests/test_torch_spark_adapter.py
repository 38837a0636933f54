"""The generic DataFrame adapter in the port (``spark/adapter.py``,
``spark/adapter2.py``), run through the port's local engine: the front
ends of ``tests/test_spark_adapter.py`` for the families the port has,
the bodies its ``pandas_udf``s wrap, ``_host_fitted_state`` on every
ported family, and the adapter models against the JAX package's on the
same fitted state and rows (float64 host products: ≤ 1e-12 relative).
"""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.models import glm as jax_glm
from spark_rapids_ml_tpu.models import linear_svc as jax_svc
from spark_rapids_ml_tpu.obs import devmon as jax_devmon
from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu.spark import adapter as jax_adapter
from spark_rapids_ml_tpu.spark import local_engine as jle
import spark_rapids_ml_tpu_torch as port_pkg
import spark_rapids_ml_tpu_torch.spark as port_spark
from spark_rapids_ml_tpu_torch.models import glm
from spark_rapids_ml_tpu_torch.models import linear_svc
from spark_rapids_ml_tpu_torch.obs import devmon, fitmon, metrics
from spark_rapids_ml_tpu_torch.spark import adapter
from spark_rapids_ml_tpu_torch.spark import adapter2
from spark_rapids_ml_tpu_torch.spark.local_engine import (
    DenseVector,
    LocalSparkSession,
)

RTOL = 1e-12


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """The CPU requested, and metrics registries of this test's own in both
    packages (the transforms' ``observed_transform`` write into them)."""
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


@pytest.fixture
def spark():
    return LocalSparkSession(n_partitions=2)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _df(spark, x, y=None, dense=DenseVector, extra=()):
    rows = []
    for i, r in enumerate(x):
        row = {"features": dense(r)}
        if y is not None:
            row["label"] = float(y[i])
        for name, values in extra:
            row[name] = float(values[i])
        rows.append(row)
    return spark.createDataFrame(rows)


def _vectors(df, col):
    return np.stack([r[col].toArray() for r in df.collect()])


def _scalars(df, col):
    return np.asarray([r[col] for r in df.collect()], dtype=np.float64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def test_random_forest_classifier_front_end(spark, rng):
    x = rng.normal(size=(300, 6))
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(float)
    df = _df(spark, x, y)
    model = port_spark.RandomForestClassifier(numTrees=15, maxDepth=4,
                                              seed=3).fit(df)
    assert (_scalars(model.transform(df), "prediction") == y).mean() > 0.9


def test_gbt_regressor_front_end(spark, rng):
    x = rng.normal(size=(300, 4))
    y = 2.0 * x[:, 0] - x[:, 1] + 0.1 * rng.normal(size=300)
    df = _df(spark, x, y)
    model = port_spark.GBTRegressor(maxIter=15, maxDepth=3, stepSize=0.3,
                                    seed=5).fit(df)
    pred = _scalars(model.transform(df), "prediction")
    assert np.corrcoef(pred, y)[0, 1] > 0.9


def test_linear_svc_front_end(spark, rng):
    x = rng.normal(size=(400, 5))
    w = np.array([2.0, -1.0, 0.0, 1.0, -0.5])
    y = (x @ w + 0.2 > 0).astype(float)
    df = _df(spark, x, y)
    model = adapter.LinearSVC(regParam=0.01).fit(df)
    assert (_scalars(model.transform(df), "prediction") == y).mean() > 0.95


def test_scalers_front_end(spark, rng):
    x = rng.normal(size=(150, 4)) * np.array([1.0, 10.0, 0.1, 5.0]) + 2.0
    df = _df(spark, x)
    ss = adapter.StandardScaler(withMean=True, withStd=True,
                                dtype="float64").fit(df)
    scaled = _vectors(ss.transform(df), "scaled_features")
    np.testing.assert_allclose(scaled.mean(axis=0), 0.0, atol=1e-9)
    np.testing.assert_allclose(scaled.std(axis=0, ddof=1), 1.0, atol=1e-9)

    mm = adapter.MinMaxScaler().fit(df)
    out = _vectors(mm.transform(df), mm._local.getOutputCol())
    np.testing.assert_allclose(out.min(axis=0), 0.0, atol=1e-12)
    np.testing.assert_allclose(out.max(axis=0), 1.0, atol=1e-12)

    ma = adapter.MaxAbsScaler().fit(df)
    out = _vectors(ma.transform(df), ma._local.getOutputCol())
    np.testing.assert_allclose(np.abs(out).max(axis=0), 1.0, atol=1e-12)

    rs = adapter.RobustScaler(withCentering=True).fit(df)
    out = _vectors(rs.transform(df), rs._local.getOutputCol())
    np.testing.assert_allclose(np.median(out, axis=0), 0.0, atol=1e-9)


def test_nearest_neighbors_front_end(spark, rng):
    items = rng.normal(size=(200, 8))
    model = port_spark.NearestNeighbors(k=5).fit(_df(spark, items))
    dist, idx = model.kneighbors(_df(spark, items[:10] + 1e-6))
    assert dist.shape == (10, 5) and idx.shape == (10, 5)
    np.testing.assert_array_equal(idx[:, 0], np.arange(10))
    with pytest.raises(NotImplementedError, match="kneighbors"):
        model.transform(_df(spark, items[:3]))


def test_nearest_neighbors_frame_matches_driver_query(spark, rng):
    """kneighbors_frame runs queries on executors (mapInArrow) and agrees
    row for row with the driver-array kneighbors path."""
    items = rng.normal(size=(120, 5))
    qdf = _df(spark, rng.normal(size=(40, 5)))
    model = port_spark.NearestNeighbors(k=4).fit(_df(spark, items))
    d_ref, i_ref = model.kneighbors(qdf)
    out = model.kneighbors_frame(qdf).collect()
    np.testing.assert_array_equal(
        np.stack([np.asarray(r["knn_indices"]) for r in out]), i_ref)
    np.testing.assert_allclose(
        np.stack([np.asarray(r["knn_distances"]) for r in out]), d_ref,
        atol=1e-12)


def test_adapter_persistence_roundtrip(spark, rng, tmp_path):
    x = rng.normal(size=(200, 4))
    y = (x[:, 0] > 0).astype(float)
    df = _df(spark, x, y)
    model = port_spark.RandomForestClassifier(numTrees=8, maxDepth=3,
                                              seed=1).fit(df)
    path = str(tmp_path / "rf_front")
    model.save(path)
    loaded = port_spark.RandomForestClassifierModel.load(path)
    assert _scalars(model.transform(df), "prediction").tolist() == \
        _scalars(loaded.transform(df), "prediction").tolist()
    svc = adapter.LinearSVC(regParam=0.05)
    svc.save(str(tmp_path / "svc_est"))
    assert adapter.LinearSVC.load(str(tmp_path / "svc_est")) \
        .getRegParam() == 0.05


def test_adapter_unknown_param_raises():
    with pytest.raises(ValueError, match="no param"):
        port_spark.RandomForestClassifier(nope=3)
    with pytest.raises(ValueError, match="no param"):
        adapter.StandardScaler().setNope(1)


def test_truncated_svd_front_end(spark, rng):
    x = rng.normal(size=(150, 8)) * np.linspace(3.0, 0.5, 8)
    df = _df(spark, x)
    model = adapter.TruncatedSVD(k=3, dtype="float64").fit(df)
    proj = _vectors(model.transform(df), model._local.getOutputCol())
    assert proj.shape == (150, 3)
    v = proj.var(axis=0)
    assert v[0] >= v[1] >= v[2]


def test_classifier_front_ends_emit_probabilities(spark, rng):
    x = rng.normal(size=(200, 4))
    y = (x[:, 0] > 0).astype(float)
    df = _df(spark, x, y)
    rf = port_spark.RandomForestClassifier(numTrees=8, maxDepth=3,
                                           seed=2).fit(df)
    out = rf.transform(df)
    proba = _vectors(out, "probability")
    assert proba.shape == (200, 2)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-9)
    np.testing.assert_array_equal(_scalars(out, "prediction"),
                                  proba.argmax(axis=1))
    gbt = port_spark.GBTClassifier(maxIter=10, maxDepth=2, seed=2).fit(df)
    out = gbt.transform(df)
    p = _vectors(out, "probability")
    assert ((p >= 0) & (p <= 1)).all()
    np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-12)
    np.testing.assert_array_equal(_scalars(out, "prediction"),
                                  (p[:, 1] > 0.5).astype(float))


def test_probability_column_suppression(spark, rng):
    x = rng.normal(size=(120, 3))
    y = (x[:, 0] > 0).astype(float)
    df = _df(spark, x, y)
    rf = port_spark.RandomForestClassifier(numTrees=5, maxDepth=2,
                                           seed=1).fit(df)
    rf.setProbabilityCol("")
    out = rf.transform(df)
    assert "probability" not in out.columns and "" not in out.columns
    assert "prediction" in out.columns


def test_linear_svc_raw_prediction_vector(spark, rng):
    """rawPrediction is Spark's 2-vector [-margin, margin]; the prediction
    follows the margin-vs-threshold rule."""
    x = rng.normal(size=(200, 4))
    y = (x @ np.array([1.0, -2.0, 0.5, 0.0]) > 0).astype(float)
    df = _df(spark, x, y)
    model = adapter.LinearSVC(regParam=0.01).fit(df)
    out = model.transform(df)
    raw = _vectors(out, "rawPrediction")
    assert raw.shape == (200, 2)
    np.testing.assert_allclose(raw[:, 0], -raw[:, 1])
    np.testing.assert_array_equal(_scalars(out, "prediction"),
                                  (raw[:, 1] > 0.0).astype(float))
    np.testing.assert_allclose(raw[:, 1], model._local.decision_function(x),
                               atol=1e-12)


def test_linear_svc_raw_suppression(spark, rng):
    x = rng.normal(size=(80, 3))
    y = (x[:, 0] > 0).astype(float)
    model = adapter.LinearSVC(regParam=0.01).fit(_df(spark, x, y))
    model.setRawPredictionCol("")
    out = model.transform(_df(spark, x, y))
    assert "rawPrediction" not in out.columns and "" not in out.columns
    assert "prediction" in out.columns


def test_glm_front_end_eta_mu_and_offset(spark, rng):
    x = rng.normal(size=(200, 3))
    off = rng.normal(size=200) * 0.1
    y = rng.poisson(np.exp(0.4 * x[:, 0] - 0.3 * x[:, 1] + off)) \
        .astype(float)
    df = _df(spark, x, y, extra=[("off", off)])
    # the adapter collects features, label and weight (as the JAX
    # adapter does); the offset enters at transform
    model = adapter.GeneralizedLinearRegression(
        family="poisson", linkPredictionCol="eta", dtype="float64").fit(df)
    model.setOffsetCol("off")
    out = model.transform(df)
    local = model._local
    eta = x @ local.coefficients + local.intercept + off
    np.testing.assert_allclose(_scalars(out, "eta"), eta, rtol=RTOL)
    np.testing.assert_allclose(_scalars(out, "prediction"), np.exp(eta),
                               rtol=RTOL)
    with pytest.raises(ValueError, match="missing from the input"):
        model.transform(_df(spark, x))


def test_collect_envelope_guard(spark, rng, monkeypatch):
    """The driver collect is envelope-guarded: warn past the soft row cap,
    raise past the hard one (the JAX package's env names)."""
    df = _df(spark, rng.normal(size=(60, 3)))
    monkeypatch.setattr(adapter, "_COLLECT_MAX_ROWS", 50)
    with pytest.raises(ValueError, match="onto the driver"):
        port_spark.NearestNeighbors(k=3).fit(df)
    monkeypatch.setattr(adapter, "_COLLECT_MAX_ROWS", 10_000)
    monkeypatch.setattr(adapter, "_COLLECT_WARN_ROWS", 50)
    with pytest.warns(ResourceWarning):
        port_spark.NearestNeighbors(k=3).fit(df)
    with pytest.raises(ValueError,
                       match="SPARK_RAPIDS_ML_TPU_COLLECT_MAX_ROWS"):
        adapter._check_collect_envelope(_df(spark, np.zeros((10_001, 1))),
                                        "X")


class _Pair(tuple):
    _fields = ("a", "b")

    def __new__(cls, a, b):
        return super().__new__(cls, (a, b))


def test_fitted_state_is_host_resident(spark, rng):
    """Adapter models ship to executors by cloudpickle closure, so their
    fitted state must be host numpy: every torch tensor, nested in
    tuples (named ones too), lists and dicts, becomes an ndarray; a model
    with device caches drops them and restages on its next search."""
    x = rng.normal(size=(120, 5))
    y = (x[:, 0] > 0).astype(float)
    model = port_spark.RandomForestClassifier(numTrees=5, maxDepth=3,
                                              seed=1).fit(_df(spark, x, y))
    local = model._local
    local.extra_ = {"w": torch.ones(3), "pair": _Pair(torch.zeros(2), [
        torch.arange(4), "keep"])}
    adapter._host_fitted_state(local)
    assert isinstance(local.extra_["w"], np.ndarray)
    pair = local.extra_["pair"]
    assert type(pair) is _Pair and isinstance(pair[0], np.ndarray)
    assert isinstance(pair[1][0], np.ndarray) and pair[1][1] == "keep"
    np.testing.assert_array_equal(pair[1][0], np.arange(4))

    items = rng.normal(size=(300, 6))
    queries = rng.normal(size=(20, 6))
    for algorithm in ("brute", "ivfflat"):
        nn = port_pkg.NearestNeighbors().setK(3).setAlgorithm(algorithm) \
            .setDtype("float64").fit(items)
        before = nn.kneighbors(queries)
        assert nn._device_items is not None
        adapter._host_fitted_state(nn)
        assert not any(isinstance(v, torch.Tensor) for v in vars(nn).values())
        assert nn._device_items is None
        after = nn.kneighbors(queries)
        np.testing.assert_array_equal(after[1], before[1])
        np.testing.assert_array_equal(after[0], before[0])


def _tensors(value) -> int:
    if isinstance(value, torch.Tensor):
        return 1
    if isinstance(value, (tuple, list)):
        return sum(_tensors(v) for v in value)
    if isinstance(value, dict):
        return sum(_tensors(v) for v in value.values())
    return 0


def _family_models(rng):
    """A small fitted model of every ported adapter family, with the body
    that serves its column: (name, model, (body, want) pairs)."""
    x = rng.normal(size=(240, 5))
    y = (x[:, 0] - x[:, 1] > 0).astype(float)
    yr = 2.0 * x[:, 0] + x[:, 2]
    counts = rng.poisson(np.exp(0.3 * x[:, 0])).astype(float)

    def chunks(target):
        return lambda: iter([(x[:120], target[:120]),
                             (x[120:], target[120:])])

    fits = {
        "RandomForestClassifier": port_pkg.RandomForestClassifier()
        .setNumTrees(3).setMaxDepth(3).fit(x, y),
        "RandomForestRegressor": port_pkg.RandomForestRegressor()
        .setNumTrees(3).setMaxDepth(3).fit(chunks(yr)),
        "GBTClassifier": port_pkg.GBTClassifier().setMaxIter(3)
        .setMaxDepth(2).fit(chunks(y)),
        "GBTRegressor": port_pkg.GBTRegressor().setMaxIter(3)
        .setMaxDepth(2).fit(x, yr),
        "DecisionTreeClassifier": port_pkg.DecisionTreeClassifier()
        .setMaxDepth(3).fit(chunks(y)),
        "DecisionTreeRegressor": port_pkg.DecisionTreeRegressor()
        .setMaxDepth(3).fit(x, yr),
        "LinearSVC": port_pkg.LinearSVC().setRegParam(0.01).fit(x, y),
        "GeneralizedLinearRegression": port_pkg.GeneralizedLinearRegression()
        .setFamily("poisson").setLinkPredictionCol("eta").fit(x, counts),
        "StandardScaler": port_pkg.StandardScaler().setWithMean(True).fit(x),
        "MinMaxScaler": port_pkg.MinMaxScaler().fit(x),
        "MaxAbsScaler": port_pkg.MaxAbsScaler().fit(x),
        "RobustScaler": port_pkg.RobustScaler().fit(x),
        "TruncatedSVD": port_pkg.TruncatedSVD().setK(3).fit(x),
        "NearestNeighbors": port_pkg.NearestNeighbors().setK(3).fit(x),
        "UMAP": port_pkg.UMAP().setNNeighbors(8).setNEpochs(5).fit(x),
    }
    return x, fits


FAMILIES = ("RandomForestClassifier", "RandomForestRegressor",
            "GBTClassifier", "GBTRegressor", "DecisionTreeClassifier",
            "DecisionTreeRegressor", "LinearSVC",
            "GeneralizedLinearRegression", "StandardScaler", "MinMaxScaler",
            "MaxAbsScaler", "RobustScaler", "TruncatedSVD",
            "NearestNeighbors", "UMAP")


def _outputs(name, model, x):
    """What the family's adapter bodies serve on ``x``, by its own
    methods."""
    if name == "NearestNeighbors":
        return list(model.kneighbors(x))
    if name == "LinearSVC":
        m = model.decision_function(x)
        return [np.stack([-m, m], axis=1),
                model.transform(x).column("prediction")]
    if name == "GeneralizedLinearRegression":
        out = model.transform(x)
        return [out.column("eta"), out.column("prediction")]
    out = model.transform(x)
    if model.has_param("probabilityCol"):
        p = np.asarray(out.column("probability"), dtype=np.float64)
        if p.ndim == 1:
            p = np.stack([1.0 - p, p], axis=1)
        return [p, out.column("prediction")]
    col = (model.getOutputCol() if model.has_param("outputCol")
           else model.getPredictionCol())
    return [np.stack([np.atleast_1d(v) for v in out.column(col)])]


def _bodies(name, model, x):
    """The adapter's module-function bodies on numpy rows."""
    if name == "NearestNeighbors":
        rows = adapter._kneighbors_rows(model, x, None)
        return [np.stack([r["knn_distances"] for r in rows]),
                np.stack([r["knn_indices"] for r in rows])]
    if name == "LinearSVC":
        raw = adapter._svc_raw(model, x)
        return [raw, adapter._svc_prediction(raw, model.getThreshold())]
    if name == "GeneralizedLinearRegression":
        _, link, _, power = model._resolved_family_link()
        eta = adapter._glm_eta(x, model.coefficients, model.intercept)
        return [eta, adapter._glm_mu(eta, link, power)]
    if model.has_param("probabilityCol"):
        classes = getattr(model, "classes_", None)
        classes = np.asarray(classes if classes is not None else [0.0, 1.0])
        p = adapter._classifier_probability(
            model, x, "probability", name.startswith("GBT"))
        return [p, adapter._classifier_prediction(model, p, classes)]
    col = (model.getOutputCol() if model.has_param("outputCol")
           else model.getPredictionCol())
    return [np.stack([np.atleast_1d(v)
                      for v in adapter._model_output(model, x, col)])]


@pytest.fixture(scope="module")
def family_models():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
        yield _family_models(np.random.default_rng(12))


@pytest.mark.parametrize("name", FAMILIES)
def test_every_family_transforms_after_host_fitted_state(family_models,
                                                         name):
    """Each ported family's model, moved to the host by
    ``_host_fitted_state`` as the adapter ships it, serves what it served
    before, and the adapter's bodies on numpy rows serve the same."""
    x, fits = family_models
    model = fits[name]
    before = _outputs(name, model, x)
    adapter._host_fitted_state(model)
    assert _tensors(vars(model)) == 0
    after = _outputs(name, model, x)
    bodies = _bodies(name, model, x)
    for a, b, c in zip(before, after, bodies):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert _rel(c, a) <= RTOL


def test_adapter_models_equal_jax_adapter_models(rng):
    """The adapter's SVC and GLM models against the JAX package's on the
    same fitted state and rows (host float64 products)."""
    x = rng.normal(size=(90, 4))
    off = rng.normal(size=90) * 0.1
    coef, b = rng.normal(size=4), 0.3
    pdf = _df(LocalSparkSession(n_partitions=2), x, extra=[("off", off)])
    jdf = _df(jle.LocalSparkSession(n_partitions=2), x,
              dense=jle.DenseVector, extra=[("off", off)])

    def svc(module, cls):
        m = module.LinearSVCModel(coefficients=coef, intercept=b)
        m.setUseXlaDot(False)
        return cls(m)

    ours = svc(linear_svc, adapter.LinearSVCModel).transform(pdf)
    ref = svc(jax_svc, jax_adapter.LinearSVCModel).transform(jdf)
    assert _rel(_vectors(ours, "rawPrediction"),
                _vectors(ref, "rawPrediction")) <= RTOL
    np.testing.assert_array_equal(_scalars(ours, "prediction"),
                                  _scalars(ref, "prediction"))
    for family, link in (("poisson", "log"), ("binomial", "probit"),
                         ("gamma", "inverse")):
        def glm_model(module, cls):
            m = module.GeneralizedLinearRegressionModel(
                coefficients=coef * 0.1, intercept=0.5)
            m.set("family", family)
            m.set("link", link)
            m.set("offsetCol", "off")
            m.set("linkPredictionCol", "eta")
            return cls(m)

        ours = glm_model(glm, adapter.GeneralizedLinearRegressionModel) \
            .transform(pdf)
        ref = glm_model(jax_glm, jax_adapter.GeneralizedLinearRegressionModel) \
            .transform(jdf)
        for col in ("eta", "prediction"):
            assert _rel(_scalars(ours, col), _scalars(ref, col)) <= RTOL


def test_umap_front_end(spark, rng):
    """The UMAP pair: the fit collects to the driver and embeds there,
    equal to the local fit on the collected rows, from a DataFrame and
    from numpy partitions (``forest_estimator.PartitionFrame``); the
    transform's body is the local model's placement; and the adapter
    model serves what the JAX package's adapter model serves on the same
    fitted state (1e-10, the transform's bar)."""
    from spark_rapids_ml_tpu.models.umap import UMAPModel as JaxUMAPModel
    from spark_rapids_ml_tpu_torch.spark.forest_estimator import (
        PartitionFrame,
    )

    x = np.concatenate([rng.normal(size=(60, 5)) + c
                        for c in (0.0, 6.0)])[rng.permutation(120)]
    local = port_pkg.UMAP().setNNeighbors(8).setNEpochs(20).fit(x)
    model = port_spark.UMAP(nNeighbors=8, nEpochs=20).fit(_df(spark, x))
    assert type(model).__name__ == "UMAPModel"
    np.testing.assert_array_equal(model.embedding_, local.embedding_)
    frame = PartitionFrame([[x[:50]], [x[50:90], x[90:100]], [x[100:]]])
    assert frame.count() == 120
    parts = adapter.UMAP(nNeighbors=8, nEpochs=20)._fit(frame)
    np.testing.assert_array_equal(parts.embedding_, local.embedding_)
    q = rng.normal(size=(30, 5)) + 3.0
    out = _vectors(model.transform(_df(spark, q)), "embedding")
    want = np.asarray(local.transform(q).column("embedding"))
    np.testing.assert_array_equal(out, want)
    body = np.stack(adapter._model_output(model._local, q, "embedding"))
    np.testing.assert_array_equal(body, want)
    jax_model = jax_adapter.UMAPModel(JaxUMAPModel(
        embedding=local.embedding_, train_items=local.train_items_)
        .setNNeighbors(8))
    ours = adapter.UMAPModel(port_pkg.UMAPModel(
        embedding=local.embedding_, train_items=local.train_items_)
        .setNNeighbors(8).setDtype("float64"))
    ref = jax_model.transform(_df(jle.LocalSparkSession(n_partitions=2), q,
                                  dense=jle.DenseVector))
    assert _rel(_vectors(ours.transform(_df(spark, q)), "embedding"),
                _vectors(ref, "embedding")) <= 1e-10


def test_adapter2_and_factory_classes_live_in_their_modules():
    for cls in (adapter2.DecisionTreeClassifier,
                adapter2.DecisionTreeClassifierModel,
                adapter2.DecisionTreeRegressor,
                adapter2.DecisionTreeRegressorModel):
        assert cls.__module__ == adapter2.__name__
        assert getattr(adapter2, cls.__name__) is cls
    for name in adapter.__all__:
        assert getattr(adapter, name).__module__ == adapter.__name__
