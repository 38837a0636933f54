"""The port's persistence and registry repairs, against the JAX package's
behaviour:

* every ``save_*`` writer is atomic (temporary sibling, rename-aside,
  rename into place): the crash cases of tests/test_persistence.py, for
  every family the port saves;
* ``io.persistence.load_model`` loads any family by the class its metadata
  records — whichever package wrote it — without importing the recorded
  module;
* ``ModelRegistry.load`` and its manifest replay go through it, and
  ``warmup`` infers the input width of every family (a pipeline's from its
  first stage), as the JAX registry does.
"""

import os

import numpy as np
import pytest

import spark_rapids_ml_tpu_torch as port_pkg
from spark_rapids_ml_tpu_torch import (
    GeneralizedLinearRegression,
    GeneralizedLinearRegressionModel,
    KMeans,
    LinearSVC,
    LinearSVCModel,
    LinearRegression,
    LinearRegressionModel,
    LogisticRegression,
    LogisticRegressionModel,
    PCA,
    PCAModel,
    Pipeline,
    PipelineModel,
    StandardScaler,
    TruncatedSVD,
    TruncatedSVDModel,
)
from spark_rapids_ml_tpu_torch.io import persistence
from spark_rapids_ml_tpu_torch.io.persistence import load_model
from spark_rapids_ml_tpu_torch.serve import ModelRegistry
from spark_rapids_ml_tpu_torch.serve.registry import _infer_features


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def _xy(seed=0, rows=60, n=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, n))
    return x, x @ np.arange(1.0, n + 1) + 0.5


def _classes(y, k):
    """Labels 0..k-1 from ``y``'s quantiles (k = 2: the binary 0/1)."""
    return np.searchsorted(np.quantile(y, np.linspace(0, 1, k + 1)[1:-1]),
                           y).astype(np.float64)


def _fitted(family):
    x, y = _xy()
    if family == "pca":
        return PCA().setK(2).fit(x)
    if family == "kmeans":
        return KMeans().setK(3).fit(x)
    if family == "scaler":
        return StandardScaler().setWithMean(True).fit(x)
    if family == "linreg":
        return LinearRegression().fit(x, labels=y)
    if family == "svd":
        return TruncatedSVD().setK(2).fit(x)
    if family == "logreg":
        return LogisticRegression().setRegParam(0.1).fit(x, _classes(y, 2))
    if family == "logreg_mn":
        return LogisticRegression().setRegParam(0.1).fit(x, _classes(y, 3))
    if family in ("svc", "glm", "svc_est", "glm_est"):
        return _linear_family(family, x, y, port_pkg)
    if family in KNN_FAMILIES:
        return _knn_family(family, x, port_pkg)
    if family in TREE_FAMILIES:
        return _tree_family(family, x, y, port_pkg)
    if family == "pipeline":
        return Pipeline([
            StandardScaler().setWithMean(True).setOutputCol("s"),
            PCA().setK(3).setInputCol("s").setOutputCol("r"),
            KMeans().setK(2).setInputCol("r"),
        ]).fit(x)
    if family == "estimator":
        return KMeans().setK(4)
    return _stage_family(family, x, port_pkg)


def _linear_family(family, x, y, pkg):
    """LinearSVC and GeneralizedLinearRegression, fitted by ``pkg`` (the
    port or the JAX package), or their estimators, each with a param set
    away from its default."""
    if family == "svc":
        return pkg.LinearSVC().setRegParam(0.1).setThreshold(0.25).fit(
            x, _classes(y, 2))
    if family == "glm":
        return pkg.GeneralizedLinearRegression(family="poisson") \
            .setLinkPredictionCol("eta").fit(x, labels=np.floor(np.abs(y)))
    if family == "svc_est":
        return pkg.LinearSVC().setStandardization(False).setMaxIter(7)
    if family == "glm_est":
        return pkg.GeneralizedLinearRegression(family="tweedie") \
            .setVariancePower(1.5).setLinkPower(0.0)
    raise KeyError(family)


def _stage_family(family, x, pkg):
    """The stage families of ``models/feature_scalers.py`` and
    ``models/feature_transformers.py``, fitted on ``x`` by ``pkg`` (the
    port or the JAX package), each with a param set away from its
    default."""
    if family == "minmax":
        return pkg.MinMaxScaler().setMin(-1.0).setMax(2.0).fit(x)
    if family == "maxabs":
        return pkg.MaxAbsScaler().setOutputCol("abs_scaled").fit(x)
    if family == "robust":
        return pkg.RobustScaler().setWithCentering(True).setLower(0.1) \
            .fit(x)
    if family == "normalizer":
        return pkg.Normalizer().setP(3.0)
    if family == "binarizer":
        return pkg.Binarizer().setThreshold(0.5)
    if family == "elementwise":
        return pkg.ElementwiseProduct(scalingVec=[0.5, -1.0, 2.0, 1.0, 3.0])
    if family == "slicer":
        return pkg.VectorSlicer(indices=[4, 0, 2])
    if family == "varsel":
        return pkg.VarianceThresholdSelector(varianceThreshold=0.1)
    if family == "varsel_model":
        return pkg.VarianceThresholdSelector(varianceThreshold=0.9).fit(x)
    if family == "chisq_model":
        return pkg.ChiSqSelectorModel(selected=[3, 1])
    if family == "minmax_est":
        return pkg.MinMaxScaler().setMax(4.0)
    if family == "maxabs_est":
        return pkg.MaxAbsScaler().setInputCol("raw")
    if family == "robust_est":
        return pkg.RobustScaler().setWithScaling(False)
    raise KeyError(family)


# the stage families, and those of them that save params only
STAGE_FAMILIES = ("minmax", "maxabs", "robust", "normalizer", "binarizer",
                  "elementwise", "slicer", "varsel", "varsel_model",
                  "chisq_model", "minmax_est", "maxabs_est", "robust_est")
PARAMS_ONLY = {"estimator", "normalizer", "binarizer", "elementwise",
               "slicer", "varsel", "minmax_est", "maxabs_est", "robust_est",
               "svc_est", "glm_est"}
# LinearSVC and GeneralizedLinearRegression, models and estimators
LINEAR_FAMILIES = ("svc", "glm", "svc_est", "glm_est")
# NearestNeighbors (model and estimator) and the DBSCAN estimator (its
# model has no writer in either package)
KNN_FAMILIES = ("knn", "knn_est", "dbscan_est")
PARAMS_ONLY |= {"knn_est", "dbscan_est"}
# RandomForest, DecisionTree and GBT models and estimators
TREE_MODELS = ("rf_cls", "rf_reg", "dt_cls", "dt_reg", "gbt_cls", "gbt_reg")
TREE_FAMILIES = TREE_MODELS + ("rf_est", "dt_est", "gbt_est")
PARAMS_ONLY |= {"rf_est", "dt_est", "gbt_est"}
FAMILIES = ("pca", "kmeans", "scaler", "linreg", "svd", "logreg",
            "logreg_mn", "pipeline", "estimator") + STAGE_FAMILIES \
    + LINEAR_FAMILIES + KNN_FAMILIES + TREE_FAMILIES


def _tree_family(family, x, y, pkg):
    """The tree models (float64, so both packages predict alike) and
    estimators, by ``pkg`` (the port or the JAX package), each with
    params set away from their defaults."""
    if family == "rf_cls":  # three classes: a 3-D leaf tensor
        return pkg.RandomForestClassifier().setNumTrees(3).setMaxDepth(3) \
            .setSeed(2).setDtype("float64").fit(x, _classes(y, 3))
    if family == "rf_reg":
        return pkg.RandomForestRegressor().setNumTrees(2).setMaxDepth(2) \
            .setSubsamplingRate(0.5).setDtype("float64").fit(x, y)
    if family == "dt_cls":
        return pkg.DecisionTreeClassifier(maxDepth=3, dtype="float64") \
            .fit(x, _classes(y, 2))
    if family == "dt_reg":
        return pkg.DecisionTreeRegressor(maxDepth=2, dtype="float64") \
            .setMinInstancesPerNode(3).fit(x, y)
    if family == "gbt_cls":
        return pkg.GBTClassifier().setMaxIter(3).setMaxDepth(2) \
            .setDtype("float64").fit(x, _classes(y, 2))
    if family == "gbt_reg":
        return pkg.GBTRegressor().setMaxIter(3).setStepSize(0.2) \
            .setDtype("float64").fit(x, y)
    if family == "rf_est":
        return pkg.RandomForestClassifier().setNumTrees(7) \
            .setFeatureSubsetStrategy("sqrt")
    if family == "dt_est":
        return pkg.DecisionTreeRegressor(maxDepth=6)
    if family == "gbt_est":
        return pkg.GBTRegressor().setMaxIter(9).setValidationTol(0.05)
    raise KeyError(family)


def _knn_family(family, x, pkg):
    """NearestNeighbors and DBSCAN, by ``pkg`` (the port or the JAX
    package), each with params set away from their defaults."""
    if family == "knn":
        return pkg.NearestNeighbors().setK(4).setAlgorithm("ivfpq") \
            .setNlist(3).setPqBits(6).setRefineRatio(3.0).fit(x)
    if family == "knn_est":
        return pkg.NearestNeighbors().setAlgorithm("ivfflat").setNprobe(2)
    if family == "dbscan_est":
        return pkg.DBSCAN().setEps(0.7).setMinPts(9).setBlockRows(64)
    raise KeyError(family)


def _state(obj):
    """What a save must carry back, as comparable arrays."""
    if isinstance(obj, PipelineModel):
        return [a for s in obj.stages for a in _state(s)]
    out = []
    for attr in ("pc", "cluster_centers", "mean", "std", "coefficients",
                 "components", "singular_values", "intercept",
                 "coefficient_matrix", "intercept_vector", "classes_",
                 "original_min", "original_max", "max_abs", "median",
                 "qrange", "selected_features", "num_iterations_",
                 "deviance_", "weight_sum_", "items", "edges_", "init_",
                 "step_size_", "feature_importances_"):
        value = getattr(obj, attr, None)
        if value is not None:
            out.append(np.asarray(value))
    if getattr(obj, "ensemble_", None) is not None:
        out += [np.asarray(a) for a in obj.ensemble_]
    return out + [np.asarray(sorted(obj.param_map_for_metadata().items()),
                             dtype=object)] if hasattr(
        obj, "param_map_for_metadata") else out


def _same(a, b):
    sa, sb = _state(a), _state(b)
    assert len(sa) == len(sb)
    for u, v in zip(sa, sb):
        if u.dtype == object:
            assert u.tolist() == v.tolist()
        else:
            np.testing.assert_array_equal(u, v)


def _boom(*args, **kwargs):
    raise RuntimeError("disk fell over mid-save")


@pytest.mark.parametrize("family", FAMILIES)
def test_atomic_save_crash_leaves_no_half_written_model(tmp_path, family,
                                                        monkeypatch):
    model = _fitted(family)
    path = str(tmp_path / "model")
    target = "_write_metadata" if family in PARAMS_ONLY else "_write_data_row"
    monkeypatch.setattr(persistence, target, _boom)
    with pytest.raises(RuntimeError, match="mid-save"):
        model.save(path)
    assert not os.path.exists(path)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("family", FAMILIES)
def test_atomic_overwrite_crash_keeps_previous_model(tmp_path, family,
                                                     monkeypatch):
    model = _fitted(family)
    path = str(tmp_path / "model")
    model.save(path)
    target = "_write_metadata" if family in PARAMS_ONLY else "_write_data_row"
    monkeypatch.setattr(persistence, target, _boom)
    with pytest.raises(RuntimeError, match="mid-save"):
        model.save(path, overwrite=True)
    monkeypatch.undo()
    assert os.listdir(tmp_path) == ["model"]
    _same(load_model(path), model)


@pytest.mark.parametrize("family", FAMILIES)
def test_atomic_save_leaves_no_tmp_on_success(tmp_path, family):
    model = _fitted(family)
    path = str(tmp_path / "model")
    model.save(path)
    model.save(path, overwrite=True)
    assert sorted(os.listdir(tmp_path)) == ["model"]
    with pytest.raises(FileExistsError):
        model.save(path)
    _same(load_model(path), model)


def test_atomic_overwrite_swap_crash_preserves_a_complete_copy(tmp_path,
                                                               monkeypatch):
    """A crash INSIDE the swap (after the new payload is complete) leaves a
    complete model on disk: the rename-aside parks the previous model at a
    .old sibling before the target flips."""
    model = _fitted("pca")
    path = str(tmp_path / "model")
    model.save(path)
    real_replace = os.replace
    calls = {"n": 0}

    def crashy_replace(src, dst):
        calls["n"] += 1
        if calls["n"] == 1:          # the rename-aside of the old model
            real_replace(src, dst)
            raise RuntimeError("killed between the two renames")
        return real_replace(src, dst)

    monkeypatch.setattr(persistence.os, "replace", crashy_replace)
    with pytest.raises(RuntimeError, match="between the two renames"):
        model.save(path, overwrite=True)
    monkeypatch.setattr(persistence.os, "replace", real_replace)
    old_dirs = [p for p in os.listdir(tmp_path) if ".old-" in p]
    assert len(old_dirs) == 1
    recovered = PCAModel.load(str(tmp_path / old_dirs[0]))
    np.testing.assert_array_equal(recovered.pc, model.pc)


def test_every_writer_is_wrapped():
    writers = [name for name in dir(persistence) if name.startswith("save_")]
    assert {"save_params", "save_pca_model", "save_kmeans_model",
            "save_scaler_model", "save_linreg_model",
            "save_svd_model", "save_logreg_model", "save_minmax_model",
            "save_svc_model", "save_glm_model", "save_knn_model",
            "save_maxabs_model", "save_robust_model",
            "save_selector_model", "save_forest_model",
            "save_gbt_model"} <= set(writers)
    for name in writers:
        assert hasattr(getattr(persistence, name), "__wrapped_save__"), name


@pytest.mark.parametrize("family", FAMILIES)
def test_load_model_dispatches_on_the_recorded_class(tmp_path, family):
    model = _fitted(family)
    path = str(tmp_path / family)
    model.save(path)
    loaded = load_model(path)
    assert type(loaded) is type(model)
    _same(loaded, model)
    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path / "ghost"))


def _jax_fitted(family):
    import spark_rapids_ml_tpu as jax_pkg

    x, y = _xy()
    if family == "linreg":
        return jax_pkg.LinearRegression().fit(x, labels=y)
    if family == "svd":
        from spark_rapids_ml_tpu.models.svd import TruncatedSVD as JaxSVD

        return JaxSVD().setK(2).fit(x)
    if family == "kmeans":
        return jax_pkg.KMeans().setK(3).fit(x)
    if family == "scaler":
        return jax_pkg.StandardScaler().setWithMean(True).fit(x)
    if family in ("logreg", "logreg_mn"):
        return jax_pkg.LogisticRegression().setRegParam(0.1).fit(
            x, _classes(y, 2 if family == "logreg" else 3))
    if family == "pipeline":
        return jax_pkg.Pipeline([
            jax_pkg.StandardScaler().setWithMean(True).setOutputCol("s"),
            jax_pkg.PCA().setK(3).setInputCol("s").setOutputCol("r"),
            jax_pkg.KMeans().setK(2).setInputCol("r"),
        ]).fit(x)
    if family in LINEAR_FAMILIES:
        return _linear_family(family, x, y, jax_pkg)
    if family in KNN_FAMILIES:
        return _knn_family(family, x, jax_pkg)
    if family in TREE_FAMILIES:
        return _tree_family(family, x, y, jax_pkg)
    return _stage_family(family, x, jax_pkg)


@pytest.mark.parametrize("family", ["linreg", "svd", "kmeans", "scaler",
                                    "logreg", "logreg_mn", "pipeline",
                                    *STAGE_FAMILIES, *LINEAR_FAMILIES,
                                    *KNN_FAMILIES, *TREE_FAMILIES])
def test_load_model_maps_jax_written_metadata_to_the_port(tmp_path, family):
    jax_model = _jax_fitted(family)
    path = str(tmp_path / family)
    jax_model.save(path)
    meta = persistence._read_metadata(path)
    assert meta["pythonClass"].startswith("spark_rapids_ml_tpu.models.")
    loaded = load_model(path)
    assert type(loaded).__module__.startswith("spark_rapids_ml_tpu_torch.")
    assert type(loaded).__name__ == type(jax_model).__name__
    if family in STAGE_FAMILIES + LINEAR_FAMILIES[2:] + KNN_FAMILIES \
            + TREE_FAMILIES:
        _same(loaded, jax_model)  # the same params, so the same state


def test_load_model_refuses_a_class_it_does_not_have(tmp_path):
    _fitted("pca").save(str(tmp_path / "m"))
    meta_path = tmp_path / "m" / "metadata" / "part-00000"
    text = meta_path.read_text().replace(
        "spark_rapids_ml_tpu_torch.models.pca.PCAModel",
        "spark_rapids_ml_tpu.models.gmm.GaussianMixtureModel")
    meta_path.write_text(text)
    with pytest.raises(ValueError, match="no counterpart"):
        load_model(str(tmp_path / "m"))


# -- the registry ---------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("family", ["linreg", "svd"])
def test_registry_loads_linreg_and_svd_saved_by_either_package(
        tmp_path, writer, family):
    model = _fitted(family) if writer == "port" else _jax_fitted(family)
    path = str(tmp_path / family)
    model.save(path)
    manifest = str(tmp_path / "manifest.json")
    registry = ModelRegistry(manifest_path=manifest)
    version = registry.load(family, path)
    loaded = registry.resolve(family, version)
    want = {"linreg": LinearRegressionModel,
            "svd": TruncatedSVDModel}[family]
    assert type(loaded) is want
    x, _ = _xy(seed=1)
    got = np.asarray(loaded.transform(x).column(
        "prediction" if family == "linreg" else loaded.getOutputCol()))
    assert got.shape[0] == x.shape[0] and np.isfinite(got).all()
    # the manifest replay goes through the same dispatch
    replayed = ModelRegistry(manifest_path=manifest)
    assert replayed.recovery_report_["recovered"] == [f"{family}@{version}"]
    assert type(replayed.resolve(family)) is want


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("family", ["logreg", "logreg_mn"])
def test_registry_loads_logreg_saved_by_either_package(tmp_path, writer,
                                                       family):
    """A binary and a multinomial model saved by either package load
    through ``load_model`` and ``ModelRegistry.load`` (and its manifest
    replay) as the port's class, and predict what the writer predicts."""
    model = _fitted(family) if writer == "port" else _jax_fitted(family)
    path = str(tmp_path / family)
    model.save(path)
    assert type(load_model(path)) is LogisticRegressionModel
    manifest = str(tmp_path / "manifest.json")
    registry = ModelRegistry(manifest_path=manifest)
    version = registry.load(family, path)
    loaded = registry.resolve(family, version)
    assert type(loaded) is LogisticRegressionModel
    assert loaded.num_classes == (2 if family == "logreg" else 3)
    x, _ = _xy(seed=1)
    out = loaded.transform(x)
    want = model.transform(x)
    np.testing.assert_array_equal(np.asarray(out.column("prediction")),
                                  np.asarray(want.column("prediction")))
    np.testing.assert_allclose(np.asarray(out.column("probability")),
                               np.asarray(want.column("probability")),
                               rtol=1e-6, atol=1e-7)
    replayed = ModelRegistry(manifest_path=manifest)
    assert replayed.recovery_report_["recovered"] == [f"{family}@{version}"]
    assert type(replayed.resolve(family)) is LogisticRegressionModel


def test_load_model_names_the_knn_and_dbscan_classes():
    for name, module in (("NearestNeighbors", "nearest_neighbors"),
                         ("NearestNeighborsModel", "nearest_neighbors"),
                         ("DBSCAN", "dbscan")):
        assert persistence._MODEL_CLASSES[name] == (
            f"spark_rapids_ml_tpu_torch.models.{module}", name)
    # the JAX DBSCANModel has no writer, so nothing names it on disk
    assert "DBSCANModel" not in persistence._MODEL_CLASSES


def test_load_model_names_the_linear_svc_and_glm_classes():
    for name, module in (("LinearSVC", "linear_svc"),
                         ("LinearSVCModel", "linear_svc"),
                         ("GeneralizedLinearRegression", "glm"),
                         ("GeneralizedLinearRegressionModel", "glm")):
        assert persistence._MODEL_CLASSES[name] == (
            f"spark_rapids_ml_tpu_torch.models.{module}", name)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("family", ["svc", "glm"])
def test_registry_loads_svc_and_glm_saved_by_either_package(tmp_path, writer,
                                                           family):
    """A LinearSVC and a GLM model saved by either package load through
    ``load_model`` and ``ModelRegistry.load`` (and its manifest replay) as
    the port's class, carry the writer's state, and serve through the
    engine's blocking path what the writer's transform gives."""
    from spark_rapids_ml_tpu_torch.serve import ServeEngine

    model = _fitted(family) if writer == "port" else _jax_fitted(family)
    path = str(tmp_path / family)
    model.save(path)
    want_cls = {"svc": LinearSVCModel,
                "glm": GeneralizedLinearRegressionModel}[family]
    assert type(load_model(path)) is want_cls
    manifest = str(tmp_path / "manifest.json")
    registry = ModelRegistry(manifest_path=manifest)
    version = registry.load(family, path)
    loaded = registry.resolve(family, version)
    assert type(loaded) is want_cls
    np.testing.assert_array_equal(loaded.coefficients, model.coefficients)
    assert loaded.intercept == model.intercept
    assert loaded.uid == model.uid
    assert _infer_features(loaded) == 5
    x, _ = _xy(seed=1)
    want = np.asarray(model.transform(x).column("prediction"))
    engine = ServeEngine(registry, max_wait_ms=1)
    try:
        served = engine.predict(family, x)
    finally:
        engine.shutdown()
    if family == "svc":
        np.testing.assert_array_equal(served, want)
    else:
        np.testing.assert_allclose(served, want, rtol=1e-12)
    replayed = ModelRegistry(manifest_path=manifest)
    assert replayed.recovery_report_["recovered"] == [f"{family}@{version}"]
    assert type(replayed.resolve(family)) is want_cls


@pytest.mark.parametrize("family", KNN_FAMILIES)
def test_knn_family_metadata_equals_the_jax_writers(tmp_path, family):
    """NearestNeighbors and DBSCAN metadata equals the JAX writers' but for
    the timestamp and the module path; a port-saved directory loads
    through the JAX class with the same items and params, and the loaded
    model answers as the saved one."""
    import spark_rapids_ml_tpu as jax_pkg

    port, jax_model = _fitted(family), _jax_fitted(family)
    jax_model.uid = port.uid
    port.save(str(tmp_path / "port"))
    jax_model.save(str(tmp_path / "jax"))
    assert _comparable_metadata(str(tmp_path / "port")) == \
        _comparable_metadata(str(tmp_path / "jax"))
    back = getattr(jax_pkg, type(port).__name__).load(str(tmp_path / "port"))
    assert type(back).__module__.startswith("spark_rapids_ml_tpu.models.")
    _same(back, port)
    if family == "knn":
        x, _ = _xy(seed=1)
        want = port.kneighbors(x)
        got = load_model(str(tmp_path / "jax")).kneighbors(x)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("family", LINEAR_FAMILIES)
def test_linear_family_metadata_equals_the_jax_writers(tmp_path, family):
    """The metadata of LinearSVC and GLM models and estimators equals the
    JAX writers' but for the timestamp and the module path (GLM's unset
    link sentinels omitted in both), and a port-saved directory loads
    through the JAX class."""
    import spark_rapids_ml_tpu as jax_pkg

    port, jax_model = _fitted(family), _jax_fitted(family)
    jax_model.uid = port.uid
    port.save(str(tmp_path / "port"))
    jax_model.save(str(tmp_path / "jax"))
    got = _comparable_metadata(str(tmp_path / "port"))
    want = _comparable_metadata(str(tmp_path / "jax"))
    if family in ("svc", "glm"):
        # the fitted dtype param is each package's own default ('auto')
        # and the fit summary differs in the last bits
        assert set(got.pop("extra", {})) == set(want.pop("extra", {}))
    assert got == want
    merged = {**got["paramMap"], **got["tpuParamMap"]}
    if family == "glm":
        assert "link" not in merged and "linkPower" not in merged
    back = getattr(jax_pkg, type(port).__name__).load(str(tmp_path / "port"))
    assert type(back).__module__.startswith("spark_rapids_ml_tpu.models.")
    _same(back, port)


def test_load_model_names_the_tree_classes():
    for module, names in (
            ("random_forest", ("RandomForestRegressor",
                               "RandomForestRegressionModel",
                               "RandomForestClassifier",
                               "RandomForestClassificationModel")),
            ("decision_tree", ("DecisionTreeRegressor",
                               "DecisionTreeRegressionModel",
                               "DecisionTreeClassifier",
                               "DecisionTreeClassificationModel")),
            ("gbt", ("GBTRegressor", "GBTRegressionModel", "GBTClassifier",
                     "GBTClassificationModel"))):
        for name in names:
            assert persistence._MODEL_CLASSES[name] == (
                f"spark_rapids_ml_tpu_torch.models.{module}", name)


def _tree_predictions(model, x):
    out = model.transform(x)
    preds = [np.asarray(out.column("prediction"), dtype=np.float64)]
    if "probability" in out.columns:
        preds.append(np.asarray(out.column("probability"), dtype=np.float64))
    return preds


@pytest.mark.parametrize("family", TREE_FAMILIES)
def test_tree_metadata_equals_the_jax_writers(tmp_path, family):
    """Tree models' and estimators' metadata equals the JAX writers' but
    for the timestamp and the module path (the DecisionTree classes under
    their Spark class names), and the data directories hold the same
    files."""
    port, jax_model = _fitted(family), _jax_fitted(family)
    jax_model.uid = port.uid
    port.save(str(tmp_path / "port"))
    jax_model.save(str(tmp_path / "jax"))
    got = _comparable_metadata(str(tmp_path / "port"))
    assert got == _comparable_metadata(str(tmp_path / "jax"))
    meta = persistence._read_metadata(str(tmp_path / "port"))
    if family.startswith("dt_") and family != "dt_est":
        assert meta["class"].startswith("org.apache.spark.ml.")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))


@pytest.mark.parametrize("family", TREE_MODELS)
def test_tree_models_load_in_either_package(tmp_path, family):
    """A forest, a decision tree and a GBT model saved by either package
    load in the other and predict what the writer predicts (float64,
    within 1e-12). The JAX package's tree readers build the class its
    metadata names, so a port-saved directory loads there as the port's
    class, as the pipeline does; with ``pythonClass`` pointed at the JAX
    class the same payload builds the JAX package's own model."""
    import json

    import spark_rapids_ml_tpu as jax_pkg

    x, _ = _xy(seed=1)
    port, jax_model = _fitted(family), _jax_fitted(family)
    port.save(str(tmp_path / "port"))
    jax_model.save(str(tmp_path / "jax"))
    # JAX-written → the port's load_model
    loaded = load_model(str(tmp_path / "jax"))
    assert type(loaded).__module__.startswith("spark_rapids_ml_tpu_torch.")
    for got, want in zip(_tree_predictions(loaded, x),
                         _tree_predictions(jax_model, x)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # port-written → the JAX class's reader
    jax_cls = getattr(jax_pkg, type(port).__name__)
    back = jax_cls.load(str(tmp_path / "port"))
    assert type(back) is type(port)
    _same(back, port)
    meta_path = tmp_path / "port" / "metadata" / "part-00000"
    meta = json.loads(meta_path.read_text())
    meta["pythonClass"] = f"{jax_cls.__module__}.{jax_cls.__name__}"
    meta_path.write_text(json.dumps(meta))
    back = jax_cls.load(str(tmp_path / "port"))
    assert type(back) is jax_cls
    for got, want in zip(_tree_predictions(back, x),
                         _tree_predictions(port, x)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_linear_regression_warms_without_n_features():
    registry = ModelRegistry()
    registry.register("lr", _fitted("linreg"))
    report = registry.warmup("lr", buckets=(8, 16))
    assert sorted(report["buckets"]) == [8, 16]


@pytest.mark.parametrize("family,width", [
    ("pca", 5), ("kmeans", 5), ("scaler", 5), ("linreg", 5),
    ("logreg", 5), ("logreg_mn", 5), ("pipeline", 5), ("minmax", 5),
    ("maxabs", 5), ("robust", 5), ("svc", 5), ("glm", 5)])
def test_feature_inference_covers_every_family(family, width):
    assert _infer_features(_fitted(family)) == width


def test_feature_inference_walks_a_pipeline_from_its_first_stage():
    model = _fitted("pipeline")
    assert _infer_features(model) == 5
    # a stateless head is looked past (width-preserving) ...
    Normalizer = type("Normalizer", (), {"transform": lambda self, d: d})
    assert _infer_features(PipelineModel(
        stages=[Normalizer(), *model.stages])) == 5
    # ... an unknown stateful one is not
    Opaque = type("Opaque", (), {"transform": lambda self, d: d})
    assert _infer_features(PipelineModel(
        stages=[Opaque(), *model.stages])) is None


# -- the stage families against the JAX writers and loaders -------------------

def _comparable_metadata(path):
    """A saved stage's metadata, less the timestamp and the module path."""
    meta = persistence._read_metadata(path)
    meta.pop("timestamp")
    for key in ("class", "pythonClass"):
        meta[key] = meta[key].rsplit(".", 1)[-1]
    return meta


@pytest.mark.parametrize("family", STAGE_FAMILIES)
def test_stage_metadata_equals_the_jax_writers(tmp_path, family):
    port, jax_model = _fitted(family), _jax_fitted(family)
    jax_model.uid = port.uid
    port.save(str(tmp_path / "port"))
    jax_model.save(str(tmp_path / "jax"))
    got = _comparable_metadata(str(tmp_path / "port"))
    want = _comparable_metadata(str(tmp_path / "jax"))
    assert got == want
    assert got["extra"] == {"selectorClass": type(port).__name__} \
        if family in ("varsel_model", "chisq_model") else "extra" not in got
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))


def _jax_loader(name):
    from spark_rapids_ml_tpu.models import feature_scalers as jfs
    from spark_rapids_ml_tpu.models import feature_transformers as jft

    return getattr(jfs, name, None) or getattr(jft, name)


@pytest.mark.parametrize("family", STAGE_FAMILIES)
def test_port_saved_stages_load_through_the_jax_class(tmp_path, family):
    model = _fitted(family)
    path = str(tmp_path / family)
    model.save(path)
    back = _jax_loader(type(model).__name__).load(path)
    assert type(back).__module__.startswith("spark_rapids_ml_tpu.models.")
    assert type(back).__name__ == type(model).__name__
    assert back.uid == model.uid
    _same(back, model)


def test_univariate_selector_metadata_has_no_counterpart(tmp_path):
    from spark_rapids_ml_tpu.models.feature_transformers2 import (
        UnivariateFeatureSelectorModel,
    )

    path = str(tmp_path / "univariate")
    UnivariateFeatureSelectorModel(selected=[0, 2]).save(path)
    with pytest.raises(ValueError, match="no counterpart"):
        load_model(path)
    with pytest.raises(ValueError, match="no counterpart"):
        persistence.load_selector_model(path)
