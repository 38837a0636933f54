"""DCT, Interaction, FeatureHasher, VectorIndexer, UnivariateFeatureSelector,
RFormula, VectorSizeHint and SQLTransformer in the port against the JAX
package, on the same seeded numpy inputs: every case of
``tests/test_feature_transformers2.py`` through both packages. Indices,
hashes, maps, selections and strings are exact; floats within 1e-12.
VectorIndexerModel, UnivariateFeatureSelectorModel and RFormulaModel save
in one package and load in the other. Each test runs in metrics
registries of its own, in both packages."""

import numpy as np
import pytest

from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxFrame
from spark_rapids_ml_tpu.models import feature_transformers2 as jft2
from spark_rapids_ml_tpu.obs import devmon as jax_devmon
from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
from spark_rapids_ml_tpu_torch.models import feature_transformers2 as ft2
from spark_rapids_ml_tpu_torch.obs import devmon, metrics

FLOAT_ATOL = 1e-12


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    monkeypatch.setattr(metrics, "_default_registry",
                        metrics.MetricsRegistry())
    monkeypatch.setattr(jax_metrics, "_default_registry",
                        jax_metrics.MetricsRegistry())
    resets = (devmon.reset_device_monitor, jax_devmon.reset_device_monitor)
    for reset in resets:
        reset()
    yield
    for reset in resets:
        reset()


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _both(cls_name, columns, method="transform", **params):
    """(the port's result, JAX's) of ``cls_name(**params).method`` on the
    same columns."""
    ours = getattr(getattr(ft2, cls_name)(**params), method)(
        VectorFrame(columns))
    theirs = getattr(getattr(jft2, cls_name)(**params), method)(
        JaxFrame(columns))
    return ours, theirs


def _col(frame, name):
    return np.asarray(frame.column(name))


@pytest.mark.parametrize("inverse", [False, True])
def test_dct_equals_jax_and_round_trips(rng, inverse):
    from scipy.fft import dct as scipy_dct

    x = rng.normal(size=(10, 8))
    ours, theirs = _both("DCT", {"features": x}, inputCol="features",
                         inverse=inverse)
    got = _col(ours, "dct")
    np.testing.assert_allclose(got, _col(theirs, "dct"), rtol=0,
                               atol=FLOAT_ATOL)
    np.testing.assert_allclose(
        got, scipy_dct(x, type=3 if inverse else 2, norm="ortho", axis=1),
        rtol=0, atol=FLOAT_ATOL)
    back = _col(ft2.DCT(inputCol="dct", outputCol="rec",
                        inverse=not inverse).transform(
        VectorFrame({"dct": got})), "rec")
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-10)


def test_interaction_outer_product():
    cols = {"a": np.array([[1.0, 2.0], [0.5, 1.0]]), "b": [3.0, 4.0],
            "c": np.array([[10.0, 20.0], [1.0, 2.0]])}
    ours, theirs = _both("Interaction", cols, inputCols=["a", "b", "c"])
    got = _col(ours, "interacted")
    np.testing.assert_array_equal(got, _col(theirs, "interacted"))
    np.testing.assert_allclose(got[0], [30, 60, 60, 120])
    assert got.shape == (2, 4)
    for cls, frame in ((ft2.Interaction, VectorFrame),
                       (jft2.Interaction, JaxFrame)):
        with pytest.raises(ValueError, match="at least 2"):
            cls(inputCols=["a"]).transform(frame(cols))


@pytest.mark.parametrize("params", [
    {"inputCols": ["real", "cat"], "numFeatures": 64},
    {"inputCols": ["real"], "numFeatures": 64, "categoricalCols": ["real"]},
    {"inputCols": ["real", "cat", "count"], "numFeatures": 1 << 12},
])
def test_feature_hasher_equals_jax(params):
    cols = {"real": [2.2, 3.3, -1.0], "cat": ["a", "b", "ü"],
            "count": [1, 2, 3]}
    ours, theirs = _both("FeatureHasher", cols, **params)
    h = _col(ours, "hashed")
    np.testing.assert_array_equal(h, _col(theirs, "hashed"))
    assert h.shape == (3, params["numFeatures"])
    if "categoricalCols" in params:
        assert (h == 1.0).sum() == 3
    elif len(params["inputCols"]) == 2:
        idx = np.flatnonzero(h[0] == 2.2)
        assert h[1, idx[0]] == 3.3
        assert (h[0] == 1.0).sum() == 1


def test_feature_hasher_guards_as_jax():
    for cls, frame in ((ft2.FeatureHasher, VectorFrame),
                       (jft2.FeatureHasher, JaxFrame)):
        with pytest.raises(ValueError, match="needs inputCols"):
            cls().transform(frame({"a": [1.0]}))
        with pytest.raises(ValueError, match="exceeds"):
            cls(inputCols=["a"]).transform(frame({"a": [1.0] * 2048}))


def _indexer_x(rng):
    x = np.column_stack([rng.normal(size=20),
                         rng.choice([0.0, 5.0, 10.0], size=20)])
    x[0, 1] = 5.0
    return x


def test_vector_indexer_maps_as_jax(rng):
    x = _indexer_x(rng)
    ours, theirs = _both("VectorIndexer", {"features": x}, method="fit",
                         inputCol="features", maxCategories=4)
    assert ours.categorical_features_ == theirs.categorical_features_ == [1]
    assert ours.category_maps == theirs.category_maps
    assert ours.category_maps[1] == {0.0: 0, 5.0: 1, 10.0: 2}
    np.testing.assert_array_equal(
        _col(ours.transform(VectorFrame({"features": x})), "indexed"),
        _col(theirs.transform(JaxFrame({"features": x})), "indexed"))
    neg = np.array([[-1.0], [0.0], [2.0], [0.0]])
    ours, theirs = _both("VectorIndexer", {"features": neg}, method="fit",
                         inputCol="features", maxCategories=4)
    assert ours.category_maps == theirs.category_maps == {
        0: {0.0: 0, -1.0: 1, 2.0: 2}}


@pytest.mark.parametrize("mode,want", [("error", None), ("keep", [3.0]),
                                       ("skip", [])])
def test_vector_indexer_invalid_modes_as_jax(rng, mode, want):
    x = _indexer_x(rng)
    bad = np.array([[0.0, 7.0]])
    outs = []
    for cls, frame in ((ft2.VectorIndexer, VectorFrame),
                       (jft2.VectorIndexer, JaxFrame)):
        model = cls(inputCol="features", maxCategories=4).fit(
            frame({"features": x}))
        model.set("handleInvalid", mode)
        if want is None:
            with pytest.raises(ValueError, match="unseen category"):
                model.transform(frame({"features": bad}))
            continue
        out = model.transform(frame({"features": bad}))
        outs.append(_col(out, "indexed")[:, 1].tolist() if len(out) else [])
        with pytest.raises(ValueError, match="expected 2 features"):
            model.transform(frame({"features": np.ones((1, 3))}))
    if want is not None:
        assert outs[0] == outs[1] == want


def _selector_data(rng, kind):
    n = 300
    if kind == "anova":
        y = rng.integers(0, 2, size=n).astype(np.float64)
        x = np.column_stack([rng.normal(size=n), y * 3.0 + rng.normal(size=n),
                             rng.normal(size=n)])
        return x, y, {"featureType": "continuous",
                      "labelType": "categorical"}
    y = rng.normal(size=n)
    if kind == "regression":
        x = np.column_stack([y * 2 + rng.normal(size=n) * 0.1,
                             rng.normal(size=n), y + rng.normal(size=n)])
        return x, y, {"featureType": "continuous",
                      "labelType": "continuous"}
    x = np.column_stack([(rng.random(n) < 0.5).astype(float),
                         (y > 0).astype(float),
                         rng.integers(0, 3, n).astype(float)])
    return x, (y > 0).astype(float), {"featureType": "categorical",
                                      "labelType": "categorical"}


@pytest.mark.parametrize("kind", ["anova", "regression", "chi2"])
@pytest.mark.parametrize("mode,threshold", [
    ("numTopFeatures", 1), ("percentile", 0.5), ("fpr", 0.01),
    ("fdr", 0.05), ("fwe", 0.05), ("numTopFeatures", None)])
def test_univariate_selector_equals_jax(rng, kind, mode, threshold):
    x, y, types = _selector_data(rng, kind)
    ours, theirs = _both(
        "UnivariateFeatureSelector", {"features": x, "label": y},
        method="fit", inputCol="features", selectionMode=mode,
        selectionThreshold=threshold, **types)
    assert ours.selected == theirs.selected
    assert isinstance(ours, ft2.UnivariateFeatureSelectorModel)
    np.testing.assert_array_equal(
        _col(ours.transform(VectorFrame({"features": x})), "selected"),
        _col(theirs.transform(JaxFrame({"features": x})), "selected"))
    if mode == "numTopFeatures" and threshold == 1:
        assert ours.selected == [1 if kind != "regression" else 0]


def test_univariate_selector_has_no_categorical_continuous_score(rng):
    x, y, _types = _selector_data(rng, "chi2")
    for cls, frame in ((ft2.UnivariateFeatureSelector, VectorFrame),
                       (jft2.UnivariateFeatureSelector, JaxFrame)):
        with pytest.raises(ValueError, match="no defined score"):
            cls(inputCol="features", featureType="categorical",
                labelType="continuous").fit(
                frame({"features": x, "label": rng.normal(size=300)}))


RF_FRAME = {"y": [1.0, 0.0, 1.0, 0.0], "age": [10.0, 20.0, 30.0, 40.0],
            "city": ["sf", "nyc", "sf", "la"]}
RF_DOT = {"cls": ["yes", "no", "yes"], "a": [1.0, 2.0, 3.0],
          "b": [4.0, 5.0, 6.0]}


@pytest.mark.parametrize("cols,formula", [(RF_FRAME, "y ~ age + city"),
                                          (RF_DOT, "cls ~ ."),
                                          (RF_DOT, "a ~ b + cls")])
def test_rformula_equals_jax(cols, formula):
    ours, theirs = _both("RFormula", cols, method="fit", formula=formula)
    assert ours.encoders == theirs.encoders
    assert ours.label_levels == theirs.label_levels
    got = ours.transform(VectorFrame(cols))
    want = theirs.transform(JaxFrame(cols))
    assert got.columns == want.columns
    for name in ("features", "label"):
        np.testing.assert_array_equal(_col(got, name), _col(want, name))
    if formula == "y ~ age + city":
        np.testing.assert_allclose(_col(got, "features")[:, 1:],
                                   [[1, 0], [0, 0], [1, 0], [0, 1]])


@pytest.mark.parametrize("formula,match", [("y ~ a:b", "not supported"),
                                           ("nonsense", "formula")])
def test_rformula_rejects_as_jax(formula, match):
    for cls, frame in ((ft2.RFormula, VectorFrame),
                       (jft2.RFormula, JaxFrame)):
        with pytest.raises(ValueError, match=match):
            cls(formula=formula).fit(frame(RF_DOT))


@pytest.mark.parametrize("mode,rows", [("skip", 2), ("optimistic", 3)])
def test_vector_size_hint_modes(mode, rows):
    cols = {"features": [np.ones(3), np.ones(3), np.ones(4)]}
    ours, theirs = _both("VectorSizeHint", cols, inputCol="features",
                         size=3, handleInvalid=mode)
    assert len(ours) == len(theirs) == rows
    for cls, frame in ((ft2.VectorSizeHint, VectorFrame),
                       (jft2.VectorSizeHint, JaxFrame)):
        with pytest.raises(ValueError, match="vector size != 3"):
            cls(inputCol="features", size=3).transform(frame(cols))
        with pytest.raises(ValueError, match="requires the size"):
            cls(inputCol="features").transform(frame(cols))


@pytest.mark.parametrize("statement,columns", [
    ("SELECT *, (v1 + v2) AS v3, v1 * 2 AS dbl FROM __THIS__",
     ["v1", "v2", "v3", "dbl"]),
    ("SELECT v2 FROM __THIS__", ["v2"]),
    ("select v1 AS x, v1 > 1.5 AS big from __THIS__;", ["x", "big"]),
])
def test_sql_transformer_equals_jax(statement, columns):
    cols = {"v1": [1.0, 2.0], "v2": [3.0, 4.0]}
    ours, theirs = _both("SQLTransformer", cols, statement=statement)
    assert ours.columns == theirs.columns == columns
    for name in columns:
        np.testing.assert_array_equal(_col(ours, name), _col(theirs, name))


@pytest.mark.parametrize("statement,match", [
    ("SELECT a FROM __THIS__ JOIN t", "not supported"),
    ("DELETE FROM __THIS__", "statement must look"),
    ("SELECT a, b FROM __THIS__ WHERE a > 1", "not supported"),
    (None, "requires the statement")])
def test_sql_transformer_rejects_as_jax(statement, match):
    for cls, frame in ((ft2.SQLTransformer, VectorFrame),
                       (jft2.SQLTransformer, JaxFrame)):
        with pytest.raises(ValueError, match=match):
            cls(statement=statement).transform(frame({"a": [1.0]}))


def _fitted(mod, frame, rng):
    x = _indexer_x(np.random.default_rng(7))
    xs, ys, types = _selector_data(np.random.default_rng(8), "anova")
    return {
        "indexer": mod.VectorIndexer(inputCol="features",
                                     maxCategories=4).fit(
            frame({"features": x})),
        "selector": mod.UnivariateFeatureSelector(
            inputCol="features", outputCol="sel", selectionMode="fpr",
            selectionThreshold=0.01, **types).fit(
            frame({"features": xs, "label": ys})),
        "rformula": mod.RFormula(formula="y ~ age + city",
                                 labelCol="target").fit(frame(RF_FRAME)),
        "hasher": mod.FeatureHasher(inputCols=["a", "b"], numFeatures=32),
        "sql": mod.SQLTransformer(statement="SELECT a FROM __THIS__"),
    }


def _same_state(a, b):
    for attr in ("category_maps", "num_features", "selected", "encoders",
                 "label_source", "label_levels"):
        if hasattr(a, attr):
            assert getattr(a, attr) == getattr(b, attr), attr
    for p in a.params():
        assert a.get_or_default(p) == b.get_or_default(p), p


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
def test_models_persist_both_ways(tmp_path, rng, direction):
    from spark_rapids_ml_tpu_torch.io import persistence
    from spark_rapids_ml_tpu_torch.io.persistence import load_model

    src, dst = (ft2, jft2) if direction == "port->jax" else (jft2, ft2)
    frame = VectorFrame if src is ft2 else JaxFrame
    for name, model in _fitted(src, frame, rng).items():
        path = str(tmp_path / name)
        model.save(path)
        loaded = getattr(dst, type(model).__name__).load(path)
        assert loaded.uid == model.uid
        _same_state(loaded, model)
        if dst is ft2:
            through = load_model(path)
            assert type(through) is type(loaded)
            _same_state(through, model)
    if dst is ft2:
        # the selector's metadata names its class; the shared reader
        # builds the port's UnivariateFeatureSelectorModel from it
        model = persistence.load_selector_model(str(tmp_path / "selector"))
        assert type(model) is ft2.UnivariateFeatureSelectorModel


def test_fits_carry_a_report(rng):
    models = _fitted(ft2, VectorFrame, rng)
    assert models["indexer"].fit_report_.algo == "vector_indexer"
    assert models["selector"].fit_report_.algo == \
        "univariate_feature_selector"
    assert models["rformula"].fit_report_.algo == "rformula"
