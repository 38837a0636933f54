"""ElementwiseProduct, VectorSlicer, VarianceThresholdSelector and
ChiSqSelectorModel in the port against the JAX package's, on the same
numpy inputs: transforms equal, the guards raising the JAX messages, the
variance selector's fit equal (one row included), a ChiSq model built
from an unsorted index set sorted as JAX sorts it, and a ChiSq model the
JAX package fitted and saved loading through the port's ``load_model``
and transforming as JAX's does. Each test runs in metrics registries of
its own, in both packages."""

import numpy as np
import pytest

from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxFrame
from spark_rapids_ml_tpu.models import feature_transformers as jft
from spark_rapids_ml_tpu.obs import devmon as jax_devmon
from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu_torch import (
    ChiSqSelectorModel,
    ElementwiseProduct,
    VarianceThresholdSelector,
    VarianceThresholdSelectorModel,
    VectorSlicer,
)
from spark_rapids_ml_tpu_torch.io.persistence import load_model
from spark_rapids_ml_tpu_torch.obs import devmon, metrics


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


def _x(seed=0, n=128, d=10):
    x = np.random.default_rng(seed).normal(size=(n, d)) \
        * np.linspace(0.2, 2.0, d)
    x[:, 3] = 1.5  # a constant column
    return x


def _col(model, x):
    return np.asarray(model.transform(x).column(model.getOutputCol()))


def test_elementwise_product_equals_jax_and_checks_its_length():
    x = _x()
    scaling = np.random.default_rng(1).normal(size=x.shape[1]).tolist()
    out = _col(ElementwiseProduct(scalingVec=scaling), x)
    np.testing.assert_array_equal(
        out, _col(jft.ElementwiseProduct(scalingVec=scaling), x))
    for cls in (ElementwiseProduct, jft.ElementwiseProduct):
        with pytest.raises(ValueError, match="scalingVec length 3 != width"):
            cls(scalingVec=[1.0, 2.0, 3.0]).transform(x)
        with pytest.raises(ValueError, match="needs scalingVec"):
            cls().transform(x)
        assert cls().serving_stage() is None


def test_vector_slicer_keeps_order_and_checks_its_indices():
    x = _x()
    indices = [7, 0, 3, 3, 9]
    out = _col(VectorSlicer(indices=indices), x)
    np.testing.assert_array_equal(out, x[:, indices])
    np.testing.assert_array_equal(
        out, _col(jft.VectorSlicer(indices=indices), x))
    for cls in (VectorSlicer, jft.VectorSlicer):
        with pytest.raises(ValueError, match="out of range for width 10"):
            cls(indices=[2, 10]).transform(x)
        for empty in ([], None):
            with pytest.raises(ValueError, match="needs indices"):
                cls(indices=empty).transform(x)
        with pytest.raises(ValueError, match="invalid value"):
            cls(indices=[-1])


@pytest.mark.parametrize("rows,threshold", [(128, 0.0), (128, 0.5),
                                            (1, 0.0)])
def test_variance_selector_fit_equals_jax(rows, threshold):
    x = _x(2)[:rows]
    got = VarianceThresholdSelector(varianceThreshold=threshold).fit(x)
    want = jft.VarianceThresholdSelector(
        varianceThreshold=threshold).fit(x)
    assert isinstance(got, VarianceThresholdSelectorModel)
    assert got.selected_features.dtype == np.int64
    np.testing.assert_array_equal(got.selected_features,
                                  want.selected_features)
    if rows == 1:
        assert got.selected_features.size == 0  # one row: all dropped
    else:
        assert 3 not in got.selected_features  # the constant column
        np.testing.assert_array_equal(_col(got, x), _col(want, x))


def test_chisq_model_sorts_its_index_set_as_jax():
    x = _x(3)
    got = ChiSqSelectorModel(selected=[8, 1, 5, 2])
    want = jft.ChiSqSelectorModel(selected=[8, 1, 5, 2])
    np.testing.assert_array_equal(got.selected_features, [1, 2, 5, 8])
    np.testing.assert_array_equal(got.selected_features,
                                  want.selected_features)
    np.testing.assert_array_equal(_col(got, x), _col(want, x))
    for model in (ChiSqSelectorModel(), jft.ChiSqSelectorModel()):
        with pytest.raises(ValueError, match="selector model is unfitted"):
            model.transform(x)
        assert model.serving_stage() is None


def test_jax_fitted_chisq_model_loads_and_transforms_in_the_port(tmp_path):
    rng = np.random.default_rng(4)
    x = rng.integers(0, 3, size=(200, 6)).astype(np.float64)
    y = (x[:, 2] + (x[:, 4] > 1)).astype(np.float64)
    jax_model = jft.ChiSqSelector(numTopFeatures=2).fit(
        JaxFrame({"features": x, "label": list(y)}))
    path = str(tmp_path / "chisq")
    jax_model.save(path)
    loaded = load_model(path)
    assert type(loaded) is ChiSqSelectorModel and loaded.uid == jax_model.uid
    np.testing.assert_array_equal(loaded.selected_features,
                                  jax_model.selected_features)
    np.testing.assert_array_equal(_col(loaded, x), _col(jax_model, x))
    assert sorted(loaded.selected_features.tolist()) == [2, 4]


# -- the categorical transformers and PolynomialExpansion ---------------------
# (every case of tests/test_feature_transformers.py through both packages)

def _both(cls_name, columns, method="transform", **params):
    """(the port's result, JAX's) of ``cls_name(**params).method`` on the
    same columns."""
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
    from spark_rapids_ml_tpu_torch.models import feature_transformers as ft

    ours = getattr(getattr(ft, cls_name)(**params), method)(
        VectorFrame(columns))
    theirs = getattr(getattr(jft, cls_name)(**params), method)(
        JaxFrame(columns))
    return ours, theirs


@pytest.mark.parametrize("values,order,labels", [
    (["b", "a", "b", "c", "b", "a"], "frequencyDesc", ["b", "a", "c"]),
    (["z", "a", "z", "a"], "frequencyDesc", ["a", "z"]),
    (["b", "a", "c", "a"], "frequencyAsc", ["b", "c", "a"]),
    (["b", "a", "c"], "alphabetAsc", ["a", "b", "c"]),
    (["b", "a", "c"], "alphabetDesc", ["c", "b", "a"]),
    ([3, 1.5, 3, "x"], "frequencyDesc", ["3", "1.5", "x"]),
])
def test_string_indexer_orders_as_jax(values, order, labels):
    ours, theirs = _both("StringIndexer", {"cat": values}, method="fit",
                         inputCol="cat", outputCol="idx",
                         stringOrderType=order)
    assert ours.labels == theirs.labels == labels
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    got = ours.transform(VectorFrame({"cat": values})).column("idx")
    want = theirs.transform(JaxFrame({"cat": values})).column("idx")
    np.testing.assert_array_equal(got, want)
    assert ours.fit_report_.algo == "string_indexer"


@pytest.mark.parametrize("mode,idx,cats", [
    ("keep", [0, 2, 1], ["a", "zzz", "b"]), ("skip", [0, 1], ["a", "b"])])
def test_string_indexer_handle_invalid_as_jax(mode, idx, cats):
    from spark_rapids_ml_tpu_torch import StringIndexer
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    test = {"cat": ["a", "zzz", "b"]}
    outs = []
    for cls, frame in ((StringIndexer, VectorFrame),
                       (jft.StringIndexer, JaxFrame)):
        model = cls(inputCol="cat", outputCol="idx").fit(
            frame({"cat": ["a", "b"]}))
        with pytest.raises(ValueError, match="unseen"):
            model.transform(frame(test))
        outs.append(model.copy({"handleInvalid": mode}).transform(
            frame(test)))
    for out in outs:
        np.testing.assert_array_equal(out.column("idx"), idx)
        assert list(out.column("cat")) == cats


def test_index_to_string_inverts_as_jax():
    from spark_rapids_ml_tpu_torch import IndexToString, StringIndexer
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    df = VectorFrame({"cat": ["b", "a", "b", "c"]})
    model = StringIndexer(inputCol="cat", outputCol="idx").fit(df)
    out = model.transform(df)
    inv = IndexToString(inputCol="idx", outputCol="orig",
                        labels=model.labels).transform(out)
    assert list(inv.column("orig")) == ["b", "a", "b", "c"]
    want = jft.IndexToString(inputCol="idx", outputCol="orig",
                             labels=model.labels).transform(
        JaxFrame({"idx": list(out.column("idx"))}))
    assert list(inv.column("orig")) == list(want.column("orig"))
    for cls, frame in ((IndexToString, VectorFrame),
                       (jft.IndexToString, JaxFrame)):
        with pytest.raises(ValueError, match="needs the labels"):
            cls(inputCol="idx").transform(frame({"idx": [0.0]}))
        with pytest.raises(ValueError, match="out of range"):
            cls(inputCol="idx", labels=["a"]).transform(
                frame({"idx": [1.0]}))


@pytest.mark.parametrize("params,train,test,want", [
    ({}, [0.0, 1.0, 2.0, 1.0], [0.0, 1.0, 2.0, 1.0],
     [[1, 0], [0, 1], [0, 0], [0, 1]]),
    ({"dropLast": False, "handleInvalid": "keep"}, [0.0, 1.0], [0.0, 5.0],
     [[1, 0, 0], [0, 0, 1]]),
    ({"handleInvalid": "keep"}, [0.0, 1.0, 2.0], [2.0, 7.0], [[0, 0, 1],
                                                              [0, 0, 0]]),
])
def test_onehot_as_jax(params, train, test, want):
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    ours, theirs = _both("OneHotEncoder", {"idx": train}, method="fit",
                         inputCol="idx", outputCol="vec", **params)
    assert ours.category_size == theirs.category_size
    got = np.asarray(ours.transform(VectorFrame({"idx": test})).column("vec"))
    np.testing.assert_array_equal(got, np.asarray(theirs.transform(
        JaxFrame({"idx": test})).column("vec")))
    np.testing.assert_array_equal(got, want)


def test_onehot_guards_as_jax():
    from spark_rapids_ml_tpu_torch import OneHotEncoder
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    for cls, frame in ((OneHotEncoder, VectorFrame),
                       (jft.OneHotEncoder, JaxFrame)):
        with pytest.raises(ValueError, match="non-negative integer"):
            cls(inputCol="idx").fit(frame({"idx": [0.5]}))
        model = cls(inputCol="idx", dropLast=False).fit(
            frame({"idx": [0.0, 1.0]}))
        with pytest.raises(ValueError, match="out of range"):
            model.transform(frame({"idx": [0.0, 5.0]}))


def test_vector_assembler_mixes_scalars_and_vectors_as_jax():
    cols = {"a": [1.0, 2.0],
            "v": [np.array([10.0, 20.0]), np.array([30.0, 40.0])],
            "m": np.array([[7.0], [8.0]]), "b": [7.0, 8.0]}
    ours, theirs = _both("VectorAssembler", cols,
                         inputCols=["a", "v", "m", "b"], outputCol="f")
    got = np.asarray(ours.column("f"))
    np.testing.assert_array_equal(got, np.asarray(theirs.column("f")))
    np.testing.assert_array_equal(got, [[1, 10, 20, 7, 7], [2, 30, 40, 8, 8]])


@pytest.mark.parametrize("mode,rows", [("skip", 1), ("keep", 2)])
def test_vector_assembler_handle_invalid_as_jax(mode, rows):
    from spark_rapids_ml_tpu_torch import VectorAssembler
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    cols = {"a": [1.0, np.nan], "b": [2.0, 3.0]}
    ours, theirs = _both("VectorAssembler", cols, inputCols=["a", "b"],
                         handleInvalid=mode)
    assert len(ours) == len(theirs) == rows
    np.testing.assert_array_equal(np.asarray(ours.column("features")),
                                  np.asarray(theirs.column("features")))
    for cls, frame in ((VectorAssembler, VectorFrame),
                       (jft.VectorAssembler, JaxFrame)):
        with pytest.raises(ValueError, match="NaN"):
            cls(inputCols=["a", "b"]).transform(frame(cols))
        with pytest.raises(ValueError, match="needs inputCols"):
            cls().transform(frame(cols))


@pytest.mark.parametrize("splits,x,mode,want", [
    ([0.0, 1.0, 2.0, 3.0], [0.0, 0.5, 1.0, 2.5, 3.0], "error",
     [0, 0, 1, 2, 2]),
    ([0.0, 1.0, 2.0], [0.5, -1.0, np.nan], "keep", [0, 2, 2]),
    ([0.0, 1.0, 2.0], [0.5, -1.0, np.nan], "skip", [0]),
    ([-np.inf, 0.0, np.inf], [-5.0, 0.0, 7.5], "error", [0, 1, 1]),
])
def test_bucketizer_as_jax(splits, x, mode, want):
    ours, theirs = _both("Bucketizer", {"x": x}, inputCol="x",
                         outputCol="b", splits=splits, handleInvalid=mode)
    np.testing.assert_array_equal(ours.column("b"), theirs.column("b"))
    np.testing.assert_array_equal(ours.column("b"), want)


def test_bucketizer_guards_as_jax():
    from spark_rapids_ml_tpu_torch import Bucketizer
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    for cls, frame in ((Bucketizer, VectorFrame), (jft.Bucketizer, JaxFrame)):
        with pytest.raises(ValueError, match="handleInvalid"):
            cls(inputCol="x", splits=[0.0, 1.0, 2.0]).transform(
                frame({"x": [0.5, -1.0]}))
        with pytest.raises(ValueError, match="needs splits"):
            cls(inputCol="x").transform(frame({"x": [0.5]}))
        with pytest.raises(ValueError, match="invalid value"):
            cls(splits=[0.0, 2.0, 1.0])


@pytest.mark.parametrize("x", [
    np.random.default_rng(42).normal(size=2000), np.ones(50),
    np.concatenate([np.random.default_rng(1).normal(size=300),
                    [np.nan, np.inf]])])
def test_quantile_discretizer_as_jax(x):
    from spark_rapids_ml_tpu_torch import Bucketizer

    ours, theirs = _both("QuantileDiscretizer", {"x": x}, method="fit",
                         inputCol="x", outputCol="b", numBuckets=4,
                         handleInvalid="keep")
    assert isinstance(ours, Bucketizer)
    assert ours.get_or_default("splits") == theirs.get_or_default("splits")
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    got = np.asarray(ours.transform(VectorFrame({"x": x})).column("b"))
    np.testing.assert_array_equal(got, np.asarray(theirs.transform(
        JaxFrame({"x": x})).column("b")))
    if x.shape[0] == 2000:
        counts = np.bincount(got.astype(int), minlength=4)
        assert counts.min() > 0.8 * x.shape[0] / 4


@pytest.mark.parametrize("width,degree", [(2, 2), (2, 3), (4, 3), (3, 1)])
def test_polynomial_expansion_spark_order_as_jax(width, degree):
    x = np.random.default_rng(width * 10 + degree).normal(size=(6, width))
    x[0, :2] = [2.0, 3.0]
    ours, theirs = _both("PolynomialExpansion", {"features": x},
                         degree=degree, outputCol="e")
    got = np.asarray(ours.column("e"))
    np.testing.assert_array_equal(got, np.asarray(theirs.column("e")))
    if width == 2 and degree == 2:
        np.testing.assert_array_equal(got[0], [2, 4, 3, 6, 9])
    if width == 2 and degree == 3:
        np.testing.assert_array_equal(got[0], [2, 4, 8, 3, 6, 12, 9, 18, 27])


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
def test_categorical_models_persist_both_ways(tmp_path, direction):
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
    from spark_rapids_ml_tpu_torch.io.persistence import load_model
    from spark_rapids_ml_tpu_torch.models import feature_transformers as ft

    src, dst = (ft, jft) if direction == "port->jax" else (jft, ft)
    frame = VectorFrame if src is ft else JaxFrame
    models = {
        "si": src.StringIndexer(inputCol="cat", handleInvalid="keep").fit(
            frame({"cat": ["x", "y", "x", "ü"]})),
        "ohe": src.OneHotEncoder(inputCol="idx", dropLast=False).fit(
            frame({"idx": [0.0, 1.0, 3.0]})),
        "bucketizer": src.Bucketizer(inputCol="x", splits=[0.0, 1.0, 5.0]),
        "assembler": src.VectorAssembler(inputCols=["a", "b"]),
        "its": src.IndexToString(inputCol="i", labels=["p", "q"]),
        "poly": src.PolynomialExpansion(degree=3),
        "qd": src.QuantileDiscretizer(inputCol="x", numBuckets=3),
    }
    for name, model in models.items():
        path = str(tmp_path / name)
        model.save(path)
        loaded = getattr(dst, type(model).__name__).load(path)
        assert loaded.uid == model.uid
        for p in model.params():
            assert loaded.get_or_default(p) == model.get_or_default(p), p
        if dst is ft:
            assert type(load_model(path)) is type(loaded)
    si = dst.StringIndexerModel.load(str(tmp_path / "si"))
    assert si.labels == models["si"].labels
    ohe = dst.OneHotEncoderModel.load(str(tmp_path / "ohe"))
    assert ohe.category_size == 4
    assert ohe.get_or_default("dropLast") is False
