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
