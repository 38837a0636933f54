"""StandardScaler in the port against the JAX package's, on the same numpy
inputs: the three fit routes (streamed host float64, device two-pass, host)
within 1e-12 at float64, Spark's zero-std factor 0, the serving stage's
bodies against the host transform, the JAX package's test_scaler.py
behaviours, and cross-loading. The JAX suite runs with x64, so its 'auto'
dtype is float64; the port's is float32 (a float32 device fit is held
within 1e-6 of the float64 statistics)."""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import StandardScaler as JaxStandardScaler
from spark_rapids_ml_tpu import StandardScalerModel as JaxStandardScalerModel
from spark_rapids_ml_tpu_torch import (
    PCA,
    Pipeline,
    StandardScaler,
    StandardScalerModel,
)
from spark_rapids_ml_tpu_torch.feature import StandardScaler as FeatureScaler

F64_TOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


@pytest.fixture
def data():
    x = np.random.default_rng(42).normal(size=(200, 8)) \
        * np.linspace(0.5, 4, 8) + 3.0
    x[:, 5] = 7.0  # zero-variance column
    return x


def _chunks(x):
    return lambda: (x[i:i + 37] for i in range(0, len(x), 37))


@pytest.mark.parametrize("route", ["device", "host", "streamed"])
def test_fit_routes_match_jax_at_float64(data, route):
    def fit(est):
        est = est.setDtype("float64").setUseXlaDot(route != "host")
        return est.fit(_chunks(data) if route == "streamed" else data)

    got, want = fit(StandardScaler()), fit(JaxStandardScaler())
    assert got.mean.dtype == np.float64 and got.std.dtype == np.float64
    np.testing.assert_allclose(got.mean, want.mean, rtol=0,
                               atol=F64_TOL * np.abs(want.mean).max())
    np.testing.assert_allclose(got.std, want.std, rtol=0,
                               atol=F64_TOL * np.abs(want.std).max())
    assert got.fit_report_.algo == "standard_scaler"


def test_float32_device_fit_meets_its_bar(data):
    got = StandardScaler().fit(data)
    want = JaxStandardScaler().fit(data)
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-6)
    np.testing.assert_allclose(got.std, want.std, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_xla", [True, False])
def test_scaler_statistics(data, use_xla):
    model = StandardScaler().setUseXlaDot(use_xla).setDtype("float64") \
        .fit(data)
    np.testing.assert_allclose(model.mean, data.mean(axis=0), atol=1e-9)
    np.testing.assert_allclose(model.std, data.std(axis=0, ddof=1),
                               atol=1e-9)


def test_scaler_defaults_scale_only(data):
    out = StandardScaler().fit(data).transform(data)
    got = np.asarray(out.column("scaled_features"))
    std = data.std(axis=0, ddof=1)
    expected = data * np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0),
                               0.0)[None, :]
    np.testing.assert_allclose(got, expected, rtol=1e-6)
    np.testing.assert_allclose(got[:, 5], 0.0)
    assert isinstance(FeatureScaler(), StandardScaler)


def test_scaler_with_mean_and_std(data):
    model = StandardScaler().setWithMean(True).setWithStd(True) \
        .setDtype("float64").fit(data)
    got = np.asarray(model.transform(data).column("scaled_features"))
    nonconst = [c for c in range(8) if c != 5]
    np.testing.assert_allclose(got[:, nonconst].mean(axis=0), 0, atol=1e-9)
    np.testing.assert_allclose(got[:, nonconst].std(axis=0, ddof=1), 1,
                               atol=1e-9)


def test_transform_equals_jax_on_the_same_statistics(data):
    model = StandardScaler().setWithMean(True).setDtype("float64").fit(data)
    jax_model = JaxStandardScalerModel(mean=model.mean, std=model.std)
    jax_model.setWithMean(True)
    np.testing.assert_array_equal(
        np.asarray(model.transform(data).column("scaled_features")),
        np.asarray(jax_model.transform(data).column("scaled_features")))


def test_scaler_pipeline_with_pca(data):
    pipe = Pipeline(stages=[
        StandardScaler().setWithMean(True).setOutputCol("scaled"),
        PCA().setInputCol("scaled").setK(3),
    ])
    out = pipe.fit(data).transform(data)
    assert np.asarray(out.column("pca_features")).shape == (200, 3)


def test_scaler_persistence_and_cross_loading(data, tmp_path):
    model = StandardScaler().setWithMean(True).fit(data)
    p = str(tmp_path / "m")
    model.save(p)
    for back in (StandardScalerModel.load(p), JaxStandardScalerModel.load(p)):
        np.testing.assert_array_equal(back.mean, model.mean)
        np.testing.assert_array_equal(back.std, model.std)
        assert back.getWithMean() is True
    jp = str(tmp_path / "jax")
    JaxStandardScaler().setWithStd(False).fit(data).save(jp)
    back = StandardScalerModel.load(jp)
    assert isinstance(back, StandardScalerModel)
    assert back.getWithStd() is False
    ep = str(tmp_path / "est")
    StandardScaler().setWithMean(True).save(ep)
    assert JaxStandardScaler.load(ep).getWithMean() is True


def test_scaler_guards(data):
    model = StandardScaler().fit(data)
    with pytest.raises(ValueError, match="features"):
        model.transform(data[:, :4])
    out = model.transform(data)
    with pytest.raises(ValueError, match="already exists"):
        model.transform(out)
    with pytest.raises(ValueError, match="2 rows"):
        StandardScaler().fit(data[:1])
    with pytest.raises(ValueError, match="2 rows"):
        StandardScaler().fit(_chunks(data[:1]))
    with pytest.raises(ValueError, match="no statistics"):
        StandardScalerModel().transform(data)


@pytest.mark.parametrize("with_mean", [False, True])
@pytest.mark.parametrize("with_std", [False, True])
def test_serving_stage_bodies_equal_the_host_transform(data, with_mean,
                                                       with_std):
    """At float64 the device stage computes the host transform's very
    expression: equal, not close; the same as the JAX stage's body."""
    import jax
    import jax.numpy as jnp

    model = StandardScaler().setWithMean(with_mean).setWithStd(with_std) \
        .setDtype("float64").fit(data)
    stage = model.serving_stage(device=torch.device("cpu"),
                                dtype=torch.float64)
    assert stage.algo == "standard_scaler" and not stage.terminal
    assert len(stage.weights) == int(with_mean) + int(with_std)
    got = stage.fn(torch.as_tensor(data), *stage.weights).numpy()
    want = np.asarray(model.transform(data).column("scaled_features"))
    np.testing.assert_array_equal(got, want)
    jax_model = JaxStandardScalerModel(mean=model.mean, std=model.std)
    jax_model.setWithMean(with_mean).setWithStd(with_std)
    jstage = jax_model.serving_stage(device=jax.devices()[0],
                                     dtype=jnp.float64)
    np.testing.assert_array_equal(
        got, np.asarray(jstage.fn(jnp.asarray(data), *jstage.weights)))
    # every precision shares the elementwise body
    for precision in ("bf16", "int8"):
        other = model.serving_stage(precision, device=torch.device("cpu"),
                                    dtype=torch.float64)
        np.testing.assert_array_equal(
            other.fn(torch.as_tensor(data), *other.weights).numpy(), got)


def test_serving_stage_stages_at_the_chain_dtype(data):
    model = StandardScaler().setWithMean(True).fit(data)
    stage = model.serving_stage()
    assert [w.dtype for w in stage.weights] == [torch.float32] * 2
    assert stage.weights[1][5].item() == 0.0  # the zero-std factor
    assert StandardScalerModel().serving_stage() is None
