"""MinMaxScaler, MaxAbsScaler, RobustScaler, Normalizer and Binarizer in the
port against the JAX package's, on the same numpy inputs (float64 host
rows, with constant columns planted): the fits' state bit-equal (in
memory and streamed from a generator), the host transforms equal, every
guard raising the JAX message, and the Binarizer's float32 threshold trap,
which both packages' stage bodies share. Each test runs in metrics
registries of its own, in both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_ml_tpu.models import feature_scalers as jfs
from spark_rapids_ml_tpu.obs import devmon as jax_devmon
from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu_torch import (
    Binarizer,
    MaxAbsScaler,
    MinMaxScaler,
    Normalizer,
    RobustScaler,
    RobustScalerModel,
)
from spark_rapids_ml_tpu_torch.models.feature_scalers import (
    MaxAbsScalerModel,
    MinMaxScalerModel,
)
from spark_rapids_ml_tpu_torch.obs import devmon, fitmon, metrics


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
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


def _x(seed=0, n=256, d=12):
    x = np.random.default_rng(seed).normal(size=(n, d)) \
        * np.linspace(0.5, 3.0, d) + 1.0
    x[:, 4] = 2.5   # a constant column
    x[:, 9] = 0.0   # an all-zero column
    return x


def _chunks(x):
    return lambda: (x[i:i + 37] for i in range(0, len(x), 37))


def _col(model, x):
    return np.asarray(model.transform(x).column(model.getOutputCol()))


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("bounds", [None, (-2.0, 3.0)])
def test_minmax_fit_and_transform_equal_jax(streamed, bounds):
    x = _x()
    ours, ref = MinMaxScaler(), jfs.MinMaxScaler()
    if bounds is not None:
        ours.setMin(bounds[0]).setMax(bounds[1])
        ref.setMin(bounds[0]).setMax(bounds[1])
    data = _chunks(x) if streamed else x
    got = ours.fit(data)
    want = ref.fit(_chunks(x) if streamed else x)
    assert got.uid == ours.uid
    np.testing.assert_array_equal(got.original_min, want.original_min)
    np.testing.assert_array_equal(got.original_max, want.original_max)
    out = _col(got, x)
    np.testing.assert_array_equal(out, _col(want, x))
    mid = 0.5 * (got.getMin() + got.getMax())
    assert (out[:, 4] == mid).all() and (out[:, 9] == mid).all()
    assert set(got.fit_timings_) == {"fit"}


@pytest.mark.parametrize("streamed", [False, True])
def test_maxabs_fit_and_transform_equal_jax(streamed):
    x = _x(1)
    got = MaxAbsScaler().fit(_chunks(x) if streamed else x)
    want = jfs.MaxAbsScaler().fit(_chunks(x) if streamed else x)
    np.testing.assert_array_equal(got.max_abs, want.max_abs)
    assert got.max_abs[9] == 0.0
    out = _col(got, x)
    np.testing.assert_array_equal(out, _col(want, x))
    np.testing.assert_array_equal(out[:, 9], x[:, 9])  # passes through


@pytest.mark.parametrize("centering", [False, True])
@pytest.mark.parametrize("scaling", [False, True])
def test_robust_fit_and_transform_equal_jax(centering, scaling):
    x = _x(2)
    x[::7, 1] = np.nan  # NaN entries are ignored per feature
    x[3, 6] = np.nan

    def fit(est):
        return est.setWithCentering(centering).setWithScaling(scaling) \
            .setLower(0.1).setUpper(0.8).fit(x)

    got, want = fit(RobustScaler()), fit(jfs.RobustScaler())
    np.testing.assert_array_equal(got.median, want.median)
    np.testing.assert_array_equal(got.qrange, want.qrange)
    assert np.isfinite(got.median).all() and got.qrange[4] == 0.0
    np.testing.assert_array_equal(_col(got, x), _col(want, x))


def test_robust_guards_raise_the_jax_messages():
    x = _x(3)
    x[:, 2] = np.nan
    for est in (RobustScaler(), jfs.RobustScaler()):
        with pytest.raises(ValueError, match="entirely NaN; impute first"):
            est.fit(x)
        with pytest.raises(ValueError, match="lower must be below upper"):
            est.setLower(0.6).setUpper(0.4).fit(_x())
    for model in (RobustScalerModel(), jfs.RobustScalerModel()):
        with pytest.raises(ValueError, match="model is unfitted"):
            model.transform(_x())


@pytest.mark.parametrize("p", [1.0, 2.0, 3.5, float("inf")])
def test_normalizer_transform_equals_jax(p):
    x = _x(4)
    x[5] = 0.0  # a zero row passes through
    out = _col(Normalizer().setP(p), x)
    np.testing.assert_array_equal(out, _col(jfs.Normalizer().setP(p), x))
    np.testing.assert_array_equal(out[5], 0.0)


@pytest.mark.parametrize("threshold", [0.0, 1.25, -0.5])
def test_binarizer_transform_equals_jax(threshold):
    x = _x(5)
    x[0, 0] = threshold  # at the threshold: not above it
    out = _col(Binarizer().setThreshold(threshold), x)
    np.testing.assert_array_equal(
        out, _col(jfs.Binarizer().setThreshold(threshold), x))
    assert out[0, 0] == 0.0 and set(np.unique(out)) <= {0.0, 1.0}


def test_guards_raise_the_jax_messages():
    x = _x()
    for cls in (MinMaxScaler, jfs.MinMaxScaler):
        with pytest.raises(ValueError, match="min must be below max"):
            cls().setMin(1.0).setMax(1.0).fit(x)
    for model in (MinMaxScalerModel(), jfs.MinMaxScalerModel(),
                  MaxAbsScalerModel(), jfs.MaxAbsScalerModel()):
        with pytest.raises(ValueError, match="model is unfitted"):
            model.transform(x)
        assert model.serving_stage() is None
    for cls in (Normalizer, jfs.Normalizer):
        with pytest.raises(ValueError, match="invalid value for param 'p'"):
            cls().setP(0.5)
    for cls in (Binarizer, jfs.Binarizer):
        for bad in (float("nan"), float("inf")):
            with pytest.raises(ValueError,
                               match="invalid value for param 'threshold'"):
                cls().setThreshold(bad)
    for cls in (MinMaxScaler, jfs.MinMaxScaler, MaxAbsScaler,
                jfs.MaxAbsScaler):
        with pytest.raises(ValueError, match="at least one row"):
            cls().fit(np.zeros((0, 3)))


def test_binarizer_float32_threshold_rounds_in_both_bodies():
    """A body compares at the chain's dtype, so at float32 the threshold
    0.1 rounds to float32(0.1) in the port's torch body and in the JAX
    body (weak typing) alike, while the host transform compares the
    widened row against float64 0.1: x = float32(0.1) binarizes to 0 in
    both bodies and to 1 on the host."""
    x32 = np.asarray([[0.1, 0.2]], dtype=np.float32)
    ours, ref = Binarizer().setThreshold(0.1), jfs.Binarizer().setThreshold(0.1)
    spec = ours.serving_stage(device=torch.device("cpu"), dtype=torch.float32)
    body = spec.fn(torch.from_numpy(x32), *spec.weights).numpy()
    jspec = ref.serving_stage(device=jax.devices()[0], dtype=jnp.float32)
    jbody = np.asarray(jspec.fn(jnp.asarray(x32), *jspec.weights))
    host = _col(ours, x32)
    np.testing.assert_array_equal(body, [[0.0, 1.0]])
    np.testing.assert_array_equal(jbody, body)
    np.testing.assert_array_equal(host, [[1.0, 1.0]])
    np.testing.assert_array_equal(_col(ref, x32), host)
