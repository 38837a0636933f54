"""GBT in the port against the JAX package's, on the same numpy inputs:
``boosting_loop`` and the init margins, then the GBTRegressor /
GBTClassifier fits and models (weights, subsampling, the validation
early stop).

Bars: at float64 the feature and threshold arrays equal element for
element, leaf values, raw scores, probabilities and feature importances
within 1e-12, and the validation stop keeps the same number of rounds; a
float32 regressor predicts within 1e-5 relative of the JAX package's
float64 fit. Each round grows a regression tree on continuous residuals,
so the data here is free of near-ties the way tests/test_torch_forest.py
says: a strong planted signal and ``minInstancesPerNode`` 8.
"""

import numpy as np
import pytest

import spark_rapids_ml_tpu as jax_pkg
from spark_rapids_ml_tpu.data.frame import as_vector_frame as jax_frame
from spark_rapids_ml_tpu.models import gbt as jax_gbt
import spark_rapids_ml_tpu_torch as port_pkg
from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame
from spark_rapids_ml_tpu_torch.models import gbt

F64_ATOL = 1e-12
F32_REL = 1e-5
N, D, DEPTH = 1024, 5, 3


@pytest.fixture(scope="module", autouse=True)
def _cpu_requested():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
        yield


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D))
    y = 2.0 * x[:, 0] - x[:, 1] + np.sin(2.0 * x[:, 2]) \
        + 0.1 * rng.normal(size=N)
    y01 = ((x[:, 0] + x[:, 1] ** 2) > 0.8).astype(np.float64)
    return x, y, y01


def _frame(pkg_frame, x, y, **cols):
    frame = pkg_frame(x, "features").with_column("label", y.tolist())
    for name, values in cols.items():
        frame = frame.with_column(name, np.asarray(values).tolist())
    return frame


CASES = {
    "regression": dict(),
    "subsampled": dict(subsamplingRate=0.7, seed=5),
    "weighted": dict(weightCol="w"),
    "validation": dict(validationIndicatorCol="val", maxIter=30,
                       stepSize=0.5),
    "classification": dict(),
    "classification_subsampled": dict(subsamplingRate=0.8, seed=3),
    "classification_validation": dict(validationIndicatorCol="val",
                                      maxIter=30, stepSize=0.5),
}


def _fit(pkg, pkg_frame, case, dtype="float64"):
    x, y, y01 = _data()
    classification = case.startswith("classification")
    label = y01 if classification else y
    rng = np.random.default_rng(9)
    cols = {"w": rng.integers(1, 9, size=N) / 4.0,
            "val": rng.random(N) < 0.25}
    est = (pkg.GBTClassifier() if classification else pkg.GBTRegressor())
    est.setMaxIter(8).setMaxDepth(DEPTH).setStepSize(0.3) \
        .setMinInstancesPerNode(8).setDtype(dtype)
    for name, value in CASES[case].items():
        est.set(name, value)
    return est.fit(_frame(pkg_frame, x, label, **cols))


@pytest.fixture(scope="module")
def fits():
    return {case: (_fit(port_pkg, as_vector_frame, case),
                   _fit(jax_pkg, jax_frame, case)) for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_gbt_fit_equals_the_jax_fit(fits, case):
    port, jax_model = fits[case]
    np.testing.assert_array_equal(port.ensemble_.feature,
                                  np.asarray(jax_model.ensemble_.feature))
    np.testing.assert_array_equal(port.ensemble_.threshold,
                                  np.asarray(jax_model.ensemble_.threshold))
    np.testing.assert_allclose(port.ensemble_.leaf_value,
                               np.asarray(jax_model.ensemble_.leaf_value),
                               rtol=0, atol=F64_ATOL)
    assert port.init_ == jax_model.init_
    assert port.step_size_ == jax_model.step_size_
    np.testing.assert_allclose(port.feature_importances_,
                               jax_model.feature_importances_, rtol=0,
                               atol=F64_ATOL)
    xq = np.random.default_rng(40).normal(size=(300, D))
    np.testing.assert_allclose(port._raw_score(xq),
                               jax_model._raw_score(xq), rtol=0,
                               atol=F64_ATOL)
    got = np.asarray(port.transform(xq).column("prediction"))
    want = np.asarray(jax_model.transform(xq).column("prediction"))
    if case.startswith("classification"):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(port.predict_proba(xq),
                                   jax_model.predict_proba(xq), rtol=0,
                                   atol=F64_ATOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=F64_ATOL)


@pytest.mark.parametrize("case", ["validation", "classification_validation"])
def test_validation_stop_keeps_the_jax_rounds(fits, case):
    port, jax_model = fits[case]
    kept = port.ensemble_.feature.shape[0]
    assert kept == np.asarray(jax_model.ensemble_.feature).shape[0]
    assert kept < CASES[case]["maxIter"]  # the stop fired
    # the rounds grown: the kept ones, then up to the stopping round
    assert len(port.boost_rounds_) > kept
    assert all(r["grow_s"] > 0 and r["host_s"] >= 0
               for r in port.boost_rounds_)


def test_float32_regressor_predicts_as_the_jax_float64_fit(fits):
    port32 = _fit(port_pkg, as_vector_frame, "regression", dtype="float32")
    _, jax_model = fits["regression"]
    np.testing.assert_array_equal(port32.ensemble_.feature,
                                  np.asarray(jax_model.ensemble_.feature))
    xq = np.random.default_rng(41).normal(size=(300, D))
    got = np.asarray(port32.transform(xq).column("prediction"))
    want = np.asarray(jax_model.transform(xq).column("prediction"))
    assert np.abs(got - want).max() <= F32_REL * np.abs(want).max()


def test_boosting_loop_is_the_jax_loop():
    """Both packages' ``boosting_loop`` around one host grower (a stump on
    the sign of the residual's row parity): equal ensembles bit for bit,
    classification and regression, subsampled, with a validation hook
    that stops."""
    rng = np.random.default_rng(2)
    n, depth = 50, 2
    y01 = (rng.random(n) < 0.4).astype(np.float64)

    def grow_fn(r, w):
        ids = (np.arange(len(r)) % 4)
        leaf = np.bincount(ids, weights=w * r, minlength=4) / np.maximum(
            np.bincount(ids, weights=w, minlength=4), 1e-12)
        return (np.zeros(3, np.int32), np.full(3, 5, np.int32), leaf,
                np.ones(3), ids)

    for classification in (False, True):
        for hook in (None, "stop"):
            out = []
            for mod in (gbt, jax_gbt):
                it = iter([3.0, 2.0, 1.99, 1.0])
                out.append(mod.boosting_loop(
                    y_padded=y01, mask=np.ones(n), n_real=n, init=0.25,
                    max_iter=4, step_size=0.5,
                    classification=classification, subsampling_rate=0.5,
                    rng=np.random.default_rng(7), max_depth=depth,
                    grow_fn=grow_fn,
                    val_hook=(lambda *a, _it=it: next(_it)) if hook
                    else None))
            (pe, pg), (je, jg) = out
            for a, b in zip(pe, je):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(pg, jg)
            assert pe.feature.shape[0] == (2 if hook else 4)


def test_init_margins_are_the_jax_packages():
    y = np.array([0.0, 1.0, 1.0, 0.0, 1.0])
    w = np.array([1.0, 2.0, 0.5, 1.0, 3.0])
    for classification in (False, True):
        assert gbt.gbt_init_margin(y, classification) == \
            jax_gbt.gbt_init_margin(y, classification)
        assert gbt.gbt_init_margin(y, classification, w) == \
            jax_gbt.gbt_init_margin(y, classification, w)
    for mean in (0.0, 1e-9, 0.3, 1.0):
        assert gbt.gbt_init_from_mean(mean, True) == \
            jax_gbt.gbt_init_from_mean(mean, True)
    with pytest.raises(ValueError, match="0/1"):
        gbt.gbt_init_margin(np.array([0.0, 2.0]), True)


def test_gbt_validation_requires_both_sides():
    x, y, _ = _data()
    frame = _frame(as_vector_frame, x[:30], y[:30], val=[True] * 30)
    with pytest.raises(ValueError, match="SOME rows"):
        port_pkg.GBTRegressor().setValidationIndicatorCol("val").fit(frame)


def test_gbt_thresholds_binary(fits):
    port, _ = fits["classification"]
    model = port.copy()
    model.set("thresholds", [1e-9, 1.0])
    x, _, _ = _data()
    pred = np.asarray(model.transform(x).column("prediction"))
    assert (pred == 0.0).all()
