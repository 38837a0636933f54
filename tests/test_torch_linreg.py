"""LinearRegression in the port against the JAX package's, on the same numpy
inputs.

The cases of tests/test_linear_regression.py and the LinearRegression cases
of tests/test_streaming_fit.py, each run through both packages, plus the
operations of ``ops/linreg_kernel.py`` one by one, the not-positive-definite
Cholesky, cross-loading in both directions and ``BatchSource``'s
``chunk_transform``. The JAX suite runs with x64 (tests/conftest.py), so
its 'auto' dtype is float64; the port's is float32, so every comparison
names its dtype:

* float64 in both: the JAX tests' own bars (1e-5 recovery, 1e-6 against
  sklearn, 1e-8 host against device), and 1e-8 between the packages;
* float32 in the port (on the CPU the Gram kernel's plain version: the
  one-shot Gram at highest, the streamed one at the default bfloat16_3x):
  within 1e-4 of the float64 JAX fit on these condition numbers (≤ 10).
"""

import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu.ops.linreg_kernel as jax_ops
from spark_rapids_ml_tpu import LinearRegression as JaxLinearRegression
from spark_rapids_ml_tpu import LinearRegressionModel as JaxLinearRegressionModel
from spark_rapids_ml_tpu.data.batches import BatchSource as JaxBatchSource
from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxVectorFrame
from spark_rapids_ml_tpu.models.linear_regression import (
    _elastic_net_solve as jax_elastic_net_solve,
)
from spark_rapids_ml_tpu_torch import LinearRegression, LinearRegressionModel
from spark_rapids_ml_tpu_torch.data.batches import BatchSource
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
from spark_rapids_ml_tpu_torch.feature import LinearRegression as FeatureLR
from spark_rapids_ml_tpu_torch.models import linear_regression as lr_module
from spark_rapids_ml_tpu_torch.models.linear_regression import (
    _elastic_net_solve,
    _zip_xy,
)
from spark_rapids_ml_tpu_torch.ops import covariance as cov_ops
from spark_rapids_ml_tpu_torch.ops import linreg_kernel as ops

ABS_TOL = 1e-5
F32_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def make_data(rng, n=200, p=6, noise=0.0):
    x = rng.normal(size=(n, p))
    w = rng.normal(size=p)
    b = 2.5
    y = x @ w + b + noise * rng.normal(size=n)
    return x, y, w, b


def _both(configure, *args, **kwargs):
    """The same estimator configuration fitted by both packages."""
    return (configure(LinearRegression()).fit(*args, **kwargs),
            configure(JaxLinearRegression()).fit(*args, **kwargs))


def _assert_same(ours, ref, tol):
    np.testing.assert_allclose(ours.coefficients, ref.coefficients, atol=tol,
                               rtol=0)
    assert ours.intercept == pytest.approx(ref.intercept, abs=tol)


def _dtype_case(dtype):
    return (lambda e: e.setDtype(dtype)), (1e-8 if dtype == "float64"
                                           else F32_TOL)


# -- the statistics and the solve -------------------------------------------

@pytest.mark.parametrize("mask", ["none", "rows", "weights"])
def test_partial_stats_match_jax(rng, mask):
    x = rng.normal(size=(50, 5))
    y = rng.normal(size=50)
    m = {"none": None, "rows": (rng.random(50) > 0.3).astype(np.float64),
         "weights": rng.uniform(0.5, 2.0, 50)}[mask]
    ours = ops.linreg_partial_stats(
        torch.as_tensor(x), torch.as_tensor(y),
        None if m is None else torch.as_tensor(m))
    ref = jax_ops.linreg_partial_stats(x, y, m)
    for got, want in zip(ours, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)


def test_the_gram_is_the_kernels_full_f32_with_root_weights(rng, monkeypatch):
    """xmᵀx goes to the kernel's wrapper as rowmul = √m, precision highest
    (on the card the FFMA pipeline)."""
    calls = []
    real = cov_ops.fused_centered_gram

    def counted(x, mean, rowmul, precision=None):
        calls.append((precision, rowmul.clone()))
        return real(x, mean, rowmul, precision)

    monkeypatch.setattr(cov_ops, "fused_centered_gram", counted)
    x = rng.normal(size=(40, 4)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 40).astype(np.float32)
    ops.linreg_partial_stats(torch.as_tensor(x), torch.as_tensor(x[:, 0]),
                             torch.as_tensor(w))
    ((precision, rowmul),) = calls
    assert precision == "highest"
    np.testing.assert_array_equal(rowmul.numpy(), np.sqrt(w))


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("reg", [0.0, 0.3])
def test_fit_and_predict_kernels_match_jax(rng, fit_intercept, reg):
    x, y, _, _ = make_data(rng, noise=0.2)
    ours = ops.linreg_fit_kernel(torch.as_tensor(x), torch.as_tensor(y),
                                 reg_param=reg, fit_intercept=fit_intercept)
    ref = jax_ops.linreg_fit_kernel(x, y, reg_param=reg,
                                    fit_intercept=fit_intercept)
    np.testing.assert_allclose(ours.coefficients.numpy(),
                               np.asarray(ref.coefficients), atol=1e-10)
    np.testing.assert_allclose(float(ours.intercept), float(ref.intercept),
                               atol=1e-10)
    pred = ops.linreg_predict_kernel(torch.as_tensor(x), ours.coefficients,
                                     ours.intercept)
    np.testing.assert_allclose(
        pred.numpy(), np.asarray(jax_ops.linreg_predict_kernel(
            x, ref.coefficients, ref.intercept)), atol=1e-9)


def test_a_matrix_that_is_not_positive_definite_gives_nan_in_both():
    """JAX's cho_factor returns NaN there; the port lets the NaN through
    instead of raising (cholesky_ex)."""
    xtx = np.array([[1.0, 2.0], [2.0, 1.0]])   # eigenvalues 3 and −1
    stats = dict(xtx=xtx, xty=np.array([1.0, 0.5]), x_sum=np.zeros(2),
                 y_sum=np.array(0.0), y_sq=np.array(1.0),
                 count=np.array(1.0))
    ours = ops.solve_normal_equations(
        ops.LinRegStats(**{k: torch.as_tensor(v) for k, v in stats.items()}),
        0.0, fit_intercept=True)
    ref = jax_ops.solve_normal_equations(jax_ops.LinRegStats(**stats), 0.0,
                                         fit_intercept=True)
    assert np.isnan(np.asarray(ref.coefficients)).all()
    assert np.isnan(ours.coefficients.numpy()).all()
    assert np.isnan(float(ours.intercept)) and np.isnan(float(ref.intercept))


# -- the cases of tests/test_linear_regression.py ----------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_exact_recovery_no_noise(rng, dtype):
    x, y, w, b = make_data(rng)
    configure, tol = _dtype_case(dtype)
    ours, ref = _both(configure, x, labels=y)
    np.testing.assert_allclose(ours.coefficients, w, atol=max(ABS_TOL, tol))
    assert ours.intercept == pytest.approx(b, abs=max(ABS_TOL, tol))
    _assert_same(ours, ref, tol)
    assert set(ours.fit_timings_) == set(ref.fit_timings_) == \
        {"densify", "h2d", "fit_kernel"}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_no_intercept(rng, dtype):
    x, y, w, _ = make_data(rng)
    y = y - 2.5  # remove the intercept term
    configure, tol = _dtype_case(dtype)
    ours, ref = _both(lambda e: configure(e).setFitIntercept(False), x,
                      labels=y)
    np.testing.assert_allclose(ours.coefficients, w, atol=max(ABS_TOL, tol))
    assert ours.intercept == ref.intercept == 0.0
    _assert_same(ours, ref, tol)


def test_ridge_matches_sklearn_and_jax(rng):
    sklearn_lm = pytest.importorskip("sklearn.linear_model")
    x, y, _, _ = make_data(rng, noise=0.5)
    lam = 0.3
    ours, ref = _both(lambda e: e.setRegParam(lam).setDtype("float64"), x,
                      labels=y)
    # the objective: (1/2n)Σerr² + (λ/2)||w||²  ⇔  sklearn Ridge alpha = n·λ
    sk = sklearn_lm.Ridge(alpha=lam * len(x)).fit(x, y)
    np.testing.assert_allclose(ours.coefficients, sk.coef_, atol=1e-6)
    assert ours.intercept == pytest.approx(sk.intercept_, abs=1e-6)
    _assert_same(ours, ref, 1e-8)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_host_path_agrees(rng, dtype):
    x, y, _, _ = make_data(rng, noise=0.3)
    configure, tol = _dtype_case(dtype)
    dev = configure(LinearRegression().setRegParam(0.1)).fit(x, labels=y)
    host, ref = _both(lambda e: e.setRegParam(0.1).setUseXlaDot(False), x,
                      labels=y)
    _assert_same(host, ref, 1e-12)   # numpy float64 in both packages
    _assert_same(host, dev, tol)


def test_label_column_in_frame(rng):
    x, y, w, b = make_data(rng)
    frame = VectorFrame({"features": x, "label": y.tolist()})
    jframe = JaxVectorFrame({"features": x, "label": y.tolist()})
    model = LinearRegression().setDtype("float64").fit(frame)
    ref = JaxLinearRegression().fit(jframe)
    np.testing.assert_allclose(model.coefficients, w, atol=ABS_TOL)
    _assert_same(model, ref, 1e-8)
    pred = np.asarray(model.transform(frame).column("prediction"))
    np.testing.assert_allclose(pred, y, atol=1e-4)
    np.testing.assert_allclose(
        pred, np.asarray(ref.transform(jframe).column("prediction")),
        atol=1e-8)
    summary, jsummary = model.evaluate(frame), ref.evaluate(jframe)
    assert summary["r2"] == pytest.approx(1.0, abs=1e-6)
    assert summary["rmse"] < 1e-4
    assert summary.keys() == jsummary.keys()
    # a float32 model predicts within the float32 bar
    f32 = LinearRegression().fit(frame)
    np.testing.assert_allclose(
        np.asarray(f32.transform(frame).column("prediction")), y, atol=1e-4)


def test_label_length_mismatch():
    for cls in (LinearRegression, JaxLinearRegression):
        with pytest.raises(ValueError, match="labels length"):
            cls().fit(np.ones((5, 2)), labels=np.ones(4))


@pytest.mark.parametrize("saver,loader", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_persistence_across_packages(tmp_path, rng, saver, loader):
    x, y, _, _ = make_data(rng, noise=0.2)
    est = {"port": LinearRegression, "jax": JaxLinearRegression}[saver]()
    model = est.setRegParam(0.05).setWeightCol("").fit(x, labels=y)
    path = str(tmp_path / "lr")
    model.save(path)
    cls = {"port": LinearRegressionModel, "jax": JaxLinearRegressionModel}
    loaded = cls[loader].load(path)
    np.testing.assert_array_equal(loaded.coefficients, model.coefficients)
    assert loaded.intercept == model.intercept
    assert loaded.getRegParam() == 0.05
    assert loaded.uid == model.uid
    est.save(str(tmp_path / "est"))
    assert FeatureLR.load(str(tmp_path / "est")).getRegParam() == 0.05


@pytest.mark.parametrize("use_xla", [True, False])
def test_weight_col_equals_row_duplication(rng, use_xla):
    """weight w=2 on a row ≡ that row appearing twice — the defining
    property of Spark's weightCol — in both packages."""
    x = rng.normal(size=(120, 4))
    y = x @ np.array([1.0, -2.0, 0.5, 3.0]) + 0.3 + 0.05 * rng.normal(size=120)
    w = rng.integers(1, 4, size=120).astype(np.float64)
    reps = np.repeat(np.arange(120), w.astype(int))

    def configure(e):
        return e.setUseXlaDot(use_xla).setDtype("float64")

    weighted = configure(LinearRegression().setWeightCol("w")).fit(
        VectorFrame({"features": x, "label": y, "w": w}))
    expanded = configure(LinearRegression()).fit(
        VectorFrame({"features": x[reps], "label": y[reps]}))
    ref = configure(JaxLinearRegression().setWeightCol("w")).fit(
        JaxVectorFrame({"features": x, "label": y, "w": w}))
    _assert_same(weighted, expanded, 1e-5)
    _assert_same(weighted, ref, 1e-10)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_weight_col_matches_sklearn_and_jax(rng, dtype):
    x = rng.normal(size=(200, 3))
    y = x @ np.array([2.0, -1.0, 0.5]) + 1.0 + 0.1 * rng.normal(size=200)
    w = rng.uniform(0.1, 5.0, size=200)
    configure, tol = _dtype_case(dtype)
    ours = configure(LinearRegression().setWeightCol("w")).fit(
        VectorFrame({"features": x, "label": y, "w": w}))
    ref = JaxLinearRegression().setWeightCol("w").fit(
        JaxVectorFrame({"features": x, "label": y, "w": w}))
    _assert_same(ours, ref, tol)
    sklearn_lm = pytest.importorskip("sklearn.linear_model")
    sk = sklearn_lm.LinearRegression().fit(x, y, sample_weight=w)
    np.testing.assert_allclose(ours.coefficients, sk.coef_,
                               atol=max(1e-6, tol))


def test_weight_col_validation_before_any_device(rng, monkeypatch):
    x = rng.normal(size=(50, 2))
    y = x[:, 0]

    def no_device(*_args, **_kwargs):
        raise AssertionError("a device was resolved before validation")

    monkeypatch.setattr(lr_module, "resolve_device", no_device)
    for bad in (-np.ones(50), np.full(50, np.nan)):
        with pytest.raises(ValueError, match="non-negative"):
            LinearRegression().setWeightCol("w").fit(
                VectorFrame({"features": x, "label": y, "w": bad}))
        with pytest.raises(ValueError, match="non-negative"):
            JaxLinearRegression().setWeightCol("w").fit(
                JaxVectorFrame({"features": x, "label": y, "w": bad}))
    with pytest.raises(ValueError, match="weight column length"):
        LinearRegression().setWeightCol("w")._extract_weights(
            VectorFrame({"w": np.ones(49)}), 50)

    def chunks():
        yield (x, y)

    for cls in (LinearRegression, JaxLinearRegression):
        with pytest.raises(ValueError, match="streamed"):
            cls().setWeightCol("w").fit(chunks)


@pytest.mark.parametrize("lam,alpha", [(0.1, 0.5), (0.05, 1.0)])
@pytest.mark.parametrize("use_xla", [True, False])
def test_elastic_net_matches_jax_and_sklearn(rng, lam, alpha, use_xla):
    """elasticNetParam: the statistics on the device, FISTA on the host in
    float64, against the JAX package (1e-8) and sklearn (its 2e-4), with
    the same exact zeros."""
    n, d = 400, 8
    x = rng.normal(size=(n, d))
    true = np.array([3.0, -2.0, 0.0, 0.0, 1.5, 0.0, 0.0, 0.5])
    y = x @ true + 1.0 + 0.05 * rng.normal(size=n)
    ours = (LinearRegression().setUseXlaDot(use_xla).setRegParam(lam)
            .setElasticNetParam(alpha).setDtype("float64")
            .fit(VectorFrame({"features": x, "label": y})))
    ref = (JaxLinearRegression().setUseXlaDot(use_xla).setRegParam(lam)
           .setElasticNetParam(alpha)
           .fit(JaxVectorFrame({"features": x, "label": y})))
    _assert_same(ours, ref, 1e-8)
    np.testing.assert_array_equal(np.abs(ours.coefficients) < 1e-6,
                                  np.abs(ref.coefficients) < 1e-6)
    f32 = (LinearRegression().setUseXlaDot(use_xla).setRegParam(lam)
           .setElasticNetParam(alpha)
           .fit(VectorFrame({"features": x, "label": y})))
    _assert_same(f32, ref, F32_TOL)
    sklin = pytest.importorskip("sklearn.linear_model")
    sk_cls = sklin.Lasso if alpha == 1.0 else sklin.ElasticNet
    kw = {"alpha": lam} if alpha == 1.0 else {"alpha": lam, "l1_ratio": alpha}
    sk = sk_cls(max_iter=10000, tol=1e-10, **kw).fit(x, y)
    np.testing.assert_allclose(ours.coefficients, sk.coef_, atol=2e-4)
    np.testing.assert_allclose(ours.intercept, sk.intercept_, atol=2e-4)


def test_elastic_net_streamed_matches_inmemory(rng):
    n, d = 300, 5
    x = rng.normal(size=(n, d))
    y = x @ np.array([2.0, 0.0, -1.0, 0.0, 0.5]) + 0.1 * rng.normal(size=n)

    def chunks():
        for i in range(0, n, 64):
            yield (x[i:i + 64], y[i:i + 64])

    def configure(e):
        return e.setRegParam(0.05).setElasticNetParam(0.7).setDtype("float64")

    mem = configure(LinearRegression()).fit(
        VectorFrame({"features": x, "label": y}))
    streamed, ref = _both(configure, chunks)
    np.testing.assert_allclose(streamed.coefficients, mem.coefficients,
                               atol=1e-5)
    _assert_same(streamed, ref, 1e-8)


def test_elastic_net_negative_equicorrelation_gram():
    """The Lipschitz estimate: ones is the BOTTOM eigenvector of a
    negative-equicorrelation Gram; FISTA must converge, to the JAX
    package's solution."""
    a = np.array([[1.0, -0.9], [-0.9, 1.0]])
    b = np.array([1.0, -0.5])
    w = _elastic_net_solve(a, b, 0.01, 1.0)
    np.testing.assert_array_equal(w, jax_elastic_net_solve(a, b, 0.01, 1.0))
    assert np.isfinite(w).all()
    # KKT check: subgradient condition of the lasso at the solution
    g = a @ w - b
    for j in range(2):
        if abs(w[j]) > 1e-10:
            assert abs(g[j] + 0.01 * np.sign(w[j])) < 1e-6
        else:
            assert abs(g[j]) <= 0.01 + 1e-6


# -- streamed fits (tests/test_streaming_fit.py) -----------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_streamed_matches_oneshot_and_jax(rng, dtype):
    x = rng.normal(size=(4000, 12))
    w = rng.normal(size=12)
    y = x @ w + 1.5 + 0.01 * rng.normal(size=4000)
    configure, tol = _dtype_case(dtype)

    def chunks():
        for i in range(0, 4000, 333):
            yield (x[i:i + 333], y[i:i + 333])

    oneshot = configure(LinearRegression().setRegParam(0.1)).fit(x, y)
    streamed = configure(LinearRegression().setRegParam(0.1)).fit(chunks)
    ref = JaxLinearRegression().setRegParam(0.1).fit(chunks)
    _assert_same(streamed, oneshot, 5e-4)
    _assert_same(streamed, ref, tol)
    assert set(streamed.fit_timings_) == set(ref.fit_timings_) == \
        {"fit_kernel"}


def test_size_threshold_triggers_streaming(rng, monkeypatch):
    x = rng.normal(size=(500, 6))
    y = x @ np.arange(1.0, 7.0) - 0.5
    monkeypatch.setenv("TPUML_STREAM_THRESHOLD_BYTES", "1024")
    streamed = LinearRegression().fit(x, y)
    ref = JaxLinearRegression().fit(x, y)
    assert "h2d" not in streamed.fit_timings_
    monkeypatch.setenv("TPUML_STREAM_THRESHOLD_BYTES", str(1 << 40))
    oneshot = LinearRegression().fit(x, y)
    assert "h2d" in oneshot.fit_timings_
    _assert_same(streamed, oneshot, 1e-4)
    _assert_same(streamed, ref, F32_TOL)


def test_streamed_host_path(rng):
    x = rng.normal(size=(2000, 5))
    y = x @ np.arange(1.0, 6.0) + 2.0

    def chunks():
        return ((x[i:i + 300], y[i:i + 300]) for i in range(0, 2000, 300))

    oneshot = LinearRegression().setUseXlaDot(False).fit(x, y)
    streamed, ref = _both(lambda e: e.setUseXlaDot(False), chunks)
    _assert_same(streamed, oneshot, 1e-8)
    _assert_same(streamed, ref, 1e-12)


def test_streamed_int_features_float_labels(rng):
    """Integer X chunks must not truncate float labels."""
    x = rng.integers(0, 5, size=(1000, 4)).astype(np.int64)
    w = np.array([0.25, -0.5, 1.75, 0.1])
    y = x @ w + 0.7

    def chunks():
        return ((x[i:i + 200], y[i:i + 200]) for i in range(0, 1000, 200))

    streamed, ref = _both(lambda e: e, chunks)
    np.testing.assert_allclose(streamed.coefficients, w, atol=1e-4)
    assert abs(streamed.intercept - 0.7) < 1e-3
    _assert_same(streamed, ref, F32_TOL)


def test_streamed_bad_chunk_shape(rng):
    x = rng.normal(size=(10, 3))
    for cls in (LinearRegression, JaxLinearRegression):
        with pytest.raises(ValueError, match=r"\(X, y\) tuples"):
            cls().fit(lambda: iter([x]))


def test_fake_factory_demoted_not_truncated(rng):
    """`lambda: gen` over one (X, y) generator: the one-shot demotion must
    still fire through the chunk transform, fitting on ALL the data."""
    x = rng.normal(size=(900, 5))
    y = x @ np.arange(1.0, 6.0) + 0.25
    gen = ((x[i:i + 100], y[i:i + 100]) for i in range(0, 900, 100))
    streamed = LinearRegression().fit(lambda: gen)
    oneshot = LinearRegression().fit(x, y)
    np.testing.assert_allclose(streamed.coefficients, oneshot.coefficients,
                               atol=5e-4)


@pytest.mark.parametrize("form", ["list", "factory", "oneshot"])
def test_batch_source_chunk_transform_matches_jax(rng, form):
    """``chunk_transform`` runs on each raw chunk before re-blocking: the
    same (batch, mask) stream as the JAX package's, for every source
    form, with the width known from the first transformed chunk."""
    x = rng.normal(size=(70, 3))
    y = rng.normal(size=70)
    pairs = [(x[i:i + 25], y[i:i + 25]) for i in range(0, 70, 25)]

    def source():
        if form == "list":
            return pairs
        if form == "factory":
            return lambda: iter(pairs)
        return iter(pairs)

    ours = BatchSource(source(), batch_rows=16, chunk_transform=_zip_xy)
    if form == "list":
        # the JAX BatchSource transforms a list's chunks twice (once when
        # it stores them, again on every pass), so (X, y) pairs fail there;
        # the port transforms them once, to the factory form's stream
        with pytest.raises(ValueError, match=r"\(X, y\) tuples"):
            JaxBatchSource(source(), batch_rows=16, chunk_transform=_zip_xy)
        ref = JaxBatchSource(lambda: iter(pairs), batch_rows=16,
                             chunk_transform=_zip_xy)
    else:
        ref = JaxBatchSource(source(), batch_rows=16,
                             chunk_transform=_zip_xy)
    assert ours.n_features == ref.n_features == 4
    assert ours.reiterable == (form != "oneshot")
    got, want = list(ours.batches()), list(ref.batches())
    assert len(got) == len(want) == 5
    for (b, m), (jb, jm) in zip(got, want):
        np.testing.assert_array_equal(b, jb)
        assert (m is None) == (jm is None)
        if m is not None:
            np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(
        np.concatenate([b if m is None else b[m] for b, m in got]),
        np.column_stack([x, y]))
    # a width given up front spares the peek
    sized = BatchSource(lambda: iter(pairs), batch_rows=16, n_features=4,
                        chunk_transform=_zip_xy)
    assert sum(b.shape[0] if m is None else int(m.sum())
               for b, m in sized.batches()) == 70


def test_device_fit_needs_a_device_or_the_cpu_request(rng, monkeypatch):
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, _, _ = make_data(rng)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LinearRegression().fit(x, labels=y)
    model = LinearRegression().setUseXlaDot(False).fit(x, labels=y)
    assert model.coefficients.shape == (6,)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.setUseXlaDot(True).transform(x)
