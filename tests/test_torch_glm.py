"""GeneralizedLinearRegression in the port against the JAX package's, on the
same numpy inputs.

The cases of tests/test_glm.py, each run through both packages (the JAX
file holds the JAX fit against sklearn, LinearRegression,
LogisticRegression and the estimating equations; here the port is held
against the JAX fit, and the oracles the JAX file uses are kept where they
cost no extra fit), plus the IRLS pass of ``ops/glm_kernel.py`` for every
family/link pair: the numpy pass equal to JAX's numpy pass, the torch pass
(√W Gram) against JAX's jitted one, the Gram launches per pass, the plain
Gram version at float32 on √W rows against JAX's ``dot_general``, and
0·log 0 = 0. The JAX suite runs with x64 (tests/conftest.py), so its
'auto' dtype is float64; the port's is float32, so every comparison names
its dtype:

* float64 in both: coefficients and intercept within 1e-8 relative, the
  same iteration count, the deviance within 1e-10 relative; one pass's
  statistics 1e-12 relative (the numpy pass: equal);
* float32 in the port (on the CPU the Gram kernel's plain version at
  highest): within 1e-4 relative of the float64 JAX fit.
"""

import json
import os

import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu.ops.glm_kernel as jax_ops
from spark_rapids_ml_tpu import (
    GeneralizedLinearRegression as JaxGLR,
    GeneralizedLinearRegressionModel as JaxGLRModel,
)
from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxVectorFrame
from spark_rapids_ml_tpu_torch import (
    GeneralizedLinearRegression,
    GeneralizedLinearRegressionModel,
    LinearRegression,
    LogisticRegression,
)
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
from spark_rapids_ml_tpu_torch.io.persistence import load_model
from spark_rapids_ml_tpu_torch.ops import covariance as cov_ops
from spark_rapids_ml_tpu_torch.ops import fused_gram as fg
from spark_rapids_ml_tpu_torch.ops import glm_kernel as ops

F64_TOL = 1e-8
F32_TOL = 1e-4
ABS_TOL = 1e-5

# every (family, link) of the grid, with tweedie's power links
GRID = [(f, link, 0.0, 1.0) for f, links in ops.FAMILY_LINKS.items()
        for link in links] + [("tweedie", "power", 1.5, 0.0),
                              ("tweedie", "power", 1.5, -0.5)]


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


@pytest.fixture
def small_buckets(monkeypatch):
    """Both packages' streamed sources in buckets of 256 rows (the default
    sizes a bucket to 128 MiB). The bucket changes only the order of
    sums."""
    import spark_rapids_ml_tpu.data.batches as jax_batches
    from spark_rapids_ml_tpu_torch.data import batches

    for module in (batches, jax_batches):
        monkeypatch.setattr(module, "auto_batch_rows", lambda *a, **k: 256)


def make_glm_data(rng, family, n=400, p=4):
    x = rng.normal(size=(n, p)) * 0.5
    beta = rng.normal(size=p) * 0.4
    b = 0.3
    eta = x @ beta + b
    if family == "gaussian":
        y = eta + 0.1 * rng.normal(size=n)
    elif family == "binomial":
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-eta))).astype(float)
    elif family == "poisson":
        y = rng.poisson(np.exp(eta)).astype(float)
    elif family == "gamma":
        shape = 5.0
        y = rng.gamma(shape, np.exp(eta) / shape)
    elif family == "tweedie":
        lam = np.exp(eta)
        counts = rng.poisson(lam)
        y = np.array([rng.gamma(2.0, 0.5 * max(m, 1) / 2.0) if c > 0 else 0.0
                      for c, m in zip(counts, lam)])
    return x, y, beta, b


def _frames(x, y, extra=None):
    cols = {"features": list(x), "label": y}
    if extra:
        cols.update(extra)
    return VectorFrame(dict(cols)), JaxVectorFrame(dict(cols))


def _both(configure, *args, dtype="float64", frames=None, **kwargs):
    """The same estimator configuration fitted by both packages, the port
    at ``dtype``; ``frames`` gives each package a frame of its own."""
    ours_args, ref_args = ((frames[0],), (frames[1],)) if frames \
        else (args, args)
    return (configure(GeneralizedLinearRegression().setDtype(dtype)).fit(
                *ours_args, **kwargs),
            configure(JaxGLR()).fit(*ref_args, **kwargs))


def _rel(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-300))


def _assert_same(ours, ref, dtype="float64"):
    got = np.append(ours.coefficients, ours.intercept)
    want = np.append(ref.coefficients, ref.intercept)
    tol = F64_TOL if dtype == "float64" else F32_TOL
    assert _rel(got, want) <= tol, _rel(got, want)
    if dtype == "float64":
        assert ours.num_iterations_ == ref.num_iterations_
        assert ours.deviance_ == pytest.approx(ref.deviance_, rel=1e-10)
    assert ours.weight_sum_ == ref.weight_sum_


def _family_data(rng, family, link, n=120):
    """Rows and labels inside (family, link)'s domain for one pass."""
    x = rng.normal(size=(n, 4)) * 0.3
    eta = x @ np.array([0.3, -0.2, 0.1, 0.05])
    if family == "binomial":
        y = (rng.random(n) < 0.4).astype(float)
        y[:3] = 0.0   # 0·log 0 terms in the deviance
    elif family == "gaussian":
        y = np.exp(eta) + 0.05 * rng.normal(size=n) + 1.0
    elif family == "poisson":
        y = rng.poisson(np.exp(eta + 0.5)).astype(float)
        y[:3] = 0.0
    elif family == "tweedie":
        y = np.where(rng.random(n) < 0.3, 0.0, rng.gamma(2.0, 0.8, n))
    else:
        y = rng.gamma(5.0, np.exp(eta + 0.5) / 5.0)
    return x, y


def _coef_for(family, link):
    """Coefficients that keep η inside the link's domain."""
    if link in ("inverse",):
        return np.array([0.05, -0.02, 0.01, 0.0]), 0.8
    if link in ("identity", "sqrt", "power"):
        return np.array([0.05, -0.02, 0.01, 0.0]), 1.2
    return np.array([0.3, -0.2, 0.1, 0.05]), 0.2


# -- the IRLS pass of ops/glm_kernel.py ----------------------------------------

@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("family,link,vp,lp", GRID)
def test_irls_pass_matches_jax(rng, family, link, vp, lp, first):
    """Each family/link pair, from mustart and from coefficients: the
    numpy pass equal to JAX's numpy pass, and the torch pass (√W Gram,
    ``torch.special`` probit, 0·log 0 guards) within 1e-12 of JAX's jitted
    one at float64."""
    x, y = _family_data(rng, family, link)
    w = rng.uniform(0.5, 2.0, len(y))
    off = rng.normal(scale=0.05, size=len(y))
    coef, b = _coef_for(family, link)
    kw = dict(family=family, link=link, var_power=vp, link_power=lp,
              use_init_mu=first)
    host = ops.irls_step_math(np, x, y, w, off, coef, b, **kw)
    ref_host = jax_ops.irls_step_math(np, x, y, w, off, coef, b, **kw)
    for got, want in zip(host, ref_host):
        assert np.array_equal(got, want)
    dev = ops.glm_irls_device_step(
        *(torch.as_tensor(a) for a in (x, y, w, off, coef)),
        torch.tensor(b, dtype=torch.float64), **kw)
    ref = jax_ops.glm_irls_device_step(x, y, w, off, coef, b, **kw)
    for name, got, want in zip(ops.GlmStepOut._fields, dev, ref):
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * max(np.abs(want).max(), 1.0),
                                   err_msg=name)


def test_xlogy_keeps_zero_log_zero_at_zero():
    a = torch.tensor([0.0, 0.0, 1.0, 2.0], dtype=torch.float64)
    b = torch.tensor([0.0, 0.5, 0.5, 1e-300], dtype=torch.float64)
    got = ops._xlogy(ops.TORCH_XP, a, b).numpy()
    want = np.asarray(jax_ops._xlogy(np, a.numpy(), b.numpy()))
    assert got[0] == got[1] == 0.0
    np.testing.assert_array_equal(got, want)
    for dtype in (torch.float32, torch.float64):
        y = torch.tensor([0.0, 1.0], dtype=dtype)
        mu = torch.tensor([0.5, 1.0], dtype=dtype)
        dev = ops.deviance_math(ops.TORCH_XP, y, mu, torch.ones_like(y),
                                family="binomial")
        assert torch.isfinite(dev)


def test_float32_clip_bounds_round_as_jax(rng):
    """binomial's clip to [1e-10, 1 − 1e-10]: at float32 the upper bound
    rounds to 1.0 in both packages."""
    import jax.numpy as jnp

    mu = np.array([0.0, 0.5, 1.0, 1.0 - 1e-12], dtype=np.float32)
    clip = ops.family_funcs("binomial")[2]
    ours = clip(ops.TORCH_XP, torch.as_tensor(mu)).numpy()
    ref = np.asarray(jax_ops.family_funcs("binomial")[2](jnp,
                                                         jnp.asarray(mu)))
    assert ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_the_gram_is_the_kernels_full_f32_with_root_weights(rng,
                                                            monkeypatch):
    """XᵀWX goes to the kernel's wrapper as rowmul = √W, precision highest,
    once per IRLS pass and once more for the final deviance at maxIter."""
    calls = []
    real = cov_ops.fused_centered_gram

    def counted(x, mean, rowmul, precision=None):
        calls.append((precision, rowmul.clone()))
        return real(x, mean, rowmul, precision)

    monkeypatch.setattr(cov_ops, "fused_centered_gram", counted)
    x, y, _, _ = make_glm_data(rng, "poisson")
    w = rng.uniform(0.5, 2.0, len(y))
    model = GeneralizedLinearRegression(family="poisson").setMaxIter(
        3).setTol(0.0).setWeightCol("w").fit(VectorFrame(
            {"features": x, "label": y, "w": w}))
    assert model.num_iterations_ == 3
    assert len(calls) == 4
    assert {p for p, _ in calls} == {"highest"}
    # the first pass runs from mustart μ = y + 0.1: W = w·μ (log link)
    np.testing.assert_allclose(calls[0][1].numpy(),
                               np.sqrt(w * (y + 0.1)), rtol=2e-6)


def test_plain_gram_on_root_w_rows_matches_dot_general(rng):
    """At float32 on the CPU, XᵀWX is the kernel's plain version on √W
    rows: within the highest mode's plain bar of JAX's
    ``dot_general(x·W, x, HIGHEST)`` at float32."""
    import jax.numpy as jnp
    from jax import lax

    x = rng.normal(size=(500, 16)).astype(np.float32)
    wi = rng.gamma(2.0, 1.0, 500).astype(np.float32)
    ours = cov_ops.centered_gram(torch.as_tensor(x), None,
                                 torch.sqrt(torch.as_tensor(wi)),
                                 precision="highest").numpy()
    ref = np.asarray(lax.dot_general(
        jnp.asarray(x * wi[:, None]), jnp.asarray(x),
        (((0,), (0,)), ((), ())), precision=lax.Precision.HIGHEST))
    assert ref.dtype == np.float32
    assert np.abs(ours - ref).max() <= fg.PLAIN_RTOL[
        fg.kernel_name("highest")] * np.abs(ref).max()


# -- the cases of tests/test_glm.py -------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gaussian_identity_equals_linear_regression(rng, dtype):
    x, y, _, _ = make_glm_data(rng, "gaussian")
    ours, ref = _both(lambda e: e, x, labels=y, dtype=dtype)
    _assert_same(ours, ref, dtype)
    lin = LinearRegression().setDtype("float64").fit(x, labels=y)
    np.testing.assert_allclose(ours.coefficients, lin.coefficients,
                               atol=ABS_TOL)
    assert ours.intercept == pytest.approx(lin.intercept, abs=ABS_TOL)


def test_binomial_logit_equals_logistic_regression(rng):
    x, y, _, _ = make_glm_data(rng, "binomial")
    ours, ref = _both(lambda e: e.set("family", "binomial").setTol(1e-12),
                      x, labels=y)
    _assert_same(ours, ref)
    log = LogisticRegression().setRegParam(0.0).setTol(1e-12).setDtype(
        "float64").fit(x, labels=y)
    np.testing.assert_allclose(ours.coefficients, log.coefficients,
                               atol=1e-4)
    assert ours.intercept == pytest.approx(log.intercept, abs=1e-4)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("family,power", [("poisson", 1.0), ("gamma", 2.0),
                                          ("tweedie", 1.5)])
def test_log_link_matches_jax(rng, family, power, dtype):
    x, y, _, _ = make_glm_data(rng, family)

    def configure(e):
        e.set("family", family)
        if family == "tweedie":
            e.setVariancePower(power).setLinkPower(0.0)
        elif family == "gamma":
            e.setLink("log")
        return e.setTol(1e-12).setMaxIter(100)

    if family == "tweedie":
        y = y + 0.01
    ours, ref = _both(configure, x, labels=y, dtype=dtype)
    _assert_same(ours, ref, dtype)


@pytest.mark.parametrize("family,link", [
    ("binomial", "probit"), ("binomial", "cloglog"),
    ("poisson", "sqrt"), ("gamma", "inverse"), ("gaussian", "log"),
])
def test_estimating_equations_stationary(rng, family, link):
    """At the IRLS optimum the quasi-score vanishes:
    sum_i w_i (y_i - mu_i) / (V(mu_i) g'(mu_i)) * [x_i, 1] = 0; and the
    port's fit equals JAX's."""
    x, y, _, _ = make_glm_data(rng, family)
    if family == "gaussian" and link == "log":
        y = np.exp(0.2 * x @ np.ones(x.shape[1]) + 0.1) \
            + 0.05 * rng.normal(size=len(y))
    ours, ref = _both(lambda e: e.set("family", family).setLink(link)
                      .setTol(1e-13).setMaxIter(200), x, labels=y)
    _assert_same(ours, ref)
    variance, _, clip_mu, _ = ops.family_funcs(family, 0.0)
    g, ginv, gprime = ops.link_funcs(link)
    eta = x @ ours.coefficients + ours.intercept
    mu = clip_mu(np, np.asarray(ginv(np, eta)))
    score_w = (y - mu) / (variance(np, mu) * np.asarray(gprime(np, mu)))
    score = np.concatenate([x.T @ score_w, [score_w.sum()]])
    scale = max(1.0, float(np.abs(y).sum()))
    assert np.max(np.abs(score)) / scale < 1e-6


def test_host_and_device_paths_agree(rng):
    x, y, _, _ = make_glm_data(rng, "poisson")
    dev = GeneralizedLinearRegression(family="poisson").setDtype(
        "float64").fit(x, labels=y)
    host = GeneralizedLinearRegression(family="poisson") \
        .setUseXlaDot(False).fit(x, labels=y)
    np.testing.assert_allclose(dev.coefficients, host.coefficients,
                               atol=1e-8)
    assert dev.intercept == pytest.approx(host.intercept, abs=1e-8)
    ref = JaxGLR(family="poisson").setUseXlaDot(False).fit(x, labels=y)
    np.testing.assert_array_equal(host.coefficients, ref.coefficients)
    assert host.intercept == ref.intercept
    assert host.deviance_ == ref.deviance_
    assert set(host.fit_timings_) == set(ref.fit_timings_)
    assert set(dev.fit_timings_) == set(
        JaxGLR(family="poisson").fit(x, labels=y).fit_timings_)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_integer_weights_equal_row_duplication(rng, dtype):
    x, y, _, _ = make_glm_data(rng, "poisson", n=120)
    w = rng.integers(1, 4, size=len(y)).astype(float)
    ours, ref = _both(lambda e: e.set("family", "poisson").setWeightCol(
        "w").setTol(1e-12), dtype=dtype, frames=_frames(x, y, {"w": w}))
    _assert_same(ours, ref, dtype)
    xr = np.repeat(x, w.astype(int), axis=0)
    yr = np.repeat(y, w.astype(int))
    dup = GeneralizedLinearRegression(family="poisson").setTol(
        1e-12).setDtype("float64").fit(xr, labels=yr)
    np.testing.assert_allclose(ours.coefficients, dup.coefficients,
                               atol=1e-6 if dtype == "float64" else F32_TOL)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_offset_acts_as_fixed_exposure(rng, dtype):
    """Poisson with log link: offset = log(exposure); the fit with the
    offset recovers the rate coefficients, and transform applies it."""
    x, _, beta, b = make_glm_data(rng, "poisson", n=2000)
    exposure = rng.uniform(0.5, 4.0, size=x.shape[0])
    y = rng.poisson(exposure * np.exp(x @ beta + b)).astype(float)
    frames = _frames(x, y, {"off": np.log(exposure)})
    ours, ref = _both(lambda e: e.set("family", "poisson").setOffsetCol(
        "off").setTol(1e-12), dtype=dtype, frames=frames)
    _assert_same(ours, ref, dtype)
    np.testing.assert_allclose(ours.coefficients, beta, atol=0.1)
    pred = np.asarray(ours.transform(frames[0]).column("prediction"))
    eta = x @ ours.coefficients + ours.intercept + np.log(exposure)
    np.testing.assert_allclose(pred, np.exp(eta), rtol=1e-10)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_streamed_fit_matches_in_memory(rng, dtype, small_buckets):
    x, y, _, _ = make_glm_data(rng, "poisson", n=600)

    def chunks():
        for i in range(0, len(y), 150):
            yield (x[i:i + 150], y[i:i + 150])

    ours, ref = _both(lambda e: e.set("family", "poisson").setTol(1e-12),
                      chunks, dtype=dtype)
    _assert_same(ours, ref, dtype)
    memory = GeneralizedLinearRegression(family="poisson").setTol(
        1e-12).setDtype("float64").fit(x, labels=y)
    np.testing.assert_allclose(ours.coefficients, memory.coefficients,
                               atol=1e-7 if dtype == "float64" else F32_TOL)


def test_streamed_host_path_matches_jax(rng, small_buckets):
    x, y, _, _ = make_glm_data(rng, "gamma", n=500)

    def chunks():
        for i in range(0, len(y), 125):
            yield (x[i:i + 125], y[i:i + 125])

    ours, ref = _both(lambda e: e.set("family", "gamma").setLink(
        "log").setUseXlaDot(False), chunks)
    np.testing.assert_allclose(ours.coefficients, ref.coefficients,
                               rtol=1e-12)
    assert ours.deviance_ == pytest.approx(ref.deviance_, rel=1e-12)


def test_streamed_launches_one_gram_per_bucket_and_pass(rng, monkeypatch,
                                                        small_buckets):
    """The streamed device fit: one kernel launch per bucket per pass, and
    one pass more for the final deviance when maxIter is reached."""
    calls = []
    real = cov_ops.fused_centered_gram

    def counted(x, mean, rowmul, precision=None):
        calls.append(x.shape[0])
        return real(x, mean, rowmul, precision)

    monkeypatch.setattr(cov_ops, "fused_centered_gram", counted)
    x, y, _, _ = make_glm_data(rng, "poisson", n=600)
    x, y = x.astype(np.float32), y.astype(np.float32)
    model = GeneralizedLinearRegression(family="poisson").setMaxIter(
        2).setTol(0.0).fit(lambda: iter([(x[:300], y[:300]),
                                          (x[300:], y[300:])]))
    assert model.num_iterations_ == 2
    # 600 rows in buckets of 256: 3 buckets, 3 passes
    assert calls == [256, 256, 88] * 3


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_link_prediction_col_and_transform(rng, dtype):
    x, y, _, _ = make_glm_data(rng, "gamma")
    ours, ref = _both(lambda e: e.set("family", "gamma").setLink(
        "log").setLinkPredictionCol("linkPred"), x, labels=y, dtype=dtype)
    frames = _frames(x, y)
    out = ours.transform(frames[0])
    eta = np.asarray(out.column("linkPred"))
    mu = np.asarray(out.column("prediction"))
    np.testing.assert_allclose(mu, np.exp(eta), rtol=1e-10)
    jmu = np.asarray(ref.transform(frames[1]).column("prediction"))
    np.testing.assert_allclose(mu, jmu, rtol=F64_TOL if dtype == "float64"
                               else F32_TOL)


def test_evaluate_summary(rng):
    x, y, _, _ = make_glm_data(rng, "poisson")
    ours, ref = _both(lambda e: e.set("family", "poisson"), x, labels=y)
    frames = _frames(x, y)
    s = ours.evaluate(frames[0])
    assert s["deviance"] <= s["nullDeviance"]
    assert s["dispersion"] == 1.0  # poisson fixes dispersion at 1
    assert s["numIterations"] >= 1
    want = ref.evaluate(frames[1])
    assert set(s) == set(want)
    for key in s:
        assert s[key] == pytest.approx(want[key], rel=1e-9), key
    g, jg = _both(lambda e: e.set("family", "gaussian"), x, labels=y)
    sg = g.evaluate(frames[0])
    assert sg["dispersion"] > 0.0
    assert sg["dispersion"] == pytest.approx(
        jg.evaluate(frames[1])["dispersion"], rel=1e-9)


def test_regparam_shrinks_coefficients(rng):
    x, y, _, _ = make_glm_data(rng, "poisson")
    free = GeneralizedLinearRegression(family="poisson").setDtype(
        "float64").fit(x, labels=y)
    reg, ref = _both(lambda e: e.set("family", "poisson").setRegParam(10.0),
                     x, labels=y)
    _assert_same(reg, ref)
    assert np.linalg.norm(reg.coefficients) < np.linalg.norm(
        free.coefficients)


@pytest.mark.parametrize("cls", [GeneralizedLinearRegression, JaxGLR])
def test_family_link_grid_validation(rng, cls):
    x, y, _, _ = make_glm_data(rng, "poisson")
    with pytest.raises(ValueError, match="not supported"):
        cls(family="poisson").setLink("logit").fit(x, labels=y)
    with pytest.raises(ValueError, match="non-negative"):
        cls(family="poisson").fit(x, labels=y - 10)
    with pytest.raises(ValueError, match="positive"):
        cls(family="gamma").setLink("log").fit(x, labels=np.zeros_like(y))
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        cls(family="binomial").fit(x, labels=y + 5)


@pytest.mark.parametrize("use_xla", [True, False])
def test_no_intercept_inverse_link_is_finite(rng, use_xla):
    """eta=0 start would put inverse-link mu at a pole; the mustart-style
    first iteration must keep fitIntercept=False fits finite."""
    x, y, _, _ = make_glm_data(rng, "gamma")
    ours, ref = _both(lambda e: e.set("family", "gamma").setFitIntercept(
        False).setUseXlaDot(use_xla), x, labels=y)
    assert np.isfinite(ours.coefficients).all()
    assert np.isfinite(ours.deviance_)
    assert ours.intercept == 0.0
    _assert_same(ours, ref)


def test_streamed_inverse_link_is_finite(rng, small_buckets):
    x, y, _, _ = make_glm_data(rng, "gamma")

    def chunks():
        for i in range(0, len(y), 100):
            yield (x[i:i + 100], y[i:i + 100])

    ours, ref = _both(lambda e: e.set("family", "gamma").setTol(1e-12),
                      chunks)
    assert np.isfinite(ours.coefficients).all()
    _assert_same(ours, ref)
    memory = GeneralizedLinearRegression(family="gamma").setTol(
        1e-12).setDtype("float64").fit(x, labels=y)
    np.testing.assert_allclose(ours.coefficients, memory.coefficients,
                               atol=1e-7)


@pytest.mark.parametrize("cls", [GeneralizedLinearRegression, JaxGLR])
def test_one_shot_generator_rejected_up_front(rng, cls):
    x, y, _, _ = make_glm_data(rng, "poisson")
    gen = ((x[i:i + 100], y[i:i + 100]) for i in range(0, len(y), 100))
    with pytest.raises(ValueError, match="one pass per IRLS"):
        cls(family="poisson").fit(gen)
    with pytest.raises(ValueError, match="offsetCol"):
        cls(family="poisson").setOffsetCol("o").fit(
            lambda: iter([(x, y)]))


@pytest.mark.parametrize("cls,frame_cls", [
    (GeneralizedLinearRegression, VectorFrame), (JaxGLR, JaxVectorFrame)])
def test_transform_missing_offset_column_raises(rng, cls, frame_cls):
    x, _, beta, b = make_glm_data(rng, "poisson", n=200)
    off = rng.uniform(0.1, 1.0, size=200)
    y = rng.poisson(np.exp(x @ beta + b + off)).astype(float)
    model = cls(family="poisson").setOffsetCol("off").fit(
        frame_cls({"features": list(x), "label": y, "off": off}))
    with pytest.raises(ValueError, match="offsetCol"):
        model.transform(frame_cls({"features": list(x), "label": y}))


def test_metadata_omits_unset_link_sentinels(rng, tmp_path):
    """'' link / null linkPower would break a real Spark reader; unset
    means canonical default, so they must not appear in the metadata,
    which equals the JAX writer's but for the timestamp and class path."""
    x, y, _, _ = make_glm_data(rng, "poisson")
    ours, ref = _both(lambda e: e.set("family", "poisson"), x, labels=y)
    metas = []
    for model, name in ((ours, "port"), (ref, "jax")):
        path = str(tmp_path / name)
        model.save(path)
        with open(os.path.join(path, "metadata", "part-00000")) as f:
            metas.append(json.loads(f.readline()))
    meta = metas[0]
    merged = {**meta["paramMap"], **meta["tpuParamMap"]}
    assert "link" not in merged
    assert "linkPower" not in merged
    jmeta = metas[1]
    assert meta["class"] == jmeta["class"]
    assert meta["paramMap"] == jmeta["paramMap"]
    assert {k: v for k, v in meta["tpuParamMap"].items() if k != "dtype"} \
        == {k: v for k, v in jmeta["tpuParamMap"].items() if k != "dtype"}
    assert set(meta["extra"]) == set(jmeta["extra"])
    loaded = GeneralizedLinearRegressionModel.load(str(tmp_path / "port"))
    assert loaded.get_or_default("link") == ""
    assert loaded.get_or_default("linkPower") is None


def test_tweedie_default_link_power():
    """family=tweedie defaults linkPower to 1 - variancePower (Spark)."""
    for cls in (GeneralizedLinearRegression, JaxGLR):
        est = cls(family="tweedie").setVariancePower(1.5)
        fam, link, vp, lp = est._resolved_family_link()
        assert (fam, link, vp, lp) == ("tweedie", "power", 1.5, -0.5)


@pytest.mark.parametrize("saver,loader", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_persistence_roundtrip(rng, tmp_path, saver, loader):
    x, y, _, _ = make_glm_data(rng, "gamma")
    est = {"port": GeneralizedLinearRegression, "jax": JaxGLR}[saver]
    model = est(family="gamma").setLink("log").fit(x, labels=y)
    path = str(tmp_path / "glm_model")
    model.save(path)
    cls = {"port": GeneralizedLinearRegressionModel,
           "jax": JaxGLRModel}[loader]
    loaded = cls.load(path)
    np.testing.assert_array_equal(loaded.coefficients, model.coefficients)
    assert loaded.intercept == model.intercept
    assert loaded.get_or_default("family") == "gamma"
    assert loaded.get_or_default("link") == "log"
    assert loaded.num_iterations_ == model.num_iterations_
    assert loaded.deviance_ == pytest.approx(model.deviance_)
    assert loaded.uid == model.uid
    frames = _frames(x, y)
    frame_of = {"port": frames[0], "jax": frames[1]}
    out_a = model.transform(frame_of[saver]).column("prediction")
    out_b = loaded.transform(frame_of[loader]).column("prediction")
    np.testing.assert_array_equal(np.asarray(out_a), np.asarray(out_b))
    assert type(load_model(path)).__name__ == \
        "GeneralizedLinearRegressionModel"


@pytest.mark.parametrize("saver,loader", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_estimator_persistence_roundtrip(tmp_path, saver, loader):
    est = {"port": GeneralizedLinearRegression, "jax": JaxGLR}[saver](
        family="tweedie").setVariancePower(1.3).setMaxIter(7)
    path = str(tmp_path / "glm_est")
    est.save(path)
    loaded = {"port": GeneralizedLinearRegression, "jax": JaxGLR}[
        loader].load(path)
    assert loaded.get_or_default("family") == "tweedie"
    assert loaded.get_or_default("variancePower") == 1.3
    assert loaded.getMaxIter() == 7


def test_fit_report_and_device_request(rng, monkeypatch):
    x, y, _, _ = make_glm_data(rng, "poisson")
    model = GeneralizedLinearRegression(family="poisson").fit(x, labels=y)
    assert model.fit_report_.algo == "glm"
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GeneralizedLinearRegression(family="poisson").fit(x, labels=y)
    host = GeneralizedLinearRegression(family="poisson").setUseXlaDot(
        False).fit(x, labels=y)
    assert host.coefficients.shape == (4,)


@pytest.fixture
def one_rank_gloo(tmp_path):
    """A one-rank gloo world in this process, torn down after the test."""
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.parallel.mesh import data_mesh

    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        yield data_mesh(1)
    finally:
        dist.destroy_process_group()


def _nan_offset_rows(rng):
    x, _, beta, b = make_glm_data(rng, "poisson", n=200)
    offset = rng.normal(scale=0.1, size=x.shape[0])
    y = rng.poisson(np.exp(x @ beta + b + offset)).astype(float)
    offset[17] = np.nan
    return x, y, offset


def test_nan_offset_raises_where_jax_gives_nan_coefficients(rng):
    """A deliberate difference: the JAX fit takes a non-finite offset
    unchecked and returns NaN coefficients; the port's local fit raises,
    as it does for a NaN weight."""
    x, y, offset = _nan_offset_rows(rng)
    frames = _frames(x, y, {"off": offset})
    ref = JaxGLR().set("family", "poisson").setOffsetCol("off").fit(frames[1])
    assert np.isnan(np.append(ref.coefficients, ref.intercept)).all()
    for dtype in ("float64", "float32"):
        est = GeneralizedLinearRegression().setDtype(dtype).set(
            "family", "poisson").setOffsetCol("off")
        with pytest.raises(ValueError, match="offset must be finite"):
            est.fit(frames[0])
    host = GeneralizedLinearRegression().set("family", "poisson") \
        .setOffsetCol("off").setUseXlaDot(False)
    with pytest.raises(ValueError, match="offset must be finite"):
        host.fit(frames[0])


def test_nan_offset_raises_in_the_distributed_fit(rng, one_rank_gloo):
    """The same rows through both packages' ``distributed_glm_fit``: JAX's
    NaN coefficients, the port's ``ValueError`` (one gloo rank)."""
    from spark_rapids_ml_tpu.parallel.distributed_glm import (
        distributed_glm_fit as jax_distributed_glm_fit,
    )
    from spark_rapids_ml_tpu.parallel.mesh import data_mesh as jax_data_mesh
    from spark_rapids_ml_tpu_torch.parallel.distributed_glm import (
        distributed_glm_fit,
    )

    x, y, offset = _nan_offset_rows(rng)
    ref = jax_distributed_glm_fit(x, y, jax_data_mesh(1), family="poisson",
                                  offset=offset)
    assert np.isnan(np.append(ref.coefficients, ref.intercept)).all()
    with pytest.raises(ValueError, match="offset must be finite"):
        distributed_glm_fit(x, y, one_rank_gloo, family="poisson",
                            offset=offset)
    # the finite offset still fits
    offset[17] = 0.0
    model = distributed_glm_fit(x, y, one_rank_gloo, family="poisson",
                                offset=offset)
    assert np.isfinite(model.coefficients).all()
