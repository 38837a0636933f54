"""LogisticRegression in the port against the JAX package's, on the same numpy
inputs.

The cases of tests/test_logistic_regression.py, each run through both
packages (the JAX file holds the JAX fit against sklearn; here the port is
held against the JAX fit), plus the operations of ``ops/logreg_kernel.py``
one by one: the √s Hessian against JAX ``_grad_hess``'s ``dot_general``,
the multinomial ``h_raw`` layout element by element, the kernel launches
per Newton iteration, results under ``set_float32_matmul_precision
("high")`` and the serving bodies. The JAX suite runs with x64
(tests/conftest.py), so its 'auto' dtype is float64; the port's is float32,
so every comparison names its dtype:

* float64 in both: 1e-8 relative (coefficients, intercepts, probabilities)
  and the same iteration count;
* float32 in the port (on the CPU the Gram kernel's plain version at
  highest): within 1e-4 relative of the float64 JAX fit. Float32 Newton
  stalls above the default tol 1e-8 and runs to maxIter, as JAX's does.

Multinomial coefficients carry a gauge (a uniform shift of every class's
intercept and, unregularized, of the coefficients) pinned by a
dtype-scaled ridge, 1.5e-8 of the Hessian's scale in float64 and 3.45e-4
in float32, so a float32 multinomial fit is compared by probabilities and
labels, not by coefficients.
"""

import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu.ops.logreg_kernel as jax_ops
from spark_rapids_ml_tpu import LogisticRegression as JaxLogisticRegression
from spark_rapids_ml_tpu import (
    LogisticRegressionModel as JaxLogisticRegressionModel,
)
from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxVectorFrame
from spark_rapids_ml_tpu.ops.quantize import (
    quantize_symmetric_host as jax_quantize_host,
)
from spark_rapids_ml_tpu_torch import (
    LogisticRegression,
    LogisticRegressionModel,
)
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
from spark_rapids_ml_tpu_torch.io.persistence import load_model
from spark_rapids_ml_tpu_torch.models import logistic_regression as lr_module
from spark_rapids_ml_tpu_torch.ops import covariance as cov_ops
from spark_rapids_ml_tpu_torch.ops import logreg_kernel as ops
from spark_rapids_ml_tpu_torch.utils.numeric import sigmoid

F64_TOL = 1e-8
F32_TOL = 1e-4
# Newton's tol for the float32 fits: their steps stall near 1e-7, so at
# the default 1e-8 every one runs all maxIter iterations (as JAX's do,
# which ``test_logreg_matches_jax`` keeps); 1e-6 stops them converged
F32_STOP = 1e-6


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


@pytest.fixture
def data(rng):
    n = 2000
    x = rng.normal(size=(n, 8))
    w_true = np.array([1.5, -2.0, 0.7, 0.0, 3.0, -0.3, 1.0, -1.2])
    p = 1.0 / (1.0 + np.exp(-(x @ w_true + 0.4)))
    y = (rng.random(n) < p).astype(np.float64)
    return x, y


def _blobs(rng, n, d, centres_at, labels=None):
    x = np.concatenate([rng.normal(loc=c, size=(n // len(centres_at), d))
                        for c in centres_at])
    y = np.repeat(np.arange(len(centres_at), dtype=np.float64)
                  if labels is None else np.asarray(labels, np.float64),
                  n // len(centres_at))
    return x, y


def _both(configure, *args, dtype="float64", dataset_pair=None, **kwargs):
    """The same estimator configuration fitted by both packages; the port
    at ``dtype``, and at float32 both at the ``F32_STOP`` tol.
    ``dataset_pair`` gives each package a frame of its own."""
    if dtype == "float32":
        configure = _stopping(configure)
    ours_args, ref_args = ((dataset_pair[0],), (dataset_pair[1],)) \
        if dataset_pair else (args, args)
    return (configure(LogisticRegression().setDtype(dtype)).fit(*ours_args,
                                                                **kwargs),
            configure(JaxLogisticRegression()).fit(*ref_args, **kwargs))


def _stopping(configure):
    return lambda e: configure(e).setTol(F32_STOP)


def _rel(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-300))


def _assert_binary_same(ours, ref, tol, same_iters=True):
    got = np.append(ours.coefficients, ours.intercept)
    want = np.append(ref.coefficients, ref.intercept)
    assert _rel(got, want) <= tol, _rel(got, want)
    if same_iters:
        assert ours.n_iter_ == ref.n_iter_


def _assert_multinomial_same(ours, ref, x, tol):
    np.testing.assert_array_equal(ours.classes_, ref.classes_)
    np.testing.assert_allclose(ours.predict_proba(x), ref.predict_proba(x),
                               rtol=0, atol=tol)
    if tol <= F64_TOL:
        # intercepts up to their uniform shift, the gauge direction only
        # the ridge pins
        got = np.column_stack([ours.coefficient_matrix,
                               ours.intercept_vector
                               - ours.intercept_vector.mean()])
        want = np.column_stack([ref.coefficient_matrix,
                                ref.intercept_vector
                                - ref.intercept_vector.mean()])
        assert _rel(got, want) <= tol
        assert ours.n_iter_ == ref.n_iter_


def _dtype_tol(dtype):
    return F64_TOL if dtype == "float64" else F32_TOL


@pytest.fixture
def small_buckets(monkeypatch):
    """Both packages' streamed sources in buckets of 256 rows: the default
    sizes a bucket to 128 MiB, millions of rows at these widths, nearly
    all zero padding here. The bucket changes only the order of sums."""
    import spark_rapids_ml_tpu.data.batches as jax_batches
    from spark_rapids_ml_tpu_torch.data import batches

    for module in (batches, jax_batches):
        monkeypatch.setattr(module, "auto_batch_rows", lambda *a, **k: 256)


# -- the operations of ops/logreg_kernel.py ---------------------------------

@pytest.mark.parametrize("mask", ["none", "rows", "weights"])
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_grad_hess_matches_jax(rng, mask, fit_intercept):
    """The √s Hessian (centered_gram with rowmul √s) against JAX
    ``_grad_hess``'s ``dot_general`` of x and x·s, and the gradient."""
    x = rng.normal(size=(60, 5))
    y = (rng.random(60) > 0.5).astype(np.float64)
    m = {"none": np.ones(60),
         "rows": (rng.random(60) > 0.3).astype(np.float64),
         "weights": rng.uniform(0.5, 2.0, 60)}[mask]
    w = rng.normal(size=6) * 0.3
    ours = ops._grad_hess(torch.as_tensor(w), torch.as_tensor(x),
                          torch.as_tensor(y), torch.as_tensor(m), 0.1,
                          fit_intercept, lambda t: t)
    ref = jax_ops._grad_hess(w, x, y, m, 0.1, fit_intercept, lambda t: t)
    for got, want in zip(ours, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-13)


def test_the_hessian_is_the_kernels_full_f32_with_root_weights(rng,
                                                               monkeypatch):
    """Xᵀdiag(s)X goes to the kernel's wrapper as rowmul = √s with s =
    p(1 − p)·w, precision highest, once per Newton iteration."""
    calls = []
    real = cov_ops.fused_centered_gram

    def counted(x, mean, rowmul, precision=None):
        calls.append((precision, rowmul.clone()))
        return real(x, mean, rowmul, precision)

    monkeypatch.setattr(cov_ops, "fused_centered_gram", counted)
    x = rng.normal(size=(40, 4)).astype(np.float32)
    y = (rng.random(40) > 0.5).astype(np.float32)
    wts = rng.uniform(0.5, 2.0, 40).astype(np.float32)
    result = ops.logreg_fit_kernel(torch.as_tensor(x), torch.as_tensor(y),
                                   torch.as_tensor(wts), reg_param=0.1,
                                   max_iter=3, tol=0.0)
    assert int(result.n_iter) == 3 and len(calls) == 3
    assert {precision for precision, _ in calls} == {"highest"}
    # the first iteration runs at w = 0: p = 1/2, s = w/4
    np.testing.assert_allclose(calls[0][1].numpy(), np.sqrt(wts / 4),
                               rtol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_multinomial_raw_stats_layout_matches_jax(rng, masked):
    """``h_raw`` element by element, in JAX's [k·(d+1)+i, l·(d+1)+j]
    layout, from K(K+1)/2 ± Grams and the column-sum border."""
    k, d = 4, 5
    x = rng.normal(size=(70, d))
    y_oh = np.eye(k)[rng.integers(0, k, 70)]
    valid = (rng.random(70) > 0.2).astype(np.float64) if masked \
        else np.ones(70)
    wb = rng.normal(size=(k, d + 1)) * 0.4
    ours = ops.multinomial_raw_stats(torch.as_tensor(wb), torch.as_tensor(x),
                                     torch.as_tensor(y_oh),
                                     torch.as_tensor(valid))
    ref = jax_ops.multinomial_raw_stats(wb, x, y_oh, valid)
    for got, want in zip(ours, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_assemble_multinomial_system_matches_jax(rng, fit_intercept):
    k, d = 3, 4
    gxa = rng.normal(size=(k, d + 1))
    a = rng.normal(size=(k * (d + 1), k * (d + 1)))
    h_raw = a @ a.T
    wb = rng.normal(size=(k, d + 1))
    ours = ops.assemble_multinomial_system(
        torch.as_tensor(gxa), torch.as_tensor(h_raw), 37.0,
        torch.as_tensor(wb), 0.2, fit_intercept)
    ref = jax_ops.assemble_multinomial_system(gxa, h_raw, 37.0, wb, 0.2,
                                              fit_intercept)
    for got, want in zip(ours, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-13, atol=1e-15)


def test_multinomial_launches_k_k1_half_grams_per_iteration(rng,
                                                            monkeypatch):
    """K(K+1)/2 kernel calls per iteration at highest, each with a
    non-negative row multiplier (the ± sign lives outside the Gram)."""
    calls = []
    real = cov_ops.fused_centered_gram

    def counted(x, mean, rowmul, precision=None):
        calls.append((precision, float(rowmul.min())))
        return real(x, mean, rowmul, precision)

    monkeypatch.setattr(cov_ops, "fused_centered_gram", counted)
    k = 4
    x, y = _blobs(rng, 200, 3, (0.0, 2.0, 4.0, 6.0))
    result = ops.multinomial_fit_kernel(
        torch.as_tensor(x, dtype=torch.float32),
        torch.as_tensor(np.eye(k)[y.astype(int)], dtype=torch.float32),
        reg_param=0.1, max_iter=2, tol=0.0, n_classes=k)
    assert int(result.n_iter) == 2
    assert len(calls) == 2 * k * (k + 1) // 2
    assert all(p == "highest" and lo >= 0.0 for p, lo in calls)


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("reg", [0.0, 0.1])
def test_fit_kernels_match_jax(rng, fit_intercept, reg):
    x = rng.normal(size=(300, 6))
    y = (rng.random(300) < sigmoid(x @ rng.normal(size=6) + 0.3)).astype(
        np.float64)
    ours = ops.logreg_fit_kernel(torch.as_tensor(x), torch.as_tensor(y),
                                 reg_param=reg, fit_intercept=fit_intercept)
    ref = jax_ops.logreg_fit_kernel(x, y, reg_param=reg,
                                    fit_intercept=fit_intercept)
    np.testing.assert_allclose(ours.coefficients.numpy(),
                               np.asarray(ref.coefficients), rtol=1e-10,
                               atol=1e-12)
    assert float(ours.intercept) == pytest.approx(float(ref.intercept),
                                                  abs=1e-10)
    assert int(ours.n_iter) == int(ref.n_iter)
    assert bool(ours.converged) == bool(ref.converged)


def test_float32_newton_stalls_above_the_default_tol_as_jax_does(rng):
    """At float32 the steps stop near eps·|w|, above the default tol 1e-8:
    both packages' kernels run all max_iter iterations and report no
    convergence, and agree within the float32 bar."""
    x = rng.normal(size=(300, 6)).astype(np.float32)
    y = (rng.random(300) < sigmoid(x @ rng.normal(size=6))).astype(
        np.float32)
    ours = ops.logreg_fit_kernel(torch.as_tensor(x), torch.as_tensor(y),
                                 reg_param=0.01, max_iter=40)
    ref = jax_ops.logreg_fit_kernel(x, y, reg_param=0.01, max_iter=40)
    assert np.asarray(ref.coefficients).dtype == np.float32
    assert int(ours.n_iter) == int(ref.n_iter) == 40
    assert bool(ours.converged) is bool(ref.converged) is False
    np.testing.assert_allclose(ours.coefficients.numpy(),
                               np.asarray(ref.coefficients), atol=F32_TOL)


def test_max_iter_zero_returns_zeros_as_jax(rng):
    x = rng.normal(size=(30, 3))
    y = (rng.random(30) > 0.5).astype(np.float64)
    ours = ops.logreg_fit_kernel(torch.as_tensor(x), torch.as_tensor(y),
                                 max_iter=0)
    ref = jax_ops.logreg_fit_kernel(x, y, max_iter=0)
    assert int(ours.n_iter) == int(ref.n_iter) == 0
    assert bool(ours.converged) == bool(ref.converged) is False
    assert not ours.coefficients.numpy().any()
    mn = ops.multinomial_fit_kernel(torch.as_tensor(x),
                                    torch.as_tensor(np.eye(3)[:30 % 3].repeat(
                                        10, axis=0)),
                                    max_iter=0, n_classes=3)
    assert int(mn.n_iter) == 0 and not mn.coefficients.numpy().any()


def test_float32_fits_are_unchanged_under_tf32_high(rng):
    """The float32 logits and gradients take no TF32 shortcut: a fit and
    the serving bodies give the same bits with the float32 matmul
    precision at 'high' as at 'highest'."""
    x = rng.normal(size=(200, 6)).astype(np.float32)
    y = (rng.random(200) > 0.5).astype(np.float32)
    k = 3
    y_oh = np.eye(k, dtype=np.float32)[rng.integers(0, k, 200)]

    def run():
        b = ops.logreg_fit_kernel(torch.as_tensor(x), torch.as_tensor(y),
                                  reg_param=0.1, max_iter=5)
        m = ops.multinomial_fit_kernel(torch.as_tensor(x),
                                       torch.as_tensor(y_oh), reg_param=0.1,
                                       max_iter=5, n_classes=k)
        p = ops._predict_sigmoid(torch.as_tensor(x), b.coefficients,
                                 b.intercept)
        return [b.coefficients, m.coefficients, p]

    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        want = run()
        torch.set_float32_matmul_precision("high")
        got = run()
    finally:
        torch.set_float32_matmul_precision(before)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -- the serving bodies -------------------------------------------------------

def _serving_case(rng, rows=45, d=13):
    x = rng.normal(size=(rows, d)).astype(np.float32)
    coef = rng.normal(size=d)
    return x, coef, 0.37


def test_native_body_matches_jax(rng):
    x, coef, b = _serving_case(rng)
    ours = ops._predict_sigmoid(torch.as_tensor(x),
                                torch.as_tensor(coef, dtype=torch.float32),
                                torch.tensor(b, dtype=torch.float32))
    ref = jax_ops._predict_sigmoid(x, coef.astype(np.float32),
                                   np.float32(b))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_bf16_body_within_1e6_of_jax(rng):
    import jax.numpy as jnp

    x, coef, b = _serving_case(rng)
    ours = ops._predict_bf16(torch.as_tensor(x),
                             torch.as_tensor(coef).to(torch.bfloat16),
                             torch.tensor(b, dtype=torch.float32))
    ref = jax_ops._predict_bf16(jnp.asarray(x),
                                jnp.asarray(coef, dtype=jnp.bfloat16),
                                jnp.asarray(b, dtype=jnp.float32))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("rows,d", [(45, 13), (5, 16), (64, 7)])
def test_int8_body_bit_equal_to_jax(rng, monkeypatch, rows, d):
    """The int8 logit (int32 accumulation, ``acc * (sx * scale)``) equals
    the JAX body's bit for bit: both sigmoids are replaced by the identity
    to read it. The probabilities then agree within one float32 ulp (the
    two libraries' float32 exp differ in the last bit)."""
    import jax
    import jax.numpy as jnp

    x, coef, b = _serving_case(rng, rows, d)
    q, scale = jax_quantize_host(coef)
    padded = ops.pad_int8_coefficients(q)
    assert padded.shape[0] % 8 == 0 and padded.shape[1] == 8
    args = (torch.as_tensor(padded), torch.tensor(scale),
            torch.tensor(b, dtype=torch.float32))
    jargs = (jnp.asarray(q), jnp.asarray(scale), jnp.asarray(b, jnp.float32))
    prob = ops._predict_int8(torch.as_tensor(x), *args)
    jprob = np.asarray(jax_ops._predict_int8(jnp.asarray(x), *jargs))
    monkeypatch.setattr(torch, "sigmoid", lambda z: z)
    monkeypatch.setattr(jax.nn, "sigmoid", lambda z: z)
    logit = ops._predict_int8(torch.as_tensor(x), *args)
    jlogit = np.asarray(jax_ops._predict_int8(jnp.asarray(x), *jargs))
    assert logit.dtype == torch.float32 and jlogit.dtype == np.float32
    np.testing.assert_array_equal(logit.numpy(), jlogit)
    np.testing.assert_allclose(prob.numpy(), jprob, rtol=0,
                               atol=np.finfo(np.float32).eps)


def test_serving_program_and_stage(data):
    """The model's serving program on the CPU returns float64
    probabilities equal to ``predict_proba``; the stage hook is terminal;
    multinomial and host-path models decline both."""
    x, y = data
    model = LogisticRegression().setRegParam(0.01).setTol(F32_STOP).fit(x, y)
    prog = model.serving_transform_program()
    assert prog is not None and prog.algo == "logistic_regression"
    out = prog.fetch(prog.run(prog.put(x[:50])))
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, model.predict_proba(x[:50]))
    stage = model.serving_stage()
    assert stage.terminal and stage.fetch_dtype == np.float64
    for precision, bar in (("bf16", 0.02), ("int8", 0.05)):
        reduced = model.serving_transform_program(precision)
        got = reduced.fetch(reduced.run(reduced.put(x[:50])))
        assert np.max(np.abs(got - out)) <= bar
    assert model.copy({"useXlaDot": False}).serving_stage() is None
    mn = LogisticRegression().setTol(F32_STOP).fit(
        *_blobs(np.random.default_rng(1), 90, 2, (0.0, 3.0, 6.0)))
    assert mn.serving_stage() is None
    assert mn.serving_transform_program() is None


# -- the cases of tests/test_logistic_regression.py ---------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("use_xla", [True, False])
@pytest.mark.parametrize("reg_param", [0.01, 0.1])
def test_logreg_matches_jax(data, use_xla, reg_param, dtype):
    x, y = data
    ours, ref = _both(lambda e: e.setRegParam(reg_param).setUseXlaDot(
        use_xla), x, y, dtype=dtype)
    # the host route is numpy float64 whatever the dtype
    tol = _dtype_tol(dtype) if use_xla else 1e-12
    _assert_binary_same(ours, ref, tol, same_iters=tol <= F64_TOL)
    assert set(ours.fit_timings_) == set(ref.fit_timings_)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_logreg_no_intercept(data, dtype):
    x, y = data
    ours, ref = _both(lambda e: e.setRegParam(0.05).setFitIntercept(False),
                      x, y, dtype=dtype)
    _assert_binary_same(ours, ref, _dtype_tol(dtype),
                        same_iters=dtype == "float64")
    assert ours.intercept == ref.intercept == 0.0


def test_logreg_transform_and_evaluate(data):
    x, y = data
    ours, ref = _both(lambda e: e.setRegParam(0.01), x, y)
    out = ours.transform(x)
    proba = np.asarray(out.column("probability"))
    pred = np.asarray(out.column("prediction"))
    assert ((proba >= 0) & (proba <= 1)).all()
    np.testing.assert_array_equal(pred, (proba >= 0.5).astype(np.int32))
    jout = ref.transform(x)
    np.testing.assert_allclose(proba, np.asarray(jout.column("probability")),
                               rtol=F64_TOL)
    np.testing.assert_array_equal(pred, np.asarray(jout.column("prediction")))
    summary = ours.evaluate(x, y)
    assert summary["accuracy"] > 0.85 and summary["logLoss"] < 0.45
    want = ref.evaluate(x, y)
    assert summary["accuracy"] == want["accuracy"]
    assert summary["logLoss"] == pytest.approx(want["logLoss"], rel=F64_TOL)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_logreg_streamed_matches_oneshot(data, dtype, small_buckets):
    x, y = data

    def chunks():
        return ((x[i:i + 333], y[i:i + 333]) for i in range(0, len(y), 333))

    ours, ref = _both(lambda e: e.setRegParam(0.02), chunks, dtype=dtype)
    _assert_binary_same(ours, ref, _dtype_tol(dtype),
                        same_iters=dtype == "float64")
    oneshot = LogisticRegression().setRegParam(0.02).setDtype(
        "float64").fit(x, y)
    _assert_binary_same(ours, oneshot, max(_dtype_tol(dtype), 1e-10),
                        same_iters=False)


def test_logreg_streamed_host_path(data, small_buckets):
    x, y = data

    def chunks():
        return ((x[i:i + 400], y[i:i + 400]) for i in range(0, len(y), 400))

    ours, ref = _both(lambda e: e.setRegParam(0.02).setUseXlaDot(False),
                      chunks)
    _assert_binary_same(ours, ref, 1e-12)
    oneshot = LogisticRegression().setRegParam(0.02).setUseXlaDot(
        False).fit(x, y)
    np.testing.assert_allclose(ours.coefficients, oneshot.coefficients,
                               atol=1e-8)


def test_streamed_buckets_are_sized_by_the_features(rng):
    """The streamed source's buckets follow X's width (8192 rows at 4096
    features), not Z = [X | y]'s."""
    from spark_rapids_ml_tpu_torch.data.batches import auto_batch_rows

    x = rng.normal(size=(10, 4096)).astype(np.float32)
    y = np.ones(10, dtype=np.float32)
    source = lr_module._xy_source(lambda: iter([(x, y)]), None)
    assert source.n_features == 4097
    assert source.batch_rows == auto_batch_rows(4096) == 8192


@pytest.mark.parametrize("cls", [LogisticRegression, JaxLogisticRegression])
def test_logreg_streamed_label_validation(rng, cls, small_buckets):
    x = rng.normal(size=(200, 3))
    y = np.full(200, 2.0)
    with pytest.raises(ValueError, match="0/1 labels"):
        cls().fit(
            lambda: ((x[i:i + 50], y[i:i + 50]) for i in range(0, 200, 50))
        )


@pytest.mark.parametrize("cls", [LogisticRegression, JaxLogisticRegression])
def test_logreg_streamed_requires_reiterable(data, cls, small_buckets):
    x, y = data
    gen = iter([(x[:100], y[:100])])
    with pytest.raises(ValueError, match="re-iterable"):
        cls().fit(gen)


@pytest.mark.parametrize("saver,loader", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_logreg_persistence(data, tmp_path, saver, loader):
    x, y = data
    est = {"port": LogisticRegression, "jax": JaxLogisticRegression}[saver]
    model = est().setRegParam(0.01).setTol(F32_STOP).fit(x, y)
    p = str(tmp_path / "m")
    model.save(p)
    cls = {"port": LogisticRegressionModel,
           "jax": JaxLogisticRegressionModel}[loader]
    back = cls.load(p)
    np.testing.assert_array_equal(back.coefficients, model.coefficients)
    assert back.intercept == model.intercept
    assert back.getRegParam() == 0.01
    assert back.uid == model.uid
    np.testing.assert_allclose(
        back.predict_proba(x[:50]), model.predict_proba(x[:50]),
        rtol=1e-6 if "port" in (saver, loader) else 1e-12)


@pytest.mark.parametrize("cls", [LogisticRegression, JaxLogisticRegression])
def test_logreg_label_validation(rng, cls):
    # exactly two classes must be the Spark 0/1 encoding
    x = rng.normal(size=(50, 3))
    y = rng.integers(0, 2, size=50).astype(float) + 0.3  # {0.3, 1.3}
    with pytest.raises(ValueError, match="0/1 labels"):
        cls().fit(x, y)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_multinomial_matches_jax(rng, dtype):
    """>2 classes auto-selects the softmax family (Spark family='auto')."""
    n, d, k = 600, 4, 3
    centers = rng.normal(scale=2, size=(k, d))
    x = np.concatenate([rng.normal(loc=c, size=(n // k, d)) for c in centers])
    y = np.repeat(np.arange(k, dtype=np.float64), n // k)
    frame = {"features": x, "label": y}
    ours, ref = _both(lambda e: e.setRegParam(0.1).setMaxIter(50),
                      dtype=dtype, dataset_pair=(VectorFrame(frame),
                                                 JaxVectorFrame(frame)))
    assert ours.num_classes == ref.num_classes == 3
    _assert_multinomial_same(ours, ref, x, _dtype_tol(dtype))
    out = ours.transform(VectorFrame({"features": x}))
    proba = np.asarray(out.column("probability"))
    pred = np.asarray(out.column("prediction"))
    assert proba.shape == (n, 3)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-6)
    jpred = np.asarray(ref.transform(JaxVectorFrame({"features": x}))
                       .column("prediction"))
    assert np.mean(pred != jpred) <= 1e-3


def test_multinomial_nonconsecutive_labels_and_weights(rng):
    n = 300
    x, y = _blobs(rng, n, 2, (0.0, 4.0, 8.0), labels=(5.0, 17.0, 42.0))
    w = rng.integers(1, 3, size=n).astype(np.float64)
    frame = {"features": x, "label": y, "w": w}
    ours = LogisticRegression().setRegParam(1e-3).setMaxIter(40).setWeightCol(
        "w").setDtype("float64").fit(VectorFrame(frame))
    ref = JaxLogisticRegression().setRegParam(1e-3).setMaxIter(
        40).setWeightCol("w").fit(JaxVectorFrame(frame))
    _assert_multinomial_same(ours, ref, x, F64_TOL)
    pred = np.asarray(
        ours.transform(VectorFrame({"features": x})).column("prediction"))
    assert set(np.unique(pred)) <= {5.0, 17.0, 42.0}
    assert (pred == y).mean() > 0.95
    # integer weights == duplication, multinomial edition
    reps = np.repeat(np.arange(n), w.astype(int))
    expanded = LogisticRegression().setRegParam(1e-3).setMaxIter(
        40).setDtype("float64").fit(
        VectorFrame({"features": x[reps], "label": y[reps]}))
    np.testing.assert_allclose(ours.coefficient_matrix,
                               expanded.coefficient_matrix, atol=1e-3)


@pytest.mark.parametrize("use_xla", [True, False])
def test_weight_col_equals_row_duplication(rng, use_xla):
    """Integer weights ≡ row duplication for the weighted MLE, device and
    host paths, and the weighted fit equals JAX's."""
    x = rng.normal(size=(150, 3))
    p = 1.0 / (1.0 + np.exp(-(x @ np.array([2.0, -1.0, 0.5]))))
    y = (rng.uniform(size=150) < p).astype(np.float64)
    w = rng.integers(1, 4, size=150).astype(np.float64)
    reps = np.repeat(np.arange(150), w.astype(int))
    frame = {"features": x, "label": y, "w": w}
    weighted = LogisticRegression().setUseXlaDot(use_xla).setMaxIter(
        30).setWeightCol("w").setDtype("float64").fit(VectorFrame(frame))
    expanded = LogisticRegression().setUseXlaDot(use_xla).setMaxIter(
        30).setDtype("float64").fit(
        VectorFrame({"features": x[reps], "label": y[reps]}))
    np.testing.assert_allclose(weighted.coefficients, expanded.coefficients,
                               atol=1e-4)
    np.testing.assert_allclose(weighted.intercept, expanded.intercept,
                               atol=1e-4)
    ref = JaxLogisticRegression().setUseXlaDot(use_xla).setMaxIter(
        30).setWeightCol("w").fit(JaxVectorFrame(frame))
    _assert_binary_same(weighted, ref, F64_TOL)


@pytest.mark.parametrize("saver,loader", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_multinomial_persistence_roundtrip(rng, tmp_path, saver, loader):
    x, y = _blobs(rng, 240, 3, (0.0, 3.0, 6.0))
    frame = {"features": x, "label": y}
    if saver == "port":
        model = LogisticRegression().setRegParam(0.01).setMaxIter(
            30).setTol(F32_STOP).fit(VectorFrame(frame))
    else:
        model = JaxLogisticRegression().setRegParam(0.01).setMaxIter(30).fit(
            JaxVectorFrame(frame))
    path = str(tmp_path / "mnlr")
    model.save(path)
    cls = {"port": LogisticRegressionModel,
           "jax": JaxLogisticRegressionModel}[loader]
    loaded = cls.load(path)
    np.testing.assert_array_equal(loaded.coefficient_matrix,
                                  model.coefficient_matrix)
    np.testing.assert_array_equal(loaded.intercept_vector,
                                  model.intercept_vector)
    np.testing.assert_array_equal(loaded.classes_, model.classes_)
    p1 = np.asarray(model.transform(x).column("prediction"))
    p2 = np.asarray(loaded.transform(x).column("prediction"))
    np.testing.assert_array_equal(p1, p2)
    assert type(load_model(path)).__name__ == "LogisticRegressionModel"


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_multinomial_no_intercept(rng, dtype):
    """fit_intercept=False trains the intercept-FREE optimum (the
    Hessian's intercept rows/columns are fully pinned)."""
    x, y = _blobs(rng, 450, 3, (1.0, 3.0, 5.0))
    frame = {"features": x, "label": y}
    ours, ref = _both(lambda e: e.setRegParam(0.05).setFitIntercept(
        False).setMaxIter(60), dtype=dtype, dataset_pair=(
            VectorFrame(frame), JaxVectorFrame(frame)))
    np.testing.assert_array_equal(ours.intercept_vector, 0.0)
    _assert_multinomial_same(ours, ref, x, _dtype_tol(dtype))


@pytest.mark.parametrize("cls,frame_cls", [
    (LogisticRegression, VectorFrame),
    (JaxLogisticRegression, JaxVectorFrame)])
def test_multinomial_evaluate_and_label_guards(rng, cls, frame_cls):
    x, y = _blobs(rng, 240, 2, (0.0, 4.0, 8.0))
    model = cls().setRegParam(0.01).setMaxIter(30).setTol(F32_STOP).fit(
        frame_cls({"features": x, "label": y}))
    summary = model.evaluate(frame_cls({"features": x, "label": y}))
    assert summary["accuracy"] > 0.95
    assert 0.0 < summary["logLoss"] < 0.5
    y_bad = y.copy()
    y_bad[0] = np.nan
    with pytest.raises(ValueError, match="finite"):
        cls().fit(frame_cls({"features": x, "label": y_bad}))
    with pytest.raises(ValueError, match="continuous"):
        cls().fit(frame_cls({"features": x, "label": rng.normal(size=240)}))


def test_multinomial_evaluate_matches_jax(rng):
    x, y = _blobs(rng, 240, 2, (0.0, 4.0, 8.0))
    frame = {"features": x, "label": y}
    ours = LogisticRegression().setRegParam(0.01).setMaxIter(30).setDtype(
        "float64").fit(VectorFrame(frame))
    ref = JaxLogisticRegression().setRegParam(0.01).setMaxIter(30).fit(
        JaxVectorFrame(frame))
    got = ours.evaluate(VectorFrame(frame))
    want = ref.evaluate(JaxVectorFrame(frame))
    assert got["accuracy"] == want["accuracy"]
    assert got["logLoss"] == pytest.approx(want["logLoss"], rel=1e-7)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_multinomial_streamed_matches_oneshot(rng, dtype, small_buckets):
    """Streamed softmax fit (raw-partials pass per Newton iteration, the
    system solved on the host in float64) against the JAX streamed fit and
    the in-memory one."""
    n, d, k = 900, 6, 3
    centers = rng.normal(scale=3, size=(k, d))
    y = rng.integers(0, k, size=n).astype(np.float64)
    x = rng.normal(size=(n, d)) + centers[y.astype(int)]

    def chunks():
        return ((x[i:i + 250], y[i:i + 250]) for i in range(0, n, 250))

    ours, ref = _both(lambda e: e.setRegParam(0.05), chunks, dtype=dtype)
    _assert_multinomial_same(ours, ref, x, _dtype_tol(dtype))
    oneshot = LogisticRegression().setRegParam(0.05).setDtype(dtype).setTol(
        F32_STOP if dtype == "float32" else 1e-8).fit(x, y)
    np.testing.assert_allclose(ours.predict_proba(x), oneshot.predict_proba(x),
                               atol=1e-6 if dtype == "float64" else F32_TOL)


@pytest.mark.parametrize("cls", [LogisticRegression, JaxLogisticRegression])
def test_multinomial_streamed_continuous_target_guard(rng, cls, small_buckets):
    x = rng.normal(size=(300, 4))
    y = rng.normal(size=300)  # continuous
    with pytest.raises(ValueError, match="continuous"):
        cls().fit(
            lambda: ((x[i:i + 100], y[i:i + 100]) for i in range(0, 300, 100))
        )


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("use_xla", [True, False])
def test_logreg_elastic_net_matches_jax(data, use_xla, dtype):
    """elasticNetParam (prox-Newton + FISTA subproblems): the same outer
    iterations as JAX's. The FISTA subproblems stop at 1e-8, so a float32
    device Hessian moves the result at that scale."""
    x, y = data
    ours, ref = _both(lambda e: e.setRegParam(0.05).setElasticNetParam(
        0.5).setUseXlaDot(use_xla).setMaxIter(50), x, y, dtype=dtype)
    tol = _dtype_tol(dtype) if use_xla else 1e-12
    _assert_binary_same(ours, ref, tol, same_iters=tol <= F64_TOL)


@pytest.mark.parametrize("cls", [LogisticRegression, JaxLogisticRegression])
def test_logreg_elastic_net_induces_sparsity(rng, cls):
    x = rng.normal(size=(500, 12))
    w_true = np.zeros(12)
    w_true[:3] = (2.0, -3.0, 1.5)   # only 3 informative features
    p = 1.0 / (1.0 + np.exp(-(x @ w_true)))
    y = (rng.random(500) < p).astype(np.float64)
    model = cls().setRegParam(0.05).setElasticNetParam(1.0).fit(x, y)
    assert (np.abs(model.coefficients[3:]) < 1e-8).sum() >= 6
    assert (np.abs(model.coefficients[:3]) > 0.05).all()


@pytest.mark.parametrize("cls", [LogisticRegression, JaxLogisticRegression])
def test_logreg_elastic_net_unsupported_paths_raise(rng, cls, small_buckets):
    x = rng.normal(size=(90, 3))
    y3 = rng.integers(0, 3, 90).astype(float)
    est = cls().setRegParam(0.1).setElasticNetParam(0.5)
    with pytest.raises(ValueError, match="elasticNetParam"):
        est.fit(x, y3)     # multinomial
    yb = (x[:, 0] > 0).astype(float)
    with pytest.raises(ValueError, match="elasticNetParam"):
        est.fit(lambda: ((x[i:i + 30], yb[i:i + 30]) for i in range(0, 90, 30)))


def test_logreg_elastic_net_separable_data_stays_finite(rng):
    # fully separable: the lam=0 Hessian collapses as p saturates; the
    # curvature ridge must keep coefficients finite
    x = rng.normal(size=(200, 4))
    y = (x[:, 0] > 0).astype(float)
    ours, ref = _both(lambda e: e.setRegParam(0.01).setElasticNetParam(
        1.0).setMaxIter(40), x, y)
    assert np.isfinite(ours.coefficients).all()
    assert np.isfinite(ours.intercept)
    assert ours.evaluate(x, y)["accuracy"] > 0.95
    assert ours.evaluate(x, y)["accuracy"] == ref.evaluate(x, y)["accuracy"]


def test_device_fit_needs_a_device_or_the_cpu_request(data, monkeypatch):
    """No Newton step carries on on the CPU when no GPU is found."""
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = data
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LogisticRegression().fit(x, y)
    model = LogisticRegression().setUseXlaDot(False).fit(x, y)
    assert model.coefficients.shape == (8,)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.setUseXlaDot(True).predict_proba(x)


def test_fit_report_and_thresholds(data):
    x, y = data
    model = LogisticRegression().setRegParam(0.01).setTol(F32_STOP).fit(x, y)
    assert model.fit_report_.algo == "logreg"
    proba = model.predict_proba(x)
    model.setThresholds([0.2, 0.8])
    pred = np.asarray(model.transform(x).column("prediction"))
    np.testing.assert_array_equal(
        pred, ((proba / 0.8) > ((1 - proba) / 0.2)).astype(np.int32))
