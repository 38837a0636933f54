"""LinearSVC in the port against the JAX package's, on the same numpy inputs.

The cases of tests/test_svc.py, each run through both packages (the JAX
file holds the JAX fit against sklearn; here the port is held against the
JAX fit), but for ``test_svc_under_onevsrest`` (OneVsRest is not ported
yet), plus the operations of ``ops/svm_kernel.py`` one by one: the √s
Hessian against JAX ``_svc_grad_hess``'s ``dot_general``, the streamed
accumulator, the kernel launches per Newton iteration, the plain Gram
version at float32 on √s rows against JAX's ``dot_general``, and results
under ``set_float32_matmul_precision("high")``. The JAX suite runs with
x64 (tests/conftest.py), so its 'auto' dtype is float64; the port's is
float32, so every comparison names its dtype:

* float64 in both: 1e-8 relative (coefficients and intercept together)
  and the same iteration count; the statistics of one step 1e-12;
* float32 in the port (on the CPU the Gram kernel's plain version at
  highest): within 1e-4 relative of the float64 JAX fit. Float32 Newton
  stalls above the default tol 1e-8 and runs to maxIter, as JAX's does,
  so the float32 fits stop at 1e-6.
"""

import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu.ops.svm_kernel as jax_ops
from spark_rapids_ml_tpu import LinearSVC as JaxLinearSVC
from spark_rapids_ml_tpu import LinearSVCModel as JaxLinearSVCModel
from spark_rapids_ml_tpu.data.frame import as_vector_frame as jax_frame
from spark_rapids_ml_tpu_torch import LinearSVC, LinearSVCModel
from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame
from spark_rapids_ml_tpu_torch.io.persistence import load_model
from spark_rapids_ml_tpu_torch.ops import covariance as cov_ops
from spark_rapids_ml_tpu_torch.ops import fused_gram as fg
from spark_rapids_ml_tpu_torch.ops import svm_kernel as ops

F64_TOL = 1e-8
F32_TOL = 1e-4
F32_STOP = 1e-6


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


@pytest.fixture
def data(rng):
    n = 2000
    x = rng.normal(size=(n, 8))
    w_true = np.array([1.5, -2.0, 0.7, 0.0, 3.0, -0.3, 1.0, -1.2])
    margin = x @ w_true + 0.4 + rng.normal(scale=2.0, size=n)
    y = (margin > 0).astype(np.float64)
    return x, y


@pytest.fixture
def small_buckets(monkeypatch):
    """Both packages' streamed sources in buckets of 256 rows: the default
    sizes a bucket to 128 MiB, millions of rows at these widths, nearly
    all zero padding here. The bucket changes only the order of sums."""
    import spark_rapids_ml_tpu.data.batches as jax_batches
    from spark_rapids_ml_tpu_torch.data import batches

    for module in (batches, jax_batches):
        monkeypatch.setattr(module, "auto_batch_rows", lambda *a, **k: 256)


def _both(configure, *args, dtype="float64", dataset_pair=None, **kwargs):
    """The same estimator configuration fitted by both packages; the port
    at ``dtype``, and at float32 both at the ``F32_STOP`` tol."""
    if dtype == "float32":
        inner = configure
        configure = lambda e: inner(e).setTol(F32_STOP)  # noqa: E731
    ours_args, ref_args = ((dataset_pair[0],), (dataset_pair[1],)) \
        if dataset_pair else (args, args)
    return (configure(LinearSVC().setDtype(dtype)).fit(*ours_args, **kwargs),
            configure(JaxLinearSVC()).fit(*ref_args, **kwargs))


def _rel(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-300))


def _assert_same(ours, ref, tol, same_iters=True):
    got = np.append(ours.coefficients, ours.intercept)
    want = np.append(ref.coefficients, ref.intercept)
    assert _rel(got, want) <= tol, _rel(got, want)
    if same_iters:
        assert ours.n_iter_ == ref.n_iter_


def _dtype_tol(dtype):
    return F64_TOL if dtype == "float64" else F32_TOL


# -- the operations of ops/svm_kernel.py --------------------------------------

@pytest.mark.parametrize("mask", ["none", "rows", "weights"])
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_grad_hess_matches_jax(rng, mask, fit_intercept):
    """The √s Hessian (centered_gram with rowmul √(s·valid)) against JAX
    ``_svc_grad_hess``'s ``dot_general`` of x and x·s, and the gradient,
    jitter and pinned intercept slot."""
    x = rng.normal(size=(60, 5))
    y_pm = 2.0 * (rng.random(60) > 0.5) - 1.0
    m = {"none": np.ones(60),
         "rows": (rng.random(60) > 0.3).astype(np.float64),
         "weights": rng.uniform(0.5, 2.0, 60)}[mask]
    w = rng.normal(size=6) * 0.5
    ours = ops._svc_grad_hess(torch.as_tensor(w), torch.as_tensor(x),
                              torch.as_tensor(y_pm), torch.as_tensor(m), 0.1,
                              fit_intercept, lambda t: t)
    ref = jax_ops._svc_grad_hess(w, x, y_pm, m, 0.1, fit_intercept,
                                 lambda t: t)
    for got, want in zip(ours, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-13)
    if not fit_intercept:
        assert float(ours[1][5, 5]) == 1.0


def test_the_hessian_is_the_kernels_full_f32_with_root_weights(rng,
                                                               monkeypatch):
    """Xᵀdiag(s)X goes to the kernel's wrapper as rowmul = √(s·w), s the
    active-set indicator, precision highest, once per Newton iteration."""
    calls = []
    real = cov_ops.fused_centered_gram

    def counted(x, mean, rowmul, precision=None):
        calls.append((precision, rowmul.clone()))
        return real(x, mean, rowmul, precision)

    monkeypatch.setattr(cov_ops, "fused_centered_gram", counted)
    x = rng.normal(size=(40, 4)).astype(np.float32)
    y = (rng.random(40) > 0.5).astype(np.float32)
    wts = rng.uniform(0.5, 2.0, 40).astype(np.float32)
    result = ops.svc_fit_kernel(torch.as_tensor(x), torch.as_tensor(y),
                                torch.as_tensor(wts), reg_param=0.1,
                                max_iter=3, tol=0.0)
    assert int(result.n_iter) == 3 and len(calls) == 3
    assert {precision for precision, _ in calls} == {"highest"}
    # the first iteration runs at w = 0: every margin is 1, s = 1
    np.testing.assert_allclose(calls[0][1].numpy(), np.sqrt(wts), rtol=1e-7)
    # later rows are √w on the active set and 0 off it
    for _, rowmul in calls[1:]:
        r = rowmul.numpy()
        assert np.all((r == 0) | np.isclose(r, np.sqrt(wts), rtol=1e-7))


@pytest.mark.parametrize("masked", [False, True])
def test_update_svc_stats_matches_jax(rng, masked):
    """One streamed bucket's partials at (w, b): the √s Gram against JAX's
    ``dot_general``, float64."""
    z = np.column_stack([rng.normal(size=(70, 5)),
                         (rng.random(70) > 0.5).astype(np.float64)])
    mask = (rng.random(70) > 0.2) if masked else None
    w = rng.normal(size=5) * 0.4
    carry = tuple(np.zeros(s) for s in ((5,), (5, 5), (5,), (), (), ()))
    ref = jax_ops.update_svc_stats(carry, z, w, 0.3, mask)
    ours = ops.update_svc_stats(
        tuple(torch.as_tensor(c) for c in carry), torch.as_tensor(z),
        torch.as_tensor(w), torch.tensor(0.3, dtype=torch.float64),
        None if mask is None else torch.as_tensor(mask))
    for got, want in zip(ours, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)


def test_plain_gram_on_root_s_rows_matches_dot_general(rng):
    """At float32 on the CPU, the Hessian is the kernel's plain version on
    √s rows: within the highest mode's plain bar of JAX's
    ``dot_general(x, x·s, HIGHEST)`` at float32."""
    import jax.numpy as jnp
    from jax import lax

    x = rng.normal(size=(500, 16)).astype(np.float32)
    s = (rng.random(500) > 0.4).astype(np.float32) * rng.uniform(
        0.5, 2.0, 500).astype(np.float32)
    ours = cov_ops.centered_gram(torch.as_tensor(x), None,
                                 torch.sqrt(torch.as_tensor(s)),
                                 precision="highest").numpy()
    ref = np.asarray(lax.dot_general(
        jnp.asarray(x), jnp.asarray(x * s[:, None]),
        (((0,), (0,)), ((), ())), precision=lax.Precision.HIGHEST))
    assert ref.dtype == np.float32
    scale = np.abs(ref).max()
    assert np.abs(ours - ref).max() <= fg.PLAIN_RTOL[
        fg.kernel_name("highest")] * scale


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("reg", [0.0, 0.1])
def test_fit_kernel_matches_jax(rng, fit_intercept, reg):
    x = rng.normal(size=(300, 6))
    y = (x @ rng.normal(size=6) + 0.3 + rng.normal(size=300) > 0).astype(
        np.float64)
    ours = ops.svc_fit_kernel(torch.as_tensor(x), torch.as_tensor(y),
                              reg_param=reg, fit_intercept=fit_intercept)
    ref = jax_ops.svc_fit_kernel(x, y, reg_param=reg,
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
    y = (x @ rng.normal(size=6) + rng.normal(size=300) > 0).astype(
        np.float32)
    ours = ops.svc_fit_kernel(torch.as_tensor(x), torch.as_tensor(y),
                              reg_param=0.01, max_iter=40)
    ref = jax_ops.svc_fit_kernel(x, y, reg_param=0.01, max_iter=40)
    assert np.asarray(ref.coefficients).dtype == np.float32
    assert int(ours.n_iter) == int(ref.n_iter) == 40
    assert bool(ours.converged) is bool(ref.converged) is False
    np.testing.assert_allclose(ours.coefficients.numpy(),
                               np.asarray(ref.coefficients), atol=F32_TOL)


def test_max_iter_zero_returns_zeros_as_jax(rng):
    x = rng.normal(size=(30, 3))
    y = (rng.random(30) > 0.5).astype(np.float64)
    ours = ops.svc_fit_kernel(torch.as_tensor(x), torch.as_tensor(y),
                              max_iter=0)
    ref = jax_ops.svc_fit_kernel(x, y, max_iter=0)
    assert int(ours.n_iter) == int(ref.n_iter) == 0
    assert bool(ours.converged) == bool(ref.converged) is False
    assert not ours.coefficients.numpy().any()


def test_float32_fits_are_unchanged_under_tf32_high(data):
    """The float32 margins and gradient are matrix-vector products, which
    no TF32 setting reaches: a fit gives the same bits with the float32
    matmul precision at 'high' as at 'highest'."""
    x, y = data
    x32, y32 = x[:400].astype(np.float32), y[:400].astype(np.float32)

    def run():
        r = ops.svc_fit_kernel(torch.as_tensor(x32), torch.as_tensor(y32),
                               reg_param=0.1, max_iter=5)
        raw = ops.svc_decision_kernel(torch.as_tensor(x32), r.coefficients,
                                      r.intercept)
        return [r.coefficients, raw]

    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        want = run()
        torch.set_float32_matmul_precision("high")
        got = run()
    finally:
        torch.set_float32_matmul_precision(before)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- the cases of tests/test_svc.py -------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("use_xla", [True, False])
@pytest.mark.parametrize("reg_param", [0.01, 0.1])
def test_svc_matches_jax(data, use_xla, reg_param, dtype):
    x, y = data
    ours, ref = _both(lambda e: e.setRegParam(reg_param).setUseXlaDot(
        use_xla).setStandardization(False), x, y, dtype=dtype)
    # the host route is numpy float64 whatever the dtype
    tol = _dtype_tol(dtype) if use_xla else 1e-12
    _assert_same(ours, ref, tol, same_iters=tol <= F64_TOL)
    assert set(ours.fit_timings_) == set(ref.fit_timings_)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_svc_no_intercept(data, dtype):
    x, y = data
    ours, ref = _both(lambda e: e.setRegParam(0.05).setFitIntercept(
        False).setStandardization(False), x, y, dtype=dtype)
    _assert_same(ours, ref, _dtype_tol(dtype), same_iters=dtype == "float64")
    assert ours.intercept == ref.intercept == 0.0


def test_svc_xla_host_paths_agree(data):
    x, y = data
    dev = LinearSVC().setRegParam(0.02).setDtype("float64").fit(x, y)
    host = LinearSVC().setRegParam(0.02).setUseXlaDot(False).fit(x, y)
    np.testing.assert_allclose(dev.coefficients, host.coefficients,
                               atol=1e-8)
    assert abs(dev.intercept - host.intercept) < 1e-8
    ref = JaxLinearSVC().setRegParam(0.02).setUseXlaDot(False).fit(x, y)
    _assert_same(host, ref, 1e-12)
    # every fit of the port reports itself (the JAX LinearSVC.fit does not)
    assert dev.fit_report_.algo == host.fit_report_.algo == "linear_svc"


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_svc_standardization_matches_manual_prescale(data, dtype):
    x, y = data
    sd = x.std(axis=0, ddof=1)
    manual = LinearSVC().setRegParam(0.03).setStandardization(
        False).setDtype("float64").fit(x / sd[None, :], y)
    ours, ref = _both(lambda e: e.setRegParam(0.03), x, y, dtype=dtype)
    if dtype == "float64":
        np.testing.assert_allclose(ours.coefficients,
                                   manual.coefficients / sd, atol=1e-8)
        assert abs(ours.intercept - manual.intercept) < 1e-8
    _assert_same(ours, ref, _dtype_tol(dtype), same_iters=dtype == "float64")


@pytest.mark.parametrize("standardize", [False, True])
def test_svc_weightcol_equals_row_duplication(rng, standardize):
    # holds with standardization too: the weighted std uses the
    # frequency-weight (Σw − 1) denominator, so weight k ≡ k copies
    x = rng.normal(size=(300, 5))
    y = (x @ np.array([1.0, -1.0, 0.5, 0.0, 2.0]) > 0).astype(np.float64)
    w = rng.integers(1, 4, size=300).astype(np.float64)
    x_dup = np.repeat(x, w.astype(int), axis=0)
    y_dup = np.repeat(y, w.astype(int))
    dup = LinearSVC().setRegParam(0.05).setStandardization(
        standardize).setDtype("float64").fit(x_dup, y_dup)
    frame = as_vector_frame(x, "features").with_column(
        "label", y.tolist()).with_column("w", w.tolist())
    weighted = LinearSVC().setRegParam(0.05).setStandardization(
        standardize).setWeightCol("w").setDtype("float64").fit(frame)
    np.testing.assert_allclose(weighted.coefficients, dup.coefficients,
                               atol=1e-7)
    assert abs(weighted.intercept - dup.intercept) < 1e-7
    jframe = jax_frame(x, "features").with_column(
        "label", y.tolist()).with_column("w", w.tolist())
    ref = JaxLinearSVC().setRegParam(0.05).setStandardization(
        standardize).setWeightCol("w").fit(jframe)
    _assert_same(weighted, ref, F64_TOL)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_svc_streamed_matches_oneshot(data, dtype, small_buckets):
    x, y = data

    def chunks():
        return ((x[i:i + 333], y[i:i + 333]) for i in range(0, len(y), 333))

    ours, ref = _both(lambda e: e.setRegParam(0.02).setStandardization(
        False), chunks, dtype=dtype)
    _assert_same(ours, ref, _dtype_tol(dtype), same_iters=dtype == "float64")
    oneshot = LinearSVC().setRegParam(0.02).setStandardization(
        False).setDtype("float64").fit(x, y)
    np.testing.assert_allclose(ours.coefficients, oneshot.coefficients,
                               atol=5e-6 if dtype == "float64" else F32_TOL)
    assert abs(ours.intercept - oneshot.intercept) < (
        5e-6 if dtype == "float64" else F32_TOL)


def test_svc_streamed_host_path(data, small_buckets):
    x, y = data

    def chunks():
        return ((x[i:i + 400], y[i:i + 400]) for i in range(0, len(y), 400))

    ours, ref = _both(lambda e: e.setRegParam(0.02).setUseXlaDot(
        False).setStandardization(False), chunks)
    _assert_same(ours, ref, 1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_svc_transform_and_threshold(data, dtype):
    x, y = data
    ours, ref = _both(lambda e: e.setRegParam(0.01), x, y, dtype=dtype)
    out = ours.transform(x)
    raw = np.asarray(out.column("rawPrediction"))
    pred = np.asarray(out.column("prediction"))
    np.testing.assert_array_equal(pred, (raw > 0.0).astype(np.float64))
    jraw = np.asarray(ref.transform(x).column("rawPrediction"))
    np.testing.assert_allclose(raw, jraw, rtol=0,
                               atol=1e-12 if dtype == "float64" else 1e-4)
    summary = ours.evaluate(x, y)
    assert summary["accuracy"] > 0.8
    want = ref.evaluate(x, y)
    assert summary["squaredHinge"] == pytest.approx(
        want["squaredHinge"], rel=1e-10 if dtype == "float64" else 1e-4)
    if dtype == "float64":
        assert summary["accuracy"] == want["accuracy"]
    np.testing.assert_array_equal(ours.predict_proba(x), raw)
    ours.set("threshold", float(np.median(raw)))
    pred2 = ours.predict(x)
    assert 0.4 < pred2.mean() < 0.6


@pytest.mark.parametrize("saver,loader", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_svc_persistence_roundtrip(tmp_path, data, saver, loader):
    x, y = data
    est = {"port": LinearSVC, "jax": JaxLinearSVC}[saver]
    model = est().setRegParam(0.01).setMaxIter(50).setTol(F32_STOP).fit(x, y)
    path = str(tmp_path / "svc")
    model.save(path)
    cls = {"port": LinearSVCModel, "jax": JaxLinearSVCModel}[loader]
    loaded = cls.load(path)
    np.testing.assert_array_equal(loaded.coefficients, model.coefficients)
    assert loaded.intercept == model.intercept
    assert loaded.getMaxIter() == 50
    assert loaded.uid == model.uid
    np.testing.assert_array_equal(loaded.predict(x[:200]),
                                  model.predict(x[:200]))
    assert type(load_model(path)).__name__ == "LinearSVCModel"


@pytest.mark.parametrize("saver,loader", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_svc_estimator_params_roundtrip(tmp_path, saver, loader):
    est = {"port": LinearSVC, "jax": JaxLinearSVC}[saver]()
    est.setRegParam(0.5).setStandardization(False)
    path = str(tmp_path / "svc_est")
    est.save(path)
    loaded = {"port": LinearSVC, "jax": JaxLinearSVC}[loader].load(path)
    assert loaded.getRegParam() == 0.5
    assert loaded.getStandardization() is False


@pytest.mark.parametrize("cls", [LinearSVC, JaxLinearSVC])
def test_svc_rejects_nonbinary_labels(rng, cls):
    x = rng.normal(size=(50, 3))
    y = rng.integers(0, 3, size=50).astype(np.float64)
    with pytest.raises(ValueError, match="LinearSVC requires 0/1 labels"):
        cls().fit(x, y)


@pytest.mark.parametrize("cls", [LinearSVC, JaxLinearSVC])
def test_svc_streamed_guards(data, cls, small_buckets):
    x, y = data
    with pytest.raises(ValueError, match="standardization"):
        cls().fit(lambda: ((x[:100], y[:100]),))
    with pytest.raises(ValueError, match="re-iterable"):
        cls().setStandardization(False).fit(iter([(x[:100], y[:100])]))
    with pytest.raises(ValueError, match="weightCol"):
        cls().setWeightCol("w").fit(lambda: ((x[:100], y[:100]),))
    y2 = np.full(100, 2.0)
    with pytest.raises(ValueError, match="0/1 labels"):
        cls().setStandardization(False).fit(lambda: ((x[:100], y2),))


def test_device_fit_needs_a_device_or_the_cpu_request(data, monkeypatch):
    """No Newton step carries on on the CPU when no GPU is found."""
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = data
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LinearSVC().fit(x, y)
    model = LinearSVC().setUseXlaDot(False).fit(x, y)
    assert model.coefficients.shape == (8,)
    assert model.predict(x).shape == (len(y),)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.setUseXlaDot(True).predict(x)
