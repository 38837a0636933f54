"""GaussianMixture in the port against the JAX package's, on the same
seeded numpy inputs.

``ops/gmm_kernel.py`` and ``models/gaussian_mixture.py`` against the JAX
modules of the same names (run with x64 on, as the JAX tests run). Bars:

* whole fits at float64 — in memory, weighted, streamed, and the host
  route (``useXlaDot=False``): means, weights, covariances and
  ``log_likelihood_`` within 1e-10 relative (max |Δ| / max |ref|), equal
  ``num_iterations_``. Both packages draw the init from numpy only, so
  the EM iterates follow each other;
* the device E-step (``gmm_estep_device``, Σ r·x·xᵀ through
  ``ops.covariance.centered_gram``, whose plain version stands in for the
  kernel on the CPU) against the JAX ``estep_stats_math`` on ``jnp``:
  1e-12 relative at float64; the responsibilities 1e-12;
* float32 against JAX's float32 fit within the JAX device / host bar
  (``tests/test_gaussian_mixture.py``: means atol 1e-6; weights held to
  the same 1e-6), equal iteration counts, and against the port's host
  float64 fit at that bar;
* the transform's columns, ``summary`` and the numpy helpers
  (``precision_cholesky``, ``m_step``, ``init_params``): equal.
"""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu_torch import GaussianMixture, GaussianMixtureModel
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
from spark_rapids_ml_tpu_torch.ops import gmm_kernel as pk

FIT_RTOL = 1e-10
ESTEP_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def _blobs(seed=0, n=600, d=4, k=3, sep=8.0):
    """tests/test_gaussian_mixture.py's ``make_blobs``: well-separated
    components at sep · one-hot centres, unit noise."""
    rng = np.random.default_rng(seed)
    centers = np.zeros((k, d))
    for i in range(k):
        centers[i, i % d] = sep * (1 + i // d)
    labels = rng.integers(0, k, size=n)
    return centers[labels] + rng.normal(size=(n, d)), rng


def _rel(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _assert_same_fit(got, want, rtol=FIT_RTOL):
    for attr in ("means", "weights", "covs"):
        assert _rel(getattr(got, attr), getattr(want, attr)) <= rtol, attr
    assert got.log_likelihood_ == pytest.approx(want.log_likelihood_,
                                                rel=rtol)
    assert got.num_iterations_ == want.num_iterations_


def _jax_classes():
    from spark_rapids_ml_tpu import GaussianMixture as JaxGMM
    from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxFrame

    return JaxGMM, JaxFrame


@pytest.mark.parametrize("route", ["in_memory", "weighted", "host",
                                   "host_weighted", "streamed",
                                   "host_streamed"])
def test_float64_fit_matches_jax(route):
    JaxGMM, JaxFrame = _jax_classes()
    x, rng = _blobs()
    kw = {"k": 3, "seed": 1, "maxIter": 60, "tol": 1e-9,
          "dtype": "float64"}
    port_data = jax_data = x
    if "weighted" in route:
        w = rng.uniform(0.5, 2.0, size=x.shape[0])
        kw["weightCol"] = "w"
        port_data = VectorFrame({"features": list(x), "w": w})
        jax_data = JaxFrame({"features": list(x), "w": w})
    elif "streamed" in route:
        def chunks():
            for i in range(0, x.shape[0], 128):
                yield x[i:i + 128]

        port_data = jax_data = chunks
    use_device = not route.startswith("host")
    got = GaussianMixture(**kw).setUseXlaDot(use_device).fit(port_data)
    want = JaxGMM(**kw).setUseXlaDot(use_device).fit(jax_data)
    assert got.num_iterations_ > 2
    _assert_same_fit(got, want)
    if not use_device and route != "host_streamed":
        # the host route is the JAX package's numpy code: equal
        for attr in ("means", "weights", "covs"):
            assert np.array_equal(getattr(got, attr), getattr(want, attr))


def _state(x, k=3, seed=2):
    """A mixture state a few EM steps in: (means, prec, log_det, log_w)."""
    w = np.ones(x.shape[0])
    weights, means, covs = pk.init_params(x, w, k, seed)
    for _ in range(2):
        prec, log_det = pk.precision_cholesky(covs)
        weights, means, covs = pk.m_step(pk.estep_stats_math(
            np, x, w, means, prec, log_det, np.log(weights)), 1e-6)
    prec, log_det = pk.precision_cholesky(covs)
    return means, prec, log_det, np.log(weights)


def test_device_estep_matches_the_jax_estep():
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.ops.gmm_kernel import (
        estep_stats_math as jax_estep,
    )

    x, rng = _blobs(seed=3, n=500)
    w = rng.uniform(0.5, 2.0, size=x.shape[0])
    state = _state(x)
    got = pk.gmm_estep_device(torch.as_tensor(x), torch.as_tensor(w),
                              *state)
    want = jax_estep(jnp, jnp.asarray(x), jnp.asarray(w),
                     *(jnp.asarray(s) for s in state))
    for name, g, wv in zip(pk.GmmStats._fields, got, want):
        assert g.dtype == torch.float64, name
        assert _rel(g.numpy(), np.asarray(wv)) <= ESTEP_RTOL, name
    # the plain route is the same statistics
    plain = pk.gmm_estep_device(torch.as_tensor(x), torch.as_tensor(w),
                                *state, plain=True)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


def test_device_responsibilities_match_jax():
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.ops.gmm_kernel import (
        responsibilities_math as jax_resp,
    )

    x, _rng = _blobs(seed=4, n=400)
    state = _state(x)
    got = pk.gmm_responsibilities_device(torch.as_tensor(x), *state)
    want = np.asarray(jax_resp(jnp, jnp.asarray(x),
                               *(jnp.asarray(s) for s in state)))
    assert np.abs(got.numpy() - want).max() <= ESTEP_RTOL
    np.testing.assert_allclose(got.numpy().sum(axis=1), 1.0, atol=1e-12)


def test_float32_estep_takes_the_gram_for_sq_sum_and_meets_float64():
    """float32: Σ r·x·xᵀ from the Gram's plain version (highest, f32
    folds) on √r rounded once from the float64 responsibilities, the
    rest in float64 rounded once; within float32's reach of the float64
    statistics."""
    x, _rng = _blobs(seed=5, n=700)
    state = _state(x)
    w = np.ones(x.shape[0])
    f64 = pk.gmm_estep_device(torch.as_tensor(x), torch.as_tensor(w),
                              *state)
    f32 = pk.gmm_estep_device(torch.as_tensor(x, dtype=torch.float32),
                              torch.as_tensor(w, dtype=torch.float32),
                              *state)
    zero = torch.zeros(x.shape[1])
    xf = torch.as_tensor(x, dtype=torch.float32)
    # the responsibilities are formed in float64; √r is rounded once
    resp, _norm = pk._responsibilities(xf, *state)
    assert resp.dtype == torch.float64
    for j in range(resp.shape[1]):
        root = torch.sqrt(resp[:, j]).float().contiguous()
        gram = pk.fused_centered_gram_reference(xf, zero, root, "highest")
        assert torch.equal(f32.sq_sum[j], gram)
    for name, a, b in zip(pk.GmmStats._fields, f32, f64):
        assert a.dtype == torch.float32, name
        assert _rel(a.numpy(), b.numpy()) <= 1e-5, name


def test_float32_fit_matches_the_jax_float32_fit():
    JaxGMM, _ = _jax_classes()
    x, _rng = _blobs(seed=6, n=300, k=2)
    got = GaussianMixture(k=2, seed=3, maxIter=50, dtype="float32").fit(x)
    want = JaxGMM(k=2, seed=3, maxIter=50, dtype="float32").fit(x)
    np.testing.assert_allclose(got.means, want.means, atol=1e-6)
    np.testing.assert_allclose(got.weights, want.weights, atol=1e-6)
    assert got.num_iterations_ == want.num_iterations_
    host = GaussianMixture(k=2, seed=3, maxIter=50).setUseXlaDot(False).fit(x)
    np.testing.assert_allclose(got.means, host.means, atol=1e-6)


def test_transform_and_summary_match_jax():
    JaxGMM, _ = _jax_classes()
    x, _rng = _blobs(seed=7, n=240)
    kw = {"k": 3, "seed": 0, "maxIter": 20, "dtype": "float64",
          "probabilityCol": "p", "predictionCol": "c"}
    got = GaussianMixture(**kw).fit(x)
    want = JaxGMM(**kw).fit(x)
    out, ref = got.transform(x[:50]), want.transform(x[:50])
    p = np.stack(out.column("p"))
    assert _rel(p, np.stack(ref.column("p"))) <= FIT_RTOL
    assert np.array_equal(np.asarray(out.column("c")),
                          np.asarray(ref.column("c")))
    s, r = got.summary(x), want.summary(x)
    assert s["numIterations"] == r["numIterations"]
    assert s["logLikelihood"] == pytest.approx(r["logLikelihood"],
                                               rel=FIT_RTOL)
    assert _rel(s["clusterSizes"], r["clusterSizes"]) <= FIT_RTOL
    assert np.array_equal(got.classes_, np.arange(3.0))


def test_numpy_helpers_equal_jax():
    from spark_rapids_ml_tpu.ops import gmm_kernel as jk

    x, rng = _blobs(seed=8, n=200)
    w = rng.uniform(0.5, 2.0, size=x.shape[0])
    init = pk.init_params(x, w, 3, 4)
    for a, b in zip(init, jk.init_params(x, w, 3, 4)):
        assert np.array_equal(a, b)
    for a, b in zip(pk.precision_cholesky(init[2], 0.1),
                    jk.precision_cholesky(init[2], 0.1)):
        assert np.array_equal(a, b)
    prec, log_det = pk.precision_cholesky(init[2])
    stats = pk.estep_stats_math(np, x, w, init[1], prec, log_det,
                                np.log(init[0]))
    for a, b in zip(pk.m_step(stats, 1e-6), jk.m_step(stats, 1e-6)):
        assert np.array_equal(a, b)
    rows = pk.kmeans_pp_rows(x, 3, np.random.default_rng(1))
    assert np.array_equal(rows, jk.kmeans_pp_rows(x, 3,
                                                  np.random.default_rng(1)))


def test_refusals_match_jax():
    x = np.ones((4, 2))
    with pytest.raises(ValueError, match="at least k rows"):
        GaussianMixture(k=5).fit(x)
    # a one-shot generator cannot feed one pass per EM iteration
    with pytest.raises(ValueError, match="zero-arg callable"):
        GaussianMixture(k=1).fit(iter([x]))
    # duplicate rows: the covariance is singular at regParam 0, as in JAX
    with pytest.raises(ValueError, match="singular component covariance"):
        GaussianMixture(k=1, regParam=0.0, maxIter=3).fit(x)
    with pytest.raises(ValueError, match="fit first"):
        GaussianMixtureModel().predict_proba(x)
