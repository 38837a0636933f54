"""The port's PCA ops (ops/covariance, eigh, randomized, pca_kernel,
streaming) against their JAX counterparts on the same numpy inputs.

float64 comparisons hold the port to the JAX package at the oracle bar
(1e-5) or tighter where both compute the same arithmetic; float32 ones say
their tolerance where they make them.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.data.batches import BatchSource as JaxBatchSource
from spark_rapids_ml_tpu.ops import eigh as jeigh
from spark_rapids_ml_tpu.ops import pca_kernel as jpk
from spark_rapids_ml_tpu.ops import randomized as jrand
from spark_rapids_ml_tpu.ops import streaming as jstream
from spark_rapids_ml_tpu_torch.data.batches import BatchSource
from spark_rapids_ml_tpu_torch.ops import covariance as tcov
from spark_rapids_ml_tpu_torch.ops import eigh as teigh
from spark_rapids_ml_tpu_torch.ops import pca_kernel as tpk
from spark_rapids_ml_tpu_torch.ops import randomized as trand
from spark_rapids_ml_tpu_torch.ops import streaming as tstream

# the JAX package's ops/__init__ re-exports a function named `covariance`
jcov = importlib.import_module("spark_rapids_ml_tpu.ops.covariance")

TOL = 1e-10  # float64, same arithmetic in both packages


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _mask(rows, valid):
    m = np.zeros(rows)
    m[:valid] = 1.0
    return m


def _decaying(rng, rows, d, base=3.0, loc=0.0):
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return rng.normal(size=(rows, d)) @ (q * base ** (-np.arange(d) / 4)) + loc


def _decaying_cov(rng, n, decay=0.9):
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return (q * decay ** np.arange(n)[None, :]) @ q.T


# -- covariance -------------------------------------------------------------

@pytest.mark.parametrize("valid", [None, 37])
def test_column_means_and_covariance_match_jax(rng, valid):
    x = rng.normal(loc=1.5, size=(50, 7))
    mask = None if valid is None else _mask(50, valid)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    want_mean = jcov.column_means(jnp.asarray(x), jm)
    got_mean = tcov.column_means(_t(x), tm)
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(want_mean), atol=TOL)
    want = jcov.covariance(jnp.asarray(x), mean=want_mean, mask=jm)
    got = tcov.covariance(_t(x), mean=got_mean, mask=tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_row_count_is_an_integer(rng):
    x = _t(rng.normal(size=(40, 3)).astype(np.float32))
    assert tcov.row_count(x).dtype == torch.int64
    assert int(tcov.row_count(x)) == 40
    n = tcov.row_count(x, _t(_mask(40, 29).astype(np.float32)))
    assert n.dtype == torch.int64 and int(n) == 29


@pytest.mark.parametrize("mean_centering", [True, False])
def test_partial_stats_and_covariance_from_stats_match_jax(rng, mean_centering):
    x = rng.normal(loc=0.5, size=(64, 6))
    mask = _mask(64, 51)
    jg, js, jn = jcov.partial_gram_stats(jnp.asarray(x), jnp.asarray(mask))
    tg, ts, tn = tcov.partial_gram_stats(_t(x), _t(mask))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL)
    assert int(tn) == int(jn) == 51
    want = jcov.covariance_from_stats(jg, js, jn, mean_centering=mean_centering)
    got = tcov.covariance_from_stats(tg, ts, tn, mean_centering=mean_centering)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_float32_covariance_matches_jax(rng):
    # JAX on the CPU computes the f32 Gram in f32 whatever its precision;
    # the port's default bfloat16_3x split adds ~1e-5 relative (the lo
    # parts are rounded to bf16), 'highest' only f32 order
    x = rng.normal(size=(300, 20)).astype(np.float32)
    want = np.asarray(jcov.covariance(jnp.asarray(x),
                                      mean=jnp.asarray(x.mean(0))))
    for precision, rtol in (("highest", 1e-5), ("bfloat16_3x", 1e-4)):
        got = tcov.covariance(_t(x), mean=_t(x.mean(0)), precision=precision)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=rtol * np.abs(want).max())


def test_gram_precision_resolution():
    assert tcov.resolve_gram_precision("auto") == jcov.resolve_gram_precision("auto")
    for name in ("default", "bfloat16", "bfloat16_3x", "float32", "highest"):
        assert tcov.resolve_gram_precision(name) == name
    with pytest.raises(ValueError):
        tcov.resolve_gram_precision("tf32")


# -- eigh -------------------------------------------------------------------

def test_eigh_descending_sign_flip_and_evr_match_jax(rng):
    cov = np.cov(rng.normal(size=(80, 9)), rowvar=False)
    je, jv = jeigh.eigh_descending(jnp.asarray(cov))
    te, tv = teigh.eigh_descending(_t(cov))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=TOL)
    np.testing.assert_allclose(teigh.sign_flip(tv).numpy(),
                               np.asarray(jeigh.sign_flip(jv)), atol=1e-8)
    np.testing.assert_allclose(teigh.explained_variance_ratio(te).numpy(),
                               np.asarray(jeigh.explained_variance_ratio(je)),
                               atol=TOL)


def test_pca_from_covariance_eigh_matches_jax(rng):
    cov = np.cov(rng.normal(size=(100, 12)), rowvar=False)
    jpc, jevr = jeigh.pca_from_covariance(jnp.asarray(cov), 5)
    tpc, tevr = teigh.pca_from_covariance(_t(cov), 5)
    np.testing.assert_allclose(tpc.numpy(), np.asarray(jpc), atol=1e-8)
    np.testing.assert_allclose(tevr.numpy(), np.asarray(jevr), atol=TOL)
    np.testing.assert_allclose(
        teigh.pca_postprocess_host(*np.linalg.eigh(cov), 5)[0],
        np.asarray(jpc), atol=1e-8)


@pytest.mark.parametrize("n,k", [(4096, 256), (784, 50), (2048, 512),
                                 (1024, 128), (1023, 8), (1024, 129)])
def test_resolve_auto_solver_matches_jax(n, k):
    assert teigh.resolve_auto_solver(n, k) == jeigh.resolve_auto_solver(n, k)


def test_gated_randomized_matches_jax_on_decaying_spectrum(rng):
    n, k = 1024, 16
    cov = _decaying_cov(rng, n)
    jpc, jevr, jused = jeigh.pca_from_covariance_gated(jnp.asarray(cov), k)
    tpc, tevr, tused = teigh.pca_from_covariance_gated(_t(cov), k)
    assert tused == jused == "randomized"
    # different random starts (jax.random vs torch.Generator): both sit
    # within the documented 1e-3 envelope of the dense solve, so 2e-3
    np.testing.assert_allclose(tpc.numpy(), np.asarray(jpc), atol=2e-3)
    np.testing.assert_allclose(tevr.numpy(), np.asarray(jevr), atol=1e-6)


def test_gate_falls_back_to_eigh_like_jax(rng):
    cov = _decaying_cov(rng, 1024)
    jpc, jevr, jused = jeigh.pca_from_covariance_gated(
        jnp.asarray(cov), 16, residual_rtol=-1.0)
    tpc, tevr, tused = teigh.pca_from_covariance_gated(
        _t(cov), 16, residual_rtol=-1.0)
    assert tused == jused == "eigh(gated)"
    np.testing.assert_allclose(tevr.numpy(), np.asarray(jevr), atol=TOL)
    np.testing.assert_allclose(tpc.numpy(), np.asarray(jpc), atol=1e-8)


def test_gate_passes_the_whitenings_zero_columns_as_jax_does(rng):
    """A top eigenvalue 1e6 above the rest: the randomized solve's
    whitening zeroes nearly every other direction for good, and the
    residual gate, scaled by the mean eigenvalue, passes the zero columns,
    in both packages (float64; ROADMAP's record of it has the card's
    measurement and why the dense float32 solve is no remedy)."""
    n, k = 1024, 128
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = 1.0 / (1.0 + np.arange(n))
    lam[0] = 1e6
    cov = (q * lam) @ q.T
    jpc, _, jused = jeigh.pca_from_covariance_gated(jnp.asarray(cov), k)
    tpc, _, tused = teigh.pca_from_covariance_gated(_t(cov), k)
    assert tused == jused == "randomized"
    for pc in (np.asarray(jpc), tpc.numpy()):
        assert (np.abs(pc).max(axis=0) == 0).sum() > 100
        # the top component itself is exact
        assert abs(abs(pc[:, 0] @ q[:, 0]) - 1.0) < 1e-8


# -- randomized ---------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(64, 6), (200, 20)])
def test_randomized_given_jax_omega_matches_jax(rng, n, k):
    cov = np.cov(_decaying(rng, 4 * n, n), rowvar=False)
    l = min(k + 10, n)
    omega = np.array(jax.random.normal(jax.random.PRNGKey(0), (n, l),
                                         dtype=jnp.float64))
    jpc, jevr = jrand.randomized_pca_from_covariance(
        jnp.asarray(cov), k, jnp.trace(jnp.asarray(cov)))
    tpc, tevr = trand.randomized_pca_from_covariance(
        _t(cov), k, torch.trace(_t(cov)), omega=omega)
    # the same start and the same float64 arithmetic
    np.testing.assert_allclose(tpc.numpy(), np.asarray(jpc), atol=1e-8)
    np.testing.assert_allclose(tevr.numpy(), np.asarray(jevr), atol=TOL)


def test_float32_randomized_keeps_the_tail_of_a_full_rank_spectrum(rng):
    """Whitening in float64: a float32 covariance with a 1/(1+j) spectrum
    gets no zero components (the JAX package's float32 clamp zeroes those
    past about the 45th), and the leading ones match the dense solve."""
    n, k = 1024, 128
    x = rng.normal(size=(8192, n)) * (1.0 + np.arange(n)) ** -0.5
    cov = np.cov(x, rowvar=False).astype(np.float32)
    pc, evr, used = teigh.pca_from_covariance_gated(_t(cov), k)
    assert used == "randomized"
    assert int((pc.abs().sum(dim=0) == 0).sum()) == 0
    assert float(evr.min()) > 0
    evals, evecs = np.linalg.eigh(cov.astype(np.float64))
    cos = np.abs(np.sum(pc.numpy() * evecs[:, ::-1][:, :k], axis=0))
    assert cos[:32].min() > 0.9999


def test_randomized_start_is_seeded_and_explicit(rng):
    cov = _t(np.cov(_decaying(rng, 300, 40), rowvar=False))
    a = trand.randomized_pca_from_covariance(cov, 4, torch.trace(cov), seed=3)
    b = trand.randomized_pca_from_covariance(cov, 4, torch.trace(cov), seed=3)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    omega = torch.randn(40, 14, generator=torch.Generator().manual_seed(3),
                        dtype=cov.dtype)
    c = trand.randomized_pca_from_covariance(cov, 4, torch.trace(cov),
                                             omega=omega)
    np.testing.assert_array_equal(a[0].numpy(), c[0].numpy())


# -- pca_kernel -------------------------------------------------------------

@pytest.mark.parametrize("mean_centering", [True, False])
def test_pca_fit_kernel_masked_matches_jax(rng, mean_centering):
    x = np.concatenate([rng.normal(loc=1.0, size=(37, 5)), np.zeros((27, 5))])
    mask = _mask(64, 37)
    want = jpk.pca_fit_kernel(jnp.asarray(x), 3, mask=jnp.asarray(mask),
                              mean_centering=mean_centering)
    got = tpk.pca_fit_kernel(_t(x), 3, mask=_t(mask),
                             mean_centering=mean_centering)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-8)


def test_transform_kernel_matches_jax_without_centering(rng):
    x = rng.normal(loc=4.0, size=(20, 6))
    pc = rng.normal(size=(6, 3))
    want = np.asarray(jpk.pca_transform_kernel(jnp.asarray(x), jnp.asarray(pc)))
    got = tpk.pca_transform_kernel(_t(x), _t(pc)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got, x @ pc, atol=TOL)


# -- streaming --------------------------------------------------------------

def _chunks(rng, rows=230, d=6, loc=2.0, size=48):
    x = rng.normal(loc=loc, size=(rows, d))
    return x, [x[i:i + size] for i in range(0, rows, size)]


@pytest.mark.parametrize("mean_centering", [True, False])
@pytest.mark.parametrize("reiterable", [True, False])
def test_stream_covariance_matches_jax(rng, mean_centering, reiterable):
    """Two-pass (re-iterable) and one-pass (one-shot) streaming, with a
    masked tail bucket (230 rows in 64-row buckets)."""
    x, chunks = _chunks(rng)

    def src(cls):
        data = (lambda: iter(chunks)) if reiterable else iter(chunks)
        return cls(data, batch_rows=64)

    jc, jm, jn = jstream.stream_covariance(
        src(JaxBatchSource), mean_centering=mean_centering, dtype=jnp.float64)
    tc, tm, tn = tstream.stream_covariance(
        src(BatchSource), mean_centering=mean_centering, dtype=torch.float64)
    assert int(tn) == int(jn) == 230
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=TOL)
    mu = x.mean(0) if mean_centering else np.zeros(6)
    want = (x - mu).T @ (x - mu) / 229
    np.testing.assert_allclose(tc.numpy(), want, atol=1e-10)


class _ShrinkingSource:
    """Claims to be re-iterable but yields fewer rows on its second pass."""

    reiterable = True
    n_features = 4

    def __init__(self, rng):
        self._x = rng.normal(size=(32, 4))
        self._passes = 0

    def batches(self):
        self._passes += 1
        rows = 32 if self._passes == 1 else 16
        yield self._x[:rows], None


def test_stream_covariance_pass_count_check_like_jax(rng):
    with pytest.raises(RuntimeError, match="FRESH iterator"):
        jstream.stream_covariance(_ShrinkingSource(rng), dtype=jnp.float64)
    with pytest.raises(RuntimeError, match="FRESH iterator"):
        tstream.stream_covariance(_ShrinkingSource(rng), dtype=torch.float64)


@pytest.mark.parametrize("solver", ["eigh", "randomized"])
def test_streaming_pca_matches_jax(rng, solver):
    n, d, k = 300, 32, 4
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    x = rng.normal(size=(n, d)) @ (q * 2.0 ** (-np.arange(d)))
    js = jstream.StreamingPCA(d, dtype=jnp.float64)
    ts = tstream.StreamingPCA(d, dtype=torch.float64)
    for i in range(0, n, 100):
        js.partial_fit(jnp.asarray(x[i:i + 100]))
        ts.partial_fit(x[i:i + 100])
    assert ts.rows_seen == js.rows_seen == n
    want = js.finalize(k, solver=solver)
    got = ts.finalize(k, solver=solver)
    # eigh: same arithmetic; randomized: different random starts, the
    # envelope tests/test_pca_oracle.py allows this spectrum (2e-3)
    atol = 1e-8 if solver == "eigh" else 2e-3
    np.testing.assert_allclose(np.abs(got.components.numpy()),
                               np.abs(np.asarray(want.components)), atol=atol)
    np.testing.assert_allclose(got.explained_variance.numpy(),
                               np.asarray(want.explained_variance), atol=atol)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               atol=TOL)


def test_update_stats_masked_tail_matches_jax(rng):
    x = rng.normal(size=(64, 5))
    mask = _mask(64, 40)
    jst = jstream.update_stats(jstream.init_stats(5, dtype=jnp.float64),
                               jnp.asarray(x), jnp.asarray(mask))
    tst = tstream.update_stats(tstream.init_stats(5, dtype=torch.float64),
                               x, mask.astype(bool))
    np.testing.assert_allclose(tst.gram.numpy(), np.asarray(jst.gram), atol=TOL)
    np.testing.assert_allclose(tst.col_sum.numpy(), np.asarray(jst.col_sum),
                               atol=TOL)
    assert int(tst.count) == int(jst.count) == 40
