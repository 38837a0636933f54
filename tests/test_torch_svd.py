"""TruncatedSVD in the port against the JAX package's and the numpy SVD
oracle, on the same numpy inputs.

The cases of tests/test_svd.py, each run through both packages. The JAX
suite runs with x64 (tests/conftest.py), so its 'auto' dtype is float64;
the port's is float32, so every comparison names its dtype:

* float64 in both: σ at tests/test_svd.py's own bar against the oracle
  (rtol 1e-9) and against the JAX package (rtol 1e-9), components at its
  1e-5 against the oracle and 1e-8 against the JAX package;
* float32 in the port (on the CPU the Gram kernel's plain version, at
  gramPrecision highest and the default bfloat16_3x): σ within 1e-5
  relative and components within 1e-4 of the float64 JAX fit, on a
  spectrum whose singular values are 3 % apart or more.
"""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu import TruncatedSVD as JaxTruncatedSVD
from spark_rapids_ml_tpu import TruncatedSVDModel as JaxTruncatedSVDModel
from spark_rapids_ml_tpu_torch import PCA, TruncatedSVD, TruncatedSVDModel
from spark_rapids_ml_tpu_torch.feature import TruncatedSVD as FeatureSVD
from spark_rapids_ml_tpu_torch.ops import covariance as cov_ops

ABS_TOL = 1e-5
PATHS = [(True, True), (True, False), (False, True), (False, False)]


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


@pytest.fixture
def data(rng):
    # non-degenerate spectrum: scale columns so singular values separate
    return rng.normal(size=(300, 24)) * np.linspace(5.0, 0.5, 24)[None, :]


def _oracle(x, k):
    _, s, vt = np.linalg.svd(x, full_matrices=False)
    return vt[:k].T, s[:k]


def _features(model, x):
    return np.asarray(model.transform(x).column(model.getOutputCol()))


@pytest.mark.parametrize("use_dot,use_svd", PATHS)
def test_svd_matches_jax_and_oracle(data, use_dot, use_svd):
    k = 5
    port = (TruncatedSVD().setK(k).setUseXlaDot(use_dot).setUseXlaSvd(use_svd)
            .setDtype("float64").fit(data))
    ref = (JaxTruncatedSVD().setK(k).setUseXlaDot(use_dot)
           .setUseXlaSvd(use_svd).setDtype("float64").fit(data))
    v_ref, s_ref = _oracle(data, k)
    np.testing.assert_allclose(port.singular_values, s_ref, rtol=1e-9)
    np.testing.assert_allclose(port.singular_values, ref.singular_values,
                               rtol=1e-9)
    np.testing.assert_allclose(np.abs(port.components), np.abs(v_ref),
                               atol=ABS_TOL)
    np.testing.assert_allclose(port.components, ref.components, atol=1e-8)
    assert port.svd_solver_used_ == ref.svd_solver_used_
    assert set(port.fit_timings_) == set(ref.fit_timings_)


@pytest.mark.parametrize("precision", ["highest", "bfloat16_3x"])
def test_float32_fit_matches_jax(data, monkeypatch, precision):
    monkeypatch.setenv("TPUML_GRAM_PRECISION", precision)
    k = 5
    port = TruncatedSVD().setK(k).fit(data)            # 'auto': float32
    ref = JaxTruncatedSVD().setK(k).setDtype("float64").fit(data)
    np.testing.assert_allclose(port.singular_values, ref.singular_values,
                               rtol=1e-5)
    np.testing.assert_allclose(port.components, ref.components, atol=1e-4)


def test_the_uncentred_gram_goes_through_the_kernel(data, monkeypatch):
    """float32 on the device: one Gram, through the kernel's wrapper with no
    mean and unit rows (on the card one launch); float64 and the host Gram
    never reach it."""
    calls = []
    real = cov_ops.fused_centered_gram

    def counted(x, mean, rowmul, precision=None):
        calls.append((tuple(x.shape), float(mean.abs().max()),
                      float((rowmul - 1).abs().max())))
        return real(x, mean, rowmul, precision)

    monkeypatch.setattr(cov_ops, "fused_centered_gram", counted)
    model = TruncatedSVD().setK(3).fit(data)
    assert calls == [((300, 24), 0.0, 0.0)]
    assert {"densify", "h2d", "gram", "solve"} <= set(model.fit_timings_)
    calls.clear()
    TruncatedSVD().setK(3).setDtype("float64").fit(data)
    TruncatedSVD().setK(3).setUseXlaDot(False).fit(data)
    assert calls == []


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-8), ("float32", 1e-4)])
def test_svd_transform_is_projection(data, dtype, tol):
    port = TruncatedSVD().setK(4).setDtype(dtype).fit(data)
    ref = JaxTruncatedSVD().setK(4).fit(data)
    out = _features(port, data[:50])
    np.testing.assert_allclose(out, data[:50] @ port.components, atol=1e-8
                               if dtype == "float64" else 1e-4)
    np.testing.assert_allclose(out, _features(ref, data[:50]),
                               atol=tol * np.abs(out).max())


def test_svd_sign_convention(data):
    # max-|.| entry of every component is positive (calSVD's signFlip,
    # rapidsml_jni.cu:37-64)
    v = np.asarray(TruncatedSVD().setK(6).fit(data).components)
    assert (v[np.abs(v).argmax(axis=0), np.arange(v.shape[1])] > 0).all()


@pytest.mark.parametrize("saver,loader", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_svd_persistence_across_packages(data, tmp_path, saver, loader):
    fit_cls = {"port": TruncatedSVD, "jax": JaxTruncatedSVD}[saver]
    model = fit_cls().setK(3).setOutputCol("o").fit(data)
    p = str(tmp_path / "m")
    model.save(p)
    back = {"port": TruncatedSVDModel, "jax": JaxTruncatedSVDModel}[loader].load(p)
    np.testing.assert_array_equal(back.components, model.components)
    np.testing.assert_array_equal(back.singular_values, model.singular_values)
    assert back.getOutputCol() == "o"
    assert back.getK() == 3
    assert back.uid == model.uid
    # the estimator's params travel too (Spark's DefaultParamsWritable)
    est = TruncatedSVD().setK(4).setSvdSolver("eigh")
    est.save(str(tmp_path / "est"))
    assert FeatureSVD.load(str(tmp_path / "est")).getSvdSolver() == "eigh"


def test_svd_k_validation(data):
    for cls in (TruncatedSVD, JaxTruncatedSVD):
        with pytest.raises(ValueError, match="k must be set"):
            cls().fit(data)
        with pytest.raises(ValueError, match="number of features"):
            cls().setK(25).fit(data)


def test_svd_relates_to_pca_without_centering(rng):
    # on pre-centered data, PCA components == SVD components
    x = rng.normal(size=(400, 12)) * np.linspace(3, 1, 12)[None, :]
    x = x - x.mean(axis=0)
    k = 4
    svd = TruncatedSVD().setK(k).setDtype("float64").fit(x)
    pca = PCA().setK(k).setDtype("float64").fit(x)
    np.testing.assert_allclose(np.abs(svd.components), np.abs(pca.pc),
                               atol=1e-6)
    ref = JaxPCA().setK(k).fit(x)
    np.testing.assert_allclose(np.abs(svd.components), np.abs(ref.pc),
                               atol=1e-6)


def test_svd_transform_rejects_width_mismatch_and_clobber(data):
    for cls in (TruncatedSVD, JaxTruncatedSVD):
        model = cls().setK(3).fit(data)
        with pytest.raises(ValueError, match="features"):
            model.transform(data[:10, :7])
        out = model.transform(data[:10])
        with pytest.raises(ValueError, match="already exists"):
            model.transform(out)  # output col present -> must not clobber


def test_svd_auto_solver_matches_eigh_on_decaying_spectrum(rng):
    """svdSolver='auto' (gated randomized) reproduces the dense result on
    a decaying spectrum at large n, records its choice, and agrees with the
    JAX package's dense fit (float64 in both)."""
    n_feat, k = 1100, 6
    x = rng.normal(size=(300, 30)) * (0.8 ** np.arange(30))[None, :]
    x = x @ rng.normal(size=(30, n_feat)) + 0.01 * rng.normal(
        size=(300, n_feat)
    )
    auto = TruncatedSVD().setK(k).setDtype("float64").fit(x)
    dense = TruncatedSVD().setK(k).setSvdSolver("eigh").setDtype(
        "float64").fit(x)
    ref = JaxTruncatedSVD().setK(k).setSvdSolver("eigh").fit(x)
    assert auto.svd_solver_used_ in ("randomized", "eigh(gated)")
    assert dense.svd_solver_used_ == ref.svd_solver_used_ == "eigh"
    np.testing.assert_allclose(auto.singular_values, dense.singular_values,
                               rtol=1e-6)
    np.testing.assert_allclose(dense.singular_values, ref.singular_values,
                               rtol=1e-9)
    # subspace agreement: each auto vector lies (almost) fully inside the
    # dense top-k subspace — robust to rotation within eigenvalue clusters
    proj = dense.components.T @ auto.components     # (k, k)
    np.testing.assert_allclose(np.linalg.norm(proj, axis=0), 1.0, atol=1e-4)


def test_device_fit_needs_a_device_or_the_cpu_request(data, monkeypatch):
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TruncatedSVD().setK(2).fit(data)
    model = TruncatedSVD().setK(2).setUseXlaDot(False).setUseXlaSvd(False) \
        .fit(data)
    assert model.components.shape == (24, 2)
