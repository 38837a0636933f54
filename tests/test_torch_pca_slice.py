"""The PCA slice as a whole: ``PCA().fit`` → ``transform`` → save/load in
the port against the JAX package, on the same numpy inputs.

float64 fits are held at tests/test_pca_oracle.py's 1e-5 bar against both
the numpy oracle and the JAX package. The JAX package's dtype='auto' is
float64 in this suite (tests/conftest.py turns x64 on) while the port's
'auto' is float32, so every comparison names its dtype.
"""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu import PCAModel as JaxPCAModel
from spark_rapids_ml_tpu_torch import PCA, PCAModel
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
from spark_rapids_ml_tpu_torch.data.vector import Vectors
from spark_rapids_ml_tpu_torch.ops import fused_gram

from conftest import numpy_pca_oracle

ABS_TOL = 1e-5

PATHS = [(True, True), (True, False), (False, True), (False, False)]


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def _features(model_or_frame, x, col="pca_features"):
    return np.asarray(model_or_frame.transform(x).column(col))


def _decaying(rng, rows, d, loc=5.0):
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return rng.normal(size=(rows, d)) @ (q * 3.0 ** (-np.arange(d) / 4)) + loc


@pytest.mark.parametrize("dot,svd", PATHS)
def test_fit_transform_matches_jax_and_oracle(rng, dot, svd):
    x = rng.normal(size=(60, 8))
    k = 5
    pc, evr, mean = numpy_pca_oracle(x, k)
    port = (PCA().setK(k).setUseXlaDot(dot).setUseXlaSvd(svd)
            .setDtype("float64").fit(x))
    ref = (JaxPCA().setK(k).setUseXlaDot(dot).setUseXlaSvd(svd)
           .setDtype("float64").fit(x))
    for got, want in ((port.pc, pc), (port.explained_variance, evr),
                      (port.mean, mean), (port.pc, ref.pc),
                      (port.explained_variance, ref.explained_variance)):
        np.testing.assert_allclose(got, want, atol=ABS_TOL)
    np.testing.assert_allclose(_features(port, x), _features(ref, x),
                               atol=ABS_TOL)


@pytest.mark.parametrize("dot,svd", PATHS)
def test_mean_centering_false_matches_jax(rng, dot, svd):
    x = rng.normal(loc=3.0, size=(50, 5))
    port = (PCA().setK(2).setMeanCentering(False).setUseXlaDot(dot)
            .setUseXlaSvd(svd).setDtype("float64").fit(x))
    ref = (JaxPCA().setK(2).setMeanCentering(False).setUseXlaDot(dot)
           .setUseXlaSvd(svd).setDtype("float64").fit(x))
    np.testing.assert_allclose(port.pc, ref.pc, atol=ABS_TOL)
    np.testing.assert_allclose(port.explained_variance,
                               ref.explained_variance, atol=ABS_TOL)
    np.testing.assert_allclose(port.mean, np.zeros(5), atol=0)


@pytest.mark.parametrize("precision", ["auto", "highest", "bfloat16_3x"])
def test_float32_fit_matches_jax(rng, precision):
    """float32 in both packages: JAX on the CPU computes its f32 Gram in
    full f32, the port rounds as its gramPrecision says; on this spectrum
    the components agree to 1e-4 (f32 eigenvectors of O(1)-gapped data)."""
    x = _decaying(rng, 400, 16)
    port = (PCA().setK(4).setDtype("float32").setGramPrecision(precision)
            .fit(x))
    ref = JaxPCA().setK(4).setDtype("float32").fit(x)
    np.testing.assert_allclose(port.pc, ref.pc, atol=1e-4)
    np.testing.assert_allclose(port.explained_variance,
                               ref.explained_variance, atol=1e-5)
    np.testing.assert_allclose(port.mean, ref.mean, rtol=1e-6)


def test_port_auto_dtype_is_float32(rng):
    x = _decaying(rng, 200, 6)
    auto = PCA().setK(2).fit(x)
    f32 = PCA().setK(2).setDtype("float32").fit(x)
    np.testing.assert_array_equal(auto.pc, f32.pc)


@pytest.mark.parametrize("solver", ["eigh", "randomized", "auto"])
def test_svd_solvers_match_jax_on_decaying_spectrum(rng, solver):
    # 1024 features, k = 8: 'auto' resolves to the gated randomized solve
    x = _decaying(rng, 1100, 1024)
    k = 8
    port = PCA().setK(k).setSvdSolver(solver).setDtype("float64").fit(x)
    ref = JaxPCA().setK(k).setSvdSolver(solver).setDtype("float64").fit(x)
    assert port.svd_solver_used_ == ref.svd_solver_used_
    # different random starts for the randomized arms: compare by
    # component-wise |cos| and EVR
    cos = np.abs(np.sum(port.pc * ref.pc, axis=0))
    assert cos.min() > 1 - 1e-6
    np.testing.assert_allclose(port.explained_variance,
                               ref.explained_variance, rtol=1e-6)


@pytest.mark.parametrize("dot,svd", PATHS)
def test_streamed_factory_matches_jax(rng, dot, svd):
    x = rng.normal(loc=1.0, size=(230, 6))
    chunks = [x[i:i + 50] for i in range(0, 230, 50)]
    port = (PCA().setK(3).setBatchRows(64).setUseXlaDot(dot)
            .setUseXlaSvd(svd).setDtype("float64").fit(lambda: iter(chunks)))
    ref = (JaxPCA().setK(3).setBatchRows(64).setUseXlaDot(dot)
           .setUseXlaSvd(svd).setDtype("float64").fit(lambda: iter(chunks)))
    pc, evr, mean = numpy_pca_oracle(x, 3)
    for model in (port, ref):
        np.testing.assert_allclose(model.pc, pc, atol=ABS_TOL)
        np.testing.assert_allclose(model.explained_variance, evr, atol=ABS_TOL)
        np.testing.assert_allclose(model.mean, mean, atol=ABS_TOL)


def test_one_shot_generator_matches_jax(rng):
    """A one-shot iterator takes the one-pass (Σxxᵀ, Σx, n) path in both."""
    x = rng.normal(size=(230, 6))
    port = (PCA().setK(3).setBatchRows(64).setDtype("float64")
            .fit(iter([x[:100], x[100:]])))
    ref = (JaxPCA().setK(3).setBatchRows(64).setDtype("float64")
           .fit(iter([x[:100], x[100:]])))
    pc, evr, _ = numpy_pca_oracle(x, 3)
    np.testing.assert_allclose(port.pc, ref.pc, atol=ABS_TOL)
    np.testing.assert_allclose(port.pc, pc, atol=ABS_TOL)
    np.testing.assert_allclose(port.explained_variance, evr, atol=ABS_TOL)


def test_size_threshold_streams_like_jax(rng, monkeypatch):
    x = rng.normal(size=(300, 8))
    monkeypatch.setenv("TPUML_STREAM_THRESHOLD_BYTES", "1024")
    port = PCA().setK(3).setBatchRows(128).setDtype("float64").fit(x)
    ref = JaxPCA().setK(3).setBatchRows(128).setDtype("float64").fit(x)
    assert "densify" in port.fit_timings_ and "covariance" in port.fit_timings_
    np.testing.assert_allclose(port.pc, ref.pc, atol=ABS_TOL)


def test_dense_and_sparse_rows_agree(rng):
    x = rng.normal(size=(40, 5))
    x[x < 0.3] = 0.0
    dense = [Vectors.dense(r) for r in x]
    sparse = [Vectors.sparse(5, np.flatnonzero(r), r[r != 0]) for r in x]
    a = PCA().setK(2).setDtype("float64").fit(VectorFrame({"features": dense}))
    b = PCA().setK(2).setDtype("float64").fit(VectorFrame({"features": sparse}))
    np.testing.assert_allclose(a.pc, b.pc, atol=1e-12)


def test_k_and_row_validation_like_jax(rng):
    x = rng.normal(size=(10, 4))
    for cls in (PCA, JaxPCA):
        with pytest.raises(ValueError, match="at most"):
            cls().setK(5).fit(x)
        with pytest.raises(ValueError, match="k must be set"):
            cls().fit(x)
        with pytest.raises(ValueError, match="more than one row"):
            cls().setK(1).fit(x[:1])


def test_from_numpy_carries_a_jax_model_across(rng):
    x = _decaying(rng, 120, 7)
    ref = JaxPCA().setK(3).setDtype("float64").fit(x)
    port = PCAModel.from_numpy(ref.pc, ref.explained_variance, ref.mean)
    assert port.getK() == 3
    port.setDtype("float64")
    np.testing.assert_allclose(_features(port, x), _features(ref, x),
                               atol=1e-10)
    with pytest.raises(ValueError):
        PCAModel.from_numpy(ref.pc, ref.explained_variance[:2])


def test_transform_projects_raw_rows_on_both_paths(rng):
    x = rng.normal(loc=2.0, size=(50, 6))
    model = PCA().setK(3).setDtype("float64").fit(x)
    dev = _features(model, x)
    np.testing.assert_allclose(dev, x @ model.pc, atol=ABS_TOL)
    model.setUseXlaDot(False)
    np.testing.assert_allclose(_features(model, x), dev, atol=ABS_TOL)


@pytest.mark.parametrize("pyarrow", [True, False])
def test_save_in_port_load_in_jax(rng, tmp_path, monkeypatch, pyarrow):
    """Without pyarrow (the GPU machine has none) the port writes the JSON
    payload, which the JAX reader accepts."""
    if not pyarrow:
        monkeypatch.setitem(__import__("sys").modules, "pyarrow", None)
    x = rng.normal(size=(80, 6))
    port = PCA().setK(3).setDtype("float64").setOutputCol("z").fit(x)
    port.save(str(tmp_path / "m"))
    payload = "part-00000.parquet" if pyarrow else "part-00000.json"
    assert (tmp_path / "m" / "data" / payload).exists()
    monkeypatch.delitem(__import__("sys").modules, "pyarrow", raising=False)
    loaded = JaxPCAModel.load(str(tmp_path / "m"))
    assert loaded.getOutputCol() == "z" and loaded.getK() == 3
    np.testing.assert_allclose(_features(loaded, x, "z"),
                               _features(port, x, "z"), atol=1e-10)


def test_save_in_jax_load_in_port(rng, tmp_path):
    x = rng.normal(size=(80, 6))
    ref = JaxPCA().setK(3).setDtype("float64").setMeanCentering(False).fit(x)
    ref.save(str(tmp_path / "m"))
    port = PCAModel.load(str(tmp_path / "m"))
    assert port.uid == ref.uid and not port.getMeanCentering()
    np.testing.assert_allclose(port.pc, ref.pc, atol=0)
    np.testing.assert_allclose(_features(port, x), _features(ref, x),
                               atol=1e-10)


def test_estimator_params_round_trip_across_packages(tmp_path):
    est = PCA().setK(4).setGramPrecision("highest").setSvdSolver("eigh")
    est.save(str(tmp_path / "e"))
    ref = JaxPCA.load(str(tmp_path / "e"))
    assert (ref.getK(), ref.getGramPrecision(), ref.getSvdSolver()) == (
        4, "highest", "eigh")
    back = PCA.load(str(tmp_path / "e"))
    assert back.param_map_for_metadata() == est.param_map_for_metadata()


def test_save_refuses_existing_path_without_overwrite(rng, tmp_path):
    model = PCA().setK(2).fit(rng.normal(size=(20, 4)))
    model.save(str(tmp_path / "m"))
    with pytest.raises(FileExistsError):
        model.save(str(tmp_path / "m"))
    model.write().overwrite().save(str(tmp_path / "m"))
    assert PCAModel.read().load(str(tmp_path / "m")).pc.shape == (4, 2)


def test_cpu_fit_launches_no_kernel_and_records_timings(rng):
    fused_gram.reset_launches()
    model = PCA().setK(2).fit(rng.normal(size=(64, 8)))
    assert sum(fused_gram.launches.values()) == 0
    assert {"densify", "h2d", "fit_kernel"} <= set(model.fit_timings_)
