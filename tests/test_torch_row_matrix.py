"""RowMatrix in the port against the JAX package's, on the same numpy inputs.

The cases of tests/test_row_matrix.py, each run through both packages.
The JAX suite runs with x64 (tests/conftest.py), so its device path is
float64; the port's device dtype is float32 unless a test sets the
module's ``_DTYPE`` seam to float64. Every device case runs in both:

* float64 (the seam): held to the JAX package at 1e-10 (covariance,
  components, EVR, projection; both sum the same float64 products in
  another order);
* float32 (the port's dtype; on the CPU the Gram kernel's plain version,
  default precision bfloat16_3x): held to the JAX package at
  tests/test_row_matrix.py's own oracle bar, ABS_TOL = 1e-5.

The host paths are numpy float64 in both packages: 1e-10.
"""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.linalg import RowMatrix as JaxRowMatrix
from spark_rapids_ml_tpu.linalg import triu_to_full as jax_triu_to_full
from spark_rapids_ml_tpu.linalg.row_matrix import (
    _full_to_triu as jax_full_to_triu,
)
from spark_rapids_ml_tpu_torch import RowMatrix as TopLevelRowMatrix
from spark_rapids_ml_tpu_torch.linalg import (
    MAX_SPR_COLS,
    RowMatrix,
    row_matrix,
    triu_to_full,
)
from spark_rapids_ml_tpu_torch.ops import covariance as cov_ops

from conftest import numpy_pca_oracle

ABS_TOL = 1e-5      # tests/test_row_matrix.py's bar: float32 runs
F64_TOL = 1e-10     # float64 in both packages
DTYPES = ["float64", "float32"]


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


@pytest.fixture
def dtype(request, monkeypatch):
    """The port's device dtype for one case, through the module seam."""
    monkeypatch.setattr(row_matrix, "_DTYPE", getattr(torch, request.param))
    return request.param


def _tol(dtype, on_device=True):
    return ABS_TOL if (dtype == "float32" and on_device) else F64_TOL


def _aligned(a, ref):
    signs = np.sign(np.sum(a * ref, axis=0))
    signs[signs == 0] = 1.0
    return a * signs


def test_lazy_dims_and_partitions(rng):
    x = rng.normal(size=(23, 5))
    ours, ref = RowMatrix(x, num_partitions=4), JaxRowMatrix(x, num_partitions=4)
    assert (ours.num_rows(), ours.num_cols(), ours.num_partitions) == \
        (ref.num_rows(), ref.num_cols(), ref.num_partitions) == (23, 5, 4)
    np.testing.assert_array_equal(ours.to_numpy(), ref.to_numpy())
    assert TopLevelRowMatrix is RowMatrix


def test_float32_partitions_stay_float32(rng):
    """A float32 matrix is kept as it is (copied to the card unwidened);
    other inputs become float64, as in the JAX package."""
    x = rng.normal(size=(12, 3))
    assert RowMatrix(x.astype(np.float32)).to_numpy().dtype == np.float32
    assert RowMatrix(x).to_numpy().dtype == np.float64
    assert RowMatrix(x.astype(np.int64)).to_numpy().dtype == np.float64
    assert RowMatrix(list(x)).to_numpy().dtype == np.float64


@pytest.mark.parametrize("dtype", DTYPES, indirect=True)
@pytest.mark.parametrize("use_xla_dot", [True, False])
@pytest.mark.parametrize("mean_centering", [True, False])
def test_covariance_matches_jax(rng, dtype, use_xla_dot, mean_centering):
    # rectangular: numRows != numCols catches the reference's
    # numCols-normalizer bug (RapidsRowMatrix.scala:169 vs :241)
    x = rng.normal(size=(57, 9))
    kw = dict(mean_centering=mean_centering, use_xla_dot=use_xla_dot,
              num_partitions=3)
    ours = RowMatrix(x, **kw).compute_covariance()
    ref = JaxRowMatrix(x, **kw).compute_covariance()
    assert ours.dtype == np.float64 and ours.shape == (9, 9)
    np.testing.assert_allclose(ours, ref, atol=_tol(dtype, use_xla_dot),
                               rtol=0)


@pytest.mark.parametrize("dtype", DTYPES, indirect=True)
def test_covariance_partitioned_input_chunks(rng, dtype):
    chunks = [rng.normal(size=(n, 6)) for n in (11, 3, 20)]
    ours, ref = RowMatrix(chunks), JaxRowMatrix(chunks)
    assert ours.num_partitions == ref.num_partitions == 3
    np.testing.assert_allclose(ours.compute_covariance(),
                               ref.compute_covariance(),
                               atol=_tol(dtype), rtol=0)


def test_device_covariance_takes_one_gram_per_partition(rng, monkeypatch):
    """Each partition is one Gram through the kernel's wrapper (on the card
    one launch), folded into one accumulator."""
    calls = []
    real = cov_ops.fused_centered_gram

    def counted(x, mean, rowmul, precision=None):
        calls.append(tuple(x.shape))
        return real(x, mean, rowmul, precision)

    monkeypatch.setattr(cov_ops, "fused_centered_gram", counted)
    x = rng.normal(size=(40, 7)).astype(np.float32)
    RowMatrix(x, num_partitions=4).compute_covariance()
    assert calls == [(10, 7)] * 4
    calls.clear()
    RowMatrix(x, use_xla_dot=False).compute_covariance()
    assert calls == []


@pytest.mark.parametrize("dtype", DTYPES, indirect=True)
@pytest.mark.parametrize("use_xla_dot", [True, False])
@pytest.mark.parametrize("use_xla_svd", [True, False])
def test_pca_driver_matches_jax_and_oracle(rng, dtype, use_xla_dot,
                                           use_xla_svd):
    x = rng.normal(size=(48, 7))
    k = 4
    kw = dict(use_xla_dot=use_xla_dot, use_xla_svd=use_xla_svd,
              num_partitions=2)
    pc, evr = RowMatrix(x, **kw).compute_principal_components_and_explained_variance(k)
    pc_ref, evr_ref = JaxRowMatrix(x, **kw).compute_principal_components_and_explained_variance(k)
    pc_exp, evr_exp, _ = numpy_pca_oracle(x, k)
    tol = _tol(dtype, use_xla_dot or use_xla_svd)
    assert pc.dtype == evr.dtype == np.float64
    np.testing.assert_allclose(pc, pc_ref, atol=tol, rtol=0)
    np.testing.assert_allclose(evr, evr_ref, atol=tol, rtol=0)
    np.testing.assert_allclose(pc, pc_exp, atol=ABS_TOL)
    np.testing.assert_allclose(evr, evr_exp, atol=ABS_TOL)


@pytest.mark.parametrize("dtype", DTYPES, indirect=True)
def test_k_equals_n_full_basis(rng, dtype):
    x = rng.normal(size=(30, 6))
    pc, evr = RowMatrix(x).compute_principal_components_and_explained_variance(6)
    pc_ref, evr_ref = JaxRowMatrix(x).compute_principal_components_and_explained_variance(6)
    assert pc.shape == (6, 6)
    np.testing.assert_allclose(evr.sum(), 1.0, atol=ABS_TOL)
    # orthonormal columns, at the device dtype's precision
    np.testing.assert_allclose(pc.T @ pc, np.eye(6),
                               atol=1e-8 if dtype == "float64" else 1e-6)
    np.testing.assert_allclose(_aligned(pc, pc_ref), pc_ref,
                               atol=_tol(dtype), rtol=0)
    np.testing.assert_allclose(evr, evr_ref, atol=_tol(dtype), rtol=0)


def test_triu_to_full_round_trip_matches_jax(rng):
    a = rng.normal(size=(7, 7))
    sym = (a + a.T) / 2
    packed = row_matrix._full_to_triu(sym)
    np.testing.assert_array_equal(packed, jax_full_to_triu(sym))
    np.testing.assert_array_equal(triu_to_full(7, packed),
                                  jax_triu_to_full(7, packed))
    np.testing.assert_allclose(triu_to_full(7, packed), sym)
    assert MAX_SPR_COLS == 65535


def _wide(cls):
    m = cls(np.zeros((2, 3)), use_xla_dot=False)
    m._num_cols = MAX_SPR_COLS + 1  # simulate a too-wide matrix
    return m


# name → (call on a package's (RowMatrix, triu_to_full), message pattern)
ERRORS = {
    "k_above_n": (lambda cls, _t: cls(np.ones((10, 4)))
                  .compute_principal_components_and_explained_variance(5),
                  "out of range"),
    "k_zero": (lambda cls, _t: cls(np.ones((10, 4)))
               .compute_principal_components_and_explained_variance(0),
               "out of range"),
    "one_row_centred": (lambda cls, _t: cls(np.ones((1, 3)))
                        .compute_covariance(), "more than one row"),
    "triu_bad_length": (lambda _c, t: t(4, np.zeros(9)), "does not match"),
    "packed_column_limit": (lambda cls, _t: _wide(cls).compute_covariance(),
                            "at most"),
    "multiply_shape": (lambda cls, _t: cls(np.ones((10, 4)))
                       .multiply(np.zeros((5, 2))), "expected 4"),
    "inconsistent_columns": (lambda cls, _t: cls([np.ones((3, 4)),
                                                  np.ones((3, 5))]),
                             "inconsistent column counts"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_both_packages_refuse_the_same_input(case):
    call, pattern = ERRORS[case]
    for pkg in ((RowMatrix, triu_to_full), (JaxRowMatrix, jax_triu_to_full)):
        with pytest.raises(ValueError, match=pattern):
            call(*pkg)


@pytest.mark.parametrize("dtype", DTYPES, indirect=True)
@pytest.mark.parametrize("use_xla_dot", [True, False])
def test_multiply_projection_matches_jax(rng, dtype, use_xla_dot):
    # the test-oracle op: mat.multiply(pc) (PCASuite.scala:50-54)
    x = rng.normal(size=(25, 6))
    p = rng.normal(size=(6, 3))
    ours = RowMatrix(x, use_xla_dot=use_xla_dot, num_partitions=2).multiply(p)
    ref = JaxRowMatrix(x, use_xla_dot=use_xla_dot, num_partitions=2).multiply(p)
    assert (ours.num_rows(), ours.num_cols(), ours.num_partitions) == (25, 3, 2)
    out = ours.to_numpy()
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, ref.to_numpy(),
                               atol=_tol(dtype, use_xla_dot), rtol=0)
    np.testing.assert_allclose(out, x @ p, atol=ABS_TOL)


def test_device_paths_need_a_device_or_the_cpu_request(rng, monkeypatch):
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = rng.normal(size=(20, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RowMatrix(x).compute_covariance()
    # the host paths never touch a device
    pc, _ = RowMatrix(x, use_xla_dot=False, use_xla_svd=False) \
        .compute_principal_components_and_explained_variance(2)
    assert pc.shape == (4, 2)
