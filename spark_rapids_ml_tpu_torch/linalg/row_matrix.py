"""RowMatrix — the distributed row-matrix layer, on PyTorch.

Counterpart of the JAX package's ``linalg/row_matrix.py``, itself the
equivalent of the source system's ``RapidsRowMatrix``
(``RapidsRowMatrix.scala:30-289``): the layer between the Estimator and the
device kernels, owning the "partition-level partial aggregation, then
global combine" schedule.

* ``num_rows()`` / ``num_cols()`` are lazy (``RapidsRowMatrix.scala:48-57,
  128-140``).
* ``compute_covariance()`` has two paths, selected by ``use_xla_dot`` (the
  reference's ``useGemm``, ``RapidsRowMatrix.scala:168-252``). The device
  path folds each partition into one device-resident (Σxxᵀ, Σx, n)
  accumulator (``ops.streaming.update_stats``): one Gram per partition,
  which on the card is one launch of the hand kernel
  (``csrc/fused_gram.cu``), then ``covariance_from_stats``. The host path
  keeps the reference's packed upper-triangular accumulator and
  ``triu_to_full`` in numpy float64, with its n ≤ 65535 limit (``:147``),
  normalises by numRows − 1 and supports ``mean_centering=False``.
* ``compute_principal_components_and_explained_variance(k)`` follows
  ``RapidsRowMatrix.scala:75-125``; ``use_xla_svd`` selects the device
  ``eigh`` (``ops.eigh.pca_from_covariance``) or the host
  ``np.linalg.eigh``, and explained variance is λ/Σλ on both.
* ``multiply`` projects every partition (``ops.pca_kernel``'s transform on
  the device, numpy on the host).

The device computes in float32, the port's ``'auto'`` dtype and what the
JAX class does without x64; the JAX class takes float64 from
``jax_enable_x64``. There is no public dtype parameter: ``_DTYPE`` below is
a module-level seam that the parity tests set to ``torch.float64`` to hold
the port against the JAX package under x64.

Partitions keep a floating input's dtype (float32 or float64) on the host;
anything else becomes float64. A float32 matrix is thus copied to the card
as it is, where the JAX class first widens it to float64; the host paths
widen each partition to float64 where they compute.

Without a CUDA device, the device paths raise unless the CPU is requested
(``SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu``); the host paths never touch a
device. The native host library is not ported: the host paths are numpy.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.utils.resources import resolve_device
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

# Packed upper-triangular length n(n+1)/2 must stay addressable with the
# reference's Int-based packed indexing (RapidsRowMatrix.scala:147,204-206).
MAX_SPR_COLS = 65535

# The device dtype (see the module docstring): a seam for the parity tests.
_DTYPE = torch.float32


def triu_to_full(n: int, packed: np.ndarray) -> np.ndarray:
    """Expand a column-major packed upper triangle into a full symmetric
    matrix — the reference's ``triuToFull`` (``RapidsRowMatrix.scala:266-288``),
    vectorized. ``packed[j*(j+1)/2 + i]`` holds element (i, j), i ≤ j.
    """
    packed = np.asarray(packed, dtype=np.float64)
    expected = n * (n + 1) // 2
    if packed.shape != (expected,):
        raise ValueError(
            f"packed length {packed.shape} does not match n={n} "
            f"(expected {expected})"
        )
    full = np.zeros((n, n), dtype=np.float64)
    rows, cols = np.triu_indices(n)
    # column-major packed order: for column j, rows 0..j
    full[rows, cols] = packed[cols * (cols + 1) // 2 + rows]
    full[cols, rows] = full[rows, cols]
    return full


def _full_to_triu(m: np.ndarray) -> np.ndarray:
    """Pack the upper triangle of a symmetric matrix, column-major."""
    n = m.shape[0]
    rows, cols = np.triu_indices(n)
    packed = np.zeros(n * (n + 1) // 2, dtype=np.float64)
    packed[cols * (cols + 1) // 2 + rows] = m[rows, cols]
    return packed


def _as_float(a) -> np.ndarray:
    """float32 and float64 arrays as they are, anything else as float64."""
    a = np.asarray(a)
    if a.dtype in (np.float32, np.float64):
        return a
    return a.astype(np.float64)


def _as_partitions(rows, num_partitions: Optional[int]) -> List[np.ndarray]:
    """Normalize input into a list of 2-D float chunks (the "partitions").

    Accepts a 2-D array, an iterable of vectors, or an iterable of 2-D
    chunks. ``num_partitions`` re-chunks a monolithic input so the
    partial-aggregate schedule is exercised like the reference's
    ``sc.parallelize(data, 2)`` tests do (``PCASuite.scala:48``).
    """
    from spark_rapids_ml_tpu_torch.data.vector import rows_to_matrix

    if isinstance(rows, np.ndarray) and rows.ndim == 2:
        parts = [_as_float(rows)]
    elif (isinstance(rows, (list, tuple)) and rows
          and isinstance(rows[0], np.ndarray) and rows[0].ndim == 2):
        parts = [_as_float(p) for p in rows]
    elif isinstance(rows, (list, tuple)):
        parts = [rows_to_matrix(rows)]
    else:
        arr = _as_float(rows)
        if arr.ndim != 2:
            raise TypeError(
                "RowMatrix rows must be a 2-D array, a list of vectors, or "
                "a list of 2-D chunks"
            )
        parts = [arr]
    if num_partitions is not None and num_partitions > 1 and len(parts) == 1:
        parts = [
            p for p in np.array_split(parts[0], num_partitions, axis=0)
            if p.shape[0] > 0
        ]
    n_cols = parts[0].shape[1]
    for p in parts:
        if p.shape[1] != n_cols:
            raise ValueError(
                f"inconsistent column counts across partitions: "
                f"{p.shape[1]} vs {n_cols}"
            )
    return parts


class RowMatrix:
    """A row-partitioned matrix with covariance/PCA drivers.

    ``RowMatrix(x, num_partitions=4).compute_principal_components_and_explained_variance(k)``
    """

    def __init__(
        self,
        rows,
        mean_centering: bool = True,
        use_xla_dot: bool = True,
        use_xla_svd: bool = True,
        device_id: int = -1,
        num_partitions: Optional[int] = None,
    ):
        self._parts = _as_partitions(rows, num_partitions)
        self.mean_centering = mean_centering
        self.use_xla_dot = use_xla_dot
        self.use_xla_svd = use_xla_svd
        self.device_id = device_id
        self._num_rows: Optional[int] = None
        self._num_cols: Optional[int] = None

    # -- lazy dimensions (RapidsRowMatrix.scala:48-57,128-140) ------------
    def num_rows(self) -> int:
        if self._num_rows is None:
            self._num_rows = int(sum(p.shape[0] for p in self._parts))
        return self._num_rows

    def num_cols(self) -> int:
        if self._num_cols is None:
            self._num_cols = int(self._parts[0].shape[1])
        return self._num_cols

    @property
    def num_partitions(self) -> int:
        return len(self._parts)

    def _device(self) -> torch.device:
        if self.device_id < -1:
            raise ValueError(f"device_id {self.device_id} out of range")
        return resolve_device(self.device_id)

    # -- covariance -------------------------------------------------------
    def compute_covariance(self) -> np.ndarray:
        """n×n sample covariance, normalized by numRows−1 on every path."""
        n_rows = self.num_rows()
        if self.mean_centering and n_rows < 2:
            # matches `require(count > 1)` (RapidsRowMatrix.scala:160)
            raise ValueError("mean centering requires more than one row")
        if self.use_xla_dot:
            return self._covariance_device()
        return self._covariance_packed()

    def _covariance_device(self) -> np.ndarray:
        """Device schedule: each partition's Gram folded into one
        sufficient-statistics accumulator, the covariance assembled on the
        device — ``RapidsRowMatrix.scala:168-202``'s partition → partial
        Gram → combine, with the driver-side reduce replaced by on-device
        accumulation (across ranks: ``parallel.distributed_pca``)."""
        from spark_rapids_ml_tpu_torch.ops.covariance import (
            covariance_from_stats,
        )
        from spark_rapids_ml_tpu_torch.ops.streaming import (
            init_stats,
            update_stats,
        )

        device = self._device()
        with TraceRange("compute cov", TraceColor.RED):
            stats = init_stats(self.num_cols(), dtype=_DTYPE, device=device)
            for part in self._parts:
                stats = update_stats(stats, part)
            cov = covariance_from_stats(
                stats.gram,
                stats.col_sum,
                stats.count,
                mean_centering=self.mean_centering,
            )
            # the host copy synchronises: the range covers the device work
            return cov.cpu().numpy().astype(np.float64)

    def _covariance_packed(self) -> np.ndarray:
        """Host schedule: packed upper-triangular accumulation
        (``treeAggregate`` + ``BLAS.spr`` + ``triuToFull``,
        ``RapidsRowMatrix.scala:203-252``). The accumulator stays packed
        (n(n+1)/2 doubles); each chunk contributes its Gram's upper
        triangle in one vectorized step instead of per-row spr updates.
        """
        n = self.num_cols()
        if n > MAX_SPR_COLS:
            raise ValueError(
                f"packed covariance path supports at most {MAX_SPR_COLS} "
                f"columns, got {n}; use the device GEMM path (use_xla_dot=True)"
            )
        with TraceRange("host cov", TraceColor.ORANGE):
            if self.mean_centering:
                # global mean pass (Statistics.colStats, RapidsRowMatrix.scala:155)
                total = np.zeros(n)
                count = 0
                for part in self._parts:
                    total += part.sum(axis=0, dtype=np.float64)
                    count += part.shape[0]
                mean = total / count
            else:
                mean = np.zeros(n)
            packed = np.zeros(n * (n + 1) // 2, dtype=np.float64)
            for part in self._parts:
                xc = np.asarray(part, dtype=np.float64) - mean[None, :]
                packed += _full_to_triu(xc.T @ xc)
            full = triu_to_full(n, packed)
            full /= max(self.num_rows() - 1, 1)
        return full

    # -- PCA driver (RapidsRowMatrix.scala:75-125) ------------------------
    def compute_principal_components_and_explained_variance(
        self, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        n = self.num_cols()
        if not 1 <= k <= n:
            raise ValueError(f"k = {k} out of range [1, {n}]")
        cov = self.compute_covariance()
        if self.use_xla_svd:
            from spark_rapids_ml_tpu_torch.ops.eigh import pca_from_covariance

            with TraceRange("device eigh", TraceColor.BLUE):
                cov_dev = torch.as_tensor(cov, dtype=_DTYPE,
                                          device=self._device())
                pc, evr = pca_from_covariance(cov_dev, k)
                return (
                    pc.cpu().numpy().astype(np.float64),
                    evr.cpu().numpy().astype(np.float64),
                )
        from spark_rapids_ml_tpu_torch.ops.eigh import pca_postprocess_host

        with TraceRange("host eigh", TraceColor.BLUE):
            evals, evecs = np.linalg.eigh(cov)
            return pca_postprocess_host(evals, evecs, k)

    def compute_principal_components(self, k: int) -> np.ndarray:
        return self.compute_principal_components_and_explained_variance(k)[0]

    # -- projection (mllib RowMatrix.multiply, the test-oracle op) --------
    def multiply(self, matrix: np.ndarray) -> "RowMatrix":
        """Row-wise right-multiplication: each partition becomes
        ``part @ matrix`` (float64). On the device when ``use_xla_dot``."""
        m = np.asarray(matrix, dtype=np.float64)
        if m.shape[0] != self.num_cols():
            raise ValueError(
                f"matrix has {m.shape[0]} rows, expected {self.num_cols()}"
            )
        if self.use_xla_dot:
            from spark_rapids_ml_tpu_torch.ops.pca_kernel import (
                pca_transform_kernel,
            )

            device = self._device()
            m_dev = torch.as_tensor(m, dtype=_DTYPE, device=device)
            parts = [
                pca_transform_kernel(
                    torch.as_tensor(p, dtype=_DTYPE, device=device), m_dev,
                ).cpu().numpy().astype(np.float64)
                for p in self._parts
            ]
        else:
            parts = [np.asarray(p, dtype=np.float64) @ m for p in self._parts]
        out = copy.copy(self)
        out._parts = parts
        out._num_cols = m.shape[1]
        return out

    def to_numpy(self) -> np.ndarray:
        return np.concatenate(self._parts, axis=0)
