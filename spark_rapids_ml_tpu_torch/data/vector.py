"""Dense/sparse vector types with Spark ML ``linalg`` semantics.

The reference framework consumes Spark ML ``Vector`` columns (dense or
sparse) and guarantees identical results for both encodings
(the reference's ``src/test/scala/com/nvidia/spark/ml/feature/PCASuite.scala:155-190``).
These lightweight equivalents preserve that user-facing contract without a
JVM: both encodings densify to the same ``numpy`` row before device transfer.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple, Union

import numpy as np


class DenseVector:
    """A dense 1-D vector of float64 values (Spark ``ml.linalg.DenseVector``)."""

    __slots__ = ("values",)

    def __init__(self, values: Iterable[float]):
        self.values = np.asarray(values, dtype=np.float64).reshape(-1)

    @property
    def size(self) -> int:
        return int(self.values.shape[0])

    def to_array(self) -> np.ndarray:
        return self.values

    toArray = to_array

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, i: int) -> float:
        return float(self.values[i])

    def __eq__(self, other) -> bool:
        if isinstance(other, (DenseVector, SparseVector)):
            return np.array_equal(self.values, other.to_array())
        return NotImplemented

    def __repr__(self) -> str:
        return f"DenseVector({self.values.tolist()})"


class SparseVector:
    """A sparse vector: (size, sorted indices, values) — Spark ``SparseVector``."""

    __slots__ = ("size", "indices", "values")

    def __init__(self, size: int, indices: Iterable[int], values: Iterable[float]):
        self.size = int(size)
        self.indices = np.asarray(indices, dtype=np.int32).reshape(-1)
        self.values = np.asarray(values, dtype=np.float64).reshape(-1)
        if self.indices.shape[0] != self.values.shape[0]:
            raise ValueError("indices and values must have the same length")
        if self.indices.size and (
            np.any(np.diff(self.indices) <= 0)
            or self.indices[0] < 0
            or self.indices[-1] >= self.size
        ):
            raise ValueError("indices must be strictly increasing and in [0, size)")

    def to_array(self) -> np.ndarray:
        out = np.zeros(self.size, dtype=np.float64)
        out[self.indices] = self.values
        return out

    toArray = to_array

    def __len__(self) -> int:
        return self.size

    def __eq__(self, other) -> bool:
        if isinstance(other, (DenseVector, SparseVector)):
            return np.array_equal(self.to_array(), other.to_array())
        return NotImplemented

    def __repr__(self) -> str:
        return (
            f"SparseVector({self.size}, {self.indices.tolist()}, "
            f"{self.values.tolist()})"
        )


Vector = Union[DenseVector, SparseVector]


class Vectors:
    """Factory helpers mirroring Spark's ``ml.linalg.Vectors``."""

    @staticmethod
    def dense(*values) -> DenseVector:
        if len(values) == 1 and isinstance(values[0], (list, tuple, np.ndarray)):
            return DenseVector(values[0])
        return DenseVector(values)

    @staticmethod
    def sparse(size: int, *args) -> SparseVector:
        # Accept (size, indices, values) or (size, [(i, v), ...]).
        if len(args) == 1:
            pairs: Sequence[Tuple[int, float]] = sorted(args[0])
            indices = [int(i) for i, _ in pairs]
            values = [float(v) for _, v in pairs]
            return SparseVector(size, indices, values)
        if len(args) == 2:
            return SparseVector(size, args[0], args[1])
        raise TypeError("Vectors.sparse(size, indices, values) or (size, pairs)")


def rows_to_matrix(rows: Iterable) -> np.ndarray:
    """Densify an iterable of vectors/arrays into an (m, n) float64 matrix.

    All rows must share one size — mirrors the reference's implicit contract
    (numFeatures from the first row,
    the reference's ``src/main/scala/org/apache/spark/ml/feature/RapidsPCA.scala:117-119``).
    """
    dense_rows = []
    n = None
    for r in rows:
        if isinstance(r, (DenseVector, SparseVector)):
            arr = r.to_array()
        else:
            arr = np.asarray(r, dtype=np.float64).reshape(-1)
        if n is None:
            n = arr.shape[0]
        elif arr.shape[0] != n:
            raise ValueError(
                f"inconsistent vector sizes: expected {n}, got {arr.shape[0]}"
            )
        dense_rows.append(arr)
    if not dense_rows:
        raise ValueError("empty input: need at least one row")
    return np.stack(dense_rows, axis=0)
