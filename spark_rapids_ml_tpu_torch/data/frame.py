"""A minimal columnar frame carrying vector columns.

Stands in for the Spark ``DataFrame`` the reference estimator consumes
(the reference's ``src/main/scala/org/apache/spark/ml/feature/RapidsPCA.scala:111-125``:
``dataset.select(inputCol) → RDD[Vector]``). Columns are named; a column may
hold Spark-style dense/sparse vectors, a 2-D numpy array (one row per frame
row), or plain scalars. A ``pandas.DataFrame`` with a vector column
converts to a frame; pandas is optional and imported only to recognise
one.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from spark_rapids_ml_tpu_torch.data.vector import DenseVector, SparseVector, rows_to_matrix


class VectorFrame:
    """Named columns of equal length; the unit of data the estimators consume."""

    def __init__(self, columns: Dict[str, object]):
        self._columns: Dict[str, object] = {}
        self._length: Optional[int] = None
        for name, col in columns.items():
            self._set(name, col)

    def _set(self, name: str, col) -> None:
        if isinstance(col, np.ndarray) and col.ndim == 2:
            length = col.shape[0]
        else:
            col = list(col)
            length = len(col)
        if self._length is None:
            self._length = length
        elif length != self._length:
            raise ValueError(
                f"column {name!r} has length {length}, expected {self._length}"
            )
        self._columns[name] = col

    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    def __len__(self) -> int:
        return self._length or 0

    def column(self, name: str):
        if name not in self._columns:
            raise KeyError(
                f"column {name!r} not found; available: {self.columns}"
            )
        return self._columns[name]

    def with_column(self, name: str, col) -> "VectorFrame":
        out = VectorFrame(dict(self._columns))
        out._set(name, col)
        return out

    def vectors_as_matrix(self, name: str) -> np.ndarray:
        """Densify a vector column to an (m, n) float64 matrix."""
        col = self.column(name)
        if isinstance(col, np.ndarray):
            return np.asarray(col, dtype=np.float64)
        return rows_to_matrix(col)

    @staticmethod
    def from_pandas(df) -> "VectorFrame":
        return VectorFrame({name: list(df[name]) for name in df.columns})

    def __repr__(self) -> str:
        return f"VectorFrame(columns={self.columns}, rows={len(self)})"


def as_vector_frame(dataset, input_col: str) -> VectorFrame:
    """Coerce any supported dataset into a VectorFrame containing input_col.

    Accepted: VectorFrame, pandas.DataFrame, 2-D numpy array (or CPU
    tensor), or an iterable of vectors/row-arrays (the array forms are
    wrapped under ``input_col``).
    """
    if isinstance(dataset, VectorFrame):
        return dataset
    try:
        import pandas as pd

        if isinstance(dataset, pd.DataFrame):
            return VectorFrame.from_pandas(dataset)
    except ImportError:  # pandas is optional
        pass
    if hasattr(dataset, "collect") and hasattr(dataset, "columns"):
        # a DataFrame (pyspark or a look-alike): collect it whole
        names = list(dataset.columns)
        rows = dataset.collect()
        return VectorFrame({
            name: [
                row[i].toArray() if hasattr(row[i], "toArray") else row[i]
                for row in rows
            ]
            for i, name in enumerate(names)
        })
    if not isinstance(dataset, (list, tuple)):
        try:
            arr = np.asarray(dataset, dtype=np.float64)
        except (TypeError, ValueError):
            arr = None
        if arr is not None and arr.ndim == 2:
            return VectorFrame({input_col: arr})
    if isinstance(dataset, (list, tuple)):
        first = dataset[0] if dataset else None
        if isinstance(first, (DenseVector, SparseVector, np.ndarray, list, tuple)):
            return VectorFrame({input_col: list(dataset)})
    raise TypeError(
        f"unsupported dataset type {type(dataset).__name__}: expected "
        "VectorFrame, pandas.DataFrame, 2-D array, or list of vectors"
    )
