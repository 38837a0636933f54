"""Imputer — per-feature missing-value replacement (Spark 3.0 surface).

Counterpart of the JAX package's ``models/imputer.py``, with the same
params, so saved metadata stays compatible. Spark's
``org.apache.spark.ml.feature.Imputer`` works over numeric columns; this
framework applies the same semantics per DIMENSION of the vector input
column (the columnar-vector idiom every transformer here uses).
``strategy``: mean | median | mode, computed over the non-missing entries
of each feature; ``missingValue`` marks missing entries (NaN by default —
NaN entries are ALWAYS treated as missing, like Spark). The fit and the
transform are host numpy float64, as in the JAX package; the fitted model
carries a ``fit_report_``, as every fit of the port's models does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.models.params import (
    HasInputCol,
    HasOutputCol,
    Param,
)
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import observed_transform
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer


class ImputerParams(HasInputCol, HasOutputCol):
    outputCol = Param("outputCol", "output column name", "imputed_features")
    strategy = Param(
        "strategy", "mean | median | mode (per feature, over non-missing "
        "entries)", "mean",
        validator=lambda v: v in ("mean", "median", "mode"),
    )
    missingValue = Param(
        "missingValue",
        "value marking a missing entry (NaN entries are always missing)",
        float("nan"),
        validator=lambda v: isinstance(v, (int, float)),
    )


def _missing_mask(x: np.ndarray, missing_value: float) -> np.ndarray:
    mask = np.isnan(x)
    if not np.isnan(missing_value):
        mask |= x == missing_value
    return mask


class Imputer(ImputerParams):
    """``Imputer().setStrategy('median').fit(df)``."""

    @observed_fit("imputer")
    def fit(self, dataset) -> "ImputerModel":
        timer = PhaseTimer()
        frame = as_vector_frame(dataset, self.getInputCol())
        with timer.phase("fit"):
            x = frame.vectors_as_matrix(self.getInputCol())
            if x.shape[0] < 1:
                raise ValueError("fit requires at least one row")
            missing = _missing_mask(x, float(self.getMissingValue()))
            strategy = self.getStrategy()
            surrogates = np.empty(x.shape[1])
            for j in range(x.shape[1]):
                col = x[~missing[:, j], j]
                if col.size == 0:
                    raise ValueError(
                        f"feature {j} has no non-missing values to "
                        f"impute from"
                    )
                if strategy == "mean":
                    surrogates[j] = col.mean()
                elif strategy == "median":
                    surrogates[j] = np.median(col)
                else:  # mode: most frequent; ties break to the SMALLEST
                    # value, Spark's convention
                    values, counts = np.unique(col, return_counts=True)
                    surrogates[j] = values[np.argmax(counts)]
        model = ImputerModel(surrogates=surrogates)
        model.uid = self.uid
        model.copy_values_from(self)
        model.fit_timings_ = timer.as_dict()
        return model

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @classmethod
    def load(cls, path: str):
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(cls, path)


class ImputerModel(ImputerParams):
    def __init__(self, surrogates: Optional[np.ndarray] = None):
        super().__init__()
        self.surrogates = surrogates
        self.fit_timings_ = {}

    def _copy_internal_state(self, other: "ImputerModel") -> None:
        other.surrogates = self.surrogates

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        if self.surrogates is None:
            raise ValueError("model is unfitted")
        frame = as_vector_frame(dataset, self.getInputCol())
        x = np.array(
            frame.vectors_as_matrix(self.getInputCol()), dtype=np.float64
        )
        missing = _missing_mask(x, float(self.getMissingValue()))
        x[missing] = np.broadcast_to(
            self.surrogates[None, :], x.shape
        )[missing]
        return frame.with_column(self.getOutputCol(), x)

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import (
            save_imputer_model,
        )

        save_imputer_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "ImputerModel":
        from spark_rapids_ml_tpu_torch.io.persistence import (
            load_imputer_model,
        )

        return load_imputer_model(path)
