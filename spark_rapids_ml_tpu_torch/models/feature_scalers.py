"""MinMaxScaler / MaxAbsScaler / RobustScaler Estimators, Normalizer and
Binarizer Transformers, on PyTorch.

Counterpart of the JAX package's ``models/feature_scalers.py``, with the
same params (Spark ``org.apache.spark.ml.feature``), so saved metadata
stays compatible:

* ``MinMaxScaler`` — rescale each feature to [min, max] (Spark semantics:
  constant columns map to the RANGE MIDPOINT 0.5·(min+max));
* ``MaxAbsScaler`` — divide each feature by its max |value| (constant-zero
  columns pass through unchanged, Spark's convention);
* ``Normalizer`` — per-ROW p-norm scaling, a pure transformer (no fit);
* ``Binarizer`` — per-element thresholding, a pure transformer;
* ``RobustScaler`` — center by the median, scale by the quantile range
  (exact ``np.nanquantile``; zero-range columns pass through).

The fits are host numpy float64, as in the JAX package (Spark's scalers
are Summarizer passes, not BLAS work); MinMax and MaxAbs also fold a
streamed source (a generator, or a zero-arg callable producing one) batch
by batch. Each fitted model carries a ``fit_report_``, as every fit of the
port's models does (the JAX package's scaler fits carry none). The host
``transform``s are the same numpy expressions.

Each fitted model also exposes ``serving_stage``: the same elementwise
expression as torch ops over the statistics staged on the device once
(``models._serving.build_host_stat_stage``), which
``PipelineModel.serving_transform_program`` chains into one program. On a
CUDA tensor the body runs on the card. A Binarizer body compares at the
chain's dtype, so at float32 its threshold rounds to float32 as the JAX
body's does (weak typing), while the host transform compares in float64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.data.batches import (
    streamed_reduce,
    streaming_source,
)
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.models._serving import build_host_stat_stage
from spark_rapids_ml_tpu_torch.models.params import (
    HasInputCol,
    HasOutputCol,
    Param,
    Params,
)
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import observed_transform
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer


class MinMaxScalerParams(HasInputCol, HasOutputCol):
    outputCol = Param("outputCol", "output column name", "scaled_features")
    min = Param("min", "lower bound after scaling", 0.0,
                validator=lambda v: isinstance(v, (int, float)))
    max = Param("max", "upper bound after scaling", 1.0,
                validator=lambda v: isinstance(v, (int, float)))


class MinMaxScaler(MinMaxScalerParams):
    """``MinMaxScaler().fit(df)`` → rescale features to [min, max]."""

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "MinMaxScaler":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(MinMaxScaler, path)

    @observed_fit("min_max_scaler")
    def fit(self, dataset) -> "MinMaxScalerModel":
        if float(self.getMin()) >= float(self.getMax()):
            raise ValueError("min must be below max")
        timer = PhaseTimer()
        source = streaming_source(dataset, 0)
        if source is not None:
            def minmax(acc, rows):
                blo, bhi = rows.min(axis=0), rows.max(axis=0)
                if acc is None:
                    return blo, bhi
                return np.minimum(acc[0], blo), np.maximum(acc[1], bhi)

            with timer.phase("fit"):
                lo, hi = streamed_reduce(source, minmax)
        else:
            frame = as_vector_frame(dataset, self.getInputCol())
            with timer.phase("fit"):
                x = frame.vectors_as_matrix(self.getInputCol())
                if x.shape[0] < 1:
                    raise ValueError("fit requires at least one row")
                lo = x.min(axis=0)
                hi = x.max(axis=0)
        model = MinMaxScalerModel(original_min=lo, original_max=hi)
        model.uid = self.uid
        model.copy_values_from(self)
        model.fit_timings_ = timer.as_dict()
        return model


class MinMaxScalerModel(MinMaxScalerParams):
    def __init__(
        self,
        original_min: Optional[np.ndarray] = None,
        original_max: Optional[np.ndarray] = None,
    ):
        super().__init__()
        self.original_min = original_min
        self.original_max = original_max

    def _copy_internal_state(self, other: "MinMaxScalerModel") -> None:
        other.original_min = self.original_min
        other.original_max = self.original_max

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        if self.original_min is None:
            raise ValueError("model is unfitted")
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        lo_t, hi_t = float(self.getMin()), float(self.getMax())
        spread = self.original_max - self.original_min
        # Spark: constant columns map to the midpoint of the target range
        safe = np.where(spread > 0, spread, 1.0)
        scaled = (x - self.original_min) / safe * (hi_t - lo_t) + lo_t
        scaled = np.where(
            spread[None, :] > 0, scaled, 0.5 * (lo_t + hi_t)
        )
        return frame.with_column(self.getOutputCol(), scaled)

    def serving_stage(self, precision: str = "native", *,
                      device=None, dtype=None):
        """Fused-pipeline stage: the host transform's expression —
        ``(x − min)/safe·(hi−lo) + lo``, constant columns to the range
        midpoint — over the device-staged extrema and mask."""
        if self.original_min is None:
            return None
        lo_t, hi_t = float(self.getMin()), float(self.getMax())
        spread = self.original_max - self.original_min
        safe = np.where(spread > 0, spread, 1.0)
        mid = 0.5 * (lo_t + hi_t)

        def fn(x, lo, safe_w, mask):
            scaled = (x - lo[None, :]) / safe_w[None, :] \
                * (hi_t - lo_t) + lo_t
            return torch.where(mask[None, :], scaled, mid)

        return build_host_stat_stage(
            self, fn, (self.original_min, safe, spread > 0),
            "min_max_scaler", device, dtype)

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import (
            save_minmax_model,
        )

        save_minmax_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "MinMaxScalerModel":
        from spark_rapids_ml_tpu_torch.io.persistence import (
            load_minmax_model,
        )

        return load_minmax_model(path)


class MaxAbsScalerParams(HasInputCol, HasOutputCol):
    outputCol = Param("outputCol", "output column name", "scaled_features")


class MaxAbsScaler(MaxAbsScalerParams):
    """``MaxAbsScaler().fit(df)`` → divide features by their max |value|."""

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "MaxAbsScaler":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(MaxAbsScaler, path)

    @observed_fit("max_abs_scaler")
    def fit(self, dataset) -> "MaxAbsScalerModel":
        timer = PhaseTimer()
        source = streaming_source(dataset, 0)
        if source is not None:
            def absmax(acc, rows):
                bm = np.abs(rows).max(axis=0)
                return bm if acc is None else np.maximum(acc, bm)

            with timer.phase("fit"):
                max_abs = streamed_reduce(source, absmax)
        else:
            frame = as_vector_frame(dataset, self.getInputCol())
            with timer.phase("fit"):
                x = frame.vectors_as_matrix(self.getInputCol())
                if x.shape[0] < 1:
                    raise ValueError("fit requires at least one row")
                max_abs = np.abs(x).max(axis=0)
        model = MaxAbsScalerModel(max_abs=max_abs)
        model.uid = self.uid
        model.copy_values_from(self)
        model.fit_timings_ = timer.as_dict()
        return model


class MaxAbsScalerModel(MaxAbsScalerParams):
    def __init__(self, max_abs: Optional[np.ndarray] = None):
        super().__init__()
        self.max_abs = max_abs

    def _copy_internal_state(self, other: "MaxAbsScalerModel") -> None:
        other.max_abs = self.max_abs

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        if self.max_abs is None:
            raise ValueError("model is unfitted")
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        # all-zero columns pass through (Spark divides by 1 there)
        denom = np.where(self.max_abs > 0, self.max_abs, 1.0)
        return frame.with_column(self.getOutputCol(), x / denom[None, :])

    def serving_stage(self, precision: str = "native", *,
                      device=None, dtype=None):
        """Fused-pipeline stage: ``x / denom`` over the device-staged
        per-feature divisor (all-zero columns pass through)."""
        if self.max_abs is None:
            return None
        denom = np.where(self.max_abs > 0, self.max_abs, 1.0)

        def fn(x, denom_w):
            return x / denom_w[None, :]

        return build_host_stat_stage(self, fn, (denom,), "max_abs_scaler",
                                     device, dtype)

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import (
            save_maxabs_model,
        )

        save_maxabs_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "MaxAbsScalerModel":
        from spark_rapids_ml_tpu_torch.io.persistence import (
            load_maxabs_model,
        )

        return load_maxabs_model(path)


class Normalizer(HasInputCol, HasOutputCol, Params):
    """Per-row p-norm scaling — a pure Transformer (no fit), Spark's
    ``Normalizer``. Zero rows pass through unchanged."""

    outputCol = Param("outputCol", "output column name", "normalized_features")
    p = Param("p", "norm order (p >= 1; inf supported)", 2.0,
              validator=lambda v: v == float("inf") or float(v) >= 1.0)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        p = float(self.getP())
        if np.isinf(p):
            norms = np.abs(x).max(axis=1)
        else:
            norms = np.power(
                np.power(np.abs(x), p).sum(axis=1), 1.0 / p
            )
        denom = np.where(norms > 0, norms, 1.0)
        return frame.with_column(
            self.getOutputCol(), x / denom[:, None]
        )

    def serving_stage(self, precision: str = "native", *,
                      device=None, dtype=None):
        """Fused-pipeline stage: per-row p-norm scaling, stateless (no
        weights)."""
        p = float(self.getP())

        def fn(x):
            if np.isinf(p):
                norms = x.abs().amax(dim=1)
            else:
                norms = torch.pow(torch.pow(x.abs(), p).sum(dim=1), 1.0 / p)
            denom = torch.where(norms > 0, norms, 1.0)
            return x / denom[:, None]

        return build_host_stat_stage(self, fn, (), "normalizer", device,
                                     dtype)

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "Normalizer":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(Normalizer, path)


class Binarizer(HasInputCol, HasOutputCol, Params):
    """Per-element thresholding — a pure Transformer (no fit), Spark's
    ``Binarizer`` applied to the vector-column idiom (each feature
    dimension binarizes independently)."""

    outputCol = Param("outputCol", "output column name",
                      "binarized_features")
    threshold = Param("threshold", "values > threshold map to 1.0", 0.0,
                      validator=lambda v: np.isfinite(float(v)))

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        return frame.with_column(
            self.getOutputCol(),
            (x > float(self.getThreshold())).astype(np.float64),
        )

    def serving_stage(self, precision: str = "native", *,
                      device=None, dtype=None):
        """Fused-pipeline stage: elementwise thresholding at the chain's
        dtype (see the module docstring), stateless; the 0/1 output stays
        in the chain dtype so a downstream GEMM stage takes it as is."""
        threshold = float(self.getThreshold())

        def fn(x):
            return (x > threshold).to(x.dtype)

        return build_host_stat_stage(self, fn, (), "binarizer", device,
                                     dtype)

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "Binarizer":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(Binarizer, path)


class RobustScalerParams(HasInputCol, HasOutputCol):
    """Spark 3.0 ``RobustScaler`` surface over the vector-column idiom:
    center by median, scale by the (lower, upper) quantile range."""

    outputCol = Param("outputCol", "output column name", "scaled_features")
    withCentering = Param("withCentering", "subtract the median", False,
                          validator=lambda v: isinstance(v, bool))
    withScaling = Param("withScaling", "divide by the quantile range",
                        True, validator=lambda v: isinstance(v, bool))
    lower = Param("lower", "lower quantile", 0.25,
                  validator=lambda v: 0.0 < float(v) < 1.0)
    upper = Param("upper", "upper quantile", 0.75,
                  validator=lambda v: 0.0 < float(v) < 1.0)


class RobustScaler(RobustScalerParams):
    """``RobustScaler().setWithCentering(True).fit(df)`` — quantile-based
    scaling that ignores outliers (exact per-feature quantiles of the
    in-memory rows)."""

    @observed_fit("robust_scaler")
    def fit(self, dataset) -> "RobustScalerModel":
        timer = PhaseTimer()
        if float(self.getLower()) >= float(self.getUpper()):
            raise ValueError("lower must be below upper")
        frame = as_vector_frame(dataset, self.getInputCol())
        with timer.phase("fit"):
            x = frame.vectors_as_matrix(self.getInputCol())
            if x.shape[0] < 1:
                raise ValueError("fit requires at least one row")
            # nanquantile: NaN entries are ignored per feature (the
            # sklearn/Spark convention); an all-NaN column has no
            # quantiles to scale by
            if np.isnan(x).all(axis=0).any():
                raise ValueError(
                    "a feature column is entirely NaN; impute first"
                )
            qs = np.nanquantile(
                x,
                [float(self.getLower()), 0.5, float(self.getUpper())],
                axis=0,
            )
        model = RobustScalerModel(median=qs[1], qrange=qs[2] - qs[0])
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


class RobustScalerModel(RobustScalerParams):
    def __init__(self, median: Optional[np.ndarray] = None,
                 qrange: Optional[np.ndarray] = None):
        super().__init__()
        self.median = median
        self.qrange = qrange
        self.fit_timings_ = {}

    def _copy_internal_state(self, other: "RobustScalerModel") -> None:
        other.median = self.median
        other.qrange = self.qrange

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        if self.median is None:
            raise ValueError("model is unfitted")
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        out = x
        if self.get_or_default("withCentering"):
            out = out - self.median[None, :]
        if self.get_or_default("withScaling"):
            # zero-range columns pass through (sklearn/Spark convention)
            denom = np.where(self.qrange > 0, self.qrange, 1.0)
            out = out / denom[None, :]
        return frame.with_column(self.getOutputCol(), out)

    def serving_stage(self, precision: str = "native", *,
                      device=None, dtype=None):
        """Fused-pipeline stage: median-center / quantile-range-scale
        over device-staged statistics, with the host transform's flag
        semantics."""
        if self.median is None:
            return None
        centering = bool(self.get_or_default("withCentering"))
        scaling = bool(self.get_or_default("withScaling"))
        weights = []
        if centering:
            weights.append(self.median)
        if scaling:
            weights.append(np.where(self.qrange > 0, self.qrange, 1.0))

        if centering and scaling:
            def fn(x, median, denom):
                return (x - median[None, :]) / denom[None, :]
        elif centering:
            def fn(x, median):
                return x - median[None, :]
        elif scaling:
            def fn(x, denom):
                return x / denom[None, :]
        else:
            def fn(x):
                return x

        return build_host_stat_stage(self, fn, tuple(weights),
                                     "robust_scaler", device, dtype)

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import (
            save_robust_model,
        )

        save_robust_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "RobustScalerModel":
        from spark_rapids_ml_tpu_torch.io.persistence import (
            load_robust_model,
        )

        return load_robust_model(path)
