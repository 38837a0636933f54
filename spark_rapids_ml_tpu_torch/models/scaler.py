"""StandardScaler Estimator / Model, on PyTorch.

Counterpart of the JAX package's ``models/scaler.py``, with the same params
(Spark ``org.apache.spark.ml.feature.StandardScaler``: ``withMean`` default
false, ``withStd`` default true), so saved metadata stays compatible.

Fit routes, as in the JAX package:

* streamed (a generator, or a zero-arg callable producing one): one pass
  of (Σx, Σx², n) in host float64;
* device (``useXlaDot``): two passes over the rows on the device, the mean
  and then Σ(x−μ)²/(n−1) (the one-pass identity cancels catastrophically
  at float32 for |μ| ≫ σ);
* host (``useXlaDot=False``): numpy float64.

``std`` uses the unbiased (n−1) normaliser like Spark's ``Summarizer``.
``transform`` runs on the host in float64, as the JAX package's does; a
zero-std column gets scale factor 0.0 (the constant column maps to 0), not
a pass-through. The serving stage runs the same ``(x − mean) · factor`` on
the device at the chain's dtype. ``dtype='auto'`` is float32 here.
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
from spark_rapids_ml_tpu_torch.models.params import (
    HasDeviceId,
    HasInputCol,
    HasOutputCol,
    Param,
)
from spark_rapids_ml_tpu_torch.models.pca import _resolve_dtype
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import observed_transform
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer


class StandardScalerParams(HasInputCol, HasOutputCol, HasDeviceId):
    outputCol = Param("outputCol", "output column name", "scaled_features")
    withMean = Param("withMean", "center to zero mean before scaling", False,
                     validator=lambda v: isinstance(v, bool))
    withStd = Param("withStd", "scale to unit standard deviation", True,
                    validator=lambda v: isinstance(v, bool))
    useXlaDot = Param(
        "useXlaDot",
        "statistics on the device (True) or host NumPy (False)",
        True, validator=lambda v: isinstance(v, bool))
    dtype = Param("dtype", "device compute dtype: 'float32', 'float64', or "
                  "'auto' (float32)", "auto",
                  validator=lambda v: v in ("auto", "float32", "float64"))


def _scale_factor(std: np.ndarray) -> np.ndarray:
    """Spark's factor: 1/std, and 0.0 for a zero-std column."""
    safe = np.where(std > 0, std, 1.0)
    return np.where(std > 0, 1.0 / safe, 0.0)


class StandardScaler(StandardScalerParams):
    """``StandardScaler().setWithMean(True).fit(df)``."""

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "StandardScaler":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(StandardScaler, path)

    @observed_fit("standard_scaler")
    def fit(self, dataset) -> "StandardScalerModel":
        timer = PhaseTimer()
        source = streaming_source(dataset, 0)
        if source is not None:
            # one host-f64 pass of (Σx, Σx², n): the one-pass identity is
            # safe at f64 for scaler purposes
            def moments(acc, rows):
                s1, s2, n = acc if acc is not None else (
                    np.zeros(rows.shape[1]), np.zeros(rows.shape[1]), 0
                )
                return (s1 + rows.sum(axis=0),
                        s2 + (rows * rows).sum(axis=0),
                        n + rows.shape[0])

            with timer.phase("fit_kernel"):
                s1, s2, n = streamed_reduce(source, moments)
                if n < 2:
                    raise ValueError(
                        "StandardScaler requires at least 2 rows"
                    )
                mean = s1 / n
                var = np.maximum((s2 - n * mean * mean) / (n - 1), 0.0)
                std = np.sqrt(var)
            return self._model(mean, std, timer)

        frame = as_vector_frame(dataset, self.getInputCol())
        with timer.phase("densify"):
            x = frame.vectors_as_matrix(self.getInputCol())
        if x.shape[0] < 2:
            raise ValueError("StandardScaler requires at least 2 rows")
        if self.getUseXlaDot():
            device = resolve_device(self.getDeviceId())
            dtype = _resolve_dtype(self.getDtype())
            with timer.phase("fit_kernel"):
                xd = torch.as_tensor(x, dtype=dtype, device=device)
                n = x.shape[0]
                mean_dev = xd.sum(dim=0) / n
                # two passes, Σ(x−μ)²/(n−1): see the module docstring
                centered = xd - mean_dev[None, :]
                var_dev = (centered * centered).sum(dim=0) / (n - 1)
                mean = mean_dev.cpu().numpy().astype(np.float64)
                var = var_dev.cpu().numpy().astype(np.float64)
            std = np.sqrt(np.maximum(var, 0))
        else:
            with timer.phase("fit_kernel"):
                mean = x.mean(axis=0)
                std = x.std(axis=0, ddof=1)
        return self._model(mean, std, timer)

    def _model(self, mean, std, timer) -> "StandardScalerModel":
        model = StandardScalerModel(mean=mean, std=std)
        model.copy_values_from(self)
        model.fit_timings_ = timer.as_dict()
        return model


class StandardScalerModel(StandardScalerParams):
    def __init__(self, mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.mean = mean
        self.std = std
        self.fit_timings_ = {}

    def _copy_internal_state(self, other: "StandardScalerModel") -> None:
        other.mean = self.mean
        other.std = self.std

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        if self.mean is None:
            raise ValueError("model has no statistics; fit first or load")
        frame = as_vector_frame(dataset, self.getInputCol())
        self.transform_schema(frame.columns)
        x = frame.vectors_as_matrix(self.getInputCol())
        if x.shape[1] != self.mean.shape[0]:
            raise ValueError(
                f"input has {x.shape[1]} features, model expects "
                f"{self.mean.shape[0]}"
            )
        out = np.asarray(x, dtype=np.float64)
        if self.getWithMean():
            out = out - self.mean[None, :]
        if self.getWithStd():
            out = out * _scale_factor(self.std)[None, :]
        return frame.with_column(self.getOutputCol(), out)

    def serving_stage(self, precision: str = "native", *,
                      device=None, dtype=None):
        """Composable fused-pipeline stage (``models._serving
        .ServingStage``): the same ``(x − mean) · factor`` expression the
        host transform runs, with the statistics staged on the device
        once. Elementwise, so every precision shares the native body (the
        product stages carry the reduced ones)."""
        if self.mean is None:
            return None
        from spark_rapids_ml_tpu_torch.models._serving import (
            build_host_stat_stage,
        )

        with_mean = bool(self.getWithMean())
        with_std = bool(self.getWithStd())
        host_weights = []
        if with_mean:
            host_weights.append(self.mean)
        if with_std:
            host_weights.append(_scale_factor(self.std))
        if with_mean and with_std:
            def fn(x, mean, factor):
                return (x - mean[None, :]) * factor[None, :]
        elif with_mean:
            def fn(x, mean):
                return x - mean[None, :]
        elif with_std:
            def fn(x, factor):
                return x * factor[None, :]
        else:
            def fn(x):
                return x
        return build_host_stat_stage(self, fn, host_weights,
                                     "standard_scaler", device, dtype)

    def transform_schema(self, columns):
        out = list(columns)
        if self.getOutputCol() in out:
            raise ValueError(
                f"output column {self.getOutputCol()!r} already exists"
            )
        out.append(self.getOutputCol())
        return out

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_scaler_model

        save_scaler_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "StandardScalerModel":
        from spark_rapids_ml_tpu_torch.io.persistence import load_scaler_model

        return load_scaler_model(path)
