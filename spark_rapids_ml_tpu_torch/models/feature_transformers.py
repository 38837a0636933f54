"""Spark ML feature transformers that compose into a served pipeline, on
PyTorch: ElementwiseProduct, VectorSlicer, VarianceThresholdSelector (with
its model) and ChiSqSelectorModel.

Counterpart of the stage half of the JAX package's
``models/feature_transformers.py``, with the same params
(``pyspark.ml.feature``) and persistence, so a model either package saved
loads in the other. Each stage exposes ``serving_stage``: the Hadamard
product or the column gather as torch ops over the scaling vector or the
int64 index vector staged on the device once
(``models._serving.build_host_stat_stage``); on a CUDA tensor the gather
runs on the card.

Not ported yet (ROADMAP queue 1 item 7): the categorical transformers
(StringIndexer, IndexToString, OneHotEncoder, VectorAssembler,
Bucketizer, QuantileDiscretizer), which have no serving stage and need
frame features this port's ``data/frame.py`` lacks, PolynomialExpansion,
and ``ChiSqSelector.fit``, which needs the JAX package's
``stat.ChiSquareTest``. A ``ChiSqSelectorModel`` the JAX package fitted
and saved loads and serves here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

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


def _persistable(cls):
    """Attach the standard params-only save/load pair."""

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    def load(path: str):
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(cls, path)

    cls.save = save
    cls.load = staticmethod(load)
    return cls


def _gather_stage(model, idx: np.ndarray, algo: str, device, dtype):
    """The column gather over ``idx`` staged on the device as int64. The
    request's width is checked against the largest index on the host
    (its shape only, no sync) before the gather: on a CUDA tensor an
    index out of range fires a device-side assert that poisons the
    process's CUDA context, where a ValueError fails this batch alone."""
    width = int(idx.max()) + 1 if idx.size else 0

    def fn(x, idx_w):
        if x.shape[1] < width:
            raise ValueError(
                f"{algo}: input width {x.shape[1]} has no column "
                f"{width - 1}")
        return x[:, idx_w]

    return build_host_stat_stage(model, fn, (idx,), algo, device, dtype)


@_persistable
class ElementwiseProduct(HasInputCol, HasOutputCol, Params):
    """Hadamard product with a broadcast ``scalingVec`` (Spark)."""

    outputCol = Param("outputCol", "output vector column", "scaled")
    scalingVec = Param("scalingVec", "per-feature multipliers", None,
                       validator=lambda v: v is None or isinstance(
                           v, (list, tuple, np.ndarray)))

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        scaling = self.get_or_default("scalingVec")
        if scaling is None:
            raise ValueError("ElementwiseProduct needs scalingVec")
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        s = np.asarray(scaling, dtype=np.float64).reshape(-1)
        if s.shape[0] != x.shape[1]:
            raise ValueError(
                f"scalingVec length {s.shape[0]} != width {x.shape[1]}")
        return frame.with_column(self.getOutputCol(), x * s[None, :])

    def serving_stage(self, precision: str = "native", *,
                      device=None, dtype=None):
        """Fused-pipeline stage (``models._serving.ServingStage``): the
        Hadamard product with the device-staged scaling vector."""
        scaling = self.get_or_default("scalingVec")
        if scaling is None:
            return None
        s = np.asarray(scaling, dtype=np.float64).reshape(-1)

        def fn(x, s_w):
            return x * s_w[None, :]

        return build_host_stat_stage(self, fn, (s,), "elementwise_product",
                                     device, dtype)


@_persistable
class VectorSlicer(HasInputCol, HasOutputCol, Params):
    """Column subset of a vector column by integer ``indices`` (Spark;
    the name-based form needs column metadata the frame does not
    carry)."""

    outputCol = Param("outputCol", "output vector column", "sliced")
    indices = Param("indices", "feature indices to keep, in order", None,
                    validator=lambda v: v is None or all(
                        isinstance(i, int) and i >= 0 for i in v))

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        indices = self.get_or_default("indices")
        if not indices:
            raise ValueError("VectorSlicer needs indices")
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        idx = np.asarray(indices, dtype=np.int64)
        if (idx >= x.shape[1]).any():
            raise ValueError(
                f"index out of range for width {x.shape[1]}")
        return frame.with_column(self.getOutputCol(), x[:, idx])

    def serving_stage(self, precision: str = "native", *,
                      device=None, dtype=None):
        """Fused-pipeline stage: the column gather, with the index vector
        staged on the device as int64."""
        indices = self.get_or_default("indices")
        if not indices:
            return None
        return _gather_stage(self, np.asarray(indices, dtype=np.int64),
                             "vector_slicer", device, dtype)


class _SelectorModelBase(HasInputCol, HasOutputCol, Params):
    outputCol = Param("outputCol", "selected vector column", "selected")

    def __init__(self, selected: Optional[Sequence[int]] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.selected_features = (
            None if selected is None
            else np.asarray(sorted(int(i) for i in selected),
                            dtype=np.int64))

    def _copy_internal_state(self, other) -> None:
        other.selected_features = self.selected_features

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        if self.selected_features is None:
            raise ValueError("selector model is unfitted")
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        return frame.with_column(
            self.getOutputCol(), x[:, self.selected_features])

    def serving_stage(self, precision: str = "native", *,
                      device=None, dtype=None):
        """Fused-pipeline stage: the fitted selection's column gather
        (shared by the variance-threshold and chi-square selectors)."""
        if self.selected_features is None:
            return None
        return _gather_stage(self, self.selected_features,
                             "feature_selector", device, dtype)

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import (
            save_selector_model,
        )

        save_selector_model(self, path, overwrite=overwrite)

    @classmethod
    def load(cls, path: str):
        from spark_rapids_ml_tpu_torch.io.persistence import (
            load_selector_model,
        )

        return load_selector_model(path)


class VarianceThresholdSelectorModel(_SelectorModelBase):
    """Keeps features whose sample variance exceeds the threshold."""


@_persistable
class VarianceThresholdSelector(HasInputCol, HasOutputCol, Params):
    """Spark 3.1 ``VarianceThresholdSelector``: drop features with
    sample variance <= varianceThreshold (host float64; a single row
    has variance 0 everywhere, so it keeps nothing). The model carries a
    ``fit_report_`` (the JAX package's carries none)."""

    outputCol = Param("outputCol", "selected vector column", "selected")
    varianceThreshold = Param("varianceThreshold",
                              "keep features with variance > this", 0.0,
                              validator=lambda v: v >= 0)

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_fit("variance_threshold_selector")
    def fit(self, dataset) -> VarianceThresholdSelectorModel:
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        var = x.var(axis=0, ddof=1) if x.shape[0] > 1 \
            else np.zeros(x.shape[1])
        keep = np.flatnonzero(var > float(
            self.get_or_default("varianceThreshold")))
        model = VarianceThresholdSelectorModel(selected=keep)
        model.uid = self.uid
        model.copy_values_from(self)
        return model


class ChiSqSelectorModel(_SelectorModelBase):
    """Keeps the chi-square-selected categorical features."""
