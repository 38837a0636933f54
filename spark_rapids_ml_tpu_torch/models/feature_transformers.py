"""Spark ML feature transformers, on the host and as served pipeline
stages: StringIndexer, IndexToString, OneHotEncoder, VectorAssembler,
Bucketizer, QuantileDiscretizer, ElementwiseProduct, VectorSlicer,
PolynomialExpansion, VarianceThresholdSelector and ChiSqSelector (with
their models).

Counterpart of the JAX package's ``models/feature_transformers.py``, with
the same params (``pyspark.ml.feature``), Spark edge cases (the
handleInvalid modes, dropLast, frequency order with alphabetical ties,
Spark's polynomial term order) and persistence, so a model either package
saved loads in the other. These are row-local host numpy in both
packages. ElementwiseProduct, VectorSlicer and the two selector models
also expose ``serving_stage``: the Hadamard product or the column gather
as torch ops over the scaling vector or the int64 index vector staged on
the device once (``models._serving.build_host_stat_stage``); on a CUDA
tensor the gather runs on the card.

``ChiSqSelector.fit`` ranks features by the port's
``stat.ChiSquareTest`` (host float64, as the JAX package's); the Spark
front ends are ``spark/transformers.py``. The fits carry a
``fit_report_``, as every port fit does (the JAX package's carry none).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

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

_INVALID_MODES = ("error", "skip", "keep")


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


# --------------------------------------------------------------------------
# StringIndexer / IndexToString
# --------------------------------------------------------------------------

class StringIndexerParams(HasInputCol, HasOutputCol):
    outputCol = Param("outputCol", "output index column", "indexed")
    stringOrderType = Param(
        "stringOrderType",
        "label-index assignment order",
        "frequencyDesc",
        validator=lambda v: v in ("frequencyDesc", "frequencyAsc",
                                  "alphabetDesc", "alphabetAsc"))
    handleInvalid = Param(
        "handleInvalid",
        "unseen label policy: error | skip | keep (index numLabels)",
        "error", validator=lambda v: v in _INVALID_MODES)


def frequency_ordered_levels(values, descending: bool = True):
    """Spark's StringIndexer level ordering: by frequency (desc by
    default) with ties broken alphabetically ascending — the ONE copy
    of this rule (RFormula composes it too)."""
    counts: dict = {}
    for v in values:
        counts[str(v)] = counts.get(str(v), 0) + 1
    sign = -1 if descending else 1
    return [v for v, _c in sorted(
        counts.items(), key=lambda kv: (sign * kv[1], kv[0]))]


@_persistable
class StringIndexer(StringIndexerParams):
    """``StringIndexer(inputCol="cat").fit(df)`` — Spark semantics:
    frequencyDesc default with ties broken alphabetically ascending."""

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_fit("string_indexer")
    def fit(self, dataset) -> "StringIndexerModel":
        frame = as_vector_frame(dataset, None)
        values = [str(v) for v in frame.column(self.getInputCol())]
        order = self.get_or_default("stringOrderType")
        if order.startswith("frequency"):
            labels = frequency_ordered_levels(
                values, descending=(order == "frequencyDesc"))
        else:
            labels = sorted(set(values),
                            reverse=(order == "alphabetDesc"))
        model = StringIndexerModel(labels=labels)
        model.uid = self.uid
        model.copy_values_from(self)
        return model


class StringIndexerModel(StringIndexerParams):
    def __init__(self, labels: Optional[List[str]] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.labels = labels

    def _copy_internal_state(self, other) -> None:
        other.labels = self.labels

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, None)
        index = {v: float(i) for i, v in enumerate(self.labels)}
        values = [str(v) for v in frame.column(self.getInputCol())]
        mode = self.get_or_default("handleInvalid")
        unseen = [v for v in values if v not in index]
        if unseen and mode == "error":
            raise ValueError(
                f"unseen labels {sorted(set(unseen))[:5]} "
                "(handleInvalid='error'; use 'skip' or 'keep')")
        if mode == "skip":
            keep = [i for i, v in enumerate(values) if v in index]
            frame = frame.select_rows(keep)
            values = [values[i] for i in keep]
        fallback = float(len(self.labels))   # 'keep': one extra bucket
        out = [index.get(v, fallback) for v in values]
        return frame.with_column(self.getOutputCol(), np.asarray(out))

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import (
            save_string_indexer_model,
        )

        save_string_indexer_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "StringIndexerModel":
        from spark_rapids_ml_tpu_torch.io.persistence import (
            load_string_indexer_model,
        )

        return load_string_indexer_model(path)


@_persistable
class IndexToString(HasInputCol, HasOutputCol, Params):
    """Inverse of StringIndexerModel: index column -> label strings via
    the ``labels`` param (Spark's explicit-labels form)."""

    outputCol = Param("outputCol", "output label column", "originalValue")
    labels = Param("labels", "index -> label mapping", None,
                   validator=lambda v: v is None or isinstance(
                       v, (list, tuple)))

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        labels = self.get_or_default("labels")
        if not labels:
            raise ValueError("IndexToString needs the labels param")
        frame = as_vector_frame(dataset, None)
        idx = np.asarray(frame.column(self.getInputCol()),
                         dtype=np.float64).astype(np.int64)
        if (idx < 0).any() or (idx >= len(labels)).any():
            raise ValueError(
                f"index out of range for {len(labels)} labels")
        return frame.with_column(
            self.getOutputCol(), [labels[i] for i in idx])


# --------------------------------------------------------------------------
# OneHotEncoder
# --------------------------------------------------------------------------

class OneHotEncoderParams(HasInputCol, HasOutputCol):
    outputCol = Param("outputCol", "output vector column", "onehot")
    dropLast = Param("dropLast", "drop the last category (Spark default)",
                     True, validator=lambda v: isinstance(v, bool))
    handleInvalid = Param(
        "handleInvalid",
        "out-of-range category policy: error | keep (extra slot)",
        "error", validator=lambda v: v in ("error", "keep"))


@_persistable
class OneHotEncoder(OneHotEncoderParams):
    """``OneHotEncoder(inputCol="idx").fit(df)`` — category count
    discovered as max(index)+1, Spark semantics (dropLast=True)."""

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_fit("one_hot_encoder")
    def fit(self, dataset) -> "OneHotEncoderModel":
        frame = as_vector_frame(dataset, None)
        idx = np.asarray(frame.column(self.getInputCol()),
                         dtype=np.float64)
        if (idx < 0).any() or not np.array_equal(idx, np.floor(idx)):
            raise ValueError(
                "OneHotEncoder input must be non-negative integer indices")
        model = OneHotEncoderModel(category_size=int(idx.max()) + 1
                                   if idx.size else 0)
        model.uid = self.uid
        model.copy_values_from(self)
        return model


class OneHotEncoderModel(OneHotEncoderParams):
    def __init__(self, category_size: int = 0,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.category_size = category_size

    def _copy_internal_state(self, other) -> None:
        other.category_size = self.category_size

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, None)
        idx = np.asarray(frame.column(self.getInputCol()),
                         dtype=np.float64).astype(np.int64)
        size = self.category_size
        mode = self.get_or_default("handleInvalid")
        keep = mode == "keep"
        width = size + (1 if keep else 0)
        if not keep and ((idx < 0) | (idx >= size)).any():
            raise ValueError(
                f"category index out of range [0, {size}) "
                "(handleInvalid='error')")
        if self.get_or_default("dropLast"):
            width -= 1
        out = np.zeros((idx.shape[0], max(width, 0)))
        j = np.where((idx >= 0) & (idx < size), idx, size)  # invalid slot
        rows = np.flatnonzero(j < width)
        out[rows, j[rows]] = 1.0
        return frame.with_column(self.getOutputCol(), out)

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_onehot_model

        save_onehot_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "OneHotEncoderModel":
        from spark_rapids_ml_tpu_torch.io.persistence import load_onehot_model

        return load_onehot_model(path)


# --------------------------------------------------------------------------
# VectorAssembler
# --------------------------------------------------------------------------

@_persistable
class VectorAssembler(HasOutputCol, Params):
    """Concatenate scalar and/or vector columns into one vector column
    (Spark's ``VectorAssembler``), with the handleInvalid trio."""

    inputCols = Param("inputCols", "columns to concatenate", None,
                      validator=lambda v: v is None or isinstance(
                          v, (list, tuple)))
    outputCol = Param("outputCol", "assembled vector column", "features")
    handleInvalid = Param(
        "handleInvalid", "NaN policy: error | skip | keep",
        "error", validator=lambda v: v in _INVALID_MODES)

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        cols = self.get_or_default("inputCols")
        if not cols:
            raise ValueError("VectorAssembler needs inputCols")
        frame = as_vector_frame(dataset, None)
        parts = []
        for name in cols:
            col = frame.column(name)
            first = col[0] if len(col) else 0.0
            if np.ndim(first) >= 1 or isinstance(
                    col, np.ndarray) and getattr(col, "ndim", 1) == 2:
                parts.append(frame.vectors_as_matrix(name))
            else:
                parts.append(
                    np.asarray(col, dtype=np.float64).reshape(-1, 1))
        out = np.concatenate(parts, axis=1) if parts else np.zeros((0, 0))
        mode = self.get_or_default("handleInvalid")
        bad = ~np.isfinite(out).all(axis=1)
        if bad.any():
            if mode == "error":
                raise ValueError(
                    f"{int(bad.sum())} rows contain NaN/Inf "
                    "(handleInvalid='error')")
            if mode == "skip":
                keep = np.flatnonzero(~bad)
                frame = frame.select_rows(keep)
                out = out[keep]
        return frame.with_column(self.getOutputCol(), out)


# --------------------------------------------------------------------------
# Bucketizer / QuantileDiscretizer
# --------------------------------------------------------------------------

def _valid_splits(v) -> bool:
    if v is None:
        return True
    v = list(v)
    return len(v) >= 3 and all(
        a < b for a, b in zip(v[:-1], v[1:]))


class BucketizerParams(HasInputCol, HasOutputCol):
    outputCol = Param("outputCol", "bucket-index column", "bucketed")
    splits = Param("splits",
                   "strictly increasing split points (len >= 3); "
                   "-inf/inf allowed at the ends",
                   None, validator=_valid_splits)
    handleInvalid = Param(
        "handleInvalid",
        "NaN / out-of-range policy: error | skip | keep (extra bucket)",
        "error", validator=lambda v: v in _INVALID_MODES)


@_persistable
class Bucketizer(BucketizerParams):
    """Scalar column -> bucket index per Spark's rules: bucket i covers
    [splits[i], splits[i+1]) with the last bucket closed on the right."""

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        splits = self.get_or_default("splits")
        if splits is None:
            raise ValueError("Bucketizer needs splits")
        splits = np.asarray([float(v) for v in splits])
        frame = as_vector_frame(dataset, None)
        x = np.asarray(frame.column(self.getInputCol()), dtype=np.float64)
        n_buckets = splits.shape[0] - 1
        idx = np.searchsorted(splits, x, side="right") - 1.0
        idx[x == splits[-1]] = n_buckets - 1   # right edge closed
        bad = np.isnan(x) | (x < splits[0]) | (x > splits[-1])
        mode = self.get_or_default("handleInvalid")
        if bad.any():
            if mode == "error":
                raise ValueError(
                    f"{int(bad.sum())} values NaN or outside "
                    f"[{splits[0]}, {splits[-1]}] "
                    "(handleInvalid='error')")
            if mode == "skip":
                keep = np.flatnonzero(~bad)
                frame = frame.select_rows(keep)
                idx = idx[keep]
            else:   # keep: Spark puts invalids in an extra last bucket
                idx[bad] = float(n_buckets)
        return frame.with_column(self.getOutputCol(), idx)


class QuantileDiscretizerParams(HasInputCol, HasOutputCol):
    outputCol = Param("outputCol", "bucket-index column", "bucketed")
    numBuckets = Param("numBuckets", "number of quantile buckets", 2,
                       validator=lambda v: isinstance(v, int) and v >= 2)
    handleInvalid = Param(
        "handleInvalid", "NaN policy for fit/transform: error | skip | keep",
        "error", validator=lambda v: v in _INVALID_MODES)


@_persistable
class QuantileDiscretizer(QuantileDiscretizerParams):
    """Fits quantile split points, returns a Bucketizer (Spark's exact
    shape: ``QuantileDiscretizer.fit -> Bucketizer``)."""

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_fit("quantile_discretizer")
    def fit(self, dataset) -> Bucketizer:
        frame = as_vector_frame(dataset, None)
        x = np.asarray(frame.column(self.getInputCol()), dtype=np.float64)
        finite = x[np.isfinite(x)]
        if finite.size == 0:
            raise ValueError("no finite values to fit quantiles on")
        q = np.linspace(0.0, 1.0, int(self.getNumBuckets()) + 1)[1:-1]
        inner = np.unique(np.quantile(finite, q))
        splits = np.concatenate([[-np.inf], inner, [np.inf]])
        if splits.shape[0] < 3:
            # all values identical: single bucket, Spark allows it via
            # a degenerate two-bucket split around the value
            splits = np.asarray([-np.inf, float(finite[0]), np.inf])
        model = Bucketizer(
            inputCol=self.getInputCol(),
            outputCol=self.getOutputCol(),
            splits=[float(v) for v in splits],
            handleInvalid=self.get_or_default("handleInvalid"),
        )
        model.uid = self.uid
        return model


# --------------------------------------------------------------------------
# Elementwise / slicing / expansion
# --------------------------------------------------------------------------

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


def _poly_index_sets(n_features: int, degree: int) -> List[List[int]]:
    """Spark PolynomialExpansion's term order: for each highest feature
    index j, for each power c of j (1..degree), every lower-index term of
    remaining degree — recursively the same order."""
    def rec(j_max: int, budget: int) -> List[List[int]]:
        out: List[List[int]] = []
        for j in range(j_max + 1):
            for c in range(1, budget + 1):
                base: List[List[int]] = [[]]
                if budget - c >= 1 and j >= 1:
                    base = base + rec(j - 1, budget - c)
                for t in base:
                    out.append(t + [j] * c)
        return out

    # every term's highest index is the j of the loop level that emitted
    # it, so the enumeration is duplicate-free by construction
    return rec(n_features - 1, degree)


@_persistable
class PolynomialExpansion(HasInputCol, HasOutputCol, Params):
    """All monomials of total degree 1..degree over the input features,
    in Spark's recursive term order (for [x, y], degree 2:
    x, x^2, y, x*y, y^2)."""

    outputCol = Param("outputCol", "expanded vector column", "expanded")
    degree = Param("degree", "maximum total degree (>= 1)", 2,
                   validator=lambda v: isinstance(v, int) and v >= 1)

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        terms = _poly_index_sets(x.shape[1], int(self.getDegree()))
        out = np.empty((x.shape[0], len(terms)))
        for t, idx_list in enumerate(terms):
            col = np.ones(x.shape[0])
            for j in idx_list:
                col = col * x[:, j]
            out[:, t] = col
        return frame.with_column(self.getOutputCol(), out)


# --------------------------------------------------------------------------
# Selectors
# --------------------------------------------------------------------------

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


@_persistable
class ChiSqSelector(HasInputCol, HasOutputCol, Params):
    """Spark ``ChiSqSelector``: rank categorical features by the
    chi-square independence test against the label
    (``stat.ChiSquareTest``), then keep by numTopFeatures / percentile /
    fpr. The model carries a ``fit_report_`` (the JAX package's carries
    none)."""

    labelCol = Param("labelCol", "label column name", "label")
    outputCol = Param("outputCol", "selected vector column", "selected")
    selectorType = Param("selectorType",
                         "numTopFeatures | percentile | fpr",
                         "numTopFeatures",
                         validator=lambda v: v in (
                             "numTopFeatures", "percentile", "fpr"))
    numTopFeatures = Param("numTopFeatures", "how many features to keep",
                           50,
                           validator=lambda v: isinstance(v, int) and v >= 1)
    percentile = Param("percentile", "fraction of features to keep", 0.1,
                       validator=lambda v: 0.0 < float(v) <= 1.0)
    fpr = Param("fpr", "p-value threshold", 0.05,
                validator=lambda v: 0.0 < float(v) <= 1.0)

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_fit("chi_sq_selector")
    def fit(self, dataset) -> ChiSqSelectorModel:
        from spark_rapids_ml_tpu_torch.stat import ChiSquareTest

        res = ChiSquareTest.test(dataset, self.getInputCol(),
                                 self.get_or_default("labelCol"))
        p = res["pValues"]
        kind = self.get_or_default("selectorType")
        order = np.argsort(p, kind="stable")
        if kind == "numTopFeatures":
            keep = order[:int(self.get_or_default("numTopFeatures"))]
        elif kind == "percentile":
            n_keep = max(1, int(len(p) * float(
                self.get_or_default("percentile"))))
            keep = order[:n_keep]
        else:
            keep = np.flatnonzero(p < float(self.get_or_default("fpr")))
        model = ChiSqSelectorModel(selected=keep)
        model.uid = self.uid
        model.copy_values_from(self)
        return model
