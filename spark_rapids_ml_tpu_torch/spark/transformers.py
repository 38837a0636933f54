"""DataFrame front-ends for the feature and text transformer surface.

The port's copy of the JAX package's ``spark/transformers.py``: the
row-wise transformers (Tokenizer / CountVectorizer / IDF, StringIndexer /
OneHotEncoder / Bucketizer, the assembler, slicer and expansion, the
hashers, the selectors, the scalers' stateless Binarizer and Normalizer)
over DataFrames:

- **udf path (default)**: ``transform`` appends the output column per
  Arrow batch through ``pandas_udf`` on the executors; the transformer
  ships by closure (broadcast-small state), constant memory per batch, no
  driver collect.
- **rebuild path**: transforms that can DROP rows
  (``handleInvalid='skip'``) or reshape the schema (RFormula,
  SQLTransformer) cannot ride ``withColumn``; they collect under the
  adapter's envelope guard, run the local transform and rebuild the
  result on the input's session (``adapter3._frame_to_df``).

Fits (StringIndexer, CountVectorizer, IDF, ...) are small-state corpus
scans: they collect the referenced columns under the same envelope guard
and run the local fit on the driver. Everything here is host numpy in
both packages.
"""

from __future__ import annotations

import numpy as np

from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
from spark_rapids_ml_tpu_torch.spark._compat import (
    DenseVector,
    VectorUDT,
    pandas_udf,
)
from spark_rapids_ml_tpu_torch.spark.adapter import (
    _AdapterEstimator,
    _AdapterModel,
    _check_collect_envelope,
)
from spark_rapids_ml_tpu_torch.spark.adapter3 import (
    _cell,
    _frame_to_df,
    _session_of,
)

from spark_rapids_ml_tpu_torch.models import feature_scalers as _fs
from spark_rapids_ml_tpu_torch.models import feature_transformers as _ft
from spark_rapids_ml_tpu_torch.models import feature_transformers2 as _ft2
from spark_rapids_ml_tpu_torch.models import text as _tx
from spark_rapids_ml_tpu_torch.obs import observed_transform

__all__ = [
    "Binarizer",
    "Bucketizer",
    "ChiSqSelector",
    "ChiSqSelectorModel",
    "CountVectorizer",
    "CountVectorizerModel",
    "DCT",
    "ElementwiseProduct",
    "FeatureHasher",
    "HashingTF",
    "IDF",
    "IDFModel",
    "IndexToString",
    "Interaction",
    "NGram",
    "Normalizer",
    "OneHotEncoder",
    "OneHotEncoderModel",
    "PolynomialExpansion",
    "QuantileDiscretizer",
    "RegexTokenizer",
    "RFormula",
    "RFormulaModel",
    "SQLTransformer",
    "StopWordsRemover",
    "StringIndexer",
    "StringIndexerModel",
    "Tokenizer",
    "UnivariateFeatureSelector",
    "UnivariateFeatureSelectorModel",
    "VarianceThresholdSelector",
    "VarianceThresholdSelectorModel",
    "VectorAssembler",
    "VectorIndexer",
    "VectorIndexerModel",
    "VectorSizeHint",
    "VectorSlicer",
]


# output-kind → (pandas_udf returnType, cell wrapper)
def _out_spec(kind: str):
    if kind == "vector":
        return VectorUDT(), (
            lambda v: DenseVector(np.asarray(v, dtype=np.float64)))
    if kind == "double":
        return "double", float
    if kind == "string":
        return "string", str
    if kind == "tokens":
        return "array<string>", (lambda v: [str(t) for t in v])
    raise ValueError(f"unknown output kind {kind!r}")


class _FrontTransform(_AdapterModel):
    """Generic transformer front-end: wraps a local transformer (or a
    fitted local model) and appends its output column per Arrow batch;
    row-dropping configurations fall back to the rebuild path."""

    _out_kind = "vector"
    _out_col_param = "outputCol"
    _in_params: tuple = ("inputCol",)

    def __init__(self, local_model=None, **kwargs):
        if local_model is None:
            local_model = self._local_model_cls()
        super().__init__(local_model)
        for name, value in kwargs.items():
            self._local.set(name, value)

    def _input_cols(self):
        names = []
        for p in self._in_params:
            v = self._local.get_or_default(p)
            if v is None:
                raise ValueError(f"{type(self).__name__} needs {p}")
            if isinstance(v, (list, tuple)):
                names.extend(v)
            else:
                names.append(v)
        return names

    def _row_dropping(self) -> bool:
        local = self._local
        return (local.has_param("handleInvalid")
                and local.get_or_default("handleInvalid") == "skip")

    def _rebuild_transform(self, dataset):
        _check_collect_envelope(dataset, type(self).__name__)
        out = self._local.transform(dataset)  # as_vector_frame duck-path
        return _frame_to_df(_session_of(dataset), out)

    @observed_transform
    def _transform(self, dataset):
        if self._row_dropping():
            return self._rebuild_transform(dataset)
        local = self._local
        out_col = local.get_or_default(self._out_col_param)
        in_cols = self._input_cols()
        return_type, wrap = _out_spec(self._out_kind)

        @pandas_udf(returnType=return_type)
        def apply(*series):
            import pandas as pd

            frame = VectorFrame({
                n: [_cell(v) for v in list(s)]
                for n, s in zip(in_cols, series)
            })
            values = local.transform(frame).column(out_col)
            return pd.Series([wrap(v) for v in values])

        return dataset.withColumn(
            out_col, apply(*[dataset[c] for c in in_cols]))


class _FrontFeatureEstimator(_AdapterEstimator):
    """Generic fit front-end: collects the referenced columns (envelope
    guarded), runs the local fit on the driver, wraps the fitted model
    in its front-end transformer."""

    _fit_col_params: tuple = ("inputCol",)
    _aliases: dict = {}

    def _collect_frame(self, dataset):
        _check_collect_envelope(dataset, type(self).__name__)
        names = []
        for p in self._fit_col_params:
            v = self._local.get_or_default(p)
            if v is None:
                raise ValueError(f"{type(self).__name__} needs {p}")
            if isinstance(v, (list, tuple)):
                names.extend(v)
            else:
                names.append(v)
        rows = dataset.select(*names).collect()
        return VectorFrame({
            n: [_cell(r[i]) for r in rows] for i, n in enumerate(names)
        })


def _make_transformer(name, local_cls, out_kind,
                      in_params=("inputCol",), doc=""):
    return type(name, (_FrontTransform,), {
        "_local_model_cls": local_cls,
        "_out_kind": out_kind,
        "_in_params": tuple(in_params),
        "__doc__": f"DataFrame front-end over "
                   f"``models.{local_cls.__name__}``. {doc}",
    })


def _make_feature_pair(name, local_est, local_model, out_kind,
                       fit_cols=("inputCol",), in_params=("inputCol",),
                       doc=""):
    model_cls = _make_transformer(
        f"{name}Model", local_model, out_kind, in_params, doc)
    est_cls = type(name, (_FrontFeatureEstimator,), {
        "_local_cls": local_est,
        "_model_cls": model_cls,
        "_fit_col_params": tuple(fit_cols),
        "__doc__": f"DataFrame front-end over "
                   f"``models.{local_est.__name__}``. {doc}",
    })
    return est_cls, model_cls


# -- stateless transformers ------------------------------------------------
Tokenizer = _make_transformer(
    "Tokenizer", _tx.Tokenizer, "tokens",
    doc="Lowercase whitespace tokenizer.")
RegexTokenizer = _make_transformer(
    "RegexTokenizer", _tx.RegexTokenizer, "tokens")
StopWordsRemover = _make_transformer(
    "StopWordsRemover", _tx.StopWordsRemover, "tokens")
NGram = _make_transformer("NGram", _tx.NGram, "tokens")
HashingTF = _make_transformer(
    "HashingTF", _tx.HashingTF, "vector",
    doc="Spark-exact murmur3(42) bucket assignment.")
IndexToString = _make_transformer(
    "IndexToString", _ft.IndexToString, "string")
VectorAssembler = _make_transformer(
    "VectorAssembler", _ft.VectorAssembler, "vector",
    in_params=("inputCols",),
    doc="handleInvalid='skip' rides the rebuild path (rows drop).")
Bucketizer = _make_transformer(
    "Bucketizer", _ft.Bucketizer, "double",
    doc="Scalar column → bucket index; 'skip' rides the rebuild path.")
ElementwiseProduct = _make_transformer(
    "ElementwiseProduct", _ft.ElementwiseProduct, "vector")
VectorSlicer = _make_transformer(
    "VectorSlicer", _ft.VectorSlicer, "vector")
PolynomialExpansion = _make_transformer(
    "PolynomialExpansion", _ft.PolynomialExpansion, "vector")
DCT = _make_transformer("DCT", _ft2.DCT, "vector")
Interaction = _make_transformer(
    "Interaction", _ft2.Interaction, "vector", in_params=("inputCols",))
FeatureHasher = _make_transformer(
    "FeatureHasher", _ft2.FeatureHasher, "vector",
    in_params=("inputCols",))
Normalizer = _make_transformer(
    "Normalizer", _fs.Normalizer, "vector")
Binarizer = _make_transformer(
    "Binarizer", _fs.Binarizer, "vector")

# -- fitted pairs ----------------------------------------------------------
CountVectorizer, CountVectorizerModel = _make_feature_pair(
    "CountVectorizer", _tx.CountVectorizer, _tx.CountVectorizerModel,
    "vector",
    doc="Vocabulary by corpus frequency desc, ties alphabetical.")
IDF, IDFModel = _make_feature_pair(
    "IDF", _tx.IDF, _tx.IDFModel, "vector")
StringIndexer, StringIndexerModel = _make_feature_pair(
    "StringIndexer", _ft.StringIndexer, _ft.StringIndexerModel,
    "double",
    doc="handleInvalid='skip' rides the rebuild path (rows drop).")
OneHotEncoder, OneHotEncoderModel = _make_feature_pair(
    "OneHotEncoder", _ft.OneHotEncoder, _ft.OneHotEncoderModel,
    "vector")
VectorIndexer, VectorIndexerModel = _make_feature_pair(
    "VectorIndexer", _ft2.VectorIndexer, _ft2.VectorIndexerModel,
    "vector")
VarianceThresholdSelector, VarianceThresholdSelectorModel = (
    _make_feature_pair(
        "VarianceThresholdSelector", _ft.VarianceThresholdSelector,
        _ft.VarianceThresholdSelectorModel, "vector"))
ChiSqSelector, ChiSqSelectorModel = _make_feature_pair(
    "ChiSqSelector", _ft.ChiSqSelector, _ft.ChiSqSelectorModel,
    "vector", fit_cols=("inputCol", "labelCol"))
UnivariateFeatureSelector, UnivariateFeatureSelectorModel = (
    _make_feature_pair(
        "UnivariateFeatureSelector", _ft2.UnivariateFeatureSelector,
        _ft2.UnivariateFeatureSelectorModel, "vector",
        fit_cols=("inputCol", "labelCol")))


class QuantileDiscretizer(_FrontFeatureEstimator):
    """DataFrame front-end over ``models.QuantileDiscretizer`` —
    Spark's exact shape: ``fit`` returns a (front-end) Bucketizer."""

    _local_cls = _ft.QuantileDiscretizer
    _model_cls = Bucketizer

    def _fit(self, dataset):
        local_bucketizer = self._local.fit(self._collect_frame(dataset))
        return Bucketizer(local_bucketizer)


class VectorSizeHint(_FrontTransform):
    """DataFrame front-end over ``models.VectorSizeHint``: validates the
    declared vector size. 'optimistic' passes through untouched; 'error'
    validates per Arrow batch (no schema change); 'skip' drops invalid
    rows via the rebuild path."""

    _local_model_cls = _ft2.VectorSizeHint

    @observed_transform
    def _transform(self, dataset):
        local = self._local
        mode = local.get_or_default("handleInvalid")
        if mode == "optimistic":
            return dataset
        if mode == "skip":
            return self._rebuild_transform(dataset)
        in_col = local.getInputCol()

        @pandas_udf(returnType=VectorUDT())
        def validate(series):
            import pandas as pd

            frame = VectorFrame({in_col: [_cell(v) for v in series]})
            local.transform(frame)  # raises on size mismatch
            return pd.Series(list(series))

        return dataset.withColumn(in_col, validate(dataset[in_col]))


class SQLTransformer(_FrontTransform):
    """DataFrame front-end over ``models.SQLTransformer`` (the
    scalar-expression ``SELECT ... FROM __THIS__`` subset). The
    statement can reshape the schema, so it always rides the rebuild
    path."""

    _local_model_cls = _ft2.SQLTransformer
    _in_params: tuple = ()

    @observed_transform
    def _transform(self, dataset):
        return self._rebuild_transform(dataset)


class RFormulaModel(_FrontTransform):
    """DataFrame front-end over ``models.RFormulaModel``: emits the
    features (+ label) columns derived from arbitrary input columns, so
    it always rides the rebuild path."""

    _local_model_cls = _ft2.RFormulaModel
    _in_params: tuple = ()

    @observed_transform
    def _transform(self, dataset):
        return self._rebuild_transform(dataset)


class RFormula(_FrontFeatureEstimator):
    """DataFrame front-end over ``models.RFormula`` (R-style
    ``y ~ x1 + x2`` feature/label assembly). The formula references
    arbitrary columns, so fit collects the WHOLE row set (envelope
    guarded)."""

    _local_cls = _ft2.RFormula
    _model_cls = RFormulaModel

    def _collect_frame(self, dataset):
        from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame

        _check_collect_envelope(dataset, type(self).__name__)
        # whole-frame collect via the shared duck-typed path (the
        # formula references arbitrary columns, so nothing prunes)
        return as_vector_frame(dataset, None)
