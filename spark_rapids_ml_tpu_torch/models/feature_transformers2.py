"""Spark ML feature transformers, batch 2, on the host: DCT, Interaction,
FeatureHasher, VectorIndexer, UnivariateFeatureSelector, RFormula,
VectorSizeHint and SQLTransformer.

Counterpart of the JAX package's ``models/feature_transformers2.py``, with
the same params, semantics (``pyspark.ml.feature`` over the
``VectorFrame`` idiom, the conventions of ``feature_transformers.py``) and
persistence. FeatureHasher hashes with ``models.text.murmur3_x86_32``, so
its indices are Spark's and the JAX package's.

The statistical fits (chi², ANOVA F and F-regression selection) take the
port's ``stat`` scores and scipy CDFs on the host: O(features) scalar work
after one vectorised pass over the data. The fits carry a
``fit_report_``, as every port fit does (the JAX package's carry none).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.models.feature_transformers import (
    _SelectorModelBase,
    _persistable,
)
from spark_rapids_ml_tpu_torch.models.params import (
    HasInputCol,
    HasOutputCol,
    Param,
    Params,
)
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import observed_transform


# --------------------------------------------------------------------------
# DCT
# --------------------------------------------------------------------------

@_persistable
class DCT(HasInputCol, HasOutputCol, Params):
    """Orthonormal DCT-II per row (Spark's ``ml.feature.DCT``);
    ``inverse=True`` applies the DCT-III inverse."""

    outputCol = Param("outputCol", "output vector column", "dct")
    inverse = Param("inverse", "apply the inverse transform (DCT-III)",
                    False, validator=lambda v: isinstance(v, bool))

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        from scipy.fft import dct

        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        kind = 3 if self.get_or_default("inverse") else 2
        out = dct(x, type=kind, norm="ortho", axis=1)
        return frame.with_column(self.getOutputCol(), out)


# --------------------------------------------------------------------------
# Interaction
# --------------------------------------------------------------------------

@_persistable
class Interaction(HasOutputCol, Params):
    """Spark's ``Interaction``: the flattened outer product of every
    input column (vectors and scalars), in input-column order."""

    inputCols = Param("inputCols", "columns to interact", None)
    outputCol = Param("outputCol", "output vector column", "interacted")

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        cols = self.get_or_default("inputCols")
        if not cols or len(cols) < 2:
            raise ValueError("Interaction needs at least 2 inputCols")
        frame = as_vector_frame(dataset, cols[0])
        mats = []
        for c in cols:
            col = frame.column(c)
            if isinstance(col, np.ndarray) and col.ndim == 2:
                mats.append(np.asarray(col, dtype=np.float64))
            else:
                arr = frame.vectors_as_matrix(c) if not np.isscalar(
                    col[0]) and not isinstance(col[0], (int, float)) \
                    else np.asarray(col, dtype=np.float64).reshape(-1, 1)
                mats.append(arr)
        out = mats[0]
        for m in mats[1:]:
            out = (out[:, :, None] * m[:, None, :]).reshape(
                out.shape[0], -1)
        return frame.with_column(self.getOutputCol(), out)


# --------------------------------------------------------------------------
# FeatureHasher
# --------------------------------------------------------------------------

@_persistable
class FeatureHasher(HasOutputCol, Params):
    """Spark's ``FeatureHasher``: murmur3 feature hashing of mixed
    columns — numeric columns hash their NAME (value becomes the cell),
    string/categorical columns hash ``"col=value"`` (cell 1.0)."""

    inputCols = Param("inputCols", "columns to hash", None)
    outputCol = Param("outputCol", "output vector column", "hashed")
    numFeatures = Param("numFeatures", "hash space size", 1 << 18,
                        validator=lambda v: isinstance(v, int) and v >= 1)
    categoricalCols = Param(
        "categoricalCols", "numeric columns to treat as categorical",
        None)

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        from spark_rapids_ml_tpu_torch.models.text import murmur3_x86_32

        cols = self.get_or_default("inputCols")
        if not cols:
            raise ValueError("FeatureHasher needs inputCols")
        n_feat = int(self.get_or_default("numFeatures"))
        cat_override = set(self.get_or_default("categoricalCols") or ())
        frame = as_vector_frame(dataset, cols[0])
        n = len(frame)
        # same dense-envelope guard as HashingTF (models/text.py): the
        # Spark default numFeatures=2^18 would silently allocate ~4 GiB
        # for only 2k rows
        from spark_rapids_ml_tpu_torch.models.text import HashingTF

        if n * n_feat * 8 > HashingTF._MAX_DENSE_BYTES:
            raise ValueError(
                f"dense hashed output {n}x{n_feat} exceeds "
                f"{HashingTF._MAX_DENSE_BYTES >> 30} GiB; lower "
                "numFeatures or batch the input")
        out = np.zeros((n, n_feat))
        for c in cols:
            col = frame.column(c)
            values = list(col)
            numeric = (c not in cat_override and all(
                isinstance(v, (int, float, np.integer, np.floating))
                and not isinstance(v, bool) for v in values))
            if numeric:
                idx = murmur3_x86_32(c.encode("utf-8")) % n_feat
                out[:, idx] += np.asarray(values, dtype=np.float64)
            else:
                for r, v in enumerate(values):
                    term = f"{c}={v}".encode("utf-8")
                    out[r, murmur3_x86_32(term) % n_feat] += 1.0
        return frame.with_column(self.getOutputCol(), out)


# --------------------------------------------------------------------------
# VectorIndexer
# --------------------------------------------------------------------------

class VectorIndexerParams(HasInputCol, HasOutputCol):
    outputCol = Param("outputCol", "output vector column", "indexed")
    maxCategories = Param(
        "maxCategories", "features with <= this many distinct values "
        "are treated as categorical and re-indexed", 20,
        validator=lambda v: isinstance(v, int) and v >= 2)
    handleInvalid = Param(
        "handleInvalid", "unseen category policy: error | skip | keep",
        "error", validator=lambda v: v in ("error", "skip", "keep"))


@_persistable
class VectorIndexer(VectorIndexerParams):
    """Decides categorical features by distinct-value count and
    re-indexes them to 0..k−1 (Spark's ``VectorIndexer``)."""

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_fit("vector_indexer")
    def fit(self, dataset) -> "VectorIndexerModel":
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        max_cat = int(self.get_or_default("maxCategories"))
        maps: Dict[int, Dict[float, int]] = {}
        for j in range(x.shape[1]):
            distinct = np.unique(x[:, j])
            if distinct.size <= max_cat:
                # Spark's zero special-case (VectorIndexer.scala): 0.0
                # always takes index 0 when present — sparsity
                # preservation — and the rest follow ascending
                vals = [float(v) for v in distinct]
                if 0.0 in vals:
                    vals = [0.0] + [v for v in vals if v != 0.0]
                maps[j] = {v: i for i, v in enumerate(vals)}
        model = VectorIndexerModel(category_maps=maps,
                                   num_features=x.shape[1])
        model.uid = self.uid
        model.copy_values_from(self)
        return model


class VectorIndexerModel(VectorIndexerParams):
    def __init__(self, category_maps: Optional[Dict] = None,
                 num_features: int = 0, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.category_maps = category_maps
        self.num_features = num_features

    def _copy_internal_state(self, other) -> None:
        other.category_maps = self.category_maps
        other.num_features = self.num_features

    @property
    def categorical_features_(self) -> List[int]:
        return sorted(self.category_maps or ())

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        if self.category_maps is None:
            raise ValueError("model has no maps; fit first or load")
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        if x.shape[1] != self.num_features:
            raise ValueError(
                f"expected {self.num_features} features, got "
                f"{x.shape[1]}")
        out = x.copy()
        invalid_rows = np.zeros(x.shape[0], dtype=bool)
        mode = self.get_or_default("handleInvalid")
        for j, mapping in self.category_maps.items():
            col = x[:, j]
            mapped = np.full(col.shape[0], -1.0)
            for v, i in mapping.items():
                mapped[col == v] = i
            unseen = mapped < 0
            if unseen.any():
                if mode == "error":
                    raise ValueError(
                        f"unseen category in feature {j} "
                        "(handleInvalid='error')")
                if mode == "keep":
                    mapped[unseen] = len(mapping)
                else:
                    invalid_rows |= unseen
            out[:, j] = mapped
        result = frame.with_column(self.getOutputCol(), out)
        if mode == "skip" and invalid_rows.any():
            result = result.select_rows(np.flatnonzero(~invalid_rows))
        return result

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import (
            save_json_state_model,
        )

        save_json_state_model(
            self, path,
            {"categoryMaps": {str(j): {str(v): i
                                       for v, i in m.items()}
                              for j, m in self.category_maps.items()},
             "numFeatures": self.num_features},
            overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "VectorIndexerModel":
        from spark_rapids_ml_tpu_torch.io.persistence import (
            load_json_state_model,
        )

        model, state = load_json_state_model(VectorIndexerModel, path)
        model.category_maps = {
            int(j): {float(v): i for v, i in m.items()}
            for j, m in state["categoryMaps"].items()}
        model.num_features = int(state["numFeatures"])
        return model


# --------------------------------------------------------------------------
# UnivariateFeatureSelector
# --------------------------------------------------------------------------

class UnivariateFeatureSelectorParams(HasInputCol, HasOutputCol):
    outputCol = Param("outputCol", "selected-features column",
                      "selected")
    labelCol = Param("labelCol", "label column", "label")
    featureType = Param("featureType", "'categorical' | 'continuous'",
                        "continuous",
                        validator=lambda v: v in ("categorical",
                                                  "continuous"))
    labelType = Param("labelType", "'categorical' | 'continuous'",
                      "categorical",
                      validator=lambda v: v in ("categorical",
                                                "continuous"))
    selectionMode = Param(
        "selectionMode",
        "numTopFeatures | percentile | fpr | fdr | fwe",
        "numTopFeatures",
        validator=lambda v: v in ("numTopFeatures", "percentile",
                                  "fpr", "fdr", "fwe"))
    selectionThreshold = Param(
        "selectionThreshold",
        "top-N / fraction / p-value bound, per selectionMode "
        "(Spark defaults: 50 / 0.1 / 0.05 by mode when unset)", None)


@_persistable
class UnivariateFeatureSelector(UnivariateFeatureSelectorParams):
    """Spark 3.1's ``UnivariateFeatureSelector``: the score function is
    chosen by (featureType, labelType) — chi² (cat/cat), ANOVA F
    (cont/cat), F-regression (cont/cont)."""

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    def _p_values(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        from scipy import stats

        from spark_rapids_ml_tpu_torch.stat import (
            anova_f_scores,
            f_regression_scores,
        )

        ft = self.get_or_default("featureType")
        lt = self.get_or_default("labelType")
        d = x.shape[1]
        if ft == "categorical" and lt == "categorical":
            p = np.empty(d)
            for j in range(d):
                table = _contingency(x[:, j], y)
                if table.shape[0] < 2 or table.shape[1] < 2:
                    p[j] = 1.0
                    continue
                p[j] = stats.chi2_contingency(table,
                                              correction=False)[1]
            return p
        if ft == "continuous" and lt == "categorical":
            return anova_f_scores(x, y)[0]
        if ft == "continuous" and lt == "continuous":
            return f_regression_scores(x, y)[0]
        raise ValueError(
            "featureType='categorical' with labelType='continuous' has "
            "no defined score function (Spark raises the same)")

    @observed_fit("univariate_feature_selector")
    def fit(self, dataset) -> "UnivariateFeatureSelectorModel":
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        y = np.asarray(frame.column(self.get_or_default("labelCol")),
                       dtype=np.float64)
        p = self._p_values(x, y)
        mode = self.get_or_default("selectionMode")
        thr = self.get_or_default("selectionThreshold")
        if thr is None:
            thr = {"numTopFeatures": 50, "percentile": 0.1,
                   "fpr": 0.05, "fdr": 0.05, "fwe": 0.05}[mode]
        d = p.shape[0]
        order = np.argsort(p, kind="stable")
        if mode == "numTopFeatures":
            sel = order[:int(thr)]
        elif mode == "percentile":
            sel = order[:int(d * float(thr))]
        elif mode == "fpr":
            sel = np.flatnonzero(p < float(thr))
        elif mode == "fwe":
            sel = np.flatnonzero(p < float(thr) / d)
        else:  # fdr: Benjamini–Hochberg
            ranked = p[order]
            below = ranked <= float(thr) * (
                np.arange(1, d + 1) / d)
            cutoff = np.max(np.flatnonzero(below)) + 1 if below.any() \
                else 0
            sel = order[:cutoff]
        model = UnivariateFeatureSelectorModel(
            selected=sorted(int(j) for j in sel))
        model.uid = self.uid
        model.copy_values_from(self)
        return model


def _contingency(col: np.ndarray, y: np.ndarray) -> np.ndarray:
    xv, xi = np.unique(col, return_inverse=True)
    yv, yi = np.unique(y, return_inverse=True)
    table = np.zeros((xv.size, yv.size))
    np.add.at(table, (xi, yi), 1.0)
    return table


class UnivariateFeatureSelectorModel(UnivariateFeatureSelectorParams,
                                     _SelectorModelBase):
    """Column-slicing transform, unfitted guard, and selector-layout
    persistence all come from ``_SelectorModelBase`` — the same base
    ChiSqSelectorModel / VarianceThresholdSelectorModel share."""

    @property
    def selected(self) -> Optional[List[int]]:
        if self.selected_features is None:
            return None
        return [int(i) for i in self.selected_features]


# --------------------------------------------------------------------------
# RFormula
# --------------------------------------------------------------------------

class RFormulaParams(Params):
    formula = Param("formula", "R-style formula: 'y ~ x1 + x2' or "
                    "'y ~ .'", None)
    featuresCol = Param("featuresCol", "assembled features column",
                        "features")
    labelCol = Param("labelCol", "label output column", "label")


@_persistable
class RFormula(RFormulaParams):
    """Spark's ``RFormula``, the '+' / '.' subset: numeric terms pass
    through, string terms one-hot encode (reference-level dropped, R
    convention), a string RESPONSE string-indexes to a label. The
    interaction/nesting operators (':', '*', '-') are not supported —
    a documented subset, validated at fit."""

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_fit("rformula")
    def fit(self, dataset) -> "RFormulaModel":
        formula = self.get_or_default("formula")
        if not formula or "~" not in formula:
            raise ValueError("formula must look like 'label ~ terms'")
        for op in (":", "*", "-"):
            if op in formula:
                raise ValueError(
                    f"operator {op!r} is not supported (only '+' "
                    "terms and '.')")
        lhs, rhs = (side.strip() for side in formula.split("~", 1))
        frame = as_vector_frame(dataset, lhs)
        terms = [t.strip() for t in rhs.split("+")]
        if terms == ["."]:
            terms = [c for c in frame.columns if c != lhs]
        from spark_rapids_ml_tpu_torch.models.feature_transformers import (
            frequency_ordered_levels as freq_desc_levels,
        )

        encoders: List[tuple] = []  # (col, kind, categories)
        for t in terms:
            col = list(frame.column(t))
            if all(isinstance(v, (int, float, np.integer, np.floating))
                   and not isinstance(v, bool) for v in col):
                encoders.append((t, "numeric", None))
            else:
                # frequencyDesc order; OneHotEncoder's dropLast drops
                # the final (least frequent) level — Spark's encoding
                encoders.append((t, "onehot", freq_desc_levels(col)))
        label_levels = None
        lhs_col = list(frame.column(lhs))
        if not all(isinstance(v, (int, float, np.integer, np.floating))
                   and not isinstance(v, bool) for v in lhs_col):
            label_levels = freq_desc_levels(lhs_col)
        model = RFormulaModel(encoders=encoders,
                              label_source=lhs,
                              label_levels=label_levels)
        model.uid = self.uid
        model.copy_values_from(self)
        return model


class RFormulaModel(RFormulaParams):
    def __init__(self, encoders=None, label_source: Optional[str] = None,
                 label_levels: Optional[List[str]] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.encoders = encoders
        self.label_source = label_source
        self.label_levels = label_levels

    def _copy_internal_state(self, other) -> None:
        other.encoders = self.encoders
        other.label_source = self.label_source
        other.label_levels = self.label_levels

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        if self.encoders is None:
            raise ValueError("model has no encoders; fit first or load")
        frame = as_vector_frame(dataset, self.encoders[0][0]
                                if self.encoders else self.label_source)
        parts = []
        for col, kind, cats in self.encoders:
            values = list(frame.column(col))
            if kind == "numeric":
                parts.append(np.asarray(values,
                                        dtype=np.float64).reshape(-1, 1))
            else:
                # dropLast over frequencyDesc levels (Spark's
                # StringIndexer + OneHotEncoder composition): the LAST,
                # least-frequent level is the all-zeros reference
                block = np.zeros((len(values), max(len(cats) - 1, 0)))
                index = {c: i for i, c in enumerate(cats)}
                for r, v in enumerate(values):
                    i = index.get(str(v))
                    if i is None:
                        raise ValueError(
                            f"unseen level {v!r} in column {col!r}")
                    if i < len(cats) - 1:
                        block[r, i] = 1.0
                parts.append(block)
        features = np.hstack(parts) if parts else np.zeros(
            (len(frame), 0))
        out = frame.with_column(self.get_or_default("featuresCol"),
                                features)
        if self.label_source in frame.columns:
            lab = list(frame.column(self.label_source))
            if self.label_levels is not None:
                index = {c: i for i, c in enumerate(self.label_levels)}
                y = np.empty(len(lab))
                for r, v in enumerate(lab):
                    i = index.get(str(v))
                    if i is None:
                        raise ValueError(
                            f"unseen level {v!r} in label column "
                            f"{self.label_source!r}")
                    y[r] = i
            else:
                y = np.asarray(lab, dtype=np.float64)
            out = out.with_column(self.get_or_default("labelCol"), y)
        return out

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import (
            save_json_state_model,
        )

        save_json_state_model(self, path, {
            "encoders": [[c, k, cats] for c, k, cats in self.encoders],
            "labelSource": self.label_source,
            "labelLevels": self.label_levels,
        }, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "RFormulaModel":
        from spark_rapids_ml_tpu_torch.io.persistence import (
            load_json_state_model,
        )

        model, state = load_json_state_model(RFormulaModel, path)
        model.encoders = [(c, k, cats)
                          for c, k, cats in state["encoders"]]
        model.label_source = state["labelSource"]
        model.label_levels = state["labelLevels"]
        return model


# --------------------------------------------------------------------------
# VectorSizeHint
# --------------------------------------------------------------------------

@_persistable
class VectorSizeHint(HasInputCol, Params):
    """Spark's ``VectorSizeHint``: asserts/declares the size of a vector
    column. handleInvalid: 'error' raises on mismatched/missing rows,
    'skip' drops them, 'optimistic' passes everything through."""

    size = Param("size", "declared vector size", None,
                 validator=lambda v: v is None or (
                     isinstance(v, int) and v >= 1))
    handleInvalid = Param("handleInvalid",
                          "error | skip | optimistic", "error",
                          validator=lambda v: v in ("error", "skip",
                                                    "optimistic"))

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        size = self.get_or_default("size")
        if size is None:
            raise ValueError("VectorSizeHint requires the size param")
        mode = self.get_or_default("handleInvalid")
        frame = as_vector_frame(dataset, self.getInputCol())
        if mode == "optimistic":
            return frame
        col = frame.column(self.getInputCol())

        def row_len(row) -> int:
            if row is None:
                return -1  # null rows are invalid (Spark semantics)
            return row.shape[0] if hasattr(row, "shape") else len(row)

        lengths = np.asarray([row_len(row) for row in col])
        bad = lengths != int(size)
        if bad.any():
            if mode == "error":
                raise ValueError(
                    f"{int(bad.sum())} rows have vector size != {size} "
                    f"in column {self.getInputCol()!r} "
                    "(handleInvalid='error')")
            return frame.select_rows(np.flatnonzero(~bad))
        return frame


# --------------------------------------------------------------------------
# SQLTransformer
# --------------------------------------------------------------------------

@_persistable
class SQLTransformer(Params):
    """Spark's ``SQLTransformer``, the scalar-expression subset:
    ``SELECT <exprs> FROM __THIS__`` where each expr is ``*``, a column
    name, or an arithmetic/comparison expression over scalar columns
    with an ``AS alias`` (evaluated via ``pandas.eval`` — documented
    subset; joins/aggregations/UDF calls are not supported and raise)."""

    statement = Param("statement", "SELECT ... FROM __THIS__", None)

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        import re

        stmt = self.get_or_default("statement")
        if not stmt:
            raise ValueError("SQLTransformer requires the statement param")
        m = re.fullmatch(
            r"\s*SELECT\s+(?P<cols>.+?)\s+FROM\s+__THIS__"
            r"(?P<rest>.*?)\s*;?\s*",
            stmt, flags=re.IGNORECASE | re.DOTALL)
        if not m:
            raise ValueError(
                "statement must look like 'SELECT ... FROM __THIS__' "
                "(the scalar-expression subset; no joins/GROUP BY)")
        if m.group("rest").strip():
            raise ValueError(
                f"clause after FROM __THIS__ is not supported "
                f"(scalar-expression subset): {m.group('rest').strip()!r}")
        for kw in ("JOIN", "GROUP BY", "ORDER BY", "WHERE", "HAVING"):
            if re.search(rf"\b{kw}\b", m.group("cols"),
                         flags=re.IGNORECASE):
                raise ValueError(
                    f"{kw} is not supported (scalar-expression subset)")
        # split the select list on top-level commas
        parts, depth, cur = [], 0, []
        for ch in m.group("cols"):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            if ch == "," and depth == 0:
                parts.append("".join(cur).strip())
                cur = []
            else:
                cur.append(ch)
        parts.append("".join(cur).strip())

        frame = (dataset if isinstance(dataset, VectorFrame)
                 else as_vector_frame(dataset, None))
        pdf = None  # built lazily: bare-column selects never pay the
        # full pandas materialization (2-D columns convert per row)
        out = {}
        for part in parts:
            if part == "*":
                for c in frame.columns:
                    out[c] = frame.column(c)
                continue
            alias_m = re.fullmatch(
                r"(?P<expr>.+?)\s+AS\s+(?P<alias>\w+)", part,
                flags=re.IGNORECASE | re.DOTALL)
            expr = alias_m.group("expr") if alias_m else part
            alias = (alias_m.group("alias") if alias_m
                     else expr.strip())
            expr = expr.strip()
            if re.fullmatch(r"\w+", expr):
                out[alias] = frame.column(expr)
                continue
            if pdf is None:
                pdf = frame.to_pandas()
            out[alias] = pdf.eval(expr).to_numpy()
        return VectorFrame(out)
