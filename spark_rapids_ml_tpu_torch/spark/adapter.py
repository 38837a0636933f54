"""Generic DataFrame front-ends for the rest of the model family.

The reference advertises a one-import-change drop-in over Spark DataFrames
(the reference's ``README.md:12-28``); the sufficient-statistics families
(PCA, LinearRegression, LogisticRegression, KMeans) have bespoke
``mapInArrow`` planes in ``spark/estimator.py``, and the tree families
per-level histogram planes in ``spark/forest_estimator.py``. The families
whose fits are NOT small-combinable-statistics shaped (KNN indexes all
items) ride THIS generic adapter instead: ``fit`` gathers the selected
columns to the driver and runs the local estimator on the driver's card —
the same "heavy solve on the driver's device" posture as the reference's
driver-GPU ``calSVD`` (``RapidsRowMatrix.scala:94-95``) — and ``transform``
runs the fitted model per Arrow batch inside a ``pandas_udf`` on executors
(model shipped by closure, the broadcast-small-state pattern of
``RapidsRowMatrix.scala:162-166``).

Scale note, stated rather than hidden: ``fit`` materializes the selected
columns on the driver, so the input must fit in driver memory — the
documented envelope for these families; the statistics families stream.
``transform`` is constant-memory per batch on executors.

The port's copy of the JAX package's ``spark/adapter.py``, for the
families the port has: RandomForest and GBT (both kinds), LinearSVC,
GeneralizedLinearRegression, StandardScaler, MinMaxScaler, MaxAbsScaler,
RobustScaler, TruncatedSVD, NearestNeighbors and UMAP, and NaiveBayes'
model (its estimator is ``spark/estimator.py``'s). Every ``pandas_udf``
body is a module function on numpy rows (``_model_output``,
``_classifier_probability``, ``_classifier_prediction``, ``_svc_raw``,
``_svc_prediction``, ``_glm_eta``, ``_glm_mu``), so it runs without
pandas; the UDFs only wrap them. ``_host_fitted_state`` moves a model's
torch tensors to host numpy before it ships. The GaussianMixture, MLP,
Imputer and OneVsRest pairs wait for their families (ROADMAP queue 1
item 7).

Works identically against real pyspark and the in-repo local engine
(``spark/_compat.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Type

import numpy as np

from spark_rapids_ml_tpu_torch.obs import observed_transform
from spark_rapids_ml_tpu_torch.spark._compat import (
    DenseVector,
    Estimator,
    Model,
    VectorUDT,
    pandas_udf,
)

__all__ = [
    "GBTClassifier",
    "GBTClassifierModel",
    "GBTRegressor",
    "GBTRegressorModel",
    "GeneralizedLinearRegression",
    "GeneralizedLinearRegressionModel",
    "LinearSVC",
    "LinearSVCModel",
    "MaxAbsScaler",
    "MaxAbsScalerModel",
    "MinMaxScaler",
    "MinMaxScalerModel",
    "NaiveBayesModel",
    "NearestNeighbors",
    "NearestNeighborsModel",
    "RandomForestClassifier",
    "RandomForestClassifierModel",
    "RandomForestRegressor",
    "RandomForestRegressorModel",
    "RobustScaler",
    "RobustScalerModel",
    "StandardScaler",
    "StandardScalerModel",
    "TruncatedSVD",
    "TruncatedSVDModel",
    "UMAP",
    "UMAPModel",
]


# Driver-collect envelope (rows). The generic adapter materializes the
# selected columns on the driver — correct for the non-decomposable fits
# it serves but bounded by driver memory, the same envelope convention the
# local models document (models/dbscan.py). Families with executor
# statistics planes (spark/estimator.py, spark/forest_estimator.py) never
# pass through here and have no such bound. The env names are the JAX
# package's.
_COLLECT_WARN_ROWS = int(
    os.environ.get("SPARK_RAPIDS_ML_TPU_COLLECT_WARN_ROWS", 1_000_000)
)
_COLLECT_MAX_ROWS = int(
    os.environ.get("SPARK_RAPIDS_ML_TPU_COLLECT_MAX_ROWS", 10_000_000)
)


def _check_collect_envelope(dataset, est_name: str) -> None:
    """Count rows before a driver collect; warn past the soft envelope,
    raise past the hard one (both configurable via env)."""
    try:
        n = int(dataset.count())
    except Exception:  # noqa: BLE001 - a frame without count() collects as-is
        return
    if n > _COLLECT_MAX_ROWS:
        raise ValueError(
            f"{est_name}.fit would collect {n:,} rows onto the driver "
            f"(envelope: {_COLLECT_MAX_ROWS:,}, "
            "SPARK_RAPIDS_ML_TPU_COLLECT_MAX_ROWS). At this scale use a "
            "statistics-plane family (PCA, LinearRegression, "
            "LogisticRegression, KMeans, RandomForest, GBT) whose "
            "executors reduce partials instead of shipping rows, or "
            "downsample the DataFrame first."
        )
    if n > _COLLECT_WARN_ROWS:
        import warnings

        warnings.warn(
            f"{est_name}.fit collects {n:,} rows onto the driver "
            f"(soft envelope {_COLLECT_WARN_ROWS:,}; hard cap "
            f"{_COLLECT_MAX_ROWS:,} via "
            "SPARK_RAPIDS_ML_TPU_COLLECT_MAX_ROWS)",
            ResourceWarning,
            stacklevel=3,
        )


def _densify(series) -> np.ndarray:
    return np.stack([
        v.toArray() if hasattr(v, "toArray")
        else np.asarray(v, dtype=np.float64)
        for v in series
    ])


# -- the transforms' pandas_udf bodies, on numpy rows -----------------------

def _model_output(local, x: np.ndarray, out_col: str) -> list:
    """The generic model body: the fitted model's own ``transform`` on the
    rows (on its device), its ``out_col`` values."""
    return list(local.transform(x).column(out_col))


def _classifier_probability(local, x: np.ndarray, proba_col: str,
                            scalar_proba: bool) -> np.ndarray:
    """The classifier's probability body: (rows, classes) float64; a model
    whose column holds P(y=1) scalars (GBT) gives Spark's [1 − p, p]."""
    values = local.transform(x).column(proba_col)
    if scalar_proba:
        p = np.asarray(values, dtype=np.float64).reshape(-1)
        return np.stack([1.0 - p, p], axis=1)
    return np.stack([np.asarray(v, dtype=np.float64) for v in values])


def _classifier_prediction(local, proba: np.ndarray,
                           classes: np.ndarray) -> np.ndarray:
    """The classifier's prediction body: the class of argmax p(i)/t(i)
    under the model's thresholds (plain argmax without), from the
    probability column alone — no second model evaluation."""
    if local.has_param("thresholds"):
        idx = local._predict_index(proba)
    else:
        idx = np.argmax(proba, axis=1)
    return np.asarray([float(classes[int(i)]) for i in idx])


def _svc_raw(local, x: np.ndarray) -> np.ndarray:
    """LinearSVC's raw body: Spark's 2-vector [−margin, margin] a row."""
    m = np.asarray(local.decision_function(x), dtype=np.float64)
    return np.stack([-m, m], axis=1)


def _svc_prediction(raw: np.ndarray, thr: float) -> np.ndarray:
    """LinearSVC's prediction body: 1.0 where the margin exceeds the
    threshold."""
    return (raw[:, 1] > thr).astype(np.float64)


def _glm_eta(x: np.ndarray, coef: np.ndarray, b: float,
             offset=None) -> np.ndarray:
    """GLM's linear-predictor body: η = x·w + b (+ offset), host
    float64."""
    eta = x @ coef + b
    if offset is not None:
        eta = eta + np.asarray(offset, dtype=np.float64)
    return eta


def _glm_mu(eta: np.ndarray, link: str, link_power: float) -> np.ndarray:
    """GLM's mean body: μ = g⁻¹(η), host float64."""
    from spark_rapids_ml_tpu_torch.ops.glm_kernel import link_funcs

    _, ginv, _ = link_funcs(link, link_power)
    return np.asarray(ginv(np, np.asarray(eta, dtype=np.float64)),
                      dtype=np.float64)


class _AdapterEstimator(Estimator):
    """``fit(df)`` → driver-collect → local estimator on the driver's card.
    Subclasses set ``_local_cls``/``_model_cls`` and whether a label
    column participates. Param names forward to the local estimator
    (``featuresCol`` aliases the local ``inputCol``), so the full local
    param surface (numTrees, algorithm, ...) is reachable."""

    _local_cls: Optional[Type] = None
    _model_cls: Optional[Type] = None
    _needs_label = False
    _aliases: Dict[str, str] = {"featuresCol": "inputCol"}

    def __init__(self, **kwargs):
        super().__init__()
        self._local = self._local_cls()
        for name, value in kwargs.items():
            self._set_local(name, value)

    # -- param forwarding --------------------------------------------------
    def _set_local(self, name: str, value):
        local_name = self._aliases.get(name, name)
        if not self._local.has_param(local_name):
            raise ValueError(
                f"{type(self).__name__} has no param {name!r}"
            )
        self._local.set(local_name, value)

    def _get_local(self, name: str):
        return self._local.get_or_default(self._aliases.get(name, name))

    def __getattr__(self, attr: str):
        if attr.startswith("set") and len(attr) > 3:
            name = attr[3].lower() + attr[4:]
            return lambda value: (self._set_local(name, value), self)[1]
        if attr.startswith("get") and len(attr) > 3:
            name = attr[3].lower() + attr[4:]
            return lambda: self._get_local(name)
        raise AttributeError(attr)

    @property
    def featuresCol(self) -> str:
        return self._local.getInputCol()

    # -- fit ---------------------------------------------------------------
    def _collect_frame(self, dataset):
        from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame

        _check_collect_envelope(dataset, type(self).__name__)
        fcol = self._local.getInputCol()
        cols = [fcol]
        lcol = None
        if self._needs_label:
            lcol = self._local.getLabelCol()
            cols.append(lcol)
        wcol = ""
        if self._local.has_param("weightCol"):
            wcol = self._local.get_or_default("weightCol") or ""
            if wcol:
                cols.append(wcol)
        rows = dataset.select(*cols).collect()
        frame = as_vector_frame(_densify([r[0] for r in rows]), fcol)
        if lcol is not None:
            frame = frame.with_column(lcol, [float(r[1]) for r in rows])
        if wcol:
            frame = frame.with_column(
                wcol, [float(r[cols.index(wcol)]) for r in rows]
            )
        return frame

    def _fit(self, dataset):
        local_model = self._local.fit(self._collect_frame(dataset))
        return self._model_cls(local_model)

    def fit(self, dataset, params=None):
        return self._fit(dataset)

    # -- persistence -------------------------------------------------------
    def save(self, path: str, overwrite: bool = False) -> None:
        self._local.save(path, overwrite=overwrite)

    @classmethod
    def load(cls, path: str):
        out = cls()
        out._local = cls._local_cls.load(path)
        return out


def _host_fitted_state(model) -> None:
    """Move a fitted model's torch tensors to host numpy, in place, nested
    in tuples (named ones too), lists and dicts. The adapter ships fitted
    models to executors by cloudpickle closure; a CUDA tensor would sync
    the driver's card at pickle time and make every executor worker
    initialize CUDA just to deserialize it. A model that keeps device
    caches drops them first (``_release_device_state``) and restages them
    on its own device at first use."""
    import torch

    release = getattr(model, "_release_device_state", None)
    if release is not None:
        release()

    def to_host(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*(to_host(e) for e in v))
        if isinstance(v, (tuple, list)):
            return type(v)(to_host(e) for e in v)
        if isinstance(v, dict):
            return {k: to_host(e) for k, e in v.items()}
        return v

    for name, value in list(vars(model).items()):
        vars(model)[name] = to_host(value)


class _AdapterModel(Model):
    """Wraps a fitted local model; ``transform`` ships it to executors by
    closure and appends the model's own output column per Arrow batch."""

    _local_model_cls: Optional[Type] = None
    # name of the local param holding the appended column, and its type
    _out_col_param = "predictionCol"
    _out_kind = "double"          # "double" | "vector"

    def __init__(self, local_model):
        super().__init__()
        _host_fitted_state(local_model)
        self._local = local_model

    def __getattr__(self, attr: str):
        if attr.startswith("set") and len(attr) > 3:
            name = attr[3].lower() + attr[4:]
            local = object.__getattribute__(self, "_local")
            if local.has_param(name):
                return lambda value: (local.set(name, value), self)[1]
        if attr.startswith("get") and len(attr) > 3:
            name = attr[3].lower() + attr[4:]
            local = object.__getattribute__(self, "_local")
            if local.has_param(name):
                return lambda: local.get_or_default(name)
        # expose fitted attributes (feature_importances_, classes_, ...)
        return getattr(object.__getattribute__(self, "_local"), attr)

    @observed_transform
    def _transform(self, dataset):
        local = self._local
        in_col = local.getInputCol()
        out_col = local.get_or_default(self._out_col_param)
        if not out_col:   # Spark convention: '' disables the column
            return dataset
        vector_out = self._out_kind == "vector"
        return_type = VectorUDT() if vector_out else "double"

        @pandas_udf(returnType=return_type)
        def apply_model(series):
            import pandas as pd

            values = _model_output(local, _densify(series), out_col)
            if vector_out:
                return pd.Series([DenseVector(v) for v in values])
            return pd.Series([float(v) for v in values])

        return dataset.withColumn(out_col, apply_model(dataset[in_col]))

    @observed_transform
    def transform(self, dataset, params=None):
        return self._transform(dataset)

    def save(self, path: str, overwrite: bool = False) -> None:
        self._local.save(path, overwrite=overwrite)

    @classmethod
    def load(cls, path: str):
        return cls(cls._local_model_cls.load(path))


class _ClassifierAdapterModel(_AdapterModel):
    """Classifier variant: ONE inference pass computes the probability
    column; the prediction column then derives from it with a cheap
    argmax UDF (classes_-mapped) — no second forest/model evaluation,
    matching Spark's vector probability + prediction pair. ``''`` in
    either column param disables that column (Spark convention)."""

    _proba_scalar = False   # local probabilityCol holds P(y=1) scalars

    @observed_transform
    def _transform(self, dataset):
        local = self._local
        in_col = local.getInputCol()
        proba_col = local.get_or_default("probabilityCol")
        pred_col = local.get_or_default(self._out_col_param)
        classes = np.asarray(
            getattr(local, "classes_", None)
            if getattr(local, "classes_", None) is not None
            else [0.0, 1.0],
            dtype=np.float64,
        )
        scalar_proba = self._proba_scalar

        if not proba_col:
            # no probability requested: single prediction-only pass
            return super()._transform(dataset)

        @pandas_udf(returnType=VectorUDT())
        def proba_udf(series):
            import pandas as pd

            proba = _classifier_probability(local, _densify(series),
                                            proba_col, scalar_proba)
            return pd.Series([DenseVector(p) for p in proba])

        result = dataset.withColumn(proba_col, proba_udf(dataset[in_col]))
        if not pred_col:
            return result

        @pandas_udf(returnType="double")
        def pred_udf(series):
            import pandas as pd

            return pd.Series(_classifier_prediction(
                local, _densify(series), classes))

        return result.withColumn(pred_col, pred_udf(result[proba_col]))


class _SVCAdapterModel(_AdapterModel):
    """LinearSVC variant: Spark's ``LinearSVCModel`` emits rawPrediction
    as the 2-vector ``[-margin, margin]`` (one score per class); the local
    model keeps the scalar margin (documented there). ONE inference pass
    computes the raw vector; the prediction column derives from it with a
    cheap margin-vs-threshold UDF. ``''`` in either column param disables
    that column (Spark convention)."""

    @observed_transform
    def _transform(self, dataset):
        local = self._local
        in_col = local.getInputCol()
        raw_col = local.get_or_default("rawPredictionCol")
        pred_col = local.get_or_default(self._out_col_param)
        thr = float(local.get_or_default("threshold"))

        if not raw_col:
            # no raw column requested: single prediction-only pass
            return super()._transform(dataset)

        @pandas_udf(returnType=VectorUDT())
        def raw_udf(series):
            import pandas as pd

            return pd.Series([DenseVector(r)
                              for r in _svc_raw(local, _densify(series))])

        result = dataset.withColumn(raw_col, raw_udf(dataset[in_col]))
        if not pred_col:
            return result

        @pandas_udf(returnType="double")
        def pred_udf(series):
            import pandas as pd

            return pd.Series(_svc_prediction(_densify(series), thr))

        return result.withColumn(pred_col, pred_udf(result[raw_col]))


class _GLMAdapterModel(_AdapterModel):
    """GeneralizedLinearRegression variant: ONE feature pass computes
    eta (linkPrediction); the mean prediction mu = g^-1(eta) derives
    elementwise from it without a second densify/matmul. When ``offsetCol``
    is set the model REQUIRES that column at scoring time and adds it to
    eta — a deliberate deviation from Spark, which silently ignores the
    training offset at transform; silently dropping a fitted exposure
    produces wrong rates (documented in ``models/glm.py``)."""

    @observed_transform
    def _transform(self, dataset):
        local = self._local
        in_col = local.getInputCol()
        pred_col = local.get_or_default("predictionCol")
        link_col = local.get_or_default("linkPredictionCol")
        offset_col = local.get_or_default("offsetCol")
        if offset_col and offset_col not in dataset.columns:
            raise ValueError(
                f"offsetCol {offset_col!r} is set on the model but missing "
                "from the input DataFrame"
            )
        _, link, _, link_power = local._resolved_family_link()
        coef = np.asarray(local.coefficients, dtype=np.float64)
        b = float(local.intercept)

        def values(feat, off, to_mu):
            eta = _glm_eta(_densify(feat), coef, b, off)
            return _glm_mu(eta, link, link_power) if to_mu else eta

        def _feature_pass(col, to_mu):
            """ONE densify + matmul pass producing eta (or mu) into col."""
            if offset_col:
                @pandas_udf(returnType="double")
                def apply(feat, off):
                    import pandas as pd

                    return pd.Series(values(feat, off, to_mu))

                return dataset.withColumn(
                    col, apply(dataset[in_col], dataset[offset_col]))

            @pandas_udf(returnType="double")
            def apply(feat):
                import pandas as pd

                return pd.Series(values(feat, None, to_mu))

            return dataset.withColumn(col, apply(dataset[in_col]))

        if not link_col:
            return _feature_pass(pred_col, True) if pred_col else dataset
        result = _feature_pass(link_col, False)
        if not pred_col:
            return result

        # mu derives elementwise from the already-computed eta column —
        # no second densify/matmul pass (the _SVCAdapterModel pattern)
        @pandas_udf(returnType="double")
        def mu_from_eta(eta_series):
            import pandas as pd

            return pd.Series(_glm_mu(np.asarray(eta_series, dtype=np.float64),
                                     link, link_power))

        return result.withColumn(pred_col, mu_from_eta(result[link_col]))


def _make_pair(name, local_est, local_model, *, needs_label,
               out_col_param="predictionCol", out_kind="double",
               classifier=False, proba_scalar=False, aliases=None, doc="",
               model_base=None):
    base = model_base or (
        _ClassifierAdapterModel if classifier else _AdapterModel
    )
    model_cls = type(
        f"{name}Model",
        (base,),
        {
            "_local_model_cls": local_model,
            "_out_col_param": out_col_param,
            "_out_kind": out_kind,
            "_proba_scalar": proba_scalar,
            "__doc__": f"DataFrame front-end over "
                       f"``models.{local_model.__name__}``. {doc}",
        },
    )
    est_cls = type(
        name,
        (_AdapterEstimator,),
        {
            "_local_cls": local_est,
            "_model_cls": model_cls,
            "_needs_label": needs_label,
            "_aliases": aliases or {"featuresCol": "inputCol"},
            "__doc__": f"DataFrame front-end over "
                       f"``models.{local_est.__name__}``. {doc}",
        },
    )
    return est_cls, model_cls


from spark_rapids_ml_tpu_torch.models.feature_scalers import (  # noqa: E402
    MaxAbsScaler as _LMAS,
    MaxAbsScalerModel as _LMAS_M,
    MinMaxScaler as _LMMS,
    MinMaxScalerModel as _LMMS_M,
    RobustScaler as _LRS,
    RobustScalerModel as _LRS_M,
)
from spark_rapids_ml_tpu_torch.models.gbt import (  # noqa: E402
    GBTClassificationModel as _LGBTC_M,
    GBTClassifier as _LGBTC,
    GBTRegressionModel as _LGBTR_M,
    GBTRegressor as _LGBTR,
)
from spark_rapids_ml_tpu_torch.models.glm import (  # noqa: E402
    GeneralizedLinearRegression as _LGLM,
    GeneralizedLinearRegressionModel as _LGLM_M,
)
from spark_rapids_ml_tpu_torch.models.linear_svc import (  # noqa: E402
    LinearSVC as _LSVC,
    LinearSVCModel as _LSVC_M,
)
from spark_rapids_ml_tpu_torch.models.naive_bayes import (  # noqa: E402
    NaiveBayesModel as _LNB_M,
)
from spark_rapids_ml_tpu_torch.models.nearest_neighbors import (  # noqa: E402
    NearestNeighbors as _LNN,
    NearestNeighborsModel as _LNN_M,
)
from spark_rapids_ml_tpu_torch.models.random_forest import (  # noqa: E402
    RandomForestClassificationModel as _LRFC_M,
    RandomForestClassifier as _LRFC,
    RandomForestRegressionModel as _LRFR_M,
    RandomForestRegressor as _LRFR,
)
from spark_rapids_ml_tpu_torch.models.scaler import (  # noqa: E402
    StandardScaler as _LSS,
    StandardScalerModel as _LSS_M,
)
from spark_rapids_ml_tpu_torch.models.svd import (  # noqa: E402
    TruncatedSVD as _LSVD,
    TruncatedSVDModel as _LSVD_M,
)
from spark_rapids_ml_tpu_torch.models.umap import (  # noqa: E402
    UMAP as _LUMAP,
    UMAPModel as _LUMAP_M,
)

RandomForestClassifier, RandomForestClassifierModel = _make_pair(
    "RandomForestClassifier", _LRFC, _LRFC_M, needs_label=True,
    classifier=True,
    doc="Histogram trees with float64 split search on the driver's card.",
)
RandomForestRegressor, RandomForestRegressorModel = _make_pair(
    "RandomForestRegressor", _LRFR, _LRFR_M, needs_label=True,
)
GBTClassifier, GBTClassifierModel = _make_pair(
    "GBTClassifier", _LGBTC, _LGBTC_M, needs_label=True,
    classifier=True, proba_scalar=True,
)
GBTRegressor, GBTRegressorModel = _make_pair(
    "GBTRegressor", _LGBTR, _LGBTR_M, needs_label=True,
)
# NaiveBayes model wrapper only: the ESTIMATOR lives in
# spark/estimator.py as a mapInArrow statistics plane (per-class
# count/sum/sq partials), which supersedes the driver-collect strategy
NaiveBayesModel = type(
    "NaiveBayesModel",
    (_ClassifierAdapterModel,),
    {"_local_model_cls": _LNB_M,
     "__doc__": "DataFrame front-end over models.NaiveBayesModel."},
)
LinearSVC, LinearSVCModel = _make_pair(
    "LinearSVC", _LSVC, _LSVC_M, needs_label=True,
    model_base=_SVCAdapterModel,
    doc="rawPrediction is Spark's 2-vector [-margin, margin]; prediction "
        "follows the margin-vs-threshold rule.",
)
GeneralizedLinearRegression, GeneralizedLinearRegressionModel = _make_pair(
    "GeneralizedLinearRegression", _LGLM, _LGLM_M, needs_label=True,
    model_base=_GLMAdapterModel,
    doc="Transform emits mu and optional linkPrediction eta.",
)
StandardScaler, StandardScalerModel = _make_pair(
    "StandardScaler", _LSS, _LSS_M, needs_label=False,
    out_col_param="outputCol", out_kind="vector",
    aliases={"featuresCol": "inputCol", "inputCol": "inputCol"},
)
MinMaxScaler, MinMaxScalerModel = _make_pair(
    "MinMaxScaler", _LMMS, _LMMS_M, needs_label=False,
    out_col_param="outputCol", out_kind="vector",
)
MaxAbsScaler, MaxAbsScalerModel = _make_pair(
    "MaxAbsScaler", _LMAS, _LMAS_M, needs_label=False,
    out_col_param="outputCol", out_kind="vector",
)
RobustScaler, RobustScalerModel = _make_pair(
    "RobustScaler", _LRS, _LRS_M, needs_label=False,
    out_col_param="outputCol", out_kind="vector",
    doc="Quantile-range scaling; exact quantiles on the collected fit "
        "(envelope-guarded).",
)
TruncatedSVD, TruncatedSVDModel = _make_pair(
    "TruncatedSVD", _LSVD, _LSVD_M, needs_label=False,
    out_col_param="outputCol", out_kind="vector",
    doc="Top-k singular structure on the driver's card.",
)
UMAP, UMAPModel = _make_pair(
    "UMAP", _LUMAP, _LUMAP_M, needs_label=False,
    out_col_param="outputCol", out_kind="vector",
    doc="Fit embeds the collected items on the driver's card; "
        "transform is the out-of-sample placement rule, applied per "
        "Arrow batch on executors.",
)


def _kneighbors_rows(local, x: np.ndarray, k: Optional[int]) -> list:
    """``kneighbors_frame``'s body: one row dict per query,
    ``{"knn_indices", "knn_distances"}``."""
    dist, idx = local.kneighbors(x, k=k)
    return [{"knn_indices": idx[i].tolist(),
             "knn_distances": dist[i].tolist()}
            for i in range(x.shape[0])]


class NearestNeighbors(_AdapterEstimator):
    """DataFrame front-end over ``models.NearestNeighbors``: ``fit(df)``
    indexes the item vectors (brute/ivfflat/ivfpq per ``algorithm``);
    ``kneighbors(query_df)`` returns (distances, indices) arrays."""

    _local_cls = _LNN
    _needs_label = False

    def _fit(self, dataset):
        local_model = self._local.fit(self._collect_frame(dataset))
        return NearestNeighborsModel(local_model)


class NearestNeighborsModel(_AdapterModel):
    _local_model_cls = _LNN_M

    def kneighbors(self, dataset, k: Optional[int] = None):
        """(distances, indices) ndarrays for the query DataFrame's feature
        column — the batch-query shape the reference project's later
        generations expose."""
        in_col = self._local.getInputCol()
        rows = dataset.select(in_col).collect()
        return self._local.kneighbors(_densify([r[0] for r in rows]), k=k)

    def kneighbors_frame(self, dataset, k: Optional[int] = None):
        """Executor-side batch kNN: every partition runs its OWN queries
        against the broadcast fitted items (host-resident after fit, so
        closure shipping is cheap) — query rows never collect to the
        driver, the per-row (indices, distances) results come back as a
        DataFrame. Row order follows the input's partition-internal
        order, the ``mapInArrow`` contract."""
        local = self._local
        in_col = local.getInputCol()

        def job(batches):
            import pyarrow as pa

            from spark_rapids_ml_tpu_torch.spark.aggregate import (
                vector_column_to_matrix,
            )

            schema = pa.schema([
                ("knn_indices", pa.list_(pa.int64())),
                ("knn_distances", pa.list_(pa.float64())),
            ])
            for batch in batches:
                x = vector_column_to_matrix(batch.column(in_col))
                if x.shape[0] == 0:
                    continue
                yield pa.RecordBatch.from_pylist(
                    _kneighbors_rows(local, x, k), schema=schema)

        return dataset.select(in_col).mapInArrow(
            job, "knn_indices array<bigint>, knn_distances array<double>"
        )

    @observed_transform
    def _transform(self, dataset):
        raise NotImplementedError(
            "NearestNeighborsModel has no column-appending transform; "
            "use kneighbors(query_df) or kneighbors_frame(query_df)"
        )
