"""Pipeline and model-selection front-ends over DataFrames.

The port's copy of the JAX package's ``spark/tuning_front.py``: Spark's
composition surface (``pyspark.ml.Pipeline``, ``pyspark.ml.tuning``)
applied to the DataFrame front-ends. Stages are the plane/adapter
estimators from ``spark/``, folds are DataFrame ``randomSplit``/``union``/
``where`` operations (never a driver collect), and scoring runs
evaluator-over-transformed-DataFrame — so a statistics-plane family (PCA,
LinearRegression, ...) is tuned without the rows ever shipping to the
driver, its partials on each executor's card where the family's
``executorDevice`` puts them. The evaluators themselves are the local
``models.evaluation`` classes: ``as_vector_frame`` accepts DataFrames,
and an evaluator only ever sees the two scalar columns of a validation
fold.

Persistence: each stage saves through its own (local-format) writer; a
``front_class.json`` sidecar records the front-end class so load rewraps
stages at the DataFrame layer instead of the VectorFrame layer. Where the
JAX package imports the module the sidecar records, the port resolves the
class by its simple name, never importing the recorded module: a class of
either package's ``spark`` layer through this package's
``spark.__getattr__``, any other as ``io.persistence.load_model`` loads
it. A directory the JAX package saved thus loads here without importing
``jax``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from spark_rapids_ml_tpu_torch.models.pipeline import (
    Pipeline as _LPipeline,
    _load_stage,
)
from spark_rapids_ml_tpu_torch.models.tuning import (
    CrossValidatorModel as _LCVModel,
    ParamGridBuilder,
    TrainValidationSplitModel as _LTVSModel,
    _best_index,
    _load_tuning,
    _save_tuning,
    _TuningParams,
)
from spark_rapids_ml_tpu_torch.models.params import Param, Params
from spark_rapids_ml_tpu_torch.obs import observed_transform

__all__ = [
    "CrossValidator",
    "CrossValidatorModel",
    "ParamGridBuilder",
    "Pipeline",
    "PipelineModel",
    "TrainValidationSplit",
    "TrainValidationSplitModel",
]


def _front_class_path(obj) -> str:
    return f"{type(obj).__module__}.{type(obj).__qualname__}"


def _clone_stage(s):
    """Param-independent copy of a pipeline stage. Adapter-family stages
    clone their wrapped local object (params AND fitted state);
    pyspark-style ESTIMATORS rebuild + ``_copyValues`` (no fitted state
    to lose); fitted pyspark-style models/transformers shallow-copy with
    a fresh param map — rebuilding them via ``type(s)()`` would zero
    their fitted attributes (a prefit PCAModel stage's ``pc``)."""
    import copy as _copy

    if hasattr(s, "_local"):
        c = type(s)()
        c._local = s._local.copy()
        return c
    if hasattr(s, "_copyValues") and hasattr(s, "fit"):
        c = type(s)()
        s._copyValues(c)
        return c
    c = _copy.copy(s)
    for attr in ("_paramMap", "_param_map"):
        if hasattr(c, attr):
            setattr(c, attr, dict(getattr(c, attr)))
    return c


def _clone_with(estimator, params: Dict[str, object]):
    """A copy of a front-end estimator with ``params`` applied.

    Three shapes: a front-end Pipeline (plain names apply to every stage
    declaring them, ``"<i>.<param>"`` pins a stage — the rule of
    ``models.tuning._fit_with``); an adapter-family front-end (clone the
    wrapped local estimator); a plane estimator (pyspark-style
    ``_copyValues`` + setter application)."""
    if hasattr(estimator, "getStages"):
        stages = [_clone_stage(s) for s in estimator.getStages()]
        for name, value in params.items():
            if "." in name:
                idx, pname = name.split(".", 1)
                _apply_param(stages[int(idx)], pname, value)
                continue
            hit = False
            for s in stages:
                if _has_front_param(s, name):
                    _apply_param(s, name, value)
                    hit = True
            if not hit:
                raise ValueError(
                    f"param {name!r} matches no pipeline stage; use "
                    f"'<stage_index>.{name}' to pin a stage"
                )
        return type(estimator)(stages=stages)
    if hasattr(estimator, "_local"):
        out = type(estimator)()
        out._local = estimator._local.copy()
        for name, value in params.items():
            out._set_local(name, value)
        return out
    out = type(estimator)()
    estimator._copyValues(out)
    for name, value in params.items():
        _apply_param(out, name, value)
    return out


def _has_front_param(stage, name: str) -> bool:
    if hasattr(stage, "_local"):
        local_name = getattr(stage, "_aliases", {}).get(name, name)
        return stage._local.has_param(local_name)
    if hasattr(stage, "hasParam"):
        try:
            return stage.hasParam(name)
        except Exception:  # noqa: BLE001 - pyspark raises on unknown
            return False
    return False


def _apply_param(stage, name: str, value) -> None:
    if hasattr(stage, "_set_local"):
        stage._set_local(name, value)
        return
    setter = getattr(stage, "set" + name[0].upper() + name[1:], None)
    if setter is not None:
        setter(value)
        return
    stage._set(**{name: value})


# --------------------------------------------------------------------------
# Pipeline
# --------------------------------------------------------------------------

def _save_stage_front(stage, path: str) -> None:
    try:
        stage.save(path, overwrite=True)
    except TypeError:  # plane estimators take save(path) only
        stage.save(path)
    with open(os.path.join(path, "front_class.json"), "w") as f:
        json.dump({"frontClass": _front_class_path(stage)}, f)


def _load_stage_front(path: str):
    """A stage at the DataFrame layer when its sidecar names a class of
    either package's ``spark`` layer (resolved by simple name through this
    package's ``spark.__getattr__``), else the class its metadata records
    (``io.persistence.load_model``); no recorded module is imported."""
    sidecar = os.path.join(path, "front_class.json")
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            module_name, cls_name = json.load(f)["frontClass"].rsplit(".", 1)
        if "spark" in module_name.split(".")[1:]:
            from spark_rapids_ml_tpu_torch import spark

            return getattr(spark, cls_name).load(path)
    return _load_stage(path)


def _save_pipeline_front(obj, stages, path: str, overwrite: bool) -> None:
    from spark_rapids_ml_tpu_torch.io.persistence import (
        _require_target,
        _write_metadata,
    )

    _require_target(path, overwrite)
    uids = [getattr(s, "uid", f"stage_{i}") for i, s in enumerate(stages)]
    _write_metadata(path, _front_class_path(obj), obj.uid,
                    {"stageUids": uids})
    for i, (stage, uid) in enumerate(zip(stages, uids)):
        _save_stage_front(stage, os.path.join(path, "stages",
                                              f"{i}_{uid}"))


def _load_pipeline_front(path: str, expect: str):
    from spark_rapids_ml_tpu_torch.io.persistence import _read_metadata

    meta = _read_metadata(path)
    cls = meta.get("pythonClass", meta.get("class", ""))
    if cls.rsplit(".", 1)[-1] != expect:
        raise ValueError(f"{path!r} holds {cls!r}, expected a {expect}")
    stages_dir = os.path.join(path, "stages")
    stage_dirs = []
    if os.path.isdir(stages_dir):
        stage_dirs = sorted(
            os.listdir(stages_dir), key=lambda d: int(d.split("_", 1)[0])
        )
    stages = [_load_stage_front(os.path.join(stages_dir, d))
              for d in stage_dirs]
    return meta["uid"], stages


class PipelineModel(Params):
    """A fitted DataFrame pipeline: front-end transformers applied in
    sequence (``pyspark.ml.PipelineModel`` semantics)."""

    def __init__(self, stages: Optional[List] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self._stages: List = list(stages) if stages else []

    @property
    def stages(self) -> List:
        return list(self._stages)

    def _copy_internal_state(self, other: "PipelineModel") -> None:
        other._stages = list(self._stages)

    @observed_transform
    def transform(self, dataset):
        df = dataset
        for stage in self._stages:
            df = stage.transform(df)
        return df

    def save(self, path: str, overwrite: bool = False) -> None:
        _save_pipeline_front(self, self._stages, path, overwrite)

    @staticmethod
    def load(path: str) -> "PipelineModel":
        uid, stages = _load_pipeline_front(path, expect="PipelineModel")
        out = PipelineModel(stages=stages)
        out.uid = uid
        return out


class Pipeline(_LPipeline):
    """DataFrame ``Pipeline(stages=[...])`` over the front-end
    estimators/transformers. Fit logic (Spark's indexOfLastEstimator
    rule) comes from ``models.pipeline.Pipeline`` — the stages are
    duck-typed, so the same composition runs over DataFrames."""

    def fit(self, dataset) -> PipelineModel:
        local_shaped = super().fit(dataset)
        out = PipelineModel(stages=local_shaped.stages)
        out.uid = self.uid
        return out

    def save(self, path: str, overwrite: bool = False) -> None:
        _save_pipeline_front(self, self._stages, path, overwrite)

    @staticmethod
    def load(path: str) -> "Pipeline":
        uid, stages = _load_pipeline_front(path, expect="Pipeline")
        out = Pipeline(stages=stages)
        out.uid = uid
        return out


# --------------------------------------------------------------------------
# CrossValidator / TrainValidationSplit
# --------------------------------------------------------------------------

def _union_all(frames):
    out = frames[0]
    for f in frames[1:]:
        out = out.union(f)
    return out


class CrossValidatorModel(_LCVModel):
    """Front-end CrossValidatorModel: persistence rewraps bestModel /
    estimator at the DataFrame layer via the front_class.json sidecar
    (the local writer would reload them as VectorFrame-layer models)."""

    def save(self, path: str, overwrite: bool = False) -> None:
        _save_tuning(self, path, overwrite, "avgMetrics",
                     list(self.avgMetrics),
                     save_stage=_save_stage_front)

    @classmethod
    def load(cls, path: str) -> "CrossValidatorModel":
        return _load_tuning(cls, path, load_stage=_load_stage_front)


class TrainValidationSplitModel(_LTVSModel):
    """Front-end TrainValidationSplitModel (sidecar persistence — see
    ``CrossValidatorModel``)."""

    def save(self, path: str, overwrite: bool = False) -> None:
        _save_tuning(self, path, overwrite, "validationMetrics",
                     list(self.validationMetrics),
                     save_stage=_save_stage_front)

    @classmethod
    def load(cls, path: str) -> "TrainValidationSplitModel":
        return _load_tuning(cls, path, load_stage=_load_stage_front)


class CrossValidator(_TuningParams):
    """DataFrame k-fold model selection: folds by ``randomSplit`` (or a
    user ``foldCol`` filtered with ``where``), train = union of the
    other folds — Spark's exact shape, no driver collect in the split
    path. ``evaluator`` is a ``models.evaluation`` class (they accept
    transformed DataFrames directly)."""

    foldCol = Param(
        "foldCol",
        "user-specified fold-index column (Spark 3.1 semantics: integer "
        "fold ids in [0, numFolds); '' = random folds by seed)",
        "",
        validator=lambda v: isinstance(v, str),
    )

    def __init__(
        self,
        estimator=None,
        estimatorParamMaps: Optional[List[Dict[str, object]]] = None,
        evaluator=None,
        uid: Optional[str] = None,
        **kwargs,
    ):
        super().__init__(uid=uid)
        self.estimator = estimator
        self.estimatorParamMaps = estimatorParamMaps or [{}]
        self.evaluator = evaluator
        for name, value in kwargs.items():
            self.set(name, value)

    def _folds(self, dataset) -> List:
        k = int(self.getNumFolds())
        fold_col = self.get_or_default("foldCol")
        if fold_col:
            splits = [dataset.where(dataset[fold_col] == f)
                      for f in range(k)]
            counts = [int(s.count()) for s in splits]
            if any(c == 0 for c in counts):
                raise ValueError(
                    f"every fold in [0, numFolds={k}) needs rows; got "
                    f"counts {counts}"
                )
            if sum(counts) != int(dataset.count()):
                raise ValueError(
                    f"foldCol {fold_col!r} must hold integer fold ids "
                    f"in [0, {k})"
                )
            return splits
        splits = dataset.randomSplit([1.0 / k] * k,
                                     seed=int(self.getSeed()))
        if any(int(s.count()) == 0 for s in splits):
            raise ValueError(
                f"randomSplit produced an empty fold over "
                f"{int(dataset.count())} rows; lower numFolds={k} or "
                "provide more data"
            )
        return splits

    def save(self, path: str, overwrite: bool = False) -> None:
        _save_tuning(self, path, overwrite, "metrics", None,
                     save_stage=_save_stage_front)

    @classmethod
    def load(cls, path: str) -> "CrossValidator":
        return _load_tuning(cls, path, load_stage=_load_stage_front)

    def fit(self, dataset) -> CrossValidatorModel:
        if self.estimator is None or self.evaluator is None:
            raise ValueError("estimator and evaluator must be set")
        splits = self._folds(dataset)
        k = len(splits)
        keep_sub = bool(self.get_or_default("collectSubModels"))
        sub_models = ([[None] * len(self.estimatorParamMaps)
                       for _ in range(k)] if keep_sub else None)
        avg_metrics = []
        for p_i, params in enumerate(self.estimatorParamMaps):
            scores = []
            for f in range(k):
                train = _union_all(
                    [splits[g] for g in range(k) if g != f])
                model = _clone_with(self.estimator, params).fit(train)
                scores.append(float(self.evaluator.evaluate(
                    model.transform(splits[f]))))
                if keep_sub:
                    sub_models[f][p_i] = model
            avg_metrics.append(float(np.mean(scores)))

        best_i = _best_index(avg_metrics,
                             self.evaluator.is_larger_better())
        best_model = _clone_with(
            self.estimator, self.estimatorParamMaps[best_i]).fit(dataset)
        out = CrossValidatorModel(
            bestModel=best_model,
            avgMetrics=avg_metrics,
            bestIndex=best_i,
        )
        out.subModels = sub_models
        out.estimator = self.estimator
        out.evaluator = self.evaluator
        out.estimatorParamMaps = self.estimatorParamMaps
        out.uid = self.uid
        out.copy_values_from(self)
        return out


class TrainValidationSplit(_TuningParams):
    """DataFrame single-split model selection (``randomSplit`` by
    ``trainRatio``; winner refit on the full dataset — Spark
    semantics)."""

    def __init__(
        self,
        estimator=None,
        estimatorParamMaps: Optional[List[Dict[str, object]]] = None,
        evaluator=None,
        uid: Optional[str] = None,
        **kwargs,
    ):
        super().__init__(uid=uid)
        self.estimator = estimator
        self.estimatorParamMaps = estimatorParamMaps or [{}]
        self.evaluator = evaluator
        for name, value in kwargs.items():
            self.set(name, value)

    def save(self, path: str, overwrite: bool = False) -> None:
        _save_tuning(self, path, overwrite, "metrics", None,
                     save_stage=_save_stage_front)

    @classmethod
    def load(cls, path: str) -> "TrainValidationSplit":
        return _load_tuning(cls, path, load_stage=_load_stage_front)

    def fit(self, dataset) -> TrainValidationSplitModel:
        if self.estimator is None or self.evaluator is None:
            raise ValueError("estimator and evaluator must be set")
        ratio = float(self.getTrainRatio())
        train, val = dataset.randomSplit([ratio, 1.0 - ratio],
                                         seed=int(self.getSeed()))
        if int(train.count()) == 0 or int(val.count()) == 0:
            raise ValueError(
                f"trainRatio {ratio} leaves an empty split over "
                f"{int(dataset.count())} rows"
            )
        keep_sub = bool(self.get_or_default("collectSubModels"))
        metrics = []
        sub_models = [] if keep_sub else None
        for params in self.estimatorParamMaps:
            model = _clone_with(self.estimator, params).fit(train)
            metrics.append(float(self.evaluator.evaluate(
                model.transform(val))))
            if keep_sub:
                sub_models.append(model)

        best_i = _best_index(metrics, self.evaluator.is_larger_better())
        best_model = _clone_with(
            self.estimator, self.estimatorParamMaps[best_i]).fit(dataset)
        out = TrainValidationSplitModel(
            bestModel=best_model, validationMetrics=metrics,
            bestIndex=best_i,
        )
        out.subModels = sub_models
        out.estimator = self.estimator
        out.evaluator = self.evaluator
        out.estimatorParamMaps = self.estimatorParamMaps
        out.uid = self.uid
        out.copy_values_from(self)
        return out
