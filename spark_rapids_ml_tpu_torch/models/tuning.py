"""Model selection: ParamGridBuilder / CrossValidator / TrainValidationSplit.

The port's copy of the JAX package's ``models/tuning.py``: the Spark ML
tuning surface (``org.apache.spark.ml.tuning``) that the reference's
Estimators are consumed through. Semantics match Spark: k-fold (or
single split) over shuffled rows, average metric per param map, winner
refit on the FULL dataset; ``foldCol`` accepts user-assigned fold ids
(Spark 3.1, CrossValidator only). Folds are drawn exactly as the JAX
package draws them (``np.random.default_rng(seed).permutation``), so a
seeded search sees the same folds in both packages. Fitting is
sequential over param maps — each inner fit already fills the card, so
Spark's ``parallelism`` knob would only contend for device memory here.
Each inner fit runs wherever the tuned estimator runs (the card, unless
the CPU is requested). The two ``fit`` methods carry a ``fit_report_``
(the JAX package's carry none).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame
from spark_rapids_ml_tpu_torch.models.params import Param, Params
from spark_rapids_ml_tpu_torch.obs import observed_fit, observed_transform


class ParamGridBuilder:
    """``ParamGridBuilder().addGrid('regParam', [0.0, 0.1]).build()`` →
    list of {param-name: value} maps (cartesian product, Spark's shape)."""

    def __init__(self):
        self._grid: Dict[str, List] = {}

    def addGrid(self, name: str, values) -> "ParamGridBuilder":
        self._grid[name] = list(values)
        return self

    def baseOn(self, base: Dict[str, object]) -> "ParamGridBuilder":
        for name, value in base.items():
            self._grid[name] = [value]
        return self

    def build(self) -> List[Dict[str, object]]:
        maps: List[Dict[str, object]] = [{}]
        for name, values in self._grid.items():
            maps = [{**m, name: v} for m in maps for v in values]
        return maps


def _input_frame(estimator, dataset):
    """Resolve the feature column: the estimator's own inputCol, or — for a
    Pipeline, which has no inputCol — the first stage that declares one.
    Estimators without a vector column at all (ALS consumes scalar
    rating triples) resolve on their primary key column instead, which
    only validates presence — row subsetting works on any column."""
    if estimator.has_param("inputCol"):
        return as_vector_frame(dataset, estimator.getInputCol())
    if estimator.has_param("userCol"):  # ALS-shaped input
        return as_vector_frame(dataset, estimator.getUserCol())
    if hasattr(estimator, "getStages"):
        for stage in estimator.getStages():
            if hasattr(stage, "has_param") and stage.has_param("inputCol"):
                return as_vector_frame(dataset, stage.getInputCol())
    raise ValueError(
        f"cannot locate an input column on {type(estimator).__name__}"
    )


def _fit_with(estimator, params: Dict[str, object], dataset):
    """Fit a copy of ``estimator`` with ``params`` applied.

    For a Pipeline, a plain param name is applied to EVERY stage declaring
    it (error if none does); ``"<stage_index>.<param>"`` pins one stage —
    the name-keyed stand-in for Spark's stage-bound Param objects.
    """
    if hasattr(estimator, "getStages"):
        stages = [
            s.copy() if hasattr(s, "copy") else s
            for s in estimator.getStages()
        ]
        for name, value in params.items():
            if "." in name:
                idx, pname = name.split(".", 1)
                stages[int(idx)].set(pname, value)
                continue
            hit = False
            for s in stages:
                if hasattr(s, "has_param") and s.has_param(name):
                    s.set(name, value)
                    hit = True
            if not hit:
                raise ValueError(
                    f"param {name!r} matches no pipeline stage; use "
                    f"'<stage_index>.{name}' to pin a stage"
                )
        return type(estimator)(stages=stages).fit(dataset)
    est = estimator.copy(extra=params)
    return est.fit(dataset)


def _score(model, evaluator, frame):
    return evaluator.evaluate(model.transform(frame))


def _best_index(metrics, larger_better: bool) -> int:
    """NaN-safe winner pick: a NaN score (e.g. cold-start NaN
    predictions reaching an RMSE evaluator) counts as the WORST
    possible value instead of silently winning via np.argmin/argmax's
    NaN propagation."""
    worst = -np.inf if larger_better else np.inf
    clean = [worst if not np.isfinite(m) else m for m in metrics]
    if all(not np.isfinite(m) for m in metrics):
        raise ValueError(
            f"every candidate scored non-finite ({metrics}); for ALS "
            "use coldStartStrategy='drop' so held-out unseen ids don't "
            "poison the metric")
    pick = np.argmax if larger_better else np.argmin
    return int(pick(clean))


class _TuningParams(Params):
    numFolds = Param(
        "numFolds",
        "number of cross-validation folds",
        3,
        validator=lambda v: isinstance(v, int) and v >= 2,
    )
    trainRatio = Param(
        "trainRatio",
        "train fraction for TrainValidationSplit",
        0.75,
        validator=lambda v: 0.0 < v < 1.0,
    )
    seed = Param(
        "seed", "shuffle seed", 0, validator=lambda v: isinstance(v, int)
    )
    parallelism = Param(
        "parallelism",
        "accepted for Spark surface parity; ignored (each device fit "
        "already saturates the chip — see the module docstring)",
        1, validator=lambda v: isinstance(v, int) and v >= 1,
    )
    collectSubModels = Param(
        "collectSubModels",
        "keep every (paramMap × fold) fitted model on the tuning model "
        "(Spark semantics; memory scales with the grid)",
        False, validator=lambda v: isinstance(v, bool),
    )


class CrossValidator(_TuningParams):
    """``CrossValidator(estimator=…, estimatorParamMaps=…, evaluator=…,
    numFolds=3)`` — Spark's k-fold model selection."""

    foldCol = Param(
        "foldCol",
        "user-specified fold-index column (Spark 3.1 semantics: integer "
        "fold ids in [0, numFolds); '' = random folds by seed). "
        "CrossValidator-only, matching Spark",
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

    @observed_fit("cross_validator")
    def fit(self, dataset) -> "CrossValidatorModel":
        if self.estimator is None or self.evaluator is None:
            raise ValueError("estimator and evaluator must be set")
        frame = _input_frame(self.estimator, dataset)
        n = len(frame)
        folds = self.getNumFolds()
        if n < folds:
            raise ValueError(f"{n} rows cannot make {folds} folds")
        fold_col = self.get_or_default("foldCol")
        if fold_col:
            # Spark 3.1 foldCol: the dataset assigns its own folds
            assign = np.asarray(frame.column(fold_col), dtype=np.float64)
            if not np.allclose(assign, np.round(assign)):
                raise ValueError("foldCol must hold integer fold ids")
            assign = np.round(assign).astype(int)
            if assign.min() < 0 or assign.max() >= folds:
                raise ValueError(
                    f"foldCol values must lie in [0, numFolds={folds})"
                )
            fold_indices = [np.where(assign == f)[0] for f in range(folds)]
            if any(idx.size == 0 for idx in fold_indices):
                raise ValueError("every fold in [0, numFolds) needs rows")
        else:
            rng = np.random.default_rng(self.getSeed())
            perm = rng.permutation(n)
            bounds = np.linspace(0, n, folds + 1).astype(int)
            fold_indices = [
                perm[bounds[f]:bounds[f + 1]] for f in range(folds)
            ]

        keep_sub = bool(self.get_or_default("collectSubModels"))
        avg_metrics = []
        # Spark's indexing: subModels[fold][paramMapIndex]
        sub_models = ([[None] * len(self.estimatorParamMaps)
                       for _ in range(folds)] if keep_sub else None)
        for p_i, params in enumerate(self.estimatorParamMaps):
            scores = []
            for f in range(folds):
                val_idx = fold_indices[f]
                train_idx = np.concatenate(
                    [fold_indices[g] for g in range(folds) if g != f]
                )
                model = _fit_with(
                    self.estimator, params, frame.select_rows(train_idx)
                )
                scores.append(
                    _score(model, self.evaluator, frame.select_rows(val_idx))
                )
                if keep_sub:
                    sub_models[f][p_i] = model
            avg_metrics.append(float(np.mean(scores)))

        best_i = _best_index(avg_metrics,
                             self.evaluator.is_larger_better())
        best_model = _fit_with(
            self.estimator, self.estimatorParamMaps[best_i], frame
        )
        out = CrossValidatorModel(
            bestModel=best_model,
            avgMetrics=avg_metrics,
            bestIndex=best_i,
        )
        out.subModels = sub_models
        # Spark's model writer persists the provenance triple
        out.estimator = self.estimator
        out.evaluator = self.evaluator
        out.estimatorParamMaps = self.estimatorParamMaps
        out.uid = self.uid
        out.copy_values_from(self)
        return out


class CrossValidatorModel(_TuningParams):
    def __init__(
        self,
        bestModel=None,
        avgMetrics: Optional[List[float]] = None,
        bestIndex: int = 0,
        uid: Optional[str] = None,
    ):
        super().__init__(uid=uid)
        self.bestModel = bestModel
        self.avgMetrics = avgMetrics or []
        self.bestIndex = bestIndex
        self.subModels = None  # [fold][paramMapIndex], Spark's indexing
        self.estimator = None
        self.evaluator = None
        self.estimatorParamMaps = None

    def _copy_internal_state(self, other: "CrossValidatorModel") -> None:
        other.bestModel = self.bestModel
        other.avgMetrics = self.avgMetrics
        other.bestIndex = self.bestIndex
        other.subModels = self.subModels
        other.estimator = self.estimator
        other.evaluator = self.evaluator
        other.estimatorParamMaps = self.estimatorParamMaps

    @observed_transform
    def transform(self, dataset):
        if self.bestModel is None:
            raise ValueError("no bestModel; fit first")
        return self.bestModel.transform(dataset)


class TrainValidationSplit(_TuningParams):
    """Single random train/validation split (Spark's cheaper CV variant)."""

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

    @observed_fit("train_validation_split")
    def fit(self, dataset) -> "TrainValidationSplitModel":
        if self.estimator is None or self.evaluator is None:
            raise ValueError("estimator and evaluator must be set")
        frame = _input_frame(self.estimator, dataset)
        n = len(frame)
        rng = np.random.default_rng(self.getSeed())
        perm = rng.permutation(n)
        n_train = int(round(n * self.getTrainRatio()))
        if n_train < 1 or n_train >= n:
            raise ValueError(
                f"trainRatio {self.getTrainRatio()} leaves an empty split "
                f"over {n} rows"
            )
        train = frame.select_rows(perm[:n_train])
        val = frame.select_rows(perm[n_train:])

        keep_sub = bool(self.get_or_default("collectSubModels"))
        metrics = []
        sub_models = [] if keep_sub else None
        for params in self.estimatorParamMaps:
            model = _fit_with(self.estimator, params, train)
            metrics.append(float(_score(model, self.evaluator, val)))
            if keep_sub:
                sub_models.append(model)

        best_i = _best_index(metrics,
                             self.evaluator.is_larger_better())
        best_model = _fit_with(
            self.estimator, self.estimatorParamMaps[best_i], frame
        )
        out = TrainValidationSplitModel(
            bestModel=best_model, validationMetrics=metrics, bestIndex=best_i
        )
        out.subModels = sub_models
        out.estimator = self.estimator
        out.evaluator = self.evaluator
        out.estimatorParamMaps = self.estimatorParamMaps
        out.uid = self.uid
        out.copy_values_from(self)
        return out


class TrainValidationSplitModel(_TuningParams):
    def __init__(
        self,
        bestModel=None,
        validationMetrics: Optional[List[float]] = None,
        bestIndex: int = 0,
        uid: Optional[str] = None,
    ):
        super().__init__(uid=uid)
        self.bestModel = bestModel
        self.validationMetrics = validationMetrics or []
        self.bestIndex = bestIndex
        self.subModels = None  # [paramMap] when collectSubModels
        self.estimator = None
        self.evaluator = None
        self.estimatorParamMaps = None

    def _copy_internal_state(self, other: "TrainValidationSplitModel") -> None:
        other.bestModel = self.bestModel
        other.validationMetrics = self.validationMetrics
        other.bestIndex = self.bestIndex
        other.subModels = self.subModels
        other.estimator = self.estimator
        other.evaluator = self.evaluator
        other.estimatorParamMaps = self.estimatorParamMaps

    @observed_transform
    def transform(self, dataset):
        if self.bestModel is None:
            raise ValueError("no bestModel; fit first")
        return self.bestModel.transform(dataset)


def _save_tuning(obj, path: str, overwrite: bool, metrics_key: str,
                 metrics, save_stage=None) -> None:
    """Shared writer for the tuning estimators/models: own params as
    metadata (paramMaps + metrics in `extra`), the estimator/evaluator/
    bestModel as nested self-describing directories (the Pipeline stage
    convention — each loads back via its recorded pythonClass).
    ``save_stage`` overrides the stage writer (the DataFrame front-end
    layer passes its sidecar-aware one)."""
    import os

    from spark_rapids_ml_tpu_torch.io.persistence import (
        _require_target,
        _write_metadata,
    )
    if save_stage is None:
        from spark_rapids_ml_tpu_torch.models.pipeline import _save_stage
        save_stage = _save_stage

    _require_target(path, overwrite)
    extra = {"estimatorParamMaps": getattr(obj, "estimatorParamMaps",
                                           None)}
    if metrics is not None:
        extra[metrics_key] = metrics
    if hasattr(obj, "bestIndex"):
        extra["bestIndex"] = int(obj.bestIndex)
    cls = f"{type(obj).__module__}.{type(obj).__qualname__}"
    _write_metadata(path, cls, obj.uid, obj.param_map_for_metadata(),
                    extra=extra)
    for name in ("estimator", "evaluator"):
        sub = getattr(obj, name, None)
        if sub is not None:
            save_stage(sub, os.path.join(path, name))
    best = getattr(obj, "bestModel", None)
    if best is not None:
        save_stage(best, os.path.join(path, "bestModel"))


def _load_tuning(cls, path: str, load_stage=None):
    import os

    from spark_rapids_ml_tpu_torch.io.persistence import (
        _read_metadata,
        _restore_params,
    )
    if load_stage is None:
        from spark_rapids_ml_tpu_torch.models.pipeline import _load_stage
        load_stage = _load_stage

    meta = _read_metadata(path)
    obj = cls(uid=meta["uid"])
    _restore_params(obj, meta)
    extra = meta.get("extra", {})
    if extra.get("estimatorParamMaps") is not None and hasattr(
            obj, "estimatorParamMaps"):
        obj.estimatorParamMaps = extra["estimatorParamMaps"]
    for name in ("estimator", "evaluator"):
        sub_path = os.path.join(path, name)
        if os.path.isdir(sub_path) and hasattr(obj, name):
            setattr(obj, name, load_stage(sub_path))
    best_path = os.path.join(path, "bestModel")
    if os.path.isdir(best_path) and hasattr(obj, "bestModel"):
        obj.bestModel = load_stage(best_path)
    if hasattr(obj, "bestIndex") and "bestIndex" in extra:
        obj.bestIndex = int(extra["bestIndex"])
    if hasattr(obj, "avgMetrics") and "avgMetrics" in extra:
        obj.avgMetrics = [float(v) for v in extra["avgMetrics"]]
    if hasattr(obj, "validationMetrics") and (
            "validationMetrics" in extra):
        obj.validationMetrics = [float(v)
                                 for v in extra["validationMetrics"]]
    return obj


def _attach_tuning_persistence():
    """save/load for the four tuning classes (Spark's MLWritable
    surface; subModels are not persisted, matching Spark's default
    writer)."""

    def est_save(self, path, overwrite=False):
        _save_tuning(self, path, overwrite, "metrics", None)

    CrossValidator.save = est_save
    TrainValidationSplit.save = est_save
    CrossValidator.load = classmethod(
        lambda cls, path: _load_tuning(cls, path))
    TrainValidationSplit.load = classmethod(
        lambda cls, path: _load_tuning(cls, path))

    def cvm_save(self, path, overwrite=False):
        _save_tuning(self, path, overwrite, "avgMetrics",
                     list(self.avgMetrics))

    def tvsm_save(self, path, overwrite=False):
        _save_tuning(self, path, overwrite, "validationMetrics",
                     list(self.validationMetrics))

    CrossValidatorModel.save = cvm_save
    TrainValidationSplitModel.save = tvsm_save
    CrossValidatorModel.load = classmethod(
        lambda cls, path: _load_tuning(cls, path))
    TrainValidationSplitModel.load = classmethod(
        lambda cls, path: _load_tuning(cls, path))


_attach_tuning_persistence()
