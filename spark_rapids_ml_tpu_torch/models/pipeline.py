"""Pipeline / PipelineModel — chained estimators and transformers.

Counterpart of the JAX package's ``models/pipeline.py``. Spark semantics
(``org.apache.spark.ml.Pipeline``): ``fit`` walks the stages in order — an
Estimator is fitted and (if later stages need its output) the fitted model
transforms the running dataset; a Transformer just transforms. The result
is a ``PipelineModel`` holding only transformers. Persistence mirrors
Spark's layout: pipeline metadata plus one subdirectory per stage under
``stages/``, each stage in its own standard metadata+data format, written
to a temporary sibling and renamed into place as every other save is
(``io.persistence``).

A stage loads through ``io.persistence.load_model``: the class recorded in
its metadata maps by its simple name to the port's class of that name, so
a pipeline the JAX package saved loads here without importing anything of
that package.
"""

from __future__ import annotations

import os
from typing import List, Optional

from spark_rapids_ml_tpu_torch.models.params import Params
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import observed_transform


def _is_estimator(stage) -> bool:
    """Estimators carry ``fit``; fitted models / transformers don't."""
    return hasattr(stage, "fit")


def _save_stage(stage, path: str) -> None:
    stage.save(path, overwrite=True)


def _load_stage(path: str):
    """Generic stage loader: the port's class for the one recorded in the
    stage's metadata (``io.persistence.load_model``)."""
    from spark_rapids_ml_tpu_torch.io.persistence import load_model

    return load_model(path)


class Pipeline(Params):
    """``Pipeline(stages=[...]).fit(df) -> PipelineModel``."""

    def __init__(self, stages: Optional[List] = None, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self._stages: List = list(stages) if stages else []

    def setStages(self, stages: List) -> "Pipeline":
        self._stages = list(stages)
        return self

    def getStages(self) -> List:
        return list(self._stages)

    set_stages = setStages
    get_stages = getStages

    def _copy_internal_state(self, other: "Pipeline") -> None:
        other._stages = list(self._stages)

    @observed_fit("pipeline")
    def fit(self, dataset) -> "PipelineModel":
        """Each stage's fit keeps its own report; the pipeline's
        ``fit_report_`` covers the whole walk (the JAX ``Pipeline.fit``
        carries none)."""
        transformers: List = []
        df = dataset
        # Spark's indexOfLastEstimator rule: the running dataset is only
        # transformed up to the last estimator; trailing transformers are
        # appended without a wasted pass during fit.
        last_est = max(
            (i for i, s in enumerate(self._stages) if _is_estimator(s)),
            default=-1,
        )
        for i, stage in enumerate(self._stages):
            if _is_estimator(stage):
                model = stage.fit(df)
                transformers.append(model)
                if i < last_est:
                    df = model.transform(df)
            else:
                transformers.append(stage)
                if i < last_est:
                    df = stage.transform(df)
        model = PipelineModel(stages=transformers)
        model.uid = self.uid
        return model

    # -- persistence ------------------------------------------------------
    def save(self, path: str, overwrite: bool = False) -> None:
        _save_pipeline_like(self, self._stages, path, overwrite)

    @staticmethod
    def load(path: str) -> "Pipeline":
        uid, stages = _load_pipeline_like(path, expect="Pipeline")
        out = Pipeline(stages=stages)
        out.uid = uid
        return out


class PipelineModel(Params):
    """A fitted pipeline: transformers applied in sequence."""

    def __init__(self, stages: Optional[List] = None, uid: Optional[str] = None):
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

    # -- serving ----------------------------------------------------------
    #
    # The staged loop above pays one host round trip per stage; the fused
    # program below pays one per batch (models/_serving.py).

    def _last_stage_col(self, getter: str) -> str:
        """Delegate an output-column getter to the LAST stage, so
        ``serve.engine.extract_output`` resolves the pipeline's answer
        column from a staged-loop frame as it does for the terminal model
        served alone."""
        if not self._stages:
            raise AttributeError(f"empty pipeline has no {getter}")
        fn = getattr(self._stages[-1], getter, None)
        if not callable(fn):
            raise AttributeError(
                f"last stage {type(self._stages[-1]).__name__} has no "
                f"{getter}")
        return fn()

    def getOutputCol(self) -> str:
        return self._last_stage_col("getOutputCol")

    def getProbabilityCol(self) -> str:
        return self._last_stage_col("getProbabilityCol")

    def getPredictionCol(self) -> str:
        return self._last_stage_col("getPredictionCol")

    def _chain_is_wired(self) -> bool:
        """Whether each stage's input column is the PREVIOUS stage's
        output column. The fused program composes stages positionally
        (stage i+1 consumes stage i's device output) — a pipeline wired
        any other way (a stage reading the RAW features past a scaler,
        say) is semantically a DAG, not a chain, and must keep the
        staged frame loop. Stages without the getters (raw-matrix
        transformers) pass — they consume whatever flows in."""
        for prev, nxt in zip(self._stages, self._stages[1:]):
            get_out = getattr(prev, "getOutputCol", None)
            get_in = getattr(nxt, "getInputCol", None)
            if not (callable(get_out) and callable(get_in)):
                continue
            try:
                if get_out() != get_in():
                    return False
            except Exception:
                return False
        return True

    def serving_stages(self, precision: str = "native", device=None):
        """``(device, dtype, stages)``: the per-stage ``ServingStage``
        chain at ``precision`` under one shared device/dtype, or None when
        any stage is not fusable (no hook, hook declined, an output-typed
        stage mid-chain, or column wiring that is not a head-to-tail
        chain). ``device`` overrides the shared device."""
        from spark_rapids_ml_tpu_torch.models._serving import (
            collect_pipeline_stages,
            resolve_pipeline_context,
        )

        if not self._stages or not self._chain_is_wired():
            return None
        device, dtype = resolve_pipeline_context(self._stages, device=device)
        specs = collect_pipeline_stages(self._stages, precision,
                                        device=device, dtype=dtype)
        if not specs:
            return None
        return device, dtype, specs

    def serving_transform_program(self, precision: str = "native",
                                  device=None):
        """ONE fused ``ServingProgram`` for the whole pipeline (one host
        round trip per batch; ``models._serving
        .build_fused_pipeline_program``), registered with the
        micro-batcher's pipeline path like a single-model program; the
        bf16 / int8 variants compose through the stage hooks. Returns
        None when any stage cannot compose — the engine then keeps the
        staged blocking loop."""
        resolved = self.serving_stages(precision, device=device)
        if resolved is None:
            return None
        from spark_rapids_ml_tpu_torch.models._serving import (
            build_fused_pipeline_program,
        )

        device, dtype, specs = resolved
        return build_fused_pipeline_program(
            device=device, dtype=dtype, stages=specs, precision=precision,
            algo="pipeline")

    def save(self, path: str, overwrite: bool = False) -> None:
        _save_pipeline_like(self, self._stages, path, overwrite)

    @staticmethod
    def load(path: str) -> "PipelineModel":
        uid, stages = _load_pipeline_like(path, expect="PipelineModel")
        out = PipelineModel(stages=stages)
        out.uid = uid
        return out


def _save_pipeline_like(obj, stages, path: str, overwrite: bool) -> None:
    from spark_rapids_ml_tpu_torch.io.persistence import _atomic_save

    _atomic_save(_write_pipeline_like)(obj, path, stages, overwrite=overwrite)


def _write_pipeline_like(obj, path: str, stages,
                         overwrite: bool = False) -> None:
    from spark_rapids_ml_tpu_torch.io.persistence import (
        _require_target,
        _write_metadata,
    )

    _require_target(path, overwrite)
    cls = f"{type(obj).__module__}.{type(obj).__qualname__}"
    # Spark stores the stage uids in metadata and each stage under
    # stages/<index>_<uid>/ — same layout here, with one shared fallback
    # so the metadata uid always matches the directory name.
    uids = [getattr(s, "uid", f"stage_{i}") for i, s in enumerate(stages)]
    _write_metadata(path, cls, obj.uid, {"stageUids": uids})
    for i, (stage, uid) in enumerate(zip(stages, uids)):
        _save_stage(stage, os.path.join(path, "stages", f"{i}_{uid}"))


def _load_pipeline_like(path: str, expect: str):
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
    stages = [_load_stage(os.path.join(stages_dir, d)) for d in stage_dirs]
    return meta["uid"], stages
