"""pyspark-facing Estimator/Model front ends of the statistics plane: PCA,
LinearRegression, LogisticRegression, KMeans and NaiveBayes, the drop-in
the reference ships.

The reference is consumed from spark-shell as a one-import-change drop-in
over Spark DataFrames; its ``fit`` pulls an ``RDD[Vector]``
(``RapidsPCA.scala:111-125``) and runs one GPU GEMM per partition on
executors (``RapidsRowMatrix.scala:168-202``). This module is that front
end for the port:

* ``fit(df)``: ``mapInArrow`` over the input columns — executors densify
  Arrow vector batches and emit per-partition sufficient statistics, on
  their card (``spark.device_aggregate``, the hand Gram kernel) or in host
  NumPy float64 (``spark.aggregate``) — then a driver-side combine and a
  finalize on the driver's card, where the reference put its driver-GPU
  ``calSVD`` (``RapidsRowMatrix.scala:94-95``).
* ``transform(df)``: batched per-Arrow-batch ``pandas_udf``s, the path the
  reference left disabled (``RapidsPCA.scala:172-190``). Each UDF body is
  a module-level function on numpy rows (``_project_pca``,
  ``_linreg_predict``, ``_logreg_probability``,
  ``_multinomial_probability``, ``_multinomial_prediction``,
  ``_kmeans_assign``), so it runs without pandas too.
* persistence: the shared Spark-ML metadata+Parquet wire format
  (``io.persistence``) through the port's models, so a model saved here
  loads in the JAX package's front end and back, from the same files.

The port's copy of the JAX package's ``spark/estimator.py``, NaiveBayes
included; its statistics job runs through
``forest_estimator._collect_rows``, so the partition shims drive it
without pyarrow. One difference by design: the JAX ``PCAModel`` transform
catches every failure of its device projection and projects on the host
instead; here a device failure raises.

Requires ``pyspark`` (an optional dependency) or the in-repo local engine
(``spark/_compat.py``).
"""

from __future__ import annotations

import numpy as np

from spark_rapids_ml_tpu_torch.spark._compat import (
    DenseMatrix,
    DenseVector,
    Estimator,
    HasInputCol,
    HasOutputCol,
    Model,
    Param,
    Params,
    TypeConverters,
    VectorUDT,
    keyword_only,
)

from spark_rapids_ml_tpu_torch.spark.aggregate import (
    combine_stats,
    finalize_pca_from_stats,
    partition_gram_stats_arrow,
    stats_spark_ddl,
)
from spark_rapids_ml_tpu_torch.obs import observed_transform


def _select_stats_plane(executor_device, device_fn, host_fn):
    """The executor-side plane chooser shared by the statistics
    front-ends: 'auto' takes the card when the executor has one and the
    host plane when the CPU was requested (``executor_device_available``
    raises with neither), 'on' requires the device plane (on the CPU when
    requested: how the tests drive it), 'off' forces the NumPy-f64 host
    plane. Returns a cloudpickle-able closure for mapInArrow."""
    if executor_device not in ("auto", "on", "off"):
        raise ValueError(
            f"executorDevice={executor_device!r}: expected "
            "'auto', 'on', or 'off'"
        )

    def stats(batches):
        if executor_device != "off":
            from spark_rapids_ml_tpu_torch.spark.device_aggregate import (
                executor_device_available,
            )

            if executor_device == "on" or executor_device_available():
                return device_fn(batches)
        return host_fn(batches)

    return stats


# -- the transforms' pandas_udf bodies, on numpy rows -----------------------

def _project_pca(x: np.ndarray, pc: np.ndarray, use_xla_dot: bool,
                 device_id: int = -1) -> np.ndarray:
    """PCAModel's UDF body: X @ PC, no mean subtraction
    (``RapidsPCA.scala:187-189``). ``use_xla_dot`` projects on the card
    (``ops.pca_kernel.pca_transform_kernel`` at float32: full f32 whatever
    the TF32 setting), else in host NumPy float64. A device failure
    raises."""
    if not use_xla_dot:
        return x @ pc
    import torch

    from spark_rapids_ml_tpu_torch.ops.pca_kernel import pca_transform_kernel
    from spark_rapids_ml_tpu_torch.utils.resources import resolve_device

    device = resolve_device(device_id)
    return pca_transform_kernel(
        torch.as_tensor(x, dtype=torch.float32, device=device),
        torch.as_tensor(pc, dtype=torch.float32, device=device),
    ).cpu().numpy()


def _linreg_predict(x: np.ndarray, coef: np.ndarray, b: float) -> np.ndarray:
    """LinearRegressionModel's UDF body, host float64."""
    return x @ coef + b


def _logreg_probability(x: np.ndarray, coef: np.ndarray,
                        b: float) -> np.ndarray:
    """Binary LogisticRegressionModel's UDF body: P(y=1) = σ(x·w + b),
    host float64 (as the JAX package's front end computes it)."""
    from spark_rapids_ml_tpu_torch.utils.numeric import sigmoid

    return sigmoid(x @ coef + b)


def _multinomial_probability(x: np.ndarray, cm: np.ndarray,
                             iv: np.ndarray) -> np.ndarray:
    """Multinomial LogisticRegressionModel's probability body: the
    max-shifted softmax of X·Wᵀ + b, host float64."""
    z = x @ cm.T + iv[None, :]
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    e /= e.sum(axis=1, keepdims=True)
    return e


def _multinomial_prediction(proba: np.ndarray, classes: np.ndarray,
                            thr) -> list:
    """Multinomial prediction body: the class of argmax p(i)/t(i) (Spark's
    thresholds rule; argmax p without thresholds)."""
    if thr is not None:
        with np.errstate(divide="ignore", invalid="ignore"):
            proba = proba / np.asarray(thr)[None, :]
        proba = np.where(np.isnan(proba), -np.inf, proba)
    return [float(classes[int(i)]) for i in np.argmax(proba, axis=1)]


def _kmeans_assign(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """KMeansModel's UDF body: the nearest centre by the expanded squared
    distance, host float64, int32 labels."""
    c2 = (centers * centers).sum(axis=1)[None, :]
    d = (x * x).sum(axis=1)[:, None] + c2 - 2.0 * (x @ centers.T)
    return d.argmin(axis=1).astype(np.int32)


class _PCAParams(HasInputCol, HasOutputCol):
    """Param surface mirroring ``RapidsPCAParams`` (``RapidsPCA.scala:30-75``)
    with the reference's GPU toggles under the JAX package's names, so
    saved metadata is shared."""

    k = Param(Params._dummy(), "k", "number of principal components",
              typeConverter=TypeConverters.toInt)
    meanCentering = Param(Params._dummy(), "meanCentering",
                          "center data before covariance",
                          typeConverter=TypeConverters.toBoolean)
    useXlaDot = Param(Params._dummy(), "useXlaDot",
                      "transform on the driver's or executor's card",
                      typeConverter=TypeConverters.toBoolean)
    useXlaSvd = Param(Params._dummy(), "useXlaSvd",
                      "eigensolve on the driver's card",
                      typeConverter=TypeConverters.toBoolean)
    deviceId = Param(Params._dummy(), "deviceId",
                     "CUDA device ordinal; -1 = task/env assignment",
                     typeConverter=TypeConverters.toInt)
    executorDevice = Param(
        Params._dummy(), "executorDevice",
        "where partition statistics run: 'auto' = each executor's "
        "card (the reference's GPU-on-every-executor architecture), the "
        "host NumPy plane when the CPU was requested; 'on' = require the "
        "executor device plane (on the CPU when requested — how tests "
        "drive it); 'off' = always executor-CPU NumPy; 'collective' = "
        "barrier stage + all_reduce over one torch.distributed job (no "
        "executor-to-driver partial shipping)",
        typeConverter=TypeConverters.toString)

    def __init__(self):
        super().__init__()
        self._setDefault(k=None, meanCentering=True, useXlaDot=True,
                         useXlaSvd=True, deviceId=-1, executorDevice="auto")

    def getK(self):
        return self.getOrDefault(self.k)

    def getMeanCentering(self):
        return self.getOrDefault(self.meanCentering)

    def getUseXlaDot(self):
        return self.getOrDefault(self.useXlaDot)

    def getUseXlaSvd(self):
        return self.getOrDefault(self.useXlaSvd)

    def getDeviceId(self):
        return self.getOrDefault(self.deviceId)

    def getExecutorDevice(self):
        return self.getOrDefault(self.executorDevice)


class PCA(Estimator, _PCAParams):
    """``PCA(k=3, inputCol="features", outputCol="pca_features").fit(df)`` —
    the reference README's example shape."""

    @keyword_only
    def __init__(self, *, k=None, inputCol=None, outputCol="pca_features",
                 meanCentering=True, useXlaDot=True, useXlaSvd=True,
                 deviceId=-1, executorDevice="auto"):
        super().__init__()
        self._setDefault(outputCol="pca_features")
        kwargs = self._input_kwargs
        self.setParams(**{k_: v for k_, v in kwargs.items() if v is not None})

    @keyword_only
    def setParams(self, *, k=None, inputCol=None, outputCol=None,
                  meanCentering=None, useXlaDot=None, useXlaSvd=None,
                  deviceId=None, executorDevice=None):
        kwargs = self._input_kwargs
        return self._set(**{k_: v for k_, v in kwargs.items() if v is not None})

    def setK(self, value):
        return self._set(k=value)

    def setInputCol(self, value):
        return self._set(inputCol=value)

    def setOutputCol(self, value):
        return self._set(outputCol=value)

    def setMeanCentering(self, value):
        return self._set(meanCentering=value)

    def setUseXlaDot(self, value):
        return self._set(useXlaDot=value)

    def setUseXlaSvd(self, value):
        return self._set(useXlaSvd=value)

    def setDeviceId(self, value):
        return self._set(deviceId=value)

    def setExecutorDevice(self, value):
        return self._set(executorDevice=value)

    def _fit(self, dataset) -> "PCAModel":
        k = self.getK()
        if k is None:
            raise ValueError("k must be set before fit()")
        input_col = self.getInputCol()
        df = dataset.select(input_col)
        executor_device = self.getExecutorDevice()
        if executor_device not in ("auto", "on", "off", "collective"):
            raise ValueError(
                f"executorDevice={executor_device!r}: expected "
                "'auto', 'on', 'off', or 'collective'"
            )
        device_id = self.getDeviceId()

        if executor_device == "collective":
            # barrier stage + on-device global reduce: each task streams
            # its partition through its own card, then all_reduce over one
            # torch.distributed job sums the partials — no
            # executor→driver partial shipping at all
            import os as _os
            import socket

            coordinator = _os.environ.get(
                "SPARK_RAPIDS_ML_TORCH_COORDINATOR")
            if not coordinator:
                # ephemeral pick-and-release: the real bind happens later
                # inside the partition-0 task, so another process could in
                # principle steal the port in between — production fleets
                # preset SPARK_RAPIDS_ML_TORCH_COORDINATOR to a reserved
                # routable host:port instead
                with socket.socket() as s:
                    s.bind(("", 0))
                    port = s.getsockname()[1]
                coordinator = f"127.0.0.1:{port}"

            first = df.first()
            if first is None:
                raise ValueError("empty dataset")
            n_features = len(first[0])

            def stats(batches):
                from spark_rapids_ml_tpu_torch.spark.device_aggregate import (
                    partition_gram_stats_device_collective,
                )

                return partition_gram_stats_device_collective(
                    batches, input_col, coordinator, n_features, device_id
                )

            try:
                mapped = df.mapInArrow(
                    stats, stats_spark_ddl(), barrier=True
                )
            except TypeError as exc:
                raise RuntimeError(
                    "executorDevice='collective' needs barrier task "
                    "scheduling: DataFrame.mapInArrow(barrier=True) "
                    "requires pyspark >= 3.5"
                ) from exc
            rows = mapped.collect()
        else:
            # 'auto'/'on' put the Gram on the executor's card (the
            # reference's per-partition executor-GPU GEMM,
            # RapidsRowMatrix.scala:168-202); 'off' and a CPU request take
            # host NumPy
            from spark_rapids_ml_tpu_torch.spark.device_aggregate import (
                partition_gram_stats_device_arrow,
            )

            stats = _select_stats_plane(
                executor_device,
                lambda b_: partition_gram_stats_device_arrow(
                    b_, input_col, device_id),
                lambda b_: partition_gram_stats_arrow(b_, input_col),
            )
            rows = df.mapInArrow(stats, stats_spark_ddl()).collect()
        gram, col_sum, count = combine_stats(rows)
        n_features = col_sum.shape[0]
        if k > n_features:
            raise ValueError(
                f"k = {k} must be at most the number of features {n_features}"
            )
        pc, evr, mean = finalize_pca_from_stats(
            gram, col_sum, count, k,
            mean_centering=self.getMeanCentering(),
            use_xla_svd=self.getUseXlaSvd(),
            device_id=self.getDeviceId(),
        )
        model = PCAModel(
            pc=DenseMatrix(n_features, k, pc.ravel(order="F").tolist()),
            explainedVariance=DenseVector(evr.tolist()),
            mean=DenseVector(mean.tolist()),
        )
        return self._copyValues(model)

    def save(self, path: str, overwrite: bool = False) -> None:
        _save_estimator_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "PCA":
        return _load_estimator_params(PCA, path)


class PCAModel(Model, _PCAParams):
    """Fitted transformer: ``pc`` (n×k DenseMatrix), ``explainedVariance``
    (k,), as ``RapidsPCAModel`` (``RapidsPCA.scala:146-210``)."""

    def __init__(self, pc=None, explainedVariance=None, mean=None):
        super().__init__()
        self.pc = pc
        self.explainedVariance = explainedVariance
        self.mean = mean

    @observed_transform
    def _transform(self, dataset):
        import pandas as pd
        from spark_rapids_ml_tpu_torch.spark._compat import pandas_udf

        pc_np = self.pc.toArray()  # (n_features, k), column-major storage
        out_col = self.getOutputCol()
        use_xla = self.getUseXlaDot()
        device_id = self.getDeviceId()

        @pandas_udf(returnType=VectorUDT())
        def project(v: pd.Series) -> pd.Series:
            x = np.stack([row.toArray() for row in v])
            y = _project_pca(x, pc_np, use_xla, device_id)
            return pd.Series([DenseVector(row) for row in y])

        return dataset.withColumn(out_col, project(dataset[self.getInputCol()]))

    # -- persistence (shared wire format) ---------------------------------
    def _to_local(self):
        from spark_rapids_ml_tpu_torch.models.pca import PCAModel as LocalPCAModel

        local = LocalPCAModel(
            pc=self.pc.toArray(),
            explained_variance=self.explainedVariance.toArray(),
            mean=self.mean.toArray() if self.mean is not None else None,
            uid=self.uid,
        )
        for name in ("k", "inputCol", "outputCol", "meanCentering",
                     "useXlaDot", "useXlaSvd", "deviceId"):
            if self.isSet(getattr(self, name)) or self.hasDefault(getattr(self, name)):
                value = self.getOrDefault(getattr(self, name))
                if value is not None and local.has_param(name):
                    local.set(name, value)
        return local

    def save(self, path: str, overwrite: bool = False) -> None:
        self._to_local().save(path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "PCAModel":
        from spark_rapids_ml_tpu_torch.models.pca import PCAModel as LocalPCAModel

        local = LocalPCAModel.load(path)
        n, k = local.pc.shape
        model = PCAModel(
            pc=DenseMatrix(n, k, local.pc.ravel(order="F").tolist()),
            explainedVariance=DenseVector(local.explained_variance.tolist()),
            mean=(DenseVector(local.mean.tolist())
                  if local.mean is not None else None),
        )
        model._resetUid(local.uid)
        for name in ("k", "inputCol", "outputCol", "meanCentering",
                     "useXlaDot", "useXlaSvd", "deviceId"):
            if local.is_set(name):
                model._set(**{name: local.get(name)})
        return model


class _LinRegParams(Params):
    featuresCol = Param(Params._dummy(), "featuresCol", "features column",
                        typeConverter=TypeConverters.toString)
    labelCol = Param(Params._dummy(), "labelCol", "label column",
                     typeConverter=TypeConverters.toString)
    predictionCol = Param(Params._dummy(), "predictionCol",
                          "prediction output column",
                          typeConverter=TypeConverters.toString)
    regParam = Param(Params._dummy(), "regParam", "L2 strength lambda",
                     typeConverter=TypeConverters.toFloat)
    fitIntercept = Param(Params._dummy(), "fitIntercept", "fit an intercept",
                         typeConverter=TypeConverters.toBoolean)
    executorDevice = Param(Params._dummy(), "executorDevice",
                           "partition statistics on each executor's "
                           "card: 'auto'/'on'/'off'",
                           typeConverter=TypeConverters.toString)
    deviceId = Param(Params._dummy(), "deviceId",
                     "executor CUDA device ordinal; -1 = task assignment",
                     typeConverter=TypeConverters.toInt)
    weightCol = Param(Params._dummy(), "weightCol",
                      "per-row sample-weight column ('' = unweighted; "
                      "weighted fits run the host-f64 executor plane)",
                      typeConverter=TypeConverters.toString)

    def __init__(self):
        super().__init__()
        self._setDefault(weightCol="")
        self._setDefault(featuresCol="features", labelCol="label",
                         predictionCol="prediction", regParam=0.0,
                         fitIntercept=True, executorDevice="auto",
                         deviceId=-1)


class LinearRegression(Estimator, _LinRegParams):
    """Normal-equations LinearRegression over a Spark DataFrame: ONE
    ``mapInArrow`` pass of Z=[X|y] sufficient statistics on executors, a
    driver combine, and the tiny (n+1)² solve — the same partial-aggregate
    data plane as the PCA fit."""

    @keyword_only
    def __init__(self, *, featuresCol="features", labelCol="label",
                 predictionCol="prediction", regParam=0.0, fitIntercept=True,
                 executorDevice="auto", deviceId=-1, weightCol=""):
        super().__init__()
        self._set(**{k_: v for k_, v in self._input_kwargs.items()
                     if v is not None})

    def setWeightCol(self, value):
        return self._set(weightCol=value)

    def setRegParam(self, value):
        return self._set(regParam=value)

    def setFitIntercept(self, value):
        return self._set(fitIntercept=value)

    def save(self, path: str, overwrite: bool = False) -> None:
        _save_estimator_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "LinearRegression":
        return _load_estimator_params(LinearRegression, path)

    def _fit(self, dataset) -> "LinearRegressionModel":
        from spark_rapids_ml_tpu_torch.spark.aggregate import (
            partition_xy_stats_arrow,
            solve_linreg_from_stats,
        )

        fcol = self.getOrDefault(self.featuresCol)
        lcol = self.getOrDefault(self.labelCol)
        device_id = self.getOrDefault(self.deviceId)
        wcol = self.getOrDefault(self.weightCol) or None
        cols = [fcol, lcol] + ([wcol] if wcol else [])
        df = dataset.select(*cols)

        from spark_rapids_ml_tpu_torch.spark.device_aggregate import (
            partition_xy_stats_device_arrow,
        )

        stats = _select_stats_plane(
            # weighted least squares runs the host-f64 plane
            "off" if wcol else self.getOrDefault(self.executorDevice),
            lambda b: partition_xy_stats_device_arrow(b, fcol, lcol,
                                                      device_id),
            lambda b: partition_xy_stats_arrow(b, fcol, lcol,
                                               weight_col=wcol),
        )

        rows = df.mapInArrow(stats, stats_spark_ddl()).collect()
        gram, col_sum, count = combine_stats(rows)
        coef, intercept = solve_linreg_from_stats(
            gram, col_sum, count,
            reg_param=float(self.getOrDefault(self.regParam)),
            fit_intercept=self.getOrDefault(self.fitIntercept),
        )
        model = LinearRegressionModel(
            coefficients=DenseVector(coef.tolist()), intercept=intercept
        )
        return self._copyValues(model)


class LinearRegressionModel(Model, _LinRegParams):
    def __init__(self, coefficients=None, intercept=0.0):
        super().__init__()
        self.coefficients = coefficients
        self.intercept = intercept

    @observed_transform
    def _transform(self, dataset):
        import pandas as pd
        from spark_rapids_ml_tpu_torch.spark._compat import pandas_udf

        coef = self.coefficients.toArray()
        b = float(self.intercept)

        @pandas_udf(returnType="double")
        def predict(v: pd.Series) -> pd.Series:
            x = np.stack([row.toArray() for row in v])
            return pd.Series(_linreg_predict(x, coef, b))

        return dataset.withColumn(
            self.getOrDefault(self.predictionCol),
            predict(dataset[self.getOrDefault(self.featuresCol)]),
        )

    # -- persistence (shared wire format via the local model) --------------
    def _to_local(self):
        from spark_rapids_ml_tpu_torch.models.linear_regression import (
            LinearRegressionModel as LocalModel,
        )

        local = LocalModel(
            coefficients=np.asarray(self.coefficients.toArray()),
            intercept=float(self.intercept),
            uid=self.uid,
        )
        for theirs, ours in (("featuresCol", "inputCol"),
                             ("labelCol", "labelCol"),
                             ("predictionCol", "predictionCol"),
                             ("regParam", "regParam"),
                             ("fitIntercept", "fitIntercept")):
            value = self.getOrDefault(getattr(self, theirs))
            if value is not None and local.has_param(ours):
                local.set(ours, value)
        return local

    def save(self, path: str, overwrite: bool = False) -> None:
        self._to_local().save(path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "LinearRegressionModel":
        from spark_rapids_ml_tpu_torch.models.linear_regression import (
            LinearRegressionModel as LocalModel,
        )

        local = LocalModel.load(path)
        model = LinearRegressionModel(
            coefficients=DenseVector(
                np.asarray(local.coefficients).tolist()),
            intercept=float(local.intercept),
        )
        model._resetUid(local.uid)
        if local.is_set("inputCol"):
            model._set(featuresCol=local.get("inputCol"))
        for name in ("labelCol", "predictionCol", "regParam",
                     "fitIntercept"):
            if local.is_set(name):
                model._set(**{name: local.get(name)})
        return model


class _LogRegParams(Params):
    featuresCol = Param(Params._dummy(), "featuresCol", "features column",
                        typeConverter=TypeConverters.toString)
    labelCol = Param(Params._dummy(), "labelCol", "binary 0/1 label column",
                     typeConverter=TypeConverters.toString)
    predictionCol = Param(Params._dummy(), "predictionCol",
                          "predicted class output column",
                          typeConverter=TypeConverters.toString)
    probabilityCol = Param(Params._dummy(), "probabilityCol",
                           "probability output column: P(y=1) double for "
                           "binary fits, per-class vector for multinomial",
                           typeConverter=TypeConverters.toString)
    regParam = Param(Params._dummy(), "regParam", "L2 strength lambda",
                     typeConverter=TypeConverters.toFloat)
    fitIntercept = Param(Params._dummy(), "fitIntercept", "fit an intercept",
                         typeConverter=TypeConverters.toBoolean)
    maxIter = Param(Params._dummy(), "maxIter", "max Newton iterations",
                    typeConverter=TypeConverters.toInt)
    tol = Param(Params._dummy(), "tol", "Newton step convergence tolerance",
                typeConverter=TypeConverters.toFloat)
    executorDevice = Param(Params._dummy(), "executorDevice",
                           "partition statistics on each executor's "
                           "card: 'auto'/'on'/'off'",
                           typeConverter=TypeConverters.toString)
    deviceId = Param(Params._dummy(), "deviceId",
                     "executor CUDA device ordinal; -1 = task assignment",
                     typeConverter=TypeConverters.toInt)
    thresholds = Param(Params._dummy(), "thresholds",
                       "per-class probability thresholds: prediction = "
                       "argmax p(i)/t(i) (Spark semantics; unset = argmax "
                       "/ p>=0.5)",
                       typeConverter=TypeConverters.toListFloat)
    weightCol = Param(Params._dummy(), "weightCol",
                      "per-row sample-weight column ('' = unweighted; "
                      "weighted fits run the host-f64 executor plane)",
                      typeConverter=TypeConverters.toString)
    family = Param(Params._dummy(), "family",
                   "auto (label-discovery pass picks) | binomial (skip "
                   "discovery; labels validated 0/1 in executors) | "
                   "multinomial (softmax plane regardless of class count)",
                   typeConverter=TypeConverters.toString)

    def __init__(self):
        super().__init__()
        self._setDefault(featuresCol="features", labelCol="label",
                         predictionCol="prediction",
                         probabilityCol="probability", regParam=0.0,
                         fitIntercept=True, maxIter=25, tol=1e-8,
                         executorDevice="auto", deviceId=-1, weightCol="",
                         family="auto")

    def setWeightCol(self, value):
        return self._set(weightCol=value)

    def setFamily(self, value):
        return self._set(family=value)

    def setThresholds(self, value):
        return self._set(thresholds=value)

    def _thresholds_or_none(self):
        if not self.isDefined(self.thresholds):
            return None
        t = self.getOrDefault(self.thresholds)
        if not t:
            return None
        t = [float(v) for v in t]
        if any(v < 0 for v in t) or sum(1 for v in t if v == 0.0) > 1 \
                or sum(t) <= 0:
            raise ValueError(
                f"thresholds must be non-negative with at most one zero "
                f"and positive sum, got {t}"
            )
        return t


class LogisticRegression(Estimator, _LogRegParams):
    """Newton-IRLS LogisticRegression over a Spark DataFrame.

    One ``mapInArrow`` statistics job per Newton iteration: executors
    compute (Xᵀr, XᵀSX, …) partials under the closure-broadcast current
    coefficients, the driver combines them and solves the tiny (n+1)²
    system — the per-iteration analogue of the reference's per-partition
    GEMM + driver reduce (``RapidsRowMatrix.scala:168-202``). Spark's
    family="auto": a label-only discovery pass selects binary Newton-IRLS
    or the multinomial softmax plane (>2 classes) automatically.
    """

    @keyword_only
    def __init__(self, *, featuresCol="features", labelCol="label",
                 predictionCol="prediction", probabilityCol="probability",
                 regParam=0.0, fitIntercept=True, maxIter=25, tol=1e-8,
                 executorDevice="auto", deviceId=-1, thresholds=None,
                 weightCol="", family="auto"):
        super().__init__()
        self._set(**{k_: v for k_, v in self._input_kwargs.items()
                     if v is not None})

    def setRegParam(self, value):
        return self._set(regParam=value)

    def setFitIntercept(self, value):
        return self._set(fitIntercept=value)

    def save(self, path: str, overwrite: bool = False) -> None:
        _save_estimator_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "LogisticRegression":
        return _load_estimator_params(LogisticRegression, path)

    def setMaxIter(self, value):
        return self._set(maxIter=value)

    def setTol(self, value):
        return self._set(tol=value)

    def _fit(self, dataset) -> "LogisticRegressionModel":
        from spark_rapids_ml_tpu_torch.spark.aggregate import (
            combine_logreg_stats,
            logreg_newton_step_from_stats,
            logreg_stats_spark_ddl,
            partition_logreg_stats_arrow,
        )

        fcol = self.getOrDefault(self.featuresCol)
        lcol = self.getOrDefault(self.labelCol)
        lam = float(self.getOrDefault(self.regParam))
        fit_b = self.getOrDefault(self.fitIntercept)
        tol = float(self.getOrDefault(self.tol))
        wcol = self.getOrDefault(self.weightCol) or None
        # cache the projection: the Newton loop re-scans it once per
        # iteration, and without persist() the input's upstream lineage
        # would be recomputed up to maxIter times (how Spark ML's own
        # iterative algorithms cache their instances RDD)
        cols = [fcol, lcol] + ([wcol] if wcol else [])
        df = dataset.select(*cols).persist()

        try:
            first = df.first()
            if first is None:
                raise ValueError("empty dataset")
            n = len(first[0])

            # family="auto": one cheap label-discovery pass picks binary
            # vs multinomial (the softmax plane), like Spark's;
            # family="binomial" skips the pass entirely (labels are
            # validated 0/1 inside the executor partials) — the OvR
            # plane uses this, having just BUILT the binary column
            family = self.getOrDefault(self.family)
            if family not in ("auto", "binomial", "multinomial"):
                raise ValueError(f"family {family!r}")
            from spark_rapids_ml_tpu_torch.spark.aggregate import (
                discover_label_values,
            )

            classes = (
                np.asarray([0.0, 1.0]) if family == "binomial"
                else discover_label_values(dataset, lcol)
            )
            if classes.size > 100:
                raise ValueError(
                    f"{classes.size} distinct label values: looks "
                    "like a continuous target, not classes "
                    "(multinomial supports up to 100)"
                )
            if classes.size < 2:
                # degenerate single-class data gets a clear driver-side
                # error (whatever the label value is) instead of a
                # meaningless fit or an opaque executor failure
                raise ValueError(
                    f"need at least 2 distinct label values to fit a "
                    f"classifier, got {classes.tolist()}"
                )
            if family == "multinomial" or classes.size > 2 \
                    or not set(classes.tolist()) <= {0.0, 1.0}:
                # Two classes that are NOT {0,1} (e.g. {1,2}) take the
                # softmax plane, which class-indexes arbitrary label
                # values like Spark does — sending them down the binary
                # path would only surface as an opaque executor-task
                # _check_binary failure.
                return self._fit_multinomial(df, fcol, lcol, classes, n,
                                             wcol=wcol)

            w = np.zeros(n)
            b = 0.0
            n_iter = 0
            objective_history = []
            from spark_rapids_ml_tpu_torch.spark.device_aggregate import (
                partition_logreg_stats_device_arrow,
            )

            executor_device = self.getOrDefault(self.executorDevice)
            device_id = self.getOrDefault(self.deviceId)
            for n_iter in range(1, self.getOrDefault(self.maxIter) + 1):
                frozen_w, frozen_b = w.copy(), b

                stats = _select_stats_plane(
                    # weighted partials live on the host-f64 plane (the
                    # weightCol Param doc states this)
                    "off" if wcol else executor_device,
                    lambda b_, _w=frozen_w, _b=frozen_b:
                        partition_logreg_stats_device_arrow(
                            b_, fcol, lcol, _w, _b, device_id),
                    lambda b_, _w=frozen_w, _b=frozen_b:
                        partition_logreg_stats_arrow(b_, fcol, lcol, _w, _b,
                                                     weight_col=wcol),
                )

                rows = df.mapInArrow(stats, logreg_stats_spark_ddl()).collect()
                gx, hxx, hxb, rsum, ssum, loss, count = combine_logreg_stats(
                    rows
                )
                objective_history.append(
                    loss / max(count, 1e-300) + 0.5 * lam * float(w @ w)
                )
                w, b, step = logreg_newton_step_from_stats(
                    gx, hxx, hxb, rsum, ssum, count, w, b,
                    reg_param=lam, fit_intercept=fit_b,
                )
                if step <= tol:
                    break
        finally:
            df.unpersist()
        model = LogisticRegressionModel(
            coefficients=DenseVector(w.tolist()), intercept=b
        )
        model.n_iter_ = n_iter
        model.objective_history_ = objective_history
        return self._copyValues(model)


    def _fit_multinomial(self, df, fcol, lcol, classes, n,
                         wcol=None):
        """Softmax Newton over mapInArrow raw-partials jobs: executors
        emit (gxa, H_raw, loss, n) at the broadcast parameters — on their
        card under executorDevice='auto'/'on' — and the driver
        assembles/solves the K(d+1) system through the same
        ``assemble_multinomial_system`` every other multinomial fit
        uses, in float64 on the driver's CPU (a (K(d+1))² host step, as
        the solve after it)."""
        import torch

        from spark_rapids_ml_tpu_torch.ops.logreg_kernel import (
            assemble_multinomial_system,
        )
        from spark_rapids_ml_tpu_torch.spark.aggregate import (
            combine_multinomial_stats,
            multinomial_stats_arrow_schema,
            multinomial_stats_spark_ddl,
            partition_multinomial_stats,
        )
        from spark_rapids_ml_tpu_torch.spark.device_aggregate import (
            partition_multinomial_stats_device,
        )

        lam = float(self.getOrDefault(self.regParam))
        fit_b = self.getOrDefault(self.fitIntercept)
        tol = float(self.getOrDefault(self.tol))
        executor_device = self.getOrDefault(self.executorDevice)
        device_id = self.getOrDefault(self.deviceId)
        k = int(classes.size)
        dim = n + 1
        wb = np.zeros((k, dim))
        n_iter = 0
        objective_history = []
        for n_iter in range(1, self.getOrDefault(self.maxIter) + 1):
            frozen = wb.copy()

            def host_fn(batches, _wb=frozen):
                import pyarrow as pa

                for row in partition_multinomial_stats(
                    batches, fcol, lcol, classes, _wb, weight_col=wcol
                ):
                    yield pa.RecordBatch.from_pylist(
                        [row], schema=multinomial_stats_arrow_schema()
                    )

            def device_fn(batches, _wb=frozen):
                import pyarrow as pa

                for row in partition_multinomial_stats_device(
                    batches, fcol, lcol, classes, _wb, device_id
                ):
                    yield pa.RecordBatch.from_pylist(
                        [row], schema=multinomial_stats_arrow_schema()
                    )

            stats = _select_stats_plane(
                "off" if wcol else executor_device, device_fn, host_fn)
            rows = df.mapInArrow(
                stats, multinomial_stats_spark_ddl()
            ).collect()
            gxa, h_raw, loss, count = combine_multinomial_stats(rows, k, dim)
            objective_history.append(
                loss / max(count, 1e-300)
                + 0.5 * lam * float((wb[:, :n] ** 2).sum())
            )
            g, h = assemble_multinomial_system(
                torch.as_tensor(gxa), torch.as_tensor(h_raw),
                float(count), torch.as_tensor(wb), lam, fit_b,
            )
            step = np.linalg.solve(
                h.numpy().astype(np.float64),
                g.numpy().astype(np.float64).reshape(-1),
            ).reshape(k, dim)
            wb = wb - step
            if np.max(np.abs(step)) <= tol:
                break
        model = LogisticRegressionModel(
            coefficient_matrix=DenseMatrix(
                k, n, wb[:, :n].ravel(order="F").tolist()
            ),
            intercept_vector=DenseVector(
                (wb[:, n] if fit_b else np.zeros(k)).tolist()
            ),
            classes=DenseVector(classes.tolist()),
        )
        model.n_iter_ = n_iter
        model.objective_history_ = objective_history
        return self._copyValues(model)


class LogisticRegressionModel(Model, _LogRegParams):
    """Binary fits populate ``coefficients``/``intercept``; multinomial
    fits populate ``coefficientMatrix``-style fields, as Spark does."""

    def __init__(self, coefficients=None, intercept=0.0,
                 coefficient_matrix=None, intercept_vector=None,
                 classes=None):
        super().__init__()
        self.coefficients = coefficients
        self.intercept = intercept
        self.coefficientMatrix = coefficient_matrix
        self.interceptVector = intercept_vector
        self.classes_ = classes
        self.n_iter_ = None
        self.objective_history_ = None

    @property
    def summary(self):
        """Spark's ``LogisticRegressionTrainingSummary`` core surface:
        ``objectiveHistory`` (per-iteration regularized mean loss recorded
        by the Newton plane) and ``totalIterations``."""
        from types import SimpleNamespace

        if self.objective_history_ is None:
            raise RuntimeError(
                "no training summary: model was loaded, not fit"
            )
        return SimpleNamespace(
            objectiveHistory=list(self.objective_history_),
            totalIterations=int(self.n_iter_ or 0),
        )

    @property
    def hasSummary(self) -> bool:
        return self.objective_history_ is not None

    @observed_transform
    def _transform(self, dataset):
        import pandas as pd
        from spark_rapids_ml_tpu_torch.spark._compat import col, pandas_udf

        pcol = self.getOrDefault(self.probabilityCol)
        fcol = self.getOrDefault(self.featuresCol)
        if self.coefficientMatrix is not None:
            cm = self.coefficientMatrix.toArray()
            iv = self.interceptVector.toArray()
            classes = self.classes_.toArray()

            @pandas_udf(returnType=VectorUDT())
            def proba_m(v: pd.Series) -> pd.Series:
                x = np.stack([row.toArray() for row in v])
                e = _multinomial_probability(x, cm, iv)
                return pd.Series([DenseVector(r) for r in e])

            out = dataset.withColumn(pcol, proba_m(dataset[fcol]))

            thr = self._thresholds_or_none()
            if thr is not None and len(thr) != len(classes):
                raise ValueError(
                    f"thresholds length {len(thr)} != numClasses "
                    f"{len(classes)}"
                )

            @pandas_udf(returnType="double")
            def pred_m(v: pd.Series) -> pd.Series:
                proba = np.stack([r.toArray() for r in v])
                return pd.Series(_multinomial_prediction(proba, classes, thr))

            return out.withColumn(
                self.getOrDefault(self.predictionCol), pred_m(out[pcol])
            )

        coef = self.coefficients.toArray()
        b = float(self.intercept)

        @pandas_udf(returnType="double")
        def proba(v: pd.Series) -> pd.Series:
            x = np.stack([row.toArray() for row in v])
            return pd.Series(_logreg_probability(x, coef, b))

        out = dataset.withColumn(pcol, proba(dataset[fcol]))
        thr = self._thresholds_or_none()
        if thr is None:
            # prediction derives from probability with a plain column
            # expression — one densifying UDF pass, not two
            return out.withColumn(
                self.getOrDefault(self.predictionCol),
                (col(pcol) >= 0.5).cast("double"),
            )
        if len(thr) != 2:
            raise ValueError(
                f"thresholds length {len(thr)} != numClasses 2"
            )
        t0, t1 = float(thr[0]), float(thr[1])
        # closed form of argmax((1-p)/t0, p/t1) as ONE column expression —
        # the same single-UDF-pass shape as the unthresholded path. Zero
        # thresholds follow the scaled-argmax limit: t0=0 predicts 1 only
        # at p==1 exactly; t1=0 predicts 1 whenever p>0.
        if t0 == 0.0:
            expr = (col(pcol) >= 1.0)
        elif t1 == 0.0:
            expr = (col(pcol) > 0.0)
        else:
            expr = (col(pcol) > t1 / (t0 + t1))
        return out.withColumn(
            self.getOrDefault(self.predictionCol), expr.cast("double")
        )

    # -- persistence (shared wire format via the local model) --------------
    def _to_local(self):
        from spark_rapids_ml_tpu_torch.models.logistic_regression import (
            LogisticRegressionModel as LocalModel,
        )

        if self.coefficientMatrix is not None:
            local = LocalModel(
                coefficient_matrix=self.coefficientMatrix.toArray(),
                intercept_vector=self.interceptVector.toArray(),
                classes=self.classes_.toArray(),
                uid=self.uid,
            )
        else:
            local = LocalModel(
                coefficients=self.coefficients.toArray(),
                intercept=float(self.intercept),
                uid=self.uid,
            )
        # the local model names its features column inputCol (HasInputCol)
        for theirs, ours in (("featuresCol", "inputCol"),
                             ("labelCol", "labelCol"),
                             ("predictionCol", "predictionCol"),
                             ("probabilityCol", "probabilityCol"),
                             ("regParam", "regParam"),
                             ("fitIntercept", "fitIntercept"),
                             ("maxIter", "maxIter"),
                             ("tol", "tol")):
            value = self.getOrDefault(getattr(self, theirs))
            if value is not None and local.has_param(ours):
                local.set(ours, value)
        thr = self._thresholds_or_none()
        if thr is not None:
            local.set("thresholds", thr)
        return local

    def save(self, path: str, overwrite: bool = False) -> None:
        self._to_local().save(path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "LogisticRegressionModel":
        from spark_rapids_ml_tpu_torch.models.logistic_regression import (
            LogisticRegressionModel as LocalModel,
        )

        local = LocalModel.load(path)
        if getattr(local, "coefficient_matrix", None) is not None:
            cm = np.asarray(local.coefficient_matrix)
            model = LogisticRegressionModel(
                coefficient_matrix=DenseMatrix(
                    cm.shape[0], cm.shape[1], cm.ravel(order="F").tolist()
                ),
                intercept_vector=DenseVector(
                    np.asarray(local.intercept_vector).tolist()
                ),
                classes=DenseVector(np.asarray(local.classes_).tolist()),
            )
        else:
            model = LogisticRegressionModel(
                coefficients=DenseVector(
                    np.asarray(local.coefficients).tolist()
                ),
                intercept=float(local.intercept),
            )
        model._resetUid(local.uid)
        if local.is_set("inputCol"):
            model._set(featuresCol=local.get("inputCol"))
        for name in ("labelCol", "predictionCol", "probabilityCol",
                     "regParam", "fitIntercept", "maxIter", "tol",
                     "thresholds"):
            if local.is_set(name):
                model._set(**{name: local.get(name)})
        return model


class _KMeansParams(Params):
    featuresCol = Param(Params._dummy(), "featuresCol", "features column",
                        typeConverter=TypeConverters.toString)
    predictionCol = Param(Params._dummy(), "predictionCol",
                          "cluster-id output column",
                          typeConverter=TypeConverters.toString)
    k = Param(Params._dummy(), "k", "number of clusters",
              typeConverter=TypeConverters.toInt)
    weightCol = Param(Params._dummy(), "weightCol",
                      "per-row sample-weight column ('' = unweighted; "
                      "weighted Lloyd partials run the host-f64 plane; "
                      "the k-means++ init sample stays unweighted)",
                      typeConverter=TypeConverters.toString)
    maxIter = Param(Params._dummy(), "maxIter", "max Lloyd iterations",
                    typeConverter=TypeConverters.toInt)
    tol = Param(Params._dummy(), "tol", "center-shift tolerance",
                typeConverter=TypeConverters.toFloat)
    seed = Param(Params._dummy(), "seed", "k-means++ seeding RNG seed",
                 typeConverter=TypeConverters.toInt)
    executorDevice = Param(Params._dummy(), "executorDevice",
                           "partition statistics on each executor's "
                           "card: 'auto'/'on'/'off'",
                           typeConverter=TypeConverters.toString)
    deviceId = Param(Params._dummy(), "deviceId",
                     "executor CUDA device ordinal; -1 = task assignment",
                     typeConverter=TypeConverters.toInt)

    def __init__(self):
        super().__init__()
        self._setDefault(featuresCol="features", predictionCol="prediction",
                         k=2, maxIter=20, tol=1e-4, seed=0,
                         executorDevice="auto", deviceId=-1)


class KMeans(Estimator, _KMeansParams):
    """Lloyd over a Spark DataFrame: k-means++ seeding on a driver-collected
    sample, then one ``mapInArrow`` stats job per iteration (per-cluster
    sums/counts/cost combined on the driver) — Spark MLlib's own
    driver-coordinated shape, with Arrow-batch executor math."""

    @keyword_only
    def __init__(self, *, k=2, featuresCol="features",
                 predictionCol="prediction", maxIter=20, tol=1e-4, seed=0,
                 executorDevice="auto", deviceId=-1, weightCol=""):
        super().__init__()
        self._setDefault(weightCol="")
        self._set(**{k_: v for k_, v in self._input_kwargs.items()
                     if v is not None})

    def setK(self, value):
        return self._set(k=value)

    def setWeightCol(self, value):
        return self._set(weightCol=value)

    def save(self, path: str, overwrite: bool = False) -> None:
        _save_estimator_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "KMeans":
        return _load_estimator_params(KMeans, path)

    def _fit(self, dataset) -> "KMeansModel":
        from spark_rapids_ml_tpu_torch.models.kmeans import _host_kmeans_pp
        from spark_rapids_ml_tpu_torch.spark.aggregate import (
            combine_kmeans_stats,
            kmeans_stats_spark_ddl,
            partition_kmeans_stats,
        )

        fcol = self.getOrDefault(self.featuresCol)
        k = self.getOrDefault(self.k)
        wcol = self.getOrDefault(self.weightCol) or None
        cols = [fcol] + ([wcol] if wcol else [])
        df = dataset.select(*cols)

        sample_rows = [r[0] for r in df.limit(max(4096, 8 * k)).collect()]
        sample = np.stack([np.asarray(r.toArray()) for r in sample_rows])
        rng = np.random.default_rng(self.getOrDefault(self.seed))
        centers = _host_kmeans_pp(sample, k, rng)

        n = centers.shape[1]
        cost = float("inf")
        from spark_rapids_ml_tpu_torch.spark.device_aggregate import (
            partition_kmeans_stats_device_arrow,
        )

        executor_device = self.getOrDefault(self.executorDevice)
        device_id = self.getOrDefault(self.deviceId)

        def host_stats(batches, _c):
            import pyarrow as pa

            from spark_rapids_ml_tpu_torch.spark.aggregate import (
                kmeans_stats_arrow_schema,
            )

            for row in partition_kmeans_stats(batches, fcol, _c,
                                              weight_col=wcol):
                yield pa.RecordBatch.from_pylist(
                    [row], schema=kmeans_stats_arrow_schema()
                )

        for _ in range(self.getOrDefault(self.maxIter)):
            frozen = centers.copy()

            stats = _select_stats_plane(
                # weighted Lloyd partials live on the host-f64 plane
                "off" if wcol else executor_device,
                lambda b_, _c=frozen: partition_kmeans_stats_device_arrow(
                    b_, fcol, _c, device_id),
                lambda b_, _c=frozen: host_stats(b_, _c),
            )

            rows = df.mapInArrow(stats, kmeans_stats_spark_ddl()).collect()
            sums, counts, cost, _ = combine_kmeans_stats(rows, k, n)
            new_centers = np.where(
                counts[:, None] > 0,
                # counts are Σw under weightCol and may be FRACTIONAL:
                # the divisor must be the actual weighted count, never a
                # clamp to 1 (which would shrink low-weight centroids)
                sums / np.maximum(counts, 1e-300)[:, None],
                centers,
            )
            moved = float(np.sqrt(((new_centers - centers) ** 2).sum(axis=1).max()))
            centers = new_centers
            if moved <= self.getOrDefault(self.tol):
                break
        model = KMeansModel(
            clusterCenters=[DenseVector(c.tolist()) for c in centers]
        )
        model.trainingCost = cost
        return self._copyValues(model)


class KMeansModel(Model, _KMeansParams):
    def __init__(self, clusterCenters=None):
        super().__init__()
        self._centers = clusterCenters
        self.trainingCost = None

    def clusterCenters(self):
        return [c.toArray() for c in self._centers]

    @property
    def hasSummary(self) -> bool:
        return self.trainingCost is not None

    @property
    def summary(self):
        """Spark's ``KMeansSummary`` core: ``trainingCost`` (the final
        within-cluster SSE the Lloyd plane computed) and ``k``."""
        from types import SimpleNamespace

        if self.trainingCost is None:
            raise RuntimeError(
                "no training summary: model was loaded, not fit"
            )
        return SimpleNamespace(
            trainingCost=float(self.trainingCost),
            k=len(self._centers),
        )

    @observed_transform
    def _transform(self, dataset):
        import pandas as pd
        from spark_rapids_ml_tpu_torch.spark._compat import pandas_udf

        centers = np.stack([c.toArray() for c in self._centers])

        @pandas_udf(returnType="int")
        def assign(v: pd.Series) -> pd.Series:
            x = np.stack([row.toArray() for row in v])
            return pd.Series(_kmeans_assign(x, centers))

        return dataset.withColumn(
            self.getOrDefault(self.predictionCol),
            assign(dataset[self.getOrDefault(self.featuresCol)]),
        )

    # -- persistence (shared wire format via the local model) --------------
    def _to_local(self):
        from spark_rapids_ml_tpu_torch.models.kmeans import (
            KMeansModel as LocalModel,
        )

        local = LocalModel(
            cluster_centers=np.stack(
                [c.toArray() for c in self._centers]),
            uid=self.uid,
        )
        if self.trainingCost is not None:
            local.training_cost_ = float(self.trainingCost)
        for theirs, ours in (("featuresCol", "inputCol"),
                             ("predictionCol", "predictionCol"),
                             ("k", "k"), ("maxIter", "maxIter"),
                             ("tol", "tol"), ("seed", "seed")):
            value = self.getOrDefault(getattr(self, theirs))
            if value is not None and local.has_param(ours):
                local.set(ours, value)
        return local

    def save(self, path: str, overwrite: bool = False) -> None:
        self._to_local().save(path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "KMeansModel":
        from spark_rapids_ml_tpu_torch.models.kmeans import (
            KMeansModel as LocalModel,
        )

        local = LocalModel.load(path)
        model = KMeansModel(clusterCenters=[
            DenseVector(np.asarray(c).tolist())
            for c in local.cluster_centers
        ])
        model._resetUid(local.uid)
        if local.is_set("inputCol"):
            model._set(featuresCol=local.get("inputCol"))
        for name in ("predictionCol", "k", "maxIter", "tol", "seed"):
            if local.is_set(name):
                model._set(**{name: local.get(name)})
        return model


class _LocalParamsProxy:
    """Adapts a pyspark Params object to io.persistence's estimator
    interface (uid + param_map_for_metadata)."""

    def __init__(self, obj):
        self._obj = obj
        self.uid = obj.uid

    def param_map_for_metadata(self):
        out = {}
        for p in self._obj.params:
            if self._obj.isSet(p) or self._obj.hasDefault(p):
                v = self._obj.getOrDefault(p)
                if v is not None:
                    out[p.name] = v
        return out


def _apply_param_map(obj, param_map):
    for name, value in param_map.items():
        if obj.hasParam(name) and value is not None:
            obj._set(**{name: value})


def _save_estimator_params(est, path, overwrite=False):
    """Params-only estimator persistence shared by the plane estimators
    (PCA/LinearRegression/LogisticRegression/KMeans/NaiveBayes): a
    dedicated proxy subclass so the metadata carries the estimator's own
    class name."""
    from spark_rapids_ml_tpu_torch.io.persistence import save_params

    proxy_cls = type(type(est).__name__, (_LocalParamsProxy,), {})
    save_params(proxy_cls(est), path, overwrite=overwrite)


def _load_estimator_params(cls, path):
    from spark_rapids_ml_tpu_torch.io.persistence import _read_metadata

    meta = _read_metadata(path)
    est = cls()
    est._resetUid(meta["uid"])
    _apply_param_map(est, meta.get("paramMap", {}))
    _apply_param_map(est, meta.get("tpuParamMap", {}))
    return est


# type(estimator).__module__ resolution in save_params sees the proxy class;
# keep the Spark class alias mapping working by naming it after PCA.
_LocalParamsProxy.__qualname__ = "PCA"


class NaiveBayes(Estimator, Params):
    """NaiveBayes over a Spark DataFrame as ONE ``mapInArrow`` statistics
    pass: partitions emit per-class (count, Σx, Σx²) rows — additively
    combinable even when partitions see different class subsets — and the
    driver finalizes the (K, d) log-probability tables. Replaces the
    driver-collect adapter strategy with the same partial-aggregate data
    plane the PCA/regression fits use. ``modelType``:
    multinomial | complement | bernoulli | gaussian (Spark 3's families + sklearn's
    GaussianNB)."""

    featuresCol = Param(Params._dummy(), "featuresCol", "features column",
                        typeConverter=TypeConverters.toString)
    labelCol = Param(Params._dummy(), "labelCol", "label column",
                     typeConverter=TypeConverters.toString)
    predictionCol = Param(Params._dummy(), "predictionCol",
                          "prediction output column",
                          typeConverter=TypeConverters.toString)
    modelType = Param(Params._dummy(), "modelType",
                      "multinomial | complement | bernoulli | gaussian",
                      typeConverter=TypeConverters.toString)
    smoothing = Param(Params._dummy(), "smoothing",
                      "additive (Laplace) smoothing",
                      typeConverter=TypeConverters.toFloat)
    weightCol = Param(Params._dummy(), "weightCol",
                      "per-row sample-weight column ('' = unweighted)",
                      typeConverter=TypeConverters.toString)

    @keyword_only
    def __init__(self, *, featuresCol="features", labelCol="label",
                 predictionCol="prediction", modelType="multinomial",
                 smoothing=1.0, weightCol=""):
        super().__init__()
        self._setDefault(featuresCol="features", labelCol="label",
                         predictionCol="prediction",
                         modelType="multinomial", smoothing=1.0,
                         weightCol="")
        self._set(**{k_: v for k_, v in self._input_kwargs.items()
                     if v is not None})

    def setModelType(self, value):
        return self._set(modelType=value)

    def setSmoothing(self, value):
        return self._set(smoothing=value)

    def setWeightCol(self, value):
        return self._set(weightCol=value)

    def save(self, path: str, overwrite: bool = False) -> None:
        _save_estimator_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "NaiveBayes":
        return _load_estimator_params(NaiveBayes, path)

    def _fit(self, dataset):
        from spark_rapids_ml_tpu_torch.models.naive_bayes import (
            NaiveBayesModel as LocalNBModel,
        )
        from spark_rapids_ml_tpu_torch.spark.adapter import (
            NaiveBayesModel as AdapterNBModel,
        )
        from spark_rapids_ml_tpu_torch.spark.aggregate import (
            combine_nb_stats,
            finalize_nb_from_stats,
            nb_stats_arrow_schema,
            nb_stats_spark_ddl,
            partition_nb_stats,
        )
        from spark_rapids_ml_tpu_torch.spark.forest_estimator import (
            _collect_rows,
        )

        fcol = self.getOrDefault(self.featuresCol)
        lcol = self.getOrDefault(self.labelCol)
        kind = self.getOrDefault(self.modelType)
        if kind not in ("multinomial", "complement", "bernoulli",
                        "gaussian"):
            raise ValueError(f"modelType {kind!r}")
        wcol = self.getOrDefault(self.weightCol) or None
        cols = [fcol, lcol] + ([wcol] if wcol else [])
        df = dataset.select(*cols)

        def stats(batches):
            return partition_nb_stats(batches, fcol, lcol, kind,
                                      weight_col=wcol)

        rows = _collect_rows(df, stats, nb_stats_arrow_schema,
                             nb_stats_spark_ddl())
        classes, counts, sums, sq = combine_nb_stats(rows)
        pi, theta, sigma = finalize_nb_from_stats(
            classes, counts, sums, sq, kind,
            self.getOrDefault(self.smoothing),
        )
        local = LocalNBModel(pi=pi, theta=theta, sigma=sigma,
                             classes=classes)
        local.set("inputCol", fcol)
        local.set("labelCol", lcol)
        local.set("predictionCol", self.getOrDefault(self.predictionCol))
        local.set("modelType", kind)
        local.set("smoothing", float(self.getOrDefault(self.smoothing)))
        return AdapterNBModel(local)
