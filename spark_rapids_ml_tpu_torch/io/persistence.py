"""Model persistence in Spark ML's on-disk layout.

A copy of the PCA, KMeans, BisectingKMeans, GaussianMixture,
StandardScaler, LinearRegression, LogisticRegression, LinearSVC,
GeneralizedLinearRegression, TruncatedSVD, NearestNeighbors, NaiveBayes,
RandomForest, DecisionTree, GBT and feature-transformer parts of the JAX
package's ``io/persistence.py``, so a model saved by either package loads
in the other (``RapidsPCA.scala:218-254``):

* ``path/metadata/part-00000`` — one JSON line: class, timestamp, uid,
  paramMap (Spark's ``DefaultParamsWriter.saveMetadata``); params Spark's
  reader does not know travel under ``tpuParamMap``, the JAX package's key;
* ``path/metadata/_SUCCESS`` — empty marker;
* ``path/data/part-00000.parquet`` — one row: for PCA ``pc`` (Spark
  DenseMatrix struct), ``explainedVariance`` (Spark DenseVector struct) and
  the extension column ``mean``; for KMeans and BisectingKMeans
  ``clusterCenters`` and ``trainingCost``; for GaussianMixture
  ``weights``, ``means`` and ``covs`` (the (k, d, d) stack as a (k·d, d)
  matrix), its iterations and log-likelihood in the metadata's
  ``extra``; for StandardScaler ``mean`` and ``std``; for
  LinearRegression Spark's (``coefficients``, ``intercept``, ``scale``);
  for LogisticRegression ``coefficients``, ``intercept``, ``numClasses``,
  ``numFeatures`` and, multinomial, ``interceptVector`` and ``classes``
  (the (K, d) matrix flattened row-major into ``coefficients``); for
  LinearSVC (``coefficients``, ``intercept``); for
  GeneralizedLinearRegression (``intercept``, ``coefficients``), its fit
  summary (iterations, deviance, weight sum) in the metadata's ``extra``;
  for TruncatedSVD ``V`` and ``s``; for NearestNeighbors the fitted
  ``items`` (DBSCAN's model has no writer, as in the JAX package); for
  NaiveBayes ``pi``, ``theta``, ``sigma`` (empty but for gaussian),
  ``classes`` and ``hasSigma``; for
  the tree models (RandomForest, DecisionTree, GBT) the ensemble's
  ``feature``, ``threshold`` and ``leafValue`` and the bin ``edges`` as
  DenseMatrix structs, with ``classes`` / ``numClasses`` (forests) or
  ``init`` / ``stepSize`` (GBT) and ``featureImportances``; for the
  selector models ``selectedFeatures``; for StringIndexerModel
  ``labelsArray``, OneHotEncoderModel ``categorySizes``,
  CountVectorizerModel ``vocabulary``, IDFModel ``idf``, ``docFreq`` and
  ``numDocs``; VectorIndexerModel and RFormulaModel carry one
  ``jsonState`` column (``save_json_state_model``); for
  MultilayerPerceptronModel one flat ``weights`` vector (per layer, W
  row-major then b), its layers, iterations and final loss in the
  metadata's ``extra``; for ImputerModel ``surrogates``.
  Without pyarrow (optional) the same row is written as
  ``part-00000.json``, which both packages' readers accept.

Estimators persist metadata only, like Spark's ``DefaultParamsWritable``,
and so do the evaluators (``models/evaluation.py``). Pipelines
(``models/pipeline.py``) write their metadata here and each stage under
``stages/``; the tuning classes (``models/tuning.py``) write their
metadata here and the estimator, evaluator and ``bestModel`` each in a
directory of its own.

``load_model`` loads any of these by the class its metadata records: the
simple name of ``pythonClass`` picks the port's class of that name from
``_MODEL_CLASSES``, so metadata the JAX package wrote (whose
``pythonClass`` names ``spark_rapids_ml_tpu.models.…``) loads without
importing the module it names. Every ``save_*`` writer is atomic
(``_atomic_save``): the payload goes to a temporary sibling, the previous
model is renamed aside, the new one renamed into place; a save that dies
leaves the previous model or nothing, never a half-written directory.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import shutil
import time
import uuid
from typing import Any, Dict, Optional

import numpy as np

_FORMAT_VERSION = "1.0"

# Spark class names for metadata, so a Spark DefaultParamsReader accepts the
# file; the Python class path travels in 'pythonClass'.
_SPARK_CLASS_ALIASES = {
    "PCA": "org.apache.spark.ml.feature.PCA",
    "PCAModel": "org.apache.spark.ml.feature.PCAModel",
    "KMeans": "org.apache.spark.ml.clustering.KMeans",
    "KMeansModel": "org.apache.spark.ml.clustering.KMeansModel",
    "BisectingKMeans": "org.apache.spark.ml.clustering.BisectingKMeans",
    "BisectingKMeansModel":
        "org.apache.spark.ml.clustering.BisectingKMeansModel",
    "LinearRegression": "org.apache.spark.ml.regression.LinearRegression",
    "LinearRegressionModel": "org.apache.spark.ml.regression.LinearRegressionModel",
    "LogisticRegression":
        "org.apache.spark.ml.classification.LogisticRegression",
    "LogisticRegressionModel":
        "org.apache.spark.ml.classification.LogisticRegressionModel",
    "LinearSVC": "org.apache.spark.ml.classification.LinearSVC",
    "LinearSVCModel": "org.apache.spark.ml.classification.LinearSVCModel",
    "GeneralizedLinearRegression":
        "org.apache.spark.ml.regression.GeneralizedLinearRegression",
    "GeneralizedLinearRegressionModel":
        "org.apache.spark.ml.regression.GeneralizedLinearRegressionModel",
    "StandardScaler": "org.apache.spark.ml.feature.StandardScaler",
    "StandardScalerModel": "org.apache.spark.ml.feature.StandardScalerModel",
    "DecisionTreeClassifier":
        "org.apache.spark.ml.classification.DecisionTreeClassifier",
    "DecisionTreeClassificationModel":
        "org.apache.spark.ml.classification.DecisionTreeClassificationModel",
    "DecisionTreeRegressor":
        "org.apache.spark.ml.regression.DecisionTreeRegressor",
    "DecisionTreeRegressionModel":
        "org.apache.spark.ml.regression.DecisionTreeRegressionModel",
    "PowerIterationClustering":
        "org.apache.spark.ml.clustering.PowerIterationClustering",
    "DCT": "org.apache.spark.ml.feature.DCT",
    "Interaction": "org.apache.spark.ml.feature.Interaction",
    "FeatureHasher": "org.apache.spark.ml.feature.FeatureHasher",
    "VectorIndexer": "org.apache.spark.ml.feature.VectorIndexer",
    "VectorIndexerModel":
        "org.apache.spark.ml.feature.VectorIndexerModel",
    "UnivariateFeatureSelector":
        "org.apache.spark.ml.feature.UnivariateFeatureSelector",
    "UnivariateFeatureSelectorModel":
        "org.apache.spark.ml.feature.UnivariateFeatureSelectorModel",
    "RFormula": "org.apache.spark.ml.feature.RFormula",
    "RFormulaModel": "org.apache.spark.ml.feature.RFormulaModel",
    "Pipeline": "org.apache.spark.ml.Pipeline",
    "PipelineModel": "org.apache.spark.ml.PipelineModel",
    "MultilayerPerceptronClassifier":
        "org.apache.spark.ml.classification.MultilayerPerceptronClassifier",
    "MultilayerPerceptronModel":
        "org.apache.spark.ml.classification."
        "MultilayerPerceptronClassificationModel",
}

# Params a real Spark DefaultParamsReader recognizes per class; the rest
# (useXlaDot, deviceId, ...) go under 'tpuParamMap', which Spark ignores.
_SPARK_PARAM_ALLOWLIST = {
    "PCA": {"k", "inputCol", "outputCol"},
    "PCAModel": {"k", "inputCol", "outputCol"},
    "KMeans": {"k", "maxIter", "tol", "seed", "predictionCol", "weightCol"},
    "KMeansModel": {"k", "maxIter", "tol", "seed", "predictionCol",
                    "weightCol"},
    "StandardScaler": {"withMean", "withStd", "inputCol", "outputCol"},
    "StandardScalerModel": {"withMean", "withStd", "inputCol", "outputCol"},
    "BisectingKMeans": {"k", "maxIter", "seed", "predictionCol",
                        "minDivisibleClusterSize", "weightCol"},
    "BisectingKMeansModel": {"k", "maxIter", "seed", "predictionCol",
                             "minDivisibleClusterSize", "weightCol"},
    "DecisionTreeClassifier": {
        "maxDepth", "maxBins", "minInstancesPerNode", "labelCol",
        "predictionCol", "probabilityCol", "seed", "weightCol"},
    "DecisionTreeClassificationModel": {
        "maxDepth", "maxBins", "minInstancesPerNode", "labelCol",
        "predictionCol", "probabilityCol", "seed", "weightCol"},
    "DecisionTreeRegressor": {
        "maxDepth", "maxBins", "minInstancesPerNode", "labelCol",
        "predictionCol", "seed", "weightCol"},
    "DecisionTreeRegressionModel": {
        "maxDepth", "maxBins", "minInstancesPerNode", "labelCol",
        "predictionCol", "seed", "weightCol"},
    "LinearRegression": {"labelCol", "predictionCol", "fitIntercept",
                         "regParam", "elasticNetParam", "weightCol"},
    "LinearRegressionModel": {"labelCol", "predictionCol", "fitIntercept",
                              "regParam", "elasticNetParam", "weightCol"},
    "LogisticRegression": {"labelCol", "predictionCol", "probabilityCol",
                           "maxIter", "tol", "regParam", "fitIntercept",
                           "weightCol"},
    "LogisticRegressionModel": {"labelCol", "predictionCol", "probabilityCol",
                                "maxIter", "tol", "regParam", "fitIntercept",
                                "weightCol"},
    "LinearSVC": {"labelCol", "predictionCol", "rawPredictionCol",
                  "maxIter", "tol", "regParam", "fitIntercept",
                  "standardization", "threshold", "weightCol"},
    "LinearSVCModel": {"labelCol", "predictionCol", "rawPredictionCol",
                       "maxIter", "tol", "regParam", "fitIntercept",
                       "standardization", "threshold", "weightCol"},
    "GeneralizedLinearRegression": {
        "labelCol", "predictionCol", "linkPredictionCol", "family", "link",
        "variancePower", "linkPower", "offsetCol", "maxIter", "tol",
        "regParam", "fitIntercept", "weightCol"},
    "GeneralizedLinearRegressionModel": {
        "labelCol", "predictionCol", "linkPredictionCol", "family", "link",
        "variancePower", "linkPower", "offsetCol", "maxIter", "tol",
        "regParam", "fitIntercept", "weightCol"},
    "PowerIterationClustering": {
        "k", "maxIter", "initMode", "srcCol", "dstCol", "weightCol"},
    "DCT": {"inputCol", "outputCol", "inverse"},
    "Interaction": {"inputCols", "outputCol"},
    "FeatureHasher": {"inputCols", "outputCol", "numFeatures",
                      "categoricalCols"},
    "VectorIndexer": {"inputCol", "outputCol", "maxCategories",
                      "handleInvalid"},
    "VectorIndexerModel": {"inputCol", "outputCol", "maxCategories",
                           "handleInvalid"},
    # Spark's selector param is featuresCol; the selectors here (as in the
    # JAX package) take inputCol, which rides the Spark-visible paramMap
    "UnivariateFeatureSelector": {
        "inputCol", "outputCol", "labelCol", "featureType",
        "labelType", "selectionMode", "selectionThreshold"},
    "UnivariateFeatureSelectorModel": {
        "inputCol", "outputCol", "labelCol", "featureType",
        "labelType", "selectionMode", "selectionThreshold"},
    "RFormula": {"formula", "featuresCol", "labelCol"},
    "RFormulaModel": {"formula", "featuresCol", "labelCol"},
    # NOTE: Spark's MLP has no weightCol param — it stays in tpuParamMap
    "MultilayerPerceptronClassifier": {
        "layers", "labelCol", "predictionCol", "probabilityCol",
        "rawPredictionCol", "maxIter", "tol", "seed", "solver",
        "stepSize", "blockSize"},
    "MultilayerPerceptronModel": {
        "layers", "labelCol", "predictionCol", "probabilityCol",
        "rawPredictionCol", "maxIter", "tol", "seed", "solver",
        "stepSize", "blockSize"},
}


def _require_target(path: str, overwrite: bool) -> None:
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(
                f"path {path!r} already exists; use overwrite=True "
                "(Spark: .write().overwrite())"
            )
        shutil.rmtree(path)


def _write_metadata(path: str, cls: str, uid: str,
                    param_map: Dict[str, Any],
                    extra: Optional[Dict[str, Any]] = None) -> None:
    meta_dir = os.path.join(path, "metadata")
    os.makedirs(meta_dir, exist_ok=True)
    simple_name = cls.rsplit(".", 1)[-1]
    allowed = _SPARK_PARAM_ALLOWLIST.get(simple_name)
    if allowed is None:
        spark_params, extra_params = param_map, {}
    else:
        spark_params = {k: v for k, v in param_map.items() if k in allowed}
        extra_params = {k: v for k, v in param_map.items() if k not in allowed}
    metadata = {
        "class": _SPARK_CLASS_ALIASES.get(simple_name, cls),
        "pythonClass": cls,
        "timestamp": int(time.time() * 1000),
        "sparkVersion": "3.1.2",  # wire-format vintage (reference pom.xml:68)
        "frameworkVersion": _FORMAT_VERSION,
        "uid": uid,
        "paramMap": spark_params,
        "defaultParamMap": {},
        "tpuParamMap": extra_params,
    }
    if extra:
        metadata["extra"] = extra
    with open(os.path.join(meta_dir, "part-00000"), "w") as f:
        f.write(json.dumps(metadata))
    open(os.path.join(meta_dir, "_SUCCESS"), "w").close()


def _read_metadata(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "metadata", "part-00000")) as f:
        return json.loads(f.readline())


def save_params(estimator, path: str, overwrite: bool = False) -> None:
    """Persist an unfitted estimator (params only)."""
    _require_target(path, overwrite)
    cls = f"{type(estimator).__module__}.{type(estimator).__qualname__}"
    _write_metadata(path, cls, estimator.uid, estimator.param_map_for_metadata())


def _restore_params(obj, meta: Dict[str, Any]):
    """Apply metadata paramMap (and the extension 'tpuParamMap') onto a
    Params object (Spark's ``metadata.getAndSetParams``)."""
    for key in ("paramMap", "tpuParamMap"):
        for name, value in meta.get(key, {}).items():
            if obj.has_param(name) and value is not None:
                obj.set(name, value)
    return obj


def load_params(estimator_cls, path: str):
    meta = _read_metadata(path)
    est = estimator_cls()
    est.uid = meta["uid"]
    return _restore_params(est, meta)


# -- dense matrix/vector structs (Spark ml.linalg UDT serialized form) ----
def _dense_matrix_struct(m: np.ndarray) -> Dict[str, Any]:
    m = np.asarray(m, dtype=np.float64)
    return {
        "type": 1,
        "numRows": int(m.shape[0]),
        "numCols": int(m.shape[1]),
        "colPtrs": None,
        "rowIndices": None,
        "values": np.asfortranarray(m).ravel(order="F").tolist(),
        "isTransposed": False,
    }


def _dense_matrix_from_struct(s: Dict[str, Any]) -> np.ndarray:
    values = np.asarray(s["values"], dtype=np.float64)
    n_rows, n_cols = int(s["numRows"]), int(s["numCols"])
    if s.get("isTransposed"):
        return values.reshape(n_rows, n_cols)
    return values.reshape(n_cols, n_rows).T


def _dense_vector_struct(v: np.ndarray) -> Dict[str, Any]:
    return {
        "type": 1,
        "size": None,
        "indices": None,
        "values": np.asarray(v, dtype=np.float64).ravel().tolist(),
    }


def _dense_vector_from_struct(s: Dict[str, Any]) -> np.ndarray:
    return np.asarray(s["values"], dtype=np.float64)


def _matrix_arrow_type():
    """Spark ``MatrixUDT`` sql type."""
    import pyarrow as pa

    return pa.struct(
        [
            ("type", pa.int8()),
            ("numRows", pa.int32()),
            ("numCols", pa.int32()),
            ("colPtrs", pa.list_(pa.int32())),
            ("rowIndices", pa.list_(pa.int32())),
            ("values", pa.list_(pa.float64())),
            ("isTransposed", pa.bool_()),
        ]
    )


def _vector_arrow_type():
    """Spark ``VectorUDT`` sql type."""
    import pyarrow as pa

    return pa.struct(
        [
            ("type", pa.int8()),
            ("size", pa.int32()),
            ("indices", pa.list_(pa.int32())),
            ("values", pa.list_(pa.float64())),
        ]
    )


# Spark catalyst type JSON for the ml.linalg UDTs, written into the parquet
# footer under 'org.apache.spark.sql.parquet.row.metadata' so a real Spark
# reader deserializes the struct columns as Matrix/Vector values.
_MATRIX_UDT_JSON = {
    "type": "udt",
    "class": "org.apache.spark.ml.linalg.MatrixUDT",
    "pyClass": "pyspark.ml.linalg.MatrixUDT",
    "sqlType": {
        "type": "struct",
        "fields": [
            {"name": "type", "type": "byte", "nullable": False, "metadata": {}},
            {"name": "numRows", "type": "integer", "nullable": False,
             "metadata": {}},
            {"name": "numCols", "type": "integer", "nullable": False,
             "metadata": {}},
            {"name": "colPtrs",
             "type": {"type": "array", "elementType": "integer",
                      "containsNull": False},
             "nullable": True, "metadata": {}},
            {"name": "rowIndices",
             "type": {"type": "array", "elementType": "integer",
                      "containsNull": False},
             "nullable": True, "metadata": {}},
            {"name": "values",
             "type": {"type": "array", "elementType": "double",
                      "containsNull": False},
             "nullable": True, "metadata": {}},
            {"name": "isTransposed", "type": "boolean", "nullable": False,
             "metadata": {}},
        ],
    },
}

_VECTOR_UDT_JSON = {
    "type": "udt",
    "class": "org.apache.spark.ml.linalg.VectorUDT",
    "pyClass": "pyspark.ml.linalg.VectorUDT",
    "sqlType": {
        "type": "struct",
        "fields": [
            {"name": "type", "type": "byte", "nullable": False, "metadata": {}},
            {"name": "size", "type": "integer", "nullable": True,
             "metadata": {}},
            {"name": "indices",
             "type": {"type": "array", "elementType": "integer",
                      "containsNull": False},
             "nullable": True, "metadata": {}},
            {"name": "values",
             "type": {"type": "array", "elementType": "double",
                      "containsNull": False},
             "nullable": True, "metadata": {}},
        ],
    },
}

_SPARK_FIELD_TYPES = {
    "matrix": _MATRIX_UDT_JSON,
    "vector": _VECTOR_UDT_JSON,
    "double": "double",
    "integer": "integer",
    "long": "long",
    "boolean": "boolean",
    "array<int>": {"type": "array", "elementType": "integer",
                   "containsNull": False},
    "array<long>": {"type": "array", "elementType": "long",
                    "containsNull": False},
    "array<string>": {"type": "array", "elementType": "string",
                      "containsNull": True},
    "array<array<string>>": {
        "type": "array",
        "elementType": {"type": "array", "elementType": "string",
                        "containsNull": True},
        "containsNull": False},
}


def spark_row_metadata(fields) -> str:
    """Catalyst StructType JSON for ``(name, kind)`` pairs."""
    return json.dumps({
        "type": "struct",
        "fields": [
            {"name": name, "type": _SPARK_FIELD_TYPES[kind],
             "nullable": True, "metadata": {}}
            for name, kind in fields
        ],
    })


def _write_data_row(path: str, row: Dict[str, Any], schema=None,
                    spark_fields=None) -> None:
    """Single-row payload as Parquet when pyarrow is installed, JSON
    otherwise (the reference repartitions to 1 before writing,
    ``RapidsPCA.scala:223``, so one file is its on-disk shape)."""
    data_dir = os.path.join(path, "data")
    os.makedirs(data_dir, exist_ok=True)
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError:  # pyarrow is optional
        with open(os.path.join(data_dir, "part-00000.json"), "w") as f:
            json.dump(row, f)
    else:
        table = pa.Table.from_pylist([row], schema=schema)
        if spark_fields is not None:
            table = table.replace_schema_metadata({
                "org.apache.spark.sql.parquet.row.metadata":
                    spark_row_metadata(spark_fields)
            })
        pq.write_table(table, os.path.join(data_dir, "part-00000.parquet"))
    open(os.path.join(data_dir, "_SUCCESS"), "w").close()


def _read_data_row(path: str) -> Dict[str, Any]:
    data_dir = os.path.join(path, "data")
    pq_files = sorted(
        f for f in os.listdir(data_dir) if f.endswith(".parquet")
    )
    if pq_files:
        import pyarrow.parquet as pq

        table = pq.read_table(os.path.join(data_dir, pq_files[0]))
        return table.to_pylist()[0]
    json_files = sorted(f for f in os.listdir(data_dir) if f.endswith(".json"))
    if json_files:
        with open(os.path.join(data_dir, json_files[0])) as f:
            return json.load(f)
    raise FileNotFoundError(f"no data payload under {data_dir}")


def save_pca_model(model, path: str, overwrite: bool = False) -> None:
    if model.pc is None:
        raise ValueError("cannot save an unfitted PCAModel")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata())
    row = {
        "pc": _dense_matrix_struct(model.pc),
        "explainedVariance": _dense_vector_struct(model.explained_variance),
        # `mean` is an extension column (Spark stores none); readers that
        # don't know it ignore it.
        "mean": _dense_vector_struct(
            model.mean if model.mean is not None else np.zeros(model.pc.shape[0])
        ),
    }
    try:
        import pyarrow as pa
    except ImportError:
        schema = None
    else:
        schema = pa.schema(
            [
                ("pc", _matrix_arrow_type()),
                ("explainedVariance", _vector_arrow_type()),
                ("mean", _vector_arrow_type()),
            ]
        )
    _write_data_row(path, row, schema=schema, spark_fields=[
        ("pc", "matrix"), ("explainedVariance", "vector"), ("mean", "vector"),
    ])


def load_pca_model(path: str):
    from spark_rapids_ml_tpu_torch.models.pca import PCAModel

    meta = _read_metadata(path)
    row = _read_data_row(path)
    model = PCAModel(
        pc=_dense_matrix_from_struct(row["pc"]),
        explained_variance=_dense_vector_from_struct(row["explainedVariance"]),
        mean=_dense_vector_from_struct(row["mean"]) if "mean" in row else None,
        uid=meta["uid"],
    )
    return _restore_params(model, meta)


def save_linreg_model(model, path: str, overwrite: bool = False) -> None:
    if model.coefficients is None:
        raise ValueError("cannot save an unfitted LinearRegressionModel")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata())
    row = {
        "coefficients": _dense_vector_struct(model.coefficients),
        "intercept": float(model.intercept),
        "scale": 1.0,  # Spark writes (intercept, coefficients, scale)
    }
    try:
        import pyarrow as pa
    except ImportError:
        schema = None
    else:
        schema = pa.schema(
            [
                ("coefficients", _vector_arrow_type()),
                ("intercept", pa.float64()),
                ("scale", pa.float64()),
            ]
        )
    _write_data_row(path, row, schema=schema, spark_fields=[
        ("coefficients", "vector"), ("intercept", "double"), ("scale", "double"),
    ])


def load_linreg_model(path: str):
    from spark_rapids_ml_tpu_torch.models.linear_regression import (
        LinearRegressionModel,
    )

    meta = _read_metadata(path)
    row = _read_data_row(path)
    model = LinearRegressionModel(
        coefficients=_dense_vector_from_struct(row["coefficients"]),
        intercept=float(row["intercept"]),
        uid=meta["uid"],
    )
    return _restore_params(model, meta)


def save_logreg_model(model, path: str, overwrite: bool = False) -> None:
    multinomial = getattr(model, "coefficient_matrix", None) is not None
    if model.coefficients is None and not multinomial:
        raise ValueError("cannot save an unfitted LogisticRegressionModel")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata())
    if multinomial:
        # Spark's multinomial layout: coefficientMatrix flattened row-major
        # into the vector slot + interceptVector/classes alongside
        k, d = model.coefficient_matrix.shape
        row = {
            "coefficients": _dense_vector_struct(
                np.asarray(model.coefficient_matrix).reshape(-1)
            ),
            "intercept": 0.0,
            "interceptVector": _dense_vector_struct(model.intercept_vector),
            "classes": _dense_vector_struct(model.classes_),
            "numClasses": int(k),
            "numFeatures": int(d),
        }
        fields = [
            ("coefficients", "vector"), ("intercept", "double"),
            ("interceptVector", "vector"), ("classes", "vector"),
            ("numClasses", "integer"), ("numFeatures", "integer"),
        ]
    else:
        row = {
            "coefficients": _dense_vector_struct(model.coefficients),
            "intercept": float(model.intercept),
            "numClasses": 2,
            "numFeatures": int(np.asarray(model.coefficients).shape[0]),
        }
        fields = [
            ("coefficients", "vector"), ("intercept", "double"),
            ("numClasses", "integer"), ("numFeatures", "integer"),
        ]
    try:
        import pyarrow as pa
    except ImportError:
        schema = None
    else:
        arrow = {"vector": _vector_arrow_type(), "double": pa.float64(),
                 "integer": pa.int32()}
        schema = pa.schema([(name, arrow[kind]) for name, kind in fields])
    _write_data_row(path, row, schema=schema, spark_fields=fields)


def load_logreg_model(path: str):
    from spark_rapids_ml_tpu_torch.models.logistic_regression import (
        LogisticRegressionModel,
    )

    meta = _read_metadata(path)
    row = _read_data_row(path)
    n_classes = int(row.get("numClasses", 2))
    if n_classes > 2 and row.get("interceptVector") is not None:
        d = int(row["numFeatures"])
        model = LogisticRegressionModel(
            coefficient_matrix=_dense_vector_from_struct(
                row["coefficients"]
            ).reshape(n_classes, d),
            intercept_vector=_dense_vector_from_struct(row["interceptVector"]),
            classes=_dense_vector_from_struct(row["classes"]),
            uid=meta["uid"],
        )
        return _restore_params(model, meta)
    model = LogisticRegressionModel(
        coefficients=_dense_vector_from_struct(row["coefficients"]),
        intercept=float(row["intercept"]),
        uid=meta["uid"],
    )
    return _restore_params(model, meta)


def save_glm_model(model, path: str, overwrite: bool = False) -> None:
    """Spark GeneralizedLinearRegressionModel layout: (intercept,
    coefficients), as ``GeneralizedLinearRegressionModelWriter`` writes
    it; the fit summary scalars ride in the metadata extras."""
    if model.coefficients is None:
        raise ValueError(
            "cannot save an unfitted GeneralizedLinearRegressionModel")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    extras = {
        "numIterations": int(model.num_iterations_),
        "deviance": float(model.deviance_),
        "weightSum": float(model.weight_sum_),
    }
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata(),
                    extra=extras)
    row = {
        "intercept": float(model.intercept),
        "coefficients": _dense_vector_struct(model.coefficients),
    }
    try:
        import pyarrow as pa
    except ImportError:
        schema = None
    else:
        schema = pa.schema(
            [
                ("intercept", pa.float64()),
                ("coefficients", _vector_arrow_type()),
            ]
        )
    _write_data_row(path, row, schema=schema, spark_fields=[
        ("intercept", "double"), ("coefficients", "vector"),
    ])


def load_glm_model(path: str):
    from spark_rapids_ml_tpu_torch.models.glm import (
        GeneralizedLinearRegressionModel,
    )

    meta = _read_metadata(path)
    row = _read_data_row(path)
    model = GeneralizedLinearRegressionModel(
        coefficients=_dense_vector_from_struct(row["coefficients"]),
        intercept=float(row["intercept"]),
        uid=meta["uid"],
    )
    extras = meta.get("extra", {})
    model.num_iterations_ = int(extras.get("numIterations", 0))
    model.deviance_ = float(extras.get("deviance", float("nan")))
    model.weight_sum_ = float(extras.get("weightSum", 0.0))
    return _restore_params(model, meta)


def save_svc_model(model, path: str, overwrite: bool = False) -> None:
    """Spark LinearSVCModel layout: (coefficients, intercept), as
    ``LinearSVCModel.LinearSVCModelWriter`` writes it."""
    if model.coefficients is None:
        raise ValueError("cannot save an unfitted LinearSVCModel")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata())
    row = {
        "coefficients": _dense_vector_struct(model.coefficients),
        "intercept": float(model.intercept),
    }
    try:
        import pyarrow as pa
    except ImportError:
        schema = None
    else:
        schema = pa.schema(
            [
                ("coefficients", _vector_arrow_type()),
                ("intercept", pa.float64()),
            ]
        )
    _write_data_row(path, row, schema=schema, spark_fields=[
        ("coefficients", "vector"), ("intercept", "double"),
    ])


def load_svc_model(path: str):
    from spark_rapids_ml_tpu_torch.models.linear_svc import LinearSVCModel

    meta = _read_metadata(path)
    row = _read_data_row(path)
    model = LinearSVCModel(
        coefficients=_dense_vector_from_struct(row["coefficients"]),
        intercept=float(row["intercept"]),
        uid=meta["uid"],
    )
    return _restore_params(model, meta)


def save_svd_model(model, path: str, overwrite: bool = False) -> None:
    if model.components is None:
        raise ValueError("cannot save an unfitted TruncatedSVDModel")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata())
    row = {
        "V": _dense_matrix_struct(model.components),
        "s": _dense_vector_struct(model.singular_values),
    }
    try:
        import pyarrow as pa
    except ImportError:
        schema = None
    else:
        schema = pa.schema(
            [("V", _matrix_arrow_type()), ("s", _vector_arrow_type())]
        )
    _write_data_row(path, row, schema=schema, spark_fields=[
        ("V", "matrix"), ("s", "vector"),
    ])


def load_svd_model(path: str):
    from spark_rapids_ml_tpu_torch.models.svd import TruncatedSVDModel

    meta = _read_metadata(path)
    row = _read_data_row(path)
    model = TruncatedSVDModel(
        components=_dense_matrix_from_struct(row["V"]),
        singular_values=_dense_vector_from_struct(row["s"]),
        uid=meta["uid"],
    )
    return _restore_params(model, meta)


def save_kmeans_model(model, path: str, overwrite: bool = False) -> None:
    if model.cluster_centers is None:
        raise ValueError("cannot save an unfitted KMeansModel")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata())
    row = {
        "clusterCenters": _dense_matrix_struct(model.cluster_centers),
        "trainingCost": (
            float(model.training_cost_)
            if model.training_cost_ is not None else None
        ),
    }
    try:
        import pyarrow as pa
    except ImportError:
        schema = None
    else:
        schema = pa.schema(
            [
                ("clusterCenters", _matrix_arrow_type()),
                ("trainingCost", pa.float64()),
            ]
        )
    _write_data_row(path, row, schema=schema, spark_fields=[
        ("clusterCenters", "matrix"), ("trainingCost", "double"),
    ])


def load_kmeans_model(path: str):
    from spark_rapids_ml_tpu_torch.models.kmeans import KMeansModel

    return _load_centers_model(path, KMeansModel)


def _load_centers_model(path: str, model_cls):
    """(clusterCenters, trainingCost) layout shared by KMeansModel and
    BisectingKMeansModel."""
    meta = _read_metadata(path)
    row = _read_data_row(path)
    model = model_cls(
        cluster_centers=_dense_matrix_from_struct(row["clusterCenters"]),
        uid=meta["uid"],
    )
    model.training_cost_ = row.get("trainingCost")
    return _restore_params(model, meta)


def save_bkm_model(model, path: str, overwrite: bool = False) -> None:
    """BisectingKMeansModel: the KMeansModel data layout (leaf centers
    matrix + training cost) — Spark persists its cluster tree, an
    implementation detail the flat-leaves design does not carry.
    Delegates to the KMeans writer so the wire format cannot drift."""
    if model.cluster_centers is None:
        raise ValueError("cannot save an unfitted BisectingKMeansModel")
    save_kmeans_model.__wrapped_save__(model, path, overwrite=overwrite)


def load_bkm_model(path: str):
    from spark_rapids_ml_tpu_torch.models.bisecting_kmeans import (
        BisectingKMeansModel,
    )

    return _load_centers_model(path, BisectingKMeansModel)


def save_gmm_model(model, path: str, overwrite: bool = False) -> None:
    """GaussianMixtureModel layout: (weights vector, means matrix, covs
    stacked as a (k*d, d) matrix) — the covariance stack reshapes to
    (k, d, d) on load; Spark's writer stores gaussians row-per-component,
    an equivalent representation. The fit summary (iterations,
    log-likelihood) travels in the metadata's ``extra``."""
    if model.weights is None:
        raise ValueError("cannot save an unfitted GaussianMixtureModel")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    extras = {
        "numIterations": int(model.num_iterations_),
        "logLikelihood": float(model.log_likelihood_),
    }
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata(),
                    extra=extras)
    k, d = model.means.shape
    row = {
        "weights": _dense_vector_struct(model.weights),
        "means": _dense_matrix_struct(model.means),
        "covs": _dense_matrix_struct(model.covs.reshape(k * d, d)),
    }
    try:
        import pyarrow as pa
    except ImportError:
        schema = None
    else:
        schema = pa.schema(
            [
                ("weights", _vector_arrow_type()),
                ("means", _matrix_arrow_type()),
                ("covs", _matrix_arrow_type()),
            ]
        )
    _write_data_row(path, row, schema=schema, spark_fields=[
        ("weights", "vector"), ("means", "matrix"), ("covs", "matrix"),
    ])


def load_gmm_model(path: str):
    from spark_rapids_ml_tpu_torch.models.gaussian_mixture import (
        GaussianMixtureModel,
    )

    meta = _read_metadata(path)
    row = _read_data_row(path)
    means = _dense_matrix_from_struct(row["means"])
    k, d = means.shape
    model = GaussianMixtureModel(
        weights=_dense_vector_from_struct(row["weights"]),
        means=means,
        covs=_dense_matrix_from_struct(row["covs"]).reshape(k, d, d),
        uid=meta["uid"],
    )
    extras = meta.get("extra", {})
    model.num_iterations_ = int(extras.get("numIterations", 0))
    model.log_likelihood_ = float(extras.get("logLikelihood", float("nan")))
    return _restore_params(model, meta)


def _save_vector_row(model, path: str, overwrite: bool,
                     fields: Dict[str, str]) -> None:
    """Metadata plus one data row of dense vectors, the layout the
    host-statistics scalers share: ``fields`` maps each on-disk field
    name to the model attribute holding it (None until fitted)."""
    if any(getattr(model, attr) is None for attr in fields.values()):
        raise ValueError(
            f"cannot save an unfitted {type(model).__qualname__}")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata())
    row = {name: _dense_vector_struct(getattr(model, attr))
           for name, attr in fields.items()}
    try:
        import pyarrow as pa
    except ImportError:
        schema = None
    else:
        schema = pa.schema([(name, _vector_arrow_type()) for name in fields])
    _write_data_row(path, row, schema=schema,
                    spark_fields=[(name, "vector") for name in fields])


def _load_vector_row(path: str, model_cls, fields: Dict[str, str]):
    """Read what ``_save_vector_row`` wrote into ``model_cls``, whose
    constructor takes each attribute of ``fields`` by name."""
    meta = _read_metadata(path)
    row = _read_data_row(path)
    model = model_cls(**{attr: _dense_vector_from_struct(row[name])
                         for name, attr in fields.items()})
    model.uid = meta["uid"]
    return _restore_params(model, meta)


_SCALER_FIELDS = {"mean": "mean", "std": "std"}
_MINMAX_FIELDS = {"originalMin": "original_min",
                  "originalMax": "original_max"}
_MAXABS_FIELDS = {"maxAbs": "max_abs"}
_ROBUST_FIELDS = {"median": "median", "range": "qrange"}


_IMPUTER_FIELDS = {"surrogates": "surrogates"}


def save_imputer_model(model, path: str, overwrite: bool = False) -> None:
    _save_vector_row(model, path, overwrite, _IMPUTER_FIELDS)


def load_imputer_model(path: str):
    from spark_rapids_ml_tpu_torch.models.imputer import ImputerModel

    return _load_vector_row(path, ImputerModel, _IMPUTER_FIELDS)


def save_mlp_model(model, path: str, overwrite: bool = False) -> None:
    """Spark MultilayerPerceptronClassificationModel layout: the layer
    sizes plus ONE flat weight vector (per layer: W row-major then b) —
    matching ``MultilayerPerceptronClassifierWriter`` upstream."""
    if model.weights_ is None:
        raise ValueError(
            "cannot save an unfitted MultilayerPerceptronModel")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    extras = {
        "numIterations": int(model.num_iterations_),
        "finalLoss": float(model.final_loss_),
        "layersFitted": [int(v) for v in model.layers_],
    }
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata(),
                    extra=extras)
    row = {"weights": _dense_vector_struct(model.flat_weights)}
    try:
        import pyarrow as pa
    except ImportError:
        schema = None
    else:
        schema = pa.schema([("weights", _vector_arrow_type())])
    _write_data_row(path, row, schema=schema,
                    spark_fields=[("weights", "vector")])


def load_mlp_model(path: str):
    from spark_rapids_ml_tpu_torch.models.mlp import (
        MultilayerPerceptronModel,
        weights_from_flat,
    )

    meta = _read_metadata(path)
    row = _read_data_row(path)
    extras = meta.get("extra", {})
    # layersFitted is this writer's record; a genuine Spark-written
    # directory carries layers only in its paramMap — fall back there
    layers_raw = extras.get("layersFitted") \
        or meta.get("paramMap", {}).get("layers") \
        or meta.get("tpuParamMap", {}).get("layers")
    if layers_raw is None:
        raise ValueError(
            f"{path}: metadata carries no layer sizes (layersFitted / "
            "paramMap.layers)")
    layers = [int(v) for v in layers_raw]
    model = MultilayerPerceptronModel(
        layers=layers,
        weights=weights_from_flat(
            _dense_vector_from_struct(row["weights"]), layers),
        uid=meta["uid"],
    )
    model.num_iterations_ = int(extras.get("numIterations", 0))
    model.final_loss_ = float(extras.get("finalLoss", float("nan")))
    return _restore_params(model, meta)


def save_scaler_model(model, path: str, overwrite: bool = False) -> None:
    _save_vector_row(model, path, overwrite, _SCALER_FIELDS)


def load_scaler_model(path: str):
    from spark_rapids_ml_tpu_torch.models.scaler import StandardScalerModel

    return _load_vector_row(path, StandardScalerModel, _SCALER_FIELDS)


def save_minmax_model(model, path: str, overwrite: bool = False) -> None:
    _save_vector_row(model, path, overwrite, _MINMAX_FIELDS)


def load_minmax_model(path: str):
    from spark_rapids_ml_tpu_torch.models.feature_scalers import (
        MinMaxScalerModel,
    )

    return _load_vector_row(path, MinMaxScalerModel, _MINMAX_FIELDS)


def save_maxabs_model(model, path: str, overwrite: bool = False) -> None:
    _save_vector_row(model, path, overwrite, _MAXABS_FIELDS)


def load_maxabs_model(path: str):
    from spark_rapids_ml_tpu_torch.models.feature_scalers import (
        MaxAbsScalerModel,
    )

    return _load_vector_row(path, MaxAbsScalerModel, _MAXABS_FIELDS)


def save_robust_model(model, path: str, overwrite: bool = False) -> None:
    _save_vector_row(model, path, overwrite, _ROBUST_FIELDS)


def load_robust_model(path: str):
    from spark_rapids_ml_tpu_torch.models.feature_scalers import (
        RobustScalerModel,
    )

    return _load_vector_row(path, RobustScalerModel, _ROBUST_FIELDS)


def save_selector_model(model, path: str, overwrite: bool = False) -> None:
    """Spark's selector-model layout: a data row with selectedFeatures;
    the model's class travels under the metadata's ``extra``."""
    if model.selected_features is None:
        raise ValueError("cannot save an unfitted selector model")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(
        path, cls, model.uid, model.param_map_for_metadata(),
        extra={"selectorClass": type(model).__qualname__})
    _write_data_row(
        path,
        {"selectedFeatures": [int(i) for i in model.selected_features]},
        spark_fields=[("selectedFeatures", "array<int>")])


_SELECTOR_MODEL_CLASSES = ("ChiSqSelectorModel",
                           "VarianceThresholdSelectorModel",
                           "UnivariateFeatureSelectorModel")


def load_selector_model(path: str):
    """A selector model by the ``selectorClass`` its metadata records
    (ChiSq when absent, as in the JAX package)."""
    from spark_rapids_ml_tpu_torch.models import feature_transformers as ft
    from spark_rapids_ml_tpu_torch.models import feature_transformers2 as ft2

    meta = _read_metadata(path)
    name = meta.get("extra", {}).get("selectorClass", "ChiSqSelectorModel")
    if name not in _SELECTOR_MODEL_CLASSES:
        raise ValueError(
            f"{path}: unknown selector model class {name!r} "
            f"(expected one of {_SELECTOR_MODEL_CLASSES})")
    row = _read_data_row(path)
    model_cls = getattr(ft, name, None) or getattr(ft2, name)
    model = model_cls(
        selected=[int(i) for i in row["selectedFeatures"]],
        uid=meta["uid"])
    return _restore_params(model, meta)


def save_json_state_model(model, path: str, state: Dict[str, Any],
                          overwrite: bool = False) -> None:
    """Generic small-state model writer: Spark's metadata/params layout
    plus one JSON payload column, for models whose learned state is
    structured (category maps, encoders) rather than matrix-shaped."""
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata())
    _write_data_row(path, {"jsonState": json.dumps(state)})


def load_json_state_model(model_cls, path: str):
    """Counterpart of ``save_json_state_model``: (the model with its params
    restored, the decoded state dict); the caller re-attaches its typed
    state."""
    meta = _read_metadata(path)
    row = _read_data_row(path)
    model = model_cls(uid=meta["uid"])
    _restore_params(model, meta)
    return model, json.loads(row["jsonState"])


def save_countvec_model(model, path: str, overwrite: bool = False) -> None:
    """Spark's CountVectorizerModel layout: a vocabulary array row."""
    if model.vocabulary is None:
        raise ValueError("cannot save an unfitted CountVectorizerModel")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata())
    _write_data_row(
        path, {"vocabulary": [str(t) for t in model.vocabulary]},
        spark_fields=[("vocabulary", "array<string>")])


def load_countvec_model(path: str):
    from spark_rapids_ml_tpu_torch.models.text import CountVectorizerModel

    meta = _read_metadata(path)
    row = _read_data_row(path)
    model = CountVectorizerModel(
        vocabulary=[str(t) for t in row["vocabulary"]], uid=meta["uid"])
    return _restore_params(model, meta)


def save_idf_model(model, path: str, overwrite: bool = False) -> None:
    """Spark's IDFModel layout: (idf vector, docFreq array, numDocs)."""
    if model.idf is None:
        raise ValueError("cannot save an unfitted IDFModel")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata())
    row = {
        "idf": _dense_vector_struct(model.idf),
        "docFreq": [int(v) for v in np.asarray(model.doc_freq)],
        "numDocs": int(model.num_docs),
    }
    try:
        import pyarrow as pa
    except ImportError:
        schema = None
    else:
        schema = pa.schema([
            ("idf", _vector_arrow_type()),
            ("docFreq", pa.list_(pa.int64())),
            ("numDocs", pa.int64()),
        ])
    _write_data_row(path, row, schema=schema, spark_fields=[
        ("idf", "vector"), ("docFreq", "array<long>"), ("numDocs", "long"),
    ])


def load_idf_model(path: str):
    from spark_rapids_ml_tpu_torch.models.text import IDFModel

    meta = _read_metadata(path)
    row = _read_data_row(path)
    model = IDFModel(
        idf=_dense_vector_from_struct(row["idf"]),
        doc_freq=np.asarray(list(row["docFreq"]), dtype=np.float64),
        num_docs=int(row["numDocs"]),
        uid=meta["uid"],
    )
    return _restore_params(model, meta)


def save_string_indexer_model(model, path: str,
                              overwrite: bool = False) -> None:
    """Spark's StringIndexerModel layout: a data row carrying
    ``labelsArray`` (Spark 3.x stores one labels list per input column;
    this model carries one)."""
    if model.labels is None:
        raise ValueError("cannot save an unfitted StringIndexerModel")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata())
    _write_data_row(
        path, {"labelsArray": [[str(v) for v in model.labels]]},
        spark_fields=[("labelsArray", "array<array<string>>")])


def load_string_indexer_model(path: str):
    from spark_rapids_ml_tpu_torch.models.feature_transformers import (
        StringIndexerModel,
    )

    meta = _read_metadata(path)
    row = _read_data_row(path)
    # Spark 3.x writes labelsArray; Spark 2.x wrote labels
    labels = (list(row["labelsArray"][0]) if "labelsArray" in row
              else list(row["labels"]))
    model = StringIndexerModel(
        labels=[str(v) for v in labels], uid=meta["uid"])
    return _restore_params(model, meta)


def save_onehot_model(model, path: str, overwrite: bool = False) -> None:
    """Spark's OneHotEncoderModel layout: a data row with categorySizes
    (one entry per input column; this model carries one)."""
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata())
    _write_data_row(path, {"categorySizes": [int(model.category_size)]},
                    spark_fields=[("categorySizes", "array<int>")])


def load_onehot_model(path: str):
    from spark_rapids_ml_tpu_torch.models.feature_transformers import (
        OneHotEncoderModel,
    )

    meta = _read_metadata(path)
    row = _read_data_row(path)
    model = OneHotEncoderModel(
        category_size=int(list(row["categorySizes"])[0]),
        uid=meta["uid"],
    )
    return _restore_params(model, meta)


def save_nb_model(model, path: str, overwrite: bool = False) -> None:
    """NaiveBayesModel: pi / theta (+ sigma for gaussian) / classes."""
    if model.theta is None:
        raise ValueError("cannot save an unfitted NaiveBayesModel")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata())
    has_sigma = model.sigma is not None
    row = {
        "pi": _dense_vector_struct(model.pi),
        "theta": _dense_matrix_struct(model.theta),
        "sigma": _dense_matrix_struct(
            model.sigma if has_sigma else np.zeros((0, 0))
        ),
        "classes": _dense_vector_struct(np.asarray(model.classes_, float)),
        "hasSigma": bool(has_sigma),
    }
    try:
        import pyarrow as pa
    except ImportError:
        schema = None
    else:
        schema = pa.schema([
            ("pi", _vector_arrow_type()),
            ("theta", _matrix_arrow_type()),
            ("sigma", _matrix_arrow_type()),
            ("classes", _vector_arrow_type()),
            ("hasSigma", pa.bool_()),
        ])
    _write_data_row(path, row, schema=schema, spark_fields=[
        ("pi", "vector"), ("theta", "matrix"), ("sigma", "matrix"),
        ("classes", "vector"), ("hasSigma", "boolean"),
    ])


def load_nb_model(path: str):
    from spark_rapids_ml_tpu_torch.models.naive_bayes import NaiveBayesModel

    meta = _read_metadata(path)
    row = _read_data_row(path)
    sigma = (
        _dense_matrix_from_struct(row["sigma"]) if row["hasSigma"] else None
    )
    model = NaiveBayesModel(
        pi=_dense_vector_from_struct(row["pi"]),
        theta=_dense_matrix_from_struct(row["theta"]),
        sigma=sigma,
        classes=_dense_vector_from_struct(row["classes"]),
    )
    model.uid = meta["uid"]
    return _restore_params(model, meta)


def save_knn_model(model, path: str, overwrite: bool = False) -> None:
    """NearestNeighborsModel: the fitted item matrix is the model payload
    (brute-force KNN has no reduced parameters; the IVF indexes are
    rebuilt from it), stored in the DenseMatrix wire struct every other
    model uses."""
    if model.items is None:
        raise ValueError("cannot save an unfitted NearestNeighborsModel")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata())
    try:
        import pyarrow as pa
    except ImportError:
        schema = None
    else:
        schema = pa.schema([("items", _matrix_arrow_type())])
    _write_data_row(path, {"items": _dense_matrix_struct(model.items)},
                    schema=schema, spark_fields=[("items", "matrix")])


def load_knn_model(path: str):
    from spark_rapids_ml_tpu_torch.models.nearest_neighbors import (
        NearestNeighborsModel,
    )

    meta = _read_metadata(path)
    row = _read_data_row(path)
    model = NearestNeighborsModel(
        items=_dense_matrix_from_struct(row["items"]))
    model.uid = meta["uid"]
    return _restore_params(model, meta)


def _ensemble_fields(model, leaf2d) -> Dict[str, Any]:
    """The ensemble's (feature, threshold, leafValue) arrays and the bin
    edges as DenseMatrix wire structs (int arrays stored as exact
    small-valued doubles, cast back on load) — the fields forest and GBT
    rows share."""
    return {
        "feature": _dense_matrix_struct(
            np.asarray(model.ensemble_.feature, dtype=np.float64)),
        "threshold": _dense_matrix_struct(
            np.asarray(model.ensemble_.threshold, dtype=np.float64)),
        "leafValue": _dense_matrix_struct(leaf2d),
        "edges": _dense_matrix_struct(
            np.asarray(model.edges_, dtype=np.float64)),
    }


def _importances_struct(model) -> Dict[str, Any]:
    return _dense_vector_struct(np.asarray(
        model.feature_importances_
        if model.feature_importances_ is not None else [],
        dtype=np.float64))


def _ensemble_from_row(row, leaf_value):
    from spark_rapids_ml_tpu_torch.ops.forest_kernel import TreeEnsemble

    return TreeEnsemble(
        feature=_dense_matrix_from_struct(row["feature"]).astype(np.int32),
        threshold=_dense_matrix_from_struct(row["threshold"]).astype(
            np.int32),
        leaf_value=leaf_value,
    )


def _tree_model_class(meta):
    """The port's class of a saved tree model, by the simple name of the
    class its metadata records (either package's)."""
    dotted = meta.get("pythonClass") or meta["class"]
    return _port_class(dotted.rsplit(".", 1)[-1])


def _restore_importances(model, row, meta):
    fi = _dense_vector_from_struct(
        row.get("featureImportances", {"values": []}))
    model.feature_importances_ = fi if fi.size else None
    model.uid = meta["uid"]
    return _restore_params(model, meta)


def save_forest_model(model, path: str, overwrite: bool = False) -> None:
    """RandomForest and DecisionTree models: the JAX package's layout —
    the ensemble's (feature, threshold, leafValue) arrays plus bin edges,
    all DenseMatrix wire structs. A 3-D classification leaf tensor
    flattens to (trees, leaves*classes) with ``numClasses``/``classes``
    alongside."""
    if model.ensemble_ is None:
        raise ValueError("cannot save an unfitted RandomForest model")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata())
    leaf = np.asarray(model.ensemble_.leaf_value, dtype=np.float64)
    if leaf.ndim == 3:
        n_classes = leaf.shape[2]
        leaf2d = leaf.reshape(leaf.shape[0], -1)
        classes = np.asarray(model.classes_, dtype=np.float64)
    else:
        n_classes = 0
        leaf2d = leaf
        classes = np.zeros((0,), dtype=np.float64)
    row = {
        **_ensemble_fields(model, leaf2d),
        "classes": _dense_vector_struct(classes),
        "numClasses": int(n_classes),
        "featureImportances": _importances_struct(model),
    }
    try:
        import pyarrow as pa
    except ImportError:
        schema = None
    else:
        schema = pa.schema([
            ("feature", _matrix_arrow_type()),
            ("threshold", _matrix_arrow_type()),
            ("leafValue", _matrix_arrow_type()),
            ("edges", _matrix_arrow_type()),
            ("classes", _vector_arrow_type()),
            ("numClasses", pa.int64()),
            ("featureImportances", _vector_arrow_type()),
        ])
    _write_data_row(path, row, schema=schema, spark_fields=[
        ("feature", "matrix"), ("threshold", "matrix"),
        ("leafValue", "matrix"), ("edges", "matrix"),
        ("classes", "vector"), ("numClasses", "long"),
        ("featureImportances", "vector"),
    ])


def load_forest_model(path: str):
    meta = _read_metadata(path)
    row = _read_data_row(path)
    leaf2d = _dense_matrix_from_struct(row["leafValue"])
    n_classes = int(row["numClasses"])
    classes = _dense_vector_from_struct(row["classes"])
    if n_classes:
        leaf = leaf2d.reshape(leaf2d.shape[0], -1, n_classes)
    else:
        leaf = leaf2d
        classes = None
    model = _tree_model_class(meta)(
        ensemble=_ensemble_from_row(row, leaf),
        edges=_dense_matrix_from_struct(row["edges"]),
        classes=classes,
    )
    return _restore_importances(model, row, meta)


def save_gbt_model(model, path: str, overwrite: bool = False) -> None:
    """GBT models: the boosted TreeEnsemble plus the additive-model scalars
    (init, stepSize) — the JAX package's layout, the forest's wire
    structs."""
    if model.ensemble_ is None:
        raise ValueError("cannot save an unfitted GBT model")
    _require_target(path, overwrite)
    cls = f"{type(model).__module__}.{type(model).__qualname__}"
    _write_metadata(path, cls, model.uid, model.param_map_for_metadata())
    row = {
        **_ensemble_fields(model, np.asarray(model.ensemble_.leaf_value,
                                             dtype=np.float64)),
        "init": float(model.init_),
        "stepSize": float(model.step_size_),
        "featureImportances": _importances_struct(model),
    }
    try:
        import pyarrow as pa
    except ImportError:
        schema = None
    else:
        schema = pa.schema([
            ("feature", _matrix_arrow_type()),
            ("threshold", _matrix_arrow_type()),
            ("leafValue", _matrix_arrow_type()),
            ("edges", _matrix_arrow_type()),
            ("init", pa.float64()),
            ("stepSize", pa.float64()),
            ("featureImportances", _vector_arrow_type()),
        ])
    _write_data_row(path, row, schema=schema, spark_fields=[
        ("feature", "matrix"), ("threshold", "matrix"),
        ("leafValue", "matrix"), ("edges", "matrix"),
        ("init", "double"), ("stepSize", "double"),
        ("featureImportances", "vector"),
    ])


def load_gbt_model(path: str):
    meta = _read_metadata(path)
    row = _read_data_row(path)
    model = _tree_model_class(meta)(
        ensemble=_ensemble_from_row(
            row, _dense_matrix_from_struct(row["leafValue"])),
        edges=_dense_matrix_from_struct(row["edges"]),
        init=float(row["init"]),
        step_size=float(row["stepSize"]),
    )
    return _restore_importances(model, row, meta)


# -- generic load + atomic save layer --------------------------------------

# simple class name → (module of the port, class): what ``load_model`` may
# construct, whichever package wrote the metadata
_MODEL_CLASSES = {
    name: (f"spark_rapids_ml_tpu_torch.models.{module}", name)
    for module, names in (
        ("pca", ("PCA", "PCAModel")),
        ("kmeans", ("KMeans", "KMeansModel")),
        ("bisecting_kmeans", ("BisectingKMeans", "BisectingKMeansModel")),
        ("gaussian_mixture", ("GaussianMixture", "GaussianMixtureModel")),
        ("scaler", ("StandardScaler", "StandardScalerModel")),
        ("feature_scalers", ("MinMaxScaler", "MinMaxScalerModel",
                             "MaxAbsScaler", "MaxAbsScalerModel",
                             "RobustScaler", "RobustScalerModel",
                             "Normalizer", "Binarizer")),
        ("feature_transformers", ("ElementwiseProduct", "VectorSlicer",
                                  "VarianceThresholdSelector",
                                  "VarianceThresholdSelectorModel",
                                  "ChiSqSelector", "ChiSqSelectorModel",
                                  "StringIndexer", "StringIndexerModel",
                                  "IndexToString", "OneHotEncoder",
                                  "OneHotEncoderModel", "VectorAssembler",
                                  "Bucketizer", "QuantileDiscretizer",
                                  "PolynomialExpansion")),
        ("feature_transformers2", ("DCT", "Interaction", "FeatureHasher",
                                   "VectorIndexer", "VectorIndexerModel",
                                   "UnivariateFeatureSelector",
                                   "UnivariateFeatureSelectorModel",
                                   "RFormula", "RFormulaModel",
                                   "VectorSizeHint", "SQLTransformer")),
        ("text", ("Tokenizer", "RegexTokenizer", "StopWordsRemover",
                  "NGram", "HashingTF", "CountVectorizer",
                  "CountVectorizerModel", "IDF", "IDFModel")),
        ("linear_regression", ("LinearRegression", "LinearRegressionModel")),
        ("logistic_regression", ("LogisticRegression",
                                 "LogisticRegressionModel")),
        ("linear_svc", ("LinearSVC", "LinearSVCModel")),
        ("glm", ("GeneralizedLinearRegression",
                 "GeneralizedLinearRegressionModel")),
        ("svd", ("TruncatedSVD", "TruncatedSVDModel")),
        ("nearest_neighbors", ("NearestNeighbors", "NearestNeighborsModel")),
        ("naive_bayes", ("NaiveBayes", "NaiveBayesModel")),
        ("mlp", ("MultilayerPerceptronClassifier",
                 "MultilayerPerceptronModel")),
        ("imputer", ("Imputer", "ImputerModel")),
        ("dbscan", ("DBSCAN",)),
        ("pic", ("PowerIterationClustering",)),
        ("random_forest", ("RandomForestRegressor",
                           "RandomForestRegressionModel",
                           "RandomForestClassifier",
                           "RandomForestClassificationModel")),
        ("decision_tree", ("DecisionTreeRegressor",
                           "DecisionTreeRegressionModel",
                           "DecisionTreeClassifier",
                           "DecisionTreeClassificationModel")),
        ("gbt", ("GBTRegressor", "GBTRegressionModel", "GBTClassifier",
                 "GBTClassificationModel")),
        ("pipeline", ("Pipeline", "PipelineModel")),
        ("evaluation", ("RegressionEvaluator",
                        "BinaryClassificationEvaluator",
                        "MulticlassClassificationEvaluator",
                        "ClusteringEvaluator", "RankingEvaluator",
                        "MultilabelClassificationEvaluator")),
        ("tuning", ("CrossValidator", "CrossValidatorModel",
                    "TrainValidationSplit", "TrainValidationSplitModel")),
    )
    for name in names
}


def load_model(path: str):
    """Load any saved model or estimator by its metadata's ``pythonClass``
    (the serving registry's load-from-disk entry point): the simple name
    picks the port's class from ``_MODEL_CLASSES``, whose ``load`` reads
    the directory. The recorded module is never imported."""
    meta = _read_metadata(path)
    dotted = meta.get("pythonClass")
    if not dotted:
        raise ValueError(
            f"{path}: metadata carries no 'pythonClass' (a Spark-written "
            "directory?); load it with the class-specific reader instead"
        )
    simple = dotted.rsplit(".", 1)[-1]
    if simple not in _MODEL_CLASSES:
        raise ValueError(
            f"{path}: {dotted} has no counterpart in this package (one of "
            f"{sorted(_MODEL_CLASSES)})"
        )
    return _port_class(simple).load(path)


def _port_class(simple: str):
    """The port's class of that simple name, from ``_MODEL_CLASSES``."""
    module_name, cls_name = _MODEL_CLASSES[simple]
    return getattr(importlib.import_module(module_name), cls_name)


def _atomic_save(save_fn):
    """Make a ``save_*`` writer atomic: the payload is written to a temp
    sibling directory, then renamed into place. A save that crashes
    mid-write leaves the target untouched (the previous model or
    nothing), never a half-written directory for the registry's load path
    to pick up."""

    @functools.wraps(save_fn)
    def wrapper(obj, path, *args, overwrite: bool = False, **kwargs):
        if os.path.exists(path) and not overwrite:
            _require_target(path, False)  # the standard FileExistsError
        token = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        tmp = f"{path}.tmp-{token}"
        old = f"{path}.old-{token}"
        try:
            save_fn(obj, tmp, *args, overwrite=True, **kwargs)
            # Swap by rename-aside: both steps are atomic renames, so a
            # crash at any point leaves the previous model at ``path`` or,
            # complete, at the ``.old`` sibling: never a half-written
            # directory, never both copies gone.
            if os.path.exists(path):  # overwrite=True, checked above
                os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    wrapper.__wrapped_save__ = save_fn
    return wrapper


# Wrap every writer in this module (including ones later sections add
# above this line).
for _name, _fn in list(globals().items()):
    if _name.startswith("save_") and callable(_fn):
        globals()[_name] = _atomic_save(_fn)
del _name, _fn
