"""Spark data-plane integration (optional dependency).

``from spark_rapids_ml_tpu_torch.spark import PCA`` is the one-import-change
drop-in the reference advertises, running against real pyspark DataFrames
or, without pyspark, the in-repo local engine (``spark/_compat.py``). The
Arrow aggregation logic lives in ``spark.aggregate`` (host NumPy float64),
``spark.forest_plane`` (the tree partials, host NumPy float64) and
``spark.device_aggregate`` (each executor's card) and imports without
pyspark, pandas or pyarrow; the Estimator/Model classes are resolved
lazily below.

The port's copy of the JAX package's ``spark/__init__.py`` for what is
ported: the statistics plane (``estimator.py``: PCA, LinearRegression,
LogisticRegression, KMeans, NaiveBayes and their models), the moments
plane (``moments_estimator.py``: the four scalers, TruncatedSVD,
LinearSVC and GLM), the per-level tree plane (``forest_estimator.py``:
DecisionTree, RandomForest and GBT), and the generic adapter's models,
NearestNeighbors and UMAP (``adapter.py``, ``adapter2.py``). Every other
front end of the JAX package's Spark plane is not ported yet; its name
raises ``AttributeError`` naming the ROADMAP item that brings it.
"""

from spark_rapids_ml_tpu_torch.spark.aggregate import (  # noqa: F401
    combine_stats,
    finalize_pca_from_stats,
    partition_gram_stats,
    vector_column_to_matrix,
)

_PYSPARK_CLASSES = (
    "PCA",
    "PCAModel",
    "LinearRegression",
    "LinearRegressionModel",
    "LogisticRegression",
    "LogisticRegressionModel",
    "KMeans",
    "KMeansModel",
    "NaiveBayes",
)

# moments-plane front-ends (spark/moments_estimator.py): the scalers,
# TruncatedSVD, LinearSVC and GLM fit on executor moment / sample / Gram /
# Newton partials, never collecting rows to the driver; their models stay
# the adapter's
_MOMENTS_PLANE_CLASSES = (
    "StandardScaler",
    "MinMaxScaler",
    "MaxAbsScaler",
    "RobustScaler",
    "TruncatedSVD",
    "LinearSVC",
    "GeneralizedLinearRegression",
)

# tree-ensemble front-ends (spark/forest_estimator.py): fits run on the
# executor statistics plane (per-level histogram partials), never
# collecting rows to the driver; transform stays the adapter pandas_udf
_FOREST_PLANE_CLASSES = (
    "DecisionTreeClassifier",
    "DecisionTreeRegressor",
    "RandomForestClassifier",
    "RandomForestRegressor",
    "GBTClassifier",
    "GBTRegressor",
)

# generic-adapter front-ends (spark/adapter.py): the models' pandas_udf
# transforms and the driver-collect NearestNeighbors and UMAP fits
_ADAPTER_CLASSES = (
    "RandomForestClassifierModel",
    "RandomForestRegressorModel",
    "GBTClassifierModel",
    "GBTRegressorModel",
    "LinearSVCModel",
    "GeneralizedLinearRegressionModel",
    "StandardScalerModel",
    "MinMaxScalerModel",
    "MaxAbsScalerModel",
    "RobustScalerModel",
    "NaiveBayesModel",
    "NearestNeighbors",
    "NearestNeighborsModel",
    "TruncatedSVDModel",
    "UMAP",
    "UMAPModel",
)

# the DecisionTree models (spark/adapter2.py); their estimators route to
# the forest plane
_ADAPTER2_CLASSES = (
    "DecisionTreeClassifierModel",
    "DecisionTreeRegressorModel",
)

_FAMILIES = "7 (their families and front ends)"
_REST = "7 (the rest of spark/)"
_EVAL = "7 (evaluation and tuning)"

# the JAX package's other Spark front ends → the ROADMAP queue 1 item that
# ports them
_UNPORTED = {
    # families not ported yet, with their front ends
    "ALS": _FAMILIES,
    "ALSModel": _FAMILIES,
    "BisectingKMeans": _FAMILIES,
    "BisectingKMeansModel": _FAMILIES,
    "BucketedRandomProjectionLSH": _FAMILIES,
    "BucketedRandomProjectionLSHModel": _FAMILIES,
    "FPGrowth": _FAMILIES,
    "FPGrowthModel": _FAMILIES,
    "GaussianMixture": _FAMILIES,
    "GaussianMixtureModel": _FAMILIES,
    "Imputer": _FAMILIES,
    "ImputerModel": _FAMILIES,
    "LDA": _FAMILIES,
    "LDAModel": _FAMILIES,
    "MinHashLSH": _FAMILIES,
    "MinHashLSHModel": _FAMILIES,
    "MultilayerPerceptronClassifier": _FAMILIES,
    "MultilayerPerceptronClassifierModel": _FAMILIES,
    "OneVsRest": _FAMILIES,
    "OneVsRestModel": _FAMILIES,
    "Word2Vec": _FAMILIES,
    "Word2VecModel": _FAMILIES,
    # the rest of spark/
    "AFTSurvivalRegression": _REST,
    "AFTSurvivalRegressionModel": _REST,
    "Binarizer": _REST,
    "Bucketizer": _REST,
    "ChiSqSelector": _REST,
    "ChiSqSelectorModel": _REST,
    "CountVectorizer": _REST,
    "CountVectorizerModel": _REST,
    "CrossValidator": _REST,
    "CrossValidatorModel": _REST,
    "DBSCAN": _REST,
    "DBSCANModel": _REST,
    "DCT": _REST,
    "ElementwiseProduct": _REST,
    "FMClassificationModel": _REST,
    "FMClassifier": _REST,
    "FMRegressionModel": _REST,
    "FMRegressor": _REST,
    "FeatureHasher": _REST,
    "HashingTF": _REST,
    "IDF": _REST,
    "IDFModel": _REST,
    "IndexToString": _REST,
    "Interaction": _REST,
    "IsotonicRegression": _REST,
    "IsotonicRegressionModel": _REST,
    "NGram": _REST,
    "Normalizer": _REST,
    "OneHotEncoder": _REST,
    "OneHotEncoderModel": _REST,
    "ParamGridBuilder": _REST,
    "Pipeline": _REST,
    "PipelineModel": _REST,
    "PolynomialExpansion": _REST,
    "PowerIterationClustering": _REST,
    "PrefixSpan": _REST,
    "QuantileDiscretizer": _REST,
    "RFormula": _REST,
    "RFormulaModel": _REST,
    "RegexTokenizer": _REST,
    "SQLTransformer": _REST,
    "StopWordsRemover": _REST,
    "StringIndexer": _REST,
    "StringIndexerModel": _REST,
    "Tokenizer": _REST,
    "TrainValidationSplit": _REST,
    "TrainValidationSplitModel": _REST,
    "UnivariateFeatureSelector": _REST,
    "UnivariateFeatureSelectorModel": _REST,
    "VarianceThresholdSelector": _REST,
    "VarianceThresholdSelectorModel": _REST,
    "VectorAssembler": _REST,
    "VectorIndexer": _REST,
    "VectorIndexerModel": _REST,
    "VectorSizeHint": _REST,
    "VectorSlicer": _REST,
    # evaluation and tuning
    "BinaryClassificationEvaluator": _EVAL,
    "ClusteringEvaluator": _EVAL,
    "MulticlassClassificationEvaluator": _EVAL,
    "MultilabelClassificationEvaluator": _EVAL,
    "RankingEvaluator": _EVAL,
    "RegressionEvaluator": _EVAL,
}

# pyspark's canonical model-class names (classification models are
# *ClassificationModel in pyspark.ml), as the JAX package aliases them
_CANONICAL_ALIASES = {
    "DecisionTreeClassificationModel": "DecisionTreeClassifierModel",
    "DecisionTreeRegressionModel": "DecisionTreeRegressorModel",
    "RandomForestClassificationModel": "RandomForestClassifierModel",
    "RandomForestRegressionModel": "RandomForestRegressorModel",
    "GBTClassificationModel": "GBTClassifierModel",
    "GBTRegressionModel": "GBTRegressorModel",
    "MultilayerPerceptronClassificationModel":
        "MultilayerPerceptronClassifierModel",
    "MultilayerPerceptronModel": "MultilayerPerceptronClassifierModel",
    "FMClassifierModel": "FMClassificationModel",
    "FMRegressorModel": "FMRegressionModel",
}

__all__ = [
    *_PYSPARK_CLASSES,
    *_MOMENTS_PLANE_CLASSES,
    *_FOREST_PLANE_CLASSES,
    *_ADAPTER_CLASSES,
    *_ADAPTER2_CLASSES,
    *(alias for alias, target in _CANONICAL_ALIASES.items()
      if target not in _UNPORTED),
    "combine_stats",
    "finalize_pca_from_stats",
    "partition_gram_stats",
    "vector_column_to_matrix",
]


def __getattr__(name):
    # binds to real pyspark when importable, else to the in-repo local
    # engine (spark/_compat.py) — same front-end code either way
    target = _CANONICAL_ALIASES.get(name, name)
    if target in _PYSPARK_CLASSES:
        from spark_rapids_ml_tpu_torch.spark import estimator

        return getattr(estimator, target)
    if target in _MOMENTS_PLANE_CLASSES:
        from spark_rapids_ml_tpu_torch.spark import moments_estimator

        return getattr(moments_estimator, target)
    if target in _FOREST_PLANE_CLASSES:
        from spark_rapids_ml_tpu_torch.spark import forest_estimator

        return getattr(forest_estimator, target)
    if target in _ADAPTER_CLASSES:
        from spark_rapids_ml_tpu_torch.spark import adapter

        return getattr(adapter, target)
    if target in _ADAPTER2_CLASSES:
        from spark_rapids_ml_tpu_torch.spark import adapter2

        return getattr(adapter2, target)
    if target in _UNPORTED:
        raise AttributeError(
            f"{name} is not ported to spark_rapids_ml_tpu_torch.spark yet: "
            f"ROADMAP queue 1 item {_UNPORTED[target]} brings it"
        )
    raise AttributeError(name)
