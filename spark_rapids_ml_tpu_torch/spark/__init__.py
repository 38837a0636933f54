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
LinearSVC, GLM, GaussianMixture, BisectingKMeans, OneVsRest and Imputer),
the per-level tree plane (``forest_estimator.py``: DecisionTree,
RandomForest and GBT), and the generic adapter's models,
NearestNeighbors, UMAP and the MultilayerPerceptronClassifier
(``adapter.py``, ``adapter2.py``, ``adapter3.py``), DBSCAN and
PowerIterationClustering
(``adapter3.py``), the feature and text transformers
(``transformers.py``), the DataFrame ``Pipeline`` and model selection
(``tuning_front.py``) and the six evaluators, which are the local
``models/evaluation.py`` classes. Every other
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
# TruncatedSVD, LinearSVC, GLM, GaussianMixture, BisectingKMeans,
# OneVsRest (plane LogisticRegression / LinearSVC sub-fits) and Imputer
# (exact missing-aware partials, or the sampled-quantile pass) fit on
# executor moment / sample / Gram / Newton / EM / split partials, never
# collecting rows to the driver; their models stay the adapters'
_MOMENTS_PLANE_CLASSES = (
    "StandardScaler",
    "MinMaxScaler",
    "MaxAbsScaler",
    "RobustScaler",
    "TruncatedSVD",
    "LinearSVC",
    "GeneralizedLinearRegression",
    "GaussianMixture",
    "BisectingKMeans",
    "OneVsRest",
    "Imputer",
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
# transforms and the driver-collect NearestNeighbors, UMAP and
# MultilayerPerceptronClassifier fits
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
    "GaussianMixtureModel",
    "ImputerModel",
    "OneVsRestModel",
    "MultilayerPerceptronClassifier",
    "MultilayerPerceptronClassifierModel",
)

# the DecisionTree models (spark/adapter2.py); their estimators route to
# the forest plane
_ADAPTER2_CLASSES = (
    "DecisionTreeClassifierModel",
    "DecisionTreeRegressorModel",
)

# the BisectingKMeans model, the DBSCAN pair and PIC (spark/adapter3.py);
# the BisectingKMeans estimator routes to the moments plane, and PIC
# mirrors Spark's no-model shape
_ADAPTER3_CLASSES = (
    "BisectingKMeansModel",
    "DBSCAN",
    "DBSCANModel",
    "PowerIterationClustering",
)

# row-wise transformer front-ends (spark/transformers.py): pandas_udf per
# Arrow batch by default; row-dropping or reshaping configurations ride
# the envelope-guarded rebuild path
_TRANSFORMER_CLASSES = (
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
)

# composition + model selection over DataFrames (spark/tuning_front.py)
_TUNING_CLASSES = (
    "CrossValidator",
    "CrossValidatorModel",
    "ParamGridBuilder",
    "Pipeline",
    "PipelineModel",
    "TrainValidationSplit",
    "TrainValidationSplitModel",
)

# the local evaluators accept transformed DataFrames directly
# (data/frame.py::as_vector_frame duck-types DataFrames), so they ARE
# the DataFrame evaluators
_EVALUATOR_CLASSES = (
    "BinaryClassificationEvaluator",
    "ClusteringEvaluator",
    "MulticlassClassificationEvaluator",
    "MultilabelClassificationEvaluator",
    "RankingEvaluator",
    "RegressionEvaluator",
)

_FAMILIES = "7 (their families and front ends)"
_REST = "7 (the rest of spark/)"

# the JAX package's other Spark front ends → the ROADMAP queue 1 item that
# ports them
_UNPORTED = {
    # families not ported yet, with their front ends
    "ALS": _FAMILIES,
    "ALSModel": _FAMILIES,
    "BucketedRandomProjectionLSH": _FAMILIES,
    "BucketedRandomProjectionLSHModel": _FAMILIES,
    "FPGrowth": _FAMILIES,
    "FPGrowthModel": _FAMILIES,
    "LDA": _FAMILIES,
    "LDAModel": _FAMILIES,
    "MinHashLSH": _FAMILIES,
    "MinHashLSHModel": _FAMILIES,
    "Word2Vec": _FAMILIES,
    "Word2VecModel": _FAMILIES,
    # the rest of spark/
    "AFTSurvivalRegression": _REST,
    "AFTSurvivalRegressionModel": _REST,
    "FMClassificationModel": _REST,
    "FMClassifier": _REST,
    "FMRegressionModel": _REST,
    "FMRegressor": _REST,
    "IsotonicRegression": _REST,
    "IsotonicRegressionModel": _REST,
    "PrefixSpan": _REST,
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
    *_ADAPTER3_CLASSES,
    *_TRANSFORMER_CLASSES,
    *_TUNING_CLASSES,
    *_EVALUATOR_CLASSES,
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
    if target in _ADAPTER3_CLASSES:
        from spark_rapids_ml_tpu_torch.spark import adapter3

        return getattr(adapter3, target)
    if target in _TRANSFORMER_CLASSES:
        from spark_rapids_ml_tpu_torch.spark import transformers

        return getattr(transformers, target)
    if target in _TUNING_CLASSES:
        from spark_rapids_ml_tpu_torch.spark import tuning_front

        return getattr(tuning_front, target)
    if target in _EVALUATOR_CLASSES:
        from spark_rapids_ml_tpu_torch.models import evaluation

        return getattr(evaluation, target)
    if target in _UNPORTED:
        raise AttributeError(
            f"{name} is not ported to spark_rapids_ml_tpu_torch.spark yet: "
            f"ROADMAP queue 1 item {_UNPORTED[target]} brings it"
        )
    raise AttributeError(name)
