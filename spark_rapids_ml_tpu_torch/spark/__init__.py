"""Spark data-plane integration (optional dependency).

``from spark_rapids_ml_tpu_torch.spark import PCA`` is the one-import-change
drop-in the reference advertises, running against real pyspark DataFrames
or, without pyspark, the in-repo local engine (``spark/_compat.py``). The
Arrow aggregation logic lives in ``spark.aggregate`` (host NumPy float64)
and ``spark.device_aggregate`` (each executor's card) and imports without
pyspark, pandas or pyarrow; the Estimator/Model classes are resolved
lazily below.

The port's copy of the JAX package's ``spark/__init__.py`` for the
statistics plane (``estimator.py``): PCA, LinearRegression,
LogisticRegression and KMeans with their models. Every other front end of
the JAX package's Spark plane is not ported yet; its name raises
``AttributeError`` naming the ROADMAP item that brings it.
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
)

# the JAX package's other Spark front ends → the ROADMAP queue 1 item that
# ports them
_UNPORTED = {
    # ROADMAP queue 1 item 5b (the forest plane)
    "DecisionTreeClassifier": "5b (the forest plane)",
    "DecisionTreeRegressor": "5b (the forest plane)",
    "GBTClassifier": "5b (the forest plane)",
    "GBTRegressor": "5b (the forest plane)",
    "RandomForestClassifier": "5b (the forest plane)",
    "RandomForestRegressor": "5b (the forest plane)",
    # ROADMAP queue 1 item 5c (the moments plane)
    "BisectingKMeans": "5c (the moments plane)",
    "GaussianMixture": "5c (the moments plane)",
    "GeneralizedLinearRegression": "5c (the moments plane)",
    "Imputer": "5c (the moments plane)",
    "LDA": "5c (the moments plane)",
    "LinearSVC": "5c (the moments plane)",
    "MaxAbsScaler": "5c (the moments plane)",
    "MinMaxScaler": "5c (the moments plane)",
    "OneVsRest": "5c (the moments plane)",
    "RobustScaler": "5c (the moments plane)",
    "StandardScaler": "5c (the moments plane)",
    "TruncatedSVD": "5c (the moments plane)",
    # ROADMAP queue 1 item 5b (the adapter front ends)
    "ALS": "5b (the adapter front ends)",
    "ALSModel": "5b (the adapter front ends)",
    "BucketedRandomProjectionLSH": "5b (the adapter front ends)",
    "BucketedRandomProjectionLSHModel": "5b (the adapter front ends)",
    "DecisionTreeClassifierModel": "5b (the adapter front ends)",
    "DecisionTreeRegressorModel": "5b (the adapter front ends)",
    "FPGrowth": "5b (the adapter front ends)",
    "FPGrowthModel": "5b (the adapter front ends)",
    "GBTClassifierModel": "5b (the adapter front ends)",
    "GBTRegressorModel": "5b (the adapter front ends)",
    "GaussianMixtureModel": "5b (the adapter front ends)",
    "GeneralizedLinearRegressionModel": "5b (the adapter front ends)",
    "ImputerModel": "5b (the adapter front ends)",
    "LDAModel": "5b (the adapter front ends)",
    "LinearSVCModel": "5b (the adapter front ends)",
    "MaxAbsScalerModel": "5b (the adapter front ends)",
    "MinHashLSH": "5b (the adapter front ends)",
    "MinHashLSHModel": "5b (the adapter front ends)",
    "MinMaxScalerModel": "5b (the adapter front ends)",
    "MultilayerPerceptronClassifier": "5b (the adapter front ends)",
    "MultilayerPerceptronClassifierModel": "5b (the adapter front ends)",
    "NearestNeighbors": "5b (the adapter front ends)",
    "NearestNeighborsModel": "5b (the adapter front ends)",
    "OneVsRestModel": "5b (the adapter front ends)",
    "RandomForestClassifierModel": "5b (the adapter front ends)",
    "RandomForestRegressorModel": "5b (the adapter front ends)",
    "RobustScalerModel": "5b (the adapter front ends)",
    "StandardScalerModel": "5b (the adapter front ends)",
    "TruncatedSVDModel": "5b (the adapter front ends)",
    "UMAP": "5b (the adapter front ends)",
    "UMAPModel": "5b (the adapter front ends)",
    "Word2Vec": "5b (the adapter front ends)",
    "Word2VecModel": "5b (the adapter front ends)",
    # ROADMAP queue 1 item 6 (NaiveBayes)
    "NaiveBayes": "6 (NaiveBayes)",
    "NaiveBayesModel": "6 (NaiveBayes)",
    # ROADMAP queue 1 item 7 (the rest of spark/)
    "AFTSurvivalRegression": "7 (the rest of spark/)",
    "AFTSurvivalRegressionModel": "7 (the rest of spark/)",
    "Binarizer": "7 (the rest of spark/)",
    "BisectingKMeansModel": "7 (the rest of spark/)",
    "Bucketizer": "7 (the rest of spark/)",
    "ChiSqSelector": "7 (the rest of spark/)",
    "ChiSqSelectorModel": "7 (the rest of spark/)",
    "CountVectorizer": "7 (the rest of spark/)",
    "CountVectorizerModel": "7 (the rest of spark/)",
    "CrossValidator": "7 (the rest of spark/)",
    "CrossValidatorModel": "7 (the rest of spark/)",
    "DBSCAN": "7 (the rest of spark/)",
    "DBSCANModel": "7 (the rest of spark/)",
    "DCT": "7 (the rest of spark/)",
    "ElementwiseProduct": "7 (the rest of spark/)",
    "FMClassificationModel": "7 (the rest of spark/)",
    "FMClassifier": "7 (the rest of spark/)",
    "FMRegressionModel": "7 (the rest of spark/)",
    "FMRegressor": "7 (the rest of spark/)",
    "FeatureHasher": "7 (the rest of spark/)",
    "HashingTF": "7 (the rest of spark/)",
    "IDF": "7 (the rest of spark/)",
    "IDFModel": "7 (the rest of spark/)",
    "IndexToString": "7 (the rest of spark/)",
    "Interaction": "7 (the rest of spark/)",
    "IsotonicRegression": "7 (the rest of spark/)",
    "IsotonicRegressionModel": "7 (the rest of spark/)",
    "NGram": "7 (the rest of spark/)",
    "Normalizer": "7 (the rest of spark/)",
    "OneHotEncoder": "7 (the rest of spark/)",
    "OneHotEncoderModel": "7 (the rest of spark/)",
    "ParamGridBuilder": "7 (the rest of spark/)",
    "Pipeline": "7 (the rest of spark/)",
    "PipelineModel": "7 (the rest of spark/)",
    "PolynomialExpansion": "7 (the rest of spark/)",
    "PowerIterationClustering": "7 (the rest of spark/)",
    "PrefixSpan": "7 (the rest of spark/)",
    "QuantileDiscretizer": "7 (the rest of spark/)",
    "RFormula": "7 (the rest of spark/)",
    "RFormulaModel": "7 (the rest of spark/)",
    "RegexTokenizer": "7 (the rest of spark/)",
    "SQLTransformer": "7 (the rest of spark/)",
    "StopWordsRemover": "7 (the rest of spark/)",
    "StringIndexer": "7 (the rest of spark/)",
    "StringIndexerModel": "7 (the rest of spark/)",
    "Tokenizer": "7 (the rest of spark/)",
    "TrainValidationSplit": "7 (the rest of spark/)",
    "TrainValidationSplitModel": "7 (the rest of spark/)",
    "UnivariateFeatureSelector": "7 (the rest of spark/)",
    "UnivariateFeatureSelectorModel": "7 (the rest of spark/)",
    "VarianceThresholdSelector": "7 (the rest of spark/)",
    "VarianceThresholdSelectorModel": "7 (the rest of spark/)",
    "VectorAssembler": "7 (the rest of spark/)",
    "VectorIndexer": "7 (the rest of spark/)",
    "VectorIndexerModel": "7 (the rest of spark/)",
    "VectorSizeHint": "7 (the rest of spark/)",
    "VectorSlicer": "7 (the rest of spark/)",
    # ROADMAP queue 1 item 7 (evaluation and tuning)
    "BinaryClassificationEvaluator": "7 (evaluation and tuning)",
    "ClusteringEvaluator": "7 (evaluation and tuning)",
    "MulticlassClassificationEvaluator": "7 (evaluation and tuning)",
    "MultilabelClassificationEvaluator": "7 (evaluation and tuning)",
    "RankingEvaluator": "7 (evaluation and tuning)",
    "RegressionEvaluator": "7 (evaluation and tuning)",
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
    "combine_stats",
    "finalize_pca_from_stats",
    "partition_gram_stats",
    "vector_column_to_matrix",
]


def __getattr__(name):
    # binds to real pyspark when importable, else to the in-repo local
    # engine (spark/_compat.py) — same front-end code either way
    if name in _PYSPARK_CLASSES:
        from spark_rapids_ml_tpu_torch.spark import estimator

        return getattr(estimator, name)
    target = _CANONICAL_ALIASES.get(name, name)
    if target in _UNPORTED:
        raise AttributeError(
            f"{name} is not ported to spark_rapids_ml_tpu_torch.spark yet: "
            f"ROADMAP queue 1 item {_UNPORTED[target]} brings it"
        )
    raise AttributeError(name)
