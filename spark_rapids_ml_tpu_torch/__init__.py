"""spark_rapids_ml_tpu_torch — the PyTorch + CUDA port of spark_rapids_ml_tpu.

The same Estimator/Model/Params surface and on-disk model format as the JAX
package ``spark_rapids_ml_tpu``, which stays the reference, computed with
PyTorch on an NVIDIA H100. Kernels that the JAX package wrote in Pallas for
the TPU are CUDA kernels written by hand for Hopper (``csrc/``), built with
``nvcc`` at first use and bound with ``ctypes``; everything the JAX package
left to XLA is plain PyTorch.

Entry points compute on the card; ``SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu``
asks for the CPU explicitly (see ``utils/resources.py``). This package
imports neither ``jax`` nor ``spark_rapids_ml_tpu``.
"""

__version__ = "0.1.0"

from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel  # noqa: F401
from spark_rapids_ml_tpu_torch.models.kmeans import (  # noqa: F401
    KMeans,
    KMeansModel,
)
from spark_rapids_ml_tpu_torch.models.scaler import (  # noqa: F401
    StandardScaler,
    StandardScalerModel,
)
from spark_rapids_ml_tpu_torch.models.pipeline import (  # noqa: F401
    Pipeline,
    PipelineModel,
)
from spark_rapids_ml_tpu_torch.models.linear_regression import (  # noqa: F401
    LinearRegression,
    LinearRegressionModel,
)
from spark_rapids_ml_tpu_torch.models.logistic_regression import (  # noqa: F401
    LogisticRegression,
    LogisticRegressionModel,
)
from spark_rapids_ml_tpu_torch.models.linear_svc import (  # noqa: F401
    LinearSVC,
    LinearSVCModel,
)
from spark_rapids_ml_tpu_torch.models.glm import (  # noqa: F401
    GeneralizedLinearRegression,
    GeneralizedLinearRegressionModel,
)
from spark_rapids_ml_tpu_torch.models.svd import (  # noqa: F401
    TruncatedSVD,
    TruncatedSVDModel,
)
from spark_rapids_ml_tpu_torch.models.nearest_neighbors import (  # noqa: F401
    NearestNeighbors,
    NearestNeighborsModel,
)
from spark_rapids_ml_tpu_torch.models.dbscan import (  # noqa: F401
    DBSCAN,
    DBSCANModel,
)
from spark_rapids_ml_tpu_torch.models.random_forest import (  # noqa: F401
    RandomForestClassificationModel,
    RandomForestClassifier,
    RandomForestRegressionModel,
    RandomForestRegressor,
)
from spark_rapids_ml_tpu_torch.models.decision_tree import (  # noqa: F401
    DecisionTreeClassificationModel,
    DecisionTreeClassifier,
    DecisionTreeRegressionModel,
    DecisionTreeRegressor,
)
from spark_rapids_ml_tpu_torch.models.gbt import (  # noqa: F401
    GBTClassificationModel,
    GBTClassifier,
    GBTRegressionModel,
    GBTRegressor,
)
from spark_rapids_ml_tpu_torch.models.feature_scalers import (  # noqa: F401
    Binarizer,
    MaxAbsScaler,
    MaxAbsScalerModel,
    MinMaxScaler,
    MinMaxScalerModel,
    Normalizer,
    RobustScaler,
    RobustScalerModel,
)
from spark_rapids_ml_tpu_torch.models.feature_transformers import (  # noqa: F401
    Bucketizer,
    ChiSqSelector,
    ChiSqSelectorModel,
    ElementwiseProduct,
    IndexToString,
    OneHotEncoder,
    OneHotEncoderModel,
    PolynomialExpansion,
    QuantileDiscretizer,
    StringIndexer,
    StringIndexerModel,
    VarianceThresholdSelector,
    VarianceThresholdSelectorModel,
    VectorAssembler,
    VectorSlicer,
)
from spark_rapids_ml_tpu_torch.models.feature_transformers2 import (  # noqa: F401
    DCT,
    FeatureHasher,
    Interaction,
    RFormula,
    RFormulaModel,
    SQLTransformer,
    UnivariateFeatureSelector,
    UnivariateFeatureSelectorModel,
    VectorIndexer,
    VectorIndexerModel,
    VectorSizeHint,
)
from spark_rapids_ml_tpu_torch.models.text import (  # noqa: F401
    CountVectorizer,
    CountVectorizerModel,
    HashingTF,
    IDF,
    IDFModel,
    NGram,
    RegexTokenizer,
    StopWordsRemover,
    Tokenizer,
)
from spark_rapids_ml_tpu_torch.models.pic import (  # noqa: F401
    PowerIterationClustering,
)
from spark_rapids_ml_tpu_torch.models.naive_bayes import (  # noqa: F401
    NaiveBayes,
    NaiveBayesModel,
)
from spark_rapids_ml_tpu_torch.models.umap import (  # noqa: F401
    UMAP,
    UMAPModel,
)
from spark_rapids_ml_tpu_torch.models.gaussian_mixture import (  # noqa: F401
    GaussianMixture,
    GaussianMixtureModel,
)
from spark_rapids_ml_tpu_torch.models.mlp import (  # noqa: F401
    MultilayerPerceptronClassifier,
    MultilayerPerceptronModel,
)
from spark_rapids_ml_tpu_torch.models.ovr import (  # noqa: F401
    OneVsRest,
    OneVsRestModel,
)
from spark_rapids_ml_tpu_torch.models.imputer import (  # noqa: F401
    Imputer,
    ImputerModel,
)
from spark_rapids_ml_tpu_torch.models.bisecting_kmeans import (  # noqa: F401
    BisectingKMeans,
    BisectingKMeansModel,
)
from spark_rapids_ml_tpu_torch.models.evaluation import (  # noqa: F401
    BinaryClassificationEvaluator,
    ClusteringEvaluator,
    MulticlassClassificationEvaluator,
    MultilabelClassificationEvaluator,
    RankingEvaluator,
    RegressionEvaluator,
)
from spark_rapids_ml_tpu_torch.models.tuning import (  # noqa: F401
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    TrainValidationSplit,
    TrainValidationSplitModel,
)
from spark_rapids_ml_tpu_torch.stat import (  # noqa: F401
    ANOVATest,
    ChiSquareTest,
    Correlation,
    FValueTest,
    KolmogorovSmirnovTest,
    Summarizer,
)
from spark_rapids_ml_tpu_torch.linalg import RowMatrix  # noqa: F401

__all__ = [
    "PCA",
    "PCAModel",
    "KMeans",
    "KMeansModel",
    "StandardScaler",
    "StandardScalerModel",
    "Pipeline",
    "PipelineModel",
    "LinearRegression",
    "LinearRegressionModel",
    "LogisticRegression",
    "LogisticRegressionModel",
    "LinearSVC",
    "LinearSVCModel",
    "GeneralizedLinearRegression",
    "GeneralizedLinearRegressionModel",
    "TruncatedSVD",
    "TruncatedSVDModel",
    "RowMatrix",
    "NearestNeighbors",
    "NearestNeighborsModel",
    "DBSCAN",
    "DBSCANModel",
    "RandomForestClassificationModel",
    "RandomForestClassifier",
    "RandomForestRegressionModel",
    "RandomForestRegressor",
    "DecisionTreeClassificationModel",
    "DecisionTreeClassifier",
    "DecisionTreeRegressionModel",
    "DecisionTreeRegressor",
    "GBTClassificationModel",
    "GBTClassifier",
    "GBTRegressionModel",
    "GBTRegressor",
    "Binarizer",
    "MaxAbsScaler",
    "MaxAbsScalerModel",
    "MinMaxScaler",
    "MinMaxScalerModel",
    "Normalizer",
    "RobustScaler",
    "RobustScalerModel",
    "ChiSqSelector",
    "ChiSqSelectorModel",
    "ElementwiseProduct",
    "VarianceThresholdSelector",
    "VarianceThresholdSelectorModel",
    "VectorSlicer",
    "StringIndexer",
    "StringIndexerModel",
    "IndexToString",
    "OneHotEncoder",
    "OneHotEncoderModel",
    "VectorAssembler",
    "Bucketizer",
    "QuantileDiscretizer",
    "PolynomialExpansion",
    "DCT",
    "Interaction",
    "FeatureHasher",
    "VectorIndexer",
    "VectorIndexerModel",
    "VectorSizeHint",
    "SQLTransformer",
    "UnivariateFeatureSelector",
    "UnivariateFeatureSelectorModel",
    "RFormula",
    "RFormulaModel",
    "Tokenizer",
    "RegexTokenizer",
    "StopWordsRemover",
    "NGram",
    "HashingTF",
    "CountVectorizer",
    "CountVectorizerModel",
    "IDF",
    "IDFModel",
    "PowerIterationClustering",
    "NaiveBayes",
    "NaiveBayesModel",
    "UMAP",
    "UMAPModel",
    "GaussianMixture",
    "GaussianMixtureModel",
    "MultilayerPerceptronClassifier",
    "MultilayerPerceptronModel",
    "OneVsRest",
    "OneVsRestModel",
    "Imputer",
    "ImputerModel",
    "BisectingKMeans",
    "BisectingKMeansModel",
    "BinaryClassificationEvaluator",
    "ClusteringEvaluator",
    "MulticlassClassificationEvaluator",
    "MultilabelClassificationEvaluator",
    "RankingEvaluator",
    "RegressionEvaluator",
    "CrossValidator",
    "CrossValidatorModel",
    "ParamGridBuilder",
    "TrainValidationSplit",
    "TrainValidationSplitModel",
    "ANOVATest",
    "ChiSquareTest",
    "Correlation",
    "FValueTest",
    "KolmogorovSmirnovTest",
    "Summarizer",
]
