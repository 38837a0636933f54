"""The port's estimators and models."""

from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel
from spark_rapids_ml_tpu_torch.models.kmeans import KMeans, KMeansModel
from spark_rapids_ml_tpu_torch.models.scaler import (
    StandardScaler,
    StandardScalerModel,
)
from spark_rapids_ml_tpu_torch.models.pipeline import Pipeline, PipelineModel
from spark_rapids_ml_tpu_torch.models.linear_regression import (
    LinearRegression,
    LinearRegressionModel,
)
from spark_rapids_ml_tpu_torch.models.logistic_regression import (
    LogisticRegression,
    LogisticRegressionModel,
)
from spark_rapids_ml_tpu_torch.models.linear_svc import (
    LinearSVC,
    LinearSVCModel,
)
from spark_rapids_ml_tpu_torch.models.glm import (
    GeneralizedLinearRegression,
    GeneralizedLinearRegressionModel,
)
from spark_rapids_ml_tpu_torch.models.svd import (
    TruncatedSVD,
    TruncatedSVDModel,
)
from spark_rapids_ml_tpu_torch.models.nearest_neighbors import (
    NearestNeighbors,
    NearestNeighborsModel,
)
from spark_rapids_ml_tpu_torch.models.dbscan import DBSCAN, DBSCANModel
from spark_rapids_ml_tpu_torch.models.random_forest import (
    RandomForestClassificationModel,
    RandomForestClassifier,
    RandomForestRegressionModel,
    RandomForestRegressor,
)
from spark_rapids_ml_tpu_torch.models.decision_tree import (
    DecisionTreeClassificationModel,
    DecisionTreeClassifier,
    DecisionTreeRegressionModel,
    DecisionTreeRegressor,
)
from spark_rapids_ml_tpu_torch.models.gbt import (
    GBTClassificationModel,
    GBTClassifier,
    GBTRegressionModel,
    GBTRegressor,
)
from spark_rapids_ml_tpu_torch.models.feature_scalers import (
    Binarizer,
    MaxAbsScaler,
    MaxAbsScalerModel,
    MinMaxScaler,
    MinMaxScalerModel,
    Normalizer,
    RobustScaler,
    RobustScalerModel,
)
from spark_rapids_ml_tpu_torch.models.feature_transformers import (
    ChiSqSelectorModel,
    ElementwiseProduct,
    VarianceThresholdSelector,
    VarianceThresholdSelectorModel,
    VectorSlicer,
)
from spark_rapids_ml_tpu_torch.models.naive_bayes import (
    NaiveBayes,
    NaiveBayesModel,
)
from spark_rapids_ml_tpu_torch.models.umap import UMAP, UMAPModel
from spark_rapids_ml_tpu_torch.models.gaussian_mixture import (
    GaussianMixture,
    GaussianMixtureModel,
)
from spark_rapids_ml_tpu_torch.models.bisecting_kmeans import (
    BisectingKMeans,
    BisectingKMeansModel,
)
from spark_rapids_ml_tpu_torch.models.mlp import (
    MultilayerPerceptronClassifier,
    MultilayerPerceptronModel,
)
from spark_rapids_ml_tpu_torch.models.ovr import OneVsRest, OneVsRestModel
from spark_rapids_ml_tpu_torch.models.imputer import Imputer, ImputerModel

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
    "ChiSqSelectorModel",
    "ElementwiseProduct",
    "VarianceThresholdSelector",
    "VarianceThresholdSelectorModel",
    "VectorSlicer",
    "NaiveBayes",
    "NaiveBayesModel",
    "UMAP",
    "UMAPModel",
    "GaussianMixture",
    "GaussianMixtureModel",
    "BisectingKMeans",
    "BisectingKMeansModel",
    "MultilayerPerceptronClassifier",
    "MultilayerPerceptronModel",
    "OneVsRest",
    "OneVsRestModel",
    "Imputer",
    "ImputerModel",
]
