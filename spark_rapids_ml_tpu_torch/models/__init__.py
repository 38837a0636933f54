"""The port's estimators and models."""

from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel
from spark_rapids_ml_tpu_torch.models.linear_regression import (
    LinearRegression,
    LinearRegressionModel,
)
from spark_rapids_ml_tpu_torch.models.svd import (
    TruncatedSVD,
    TruncatedSVDModel,
)

__all__ = [
    "PCA",
    "PCAModel",
    "LinearRegression",
    "LinearRegressionModel",
    "TruncatedSVD",
    "TruncatedSVDModel",
]
