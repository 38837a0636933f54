"""Drop-in import namespace: ``from spark_rapids_ml_tpu_torch.feature import PCA``.

The same class names under a ``feature`` module path as
``pyspark.ml.feature`` and the JAX package's ``feature`` module (of whose
estimators the port has PCA, LinearRegression and TruncatedSVD so far).
"""

from spark_rapids_ml_tpu_torch.models.linear_regression import (
    LinearRegression,
    LinearRegressionModel,
)
from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel
from spark_rapids_ml_tpu_torch.models.svd import TruncatedSVD, TruncatedSVDModel

__all__ = [
    "PCA",
    "PCAModel",
    "LinearRegression",
    "LinearRegressionModel",
    "TruncatedSVD",
    "TruncatedSVDModel",
]
