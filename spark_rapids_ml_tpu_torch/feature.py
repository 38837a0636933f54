"""Drop-in import namespace: ``from spark_rapids_ml_tpu_torch.feature import PCA``.

The same class names under a ``feature`` module path as
``pyspark.ml.feature`` and the JAX package's ``feature`` module
(``feature.py:13-33`` there), re-exported with no added logic.
"""

from spark_rapids_ml_tpu_torch.models.kmeans import KMeans, KMeansModel
from spark_rapids_ml_tpu_torch.models.linear_regression import (
    LinearRegression,
    LinearRegressionModel,
)
from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel
from spark_rapids_ml_tpu_torch.models.scaler import (
    StandardScaler,
    StandardScalerModel,
)
from spark_rapids_ml_tpu_torch.models.svd import TruncatedSVD, TruncatedSVDModel

__all__ = [
    "PCA",
    "PCAModel",
    "KMeans",
    "KMeansModel",
    "LinearRegression",
    "LinearRegressionModel",
    "TruncatedSVD",
    "TruncatedSVDModel",
    "StandardScaler",
    "StandardScalerModel",
]
