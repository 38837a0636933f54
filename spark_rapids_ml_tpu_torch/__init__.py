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
    ChiSqSelectorModel,
    ElementwiseProduct,
    VarianceThresholdSelector,
    VarianceThresholdSelectorModel,
    VectorSlicer,
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
    "ChiSqSelectorModel",
    "ElementwiseProduct",
    "VarianceThresholdSelector",
    "VarianceThresholdSelectorModel",
    "VectorSlicer",
]
