"""Drop-in import namespace: ``from spark_rapids_ml_tpu_torch.feature import PCA``.

The same class names under a ``feature`` module path as
``pyspark.ml.feature`` and the JAX package's ``feature`` module.
"""

from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel

__all__ = ["PCA", "PCAModel"]
