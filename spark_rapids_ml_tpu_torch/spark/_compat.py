"""pyspark binding seam for the Spark front-ends.

Re-exports the pyspark names ``spark/estimator.py`` consumes when pyspark
is importable (the production binding — the engine underneath is real
Spark), and the local engine's API-compatible subset otherwise
(``spark/local_engine.py`` — the in-environment proof lane). One seam so
the front-end code is IDENTICAL under both: what the local lane exercises
is the same code the pyspark lane runs.
"""

from __future__ import annotations

try:  # pragma: no cover - exercised in pyspark environments (CI lane)
    from pyspark import keyword_only
    from pyspark.ml import Estimator, Model
    from pyspark.ml.linalg import (
        DenseMatrix,
        DenseVector,
        SparseVector,
        VectorUDT,
    )
    from pyspark.ml.param import Param, Params, TypeConverters
    from pyspark.ml.param.shared import HasInputCol, HasOutputCol
    from pyspark.sql.functions import col, pandas_udf

    HAVE_PYSPARK = True
except ImportError:
    from spark_rapids_ml_tpu_torch.spark.local_engine import (
        DenseMatrix,
        DenseVector,
        Estimator,
        HasInputCol,
        HasOutputCol,
        Model,
        Param,
        Params,
        SparseVector,
        TypeConverters,
        VectorUDT,
        col,
        keyword_only,
        pandas_udf,
    )

    HAVE_PYSPARK = False

__all__ = [
    "HAVE_PYSPARK",
    "DenseMatrix",
    "DenseVector",
    "SparseVector",
    "Estimator",
    "HasInputCol",
    "HasOutputCol",
    "Model",
    "Param",
    "Params",
    "TypeConverters",
    "VectorUDT",
    "col",
    "keyword_only",
    "pandas_udf",
]
