"""The distributed linear algebra layer (L3 of the reference's stack):
``RowMatrix``, the counterpart of the reference's
``org.apache.spark.ml.linalg.distributed.RapidsRowMatrix`` and of the JAX
package's ``linalg`` subpackage."""

from spark_rapids_ml_tpu_torch.linalg.row_matrix import (  # noqa: F401
    MAX_SPR_COLS,
    RowMatrix,
    triu_to_full,
)

__all__ = ["RowMatrix", "triu_to_full", "MAX_SPR_COLS"]
