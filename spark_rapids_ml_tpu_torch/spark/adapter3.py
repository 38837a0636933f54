"""DataFrame front-ends for BisectingKMeans, DBSCAN and
PowerIterationClustering.

Same generic-adapter posture as ``spark/adapter.py`` (driver-collect fit
inside the documented envelope, executor ``pandas_udf`` transform) for the
estimator/model pairs. The BisectingKMeans ESTIMATOR the package exports
fits on the executor statistics plane (``spark/moments_estimator.py``);
its model transforms here. DBSCAN has no out-of-sample predict, so its
model labels the fitted DataFrame by rebuilding it; PIC mirrors Spark's
own shape: it has no fitted model, and ``assignClusters`` returns a NEW
(id, cluster) DataFrame built on the input's session. The helpers that
rebuild a local ``VectorFrame`` as a DataFrame serve
``spark/transformers.py`` too.

The port's copy of the JAX package's ``spark/adapter3.py`` for these
three families. The factorization-machine, AFTSurvivalRegression,
IsotonicRegression and PrefixSpan front ends wait for their families
(ROADMAP queue 1 items 7e and 7g).
"""

from __future__ import annotations

import numpy as np

from spark_rapids_ml_tpu_torch.models.bisecting_kmeans import (
    BisectingKMeans as _LBKM,
    BisectingKMeansModel as _LBKM_M,
)
from spark_rapids_ml_tpu_torch.models.dbscan import (
    DBSCAN as _LDBSCAN,
    DBSCANModel as _LDBSCAN_M,
)
from spark_rapids_ml_tpu_torch.models.pic import (
    PowerIterationClustering as _LPIC,
)
from spark_rapids_ml_tpu_torch.obs import observed_transform
from spark_rapids_ml_tpu_torch.spark._compat import DenseVector
from spark_rapids_ml_tpu_torch.spark.adapter import (
    _AdapterEstimator,
    _AdapterModel,
    _check_collect_envelope,
    _make_pair,
)

__all__ = [
    "BisectingKMeans",
    "BisectingKMeansModel",
    "DBSCAN",
    "DBSCANModel",
    "PowerIterationClustering",
]


def _session_of(dataset):
    """The session a result DataFrame is created on: pyspark's
    ``df.sparkSession`` or the local engine's ``df._session``."""
    s = getattr(dataset, "sparkSession", None)
    if s is not None:
        return s
    s = getattr(dataset, "_session", None)
    if s is not None:
        return s
    ctx = getattr(dataset, "sql_ctx", None)  # pyspark < 3.3
    if ctx is not None:
        return ctx.sparkSession
    raise TypeError(
        f"cannot locate a session on {type(dataset).__name__}"
    )


def _cell(v):
    """DataFrame cell → local-frame cell (vectors densify; the rest pass
    through: strings, token lists, scalars)."""
    return v.toArray() if hasattr(v, "toArray") else v


def _is_vector_column(col) -> bool:
    if isinstance(col, np.ndarray) and col.ndim == 2:
        return True
    first = col[0] if len(col) else None
    return isinstance(first, np.ndarray) or hasattr(first, "toArray")


def _frame_to_df(session, frame):
    """A local ``VectorFrame`` rebuilt as a DataFrame on ``session``; 2-D
    numeric columns become vector cells (the one rebuilder: PIC, DBSCAN and
    the transformer rebuild path all take it)."""
    names = frame.columns
    cols = {}
    for c in names:
        col = frame.column(c)
        if _is_vector_column(col):
            cols[c] = [DenseVector(np.asarray(v, dtype=np.float64))
                       for v in col]
        else:
            cols[c] = list(col)
    n = len(frame)
    if n == 0:
        # zero rows leave nothing to infer types from: the local engine
        # takes bare column names; pyspark needs a typed schema, so an
        # empty result carries string-typed columns (only the names
        # survive an empty frame)
        try:
            return session.createDataFrame([], schema=names)
        except Exception:  # noqa: BLE001 - pyspark rejects bare names
            from pyspark.sql.types import (
                StringType,
                StructField,
                StructType,
            )

            return session.createDataFrame([], schema=StructType(
                [StructField(c, StringType()) for c in names]))
    rows = [{c: cols[c][i] for c in names} for i in range(n)]
    return session.createDataFrame(rows)


BisectingKMeans, BisectingKMeansModel = _make_pair(
    "BisectingKMeans", _LBKM, _LBKM_M, needs_label=False,
    doc="Divisive hierarchy of device 2-means splits; transform assigns "
        "the nearest leaf center.")


class DBSCANModel(_AdapterModel):
    """DataFrame front-end over ``models.DBSCANModel``. DBSCAN has no
    out-of-sample predict: ``transform`` labels the FITTED dataset
    (row-count checked, as in the JAX package) by rebuilding it with the
    stored labels appended by position, so it must receive the DataFrame
    that was fit (on Spark, the same deterministic lineage, so ``collect``
    order matches the fit's)."""

    _local_model_cls = _LDBSCAN_M

    @observed_transform
    def _transform(self, dataset):
        local = self._local
        if local.labels_ is None:
            raise ValueError("model has no labels; fit first")
        pred_col = local.getPredictionCol()
        from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame

        # one pass: as_vector_frame collects the whole DataFrame (a
        # separate count() would scan the input again)
        frame = as_vector_frame(dataset, local.getInputCol())
        if len(frame) != len(local.labels_):
            raise ValueError(
                f"DBSCAN labels the fitted dataset only: got "
                f"{len(frame)} rows, fitted {len(local.labels_)}"
            )
        frame = frame.with_column(
            pred_col, [int(v) for v in local.labels_]
        )
        return _frame_to_df(_session_of(dataset), frame)


class DBSCAN(_AdapterEstimator):
    """DataFrame front-end over ``models.DBSCAN`` (density clustering on the
    driver's card, tiled past the dense envelope; the fit collects inside
    the documented envelope)."""

    _local_cls = _LDBSCAN
    _model_cls = DBSCANModel


class PowerIterationClustering(_AdapterEstimator):
    """DataFrame front-end over ``models.PowerIterationClustering``.
    Spark's PIC is not an Estimator: ``assignClusters(edges)`` returns a
    NEW (id, cluster) DataFrame on the input's session; the edge frame
    holds (srcCol, dstCol[, weightCol]) rows."""

    _local_cls = _LPIC
    _aliases: dict = {}  # PIC consumes edge columns, not a vector column

    def fit(self, dataset, params=None):
        raise TypeError(
            "PowerIterationClustering has no fit; use assignClusters"
        )

    def assignClusters(self, dataset):
        _check_collect_envelope(dataset, "PowerIterationClustering")
        local = self._local
        cols = [local.getSrcCol(), local.getDstCol()]
        wc = local.get_or_default("weightCol")
        if wc:
            cols.append(wc)
        from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

        rows = dataset.select(*cols).collect()
        frame = VectorFrame({
            c: [float(r[i]) for r in rows] for i, c in enumerate(cols)
        })
        out = local.assign_clusters(frame)
        return _frame_to_df(_session_of(dataset), out)

    assign_clusters = assignClusters


# factory-created classes carry the factory's module by default; pin them
# here so persistence sidecars and pickling resolve them where they live
for _name in __all__:
    globals()[_name].__module__ = __name__
del _name
