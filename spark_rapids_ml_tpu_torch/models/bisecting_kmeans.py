"""BisectingKMeans Estimator / Model, on PyTorch.

Counterpart of the JAX package's ``models/bisecting_kmeans.py``, with the
same params, so saved metadata stays compatible. Spark
``org.apache.spark.ml.clustering.BisectingKMeans`` semantics: start from
one all-points cluster and repeatedly bisect the highest-cost divisible
leaf with an inner 2-means until ``k`` leaves exist (fewer if nothing is
divisible — Spark allows the actual number to be smaller).
``minDivisibleClusterSize`` >= 1 is a row count, < 1 a fraction of the
dataset, exactly as upstream.

Every bisection runs the local KMeans estimator (``models/kmeans.py``)
with ``seed + n_splits``: with ``useXlaDot`` its k-means++ seeding and
Lloyd on the device (seeded by a ``torch.Generator``, so the splits are
held to the JAX package's bars, not draw for draw), without it the host
numpy Lloyd seeded by numpy, which gives the JAX package's fit exactly.
The tree bookkeeping (leaf costs, index sets) is host numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.models.kmeans import (
    KMeans,
    KMeansModel,
    _sqdist,
)
from spark_rapids_ml_tpu_torch.models.params import (
    HasDeviceId,
    HasInputCol,
    HasWeightCol,
    Param,
)
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import observed_transform
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer


class BisectingKMeansParams(HasInputCol, HasDeviceId, HasWeightCol):
    k = Param("k", "desired number of leaf clusters", 4,
              validator=lambda v: isinstance(v, int) and v >= 1)
    maxIter = Param("maxIter", "Lloyd iterations per bisection", 20,
                    validator=lambda v: isinstance(v, int) and v >= 0)
    seed = Param("seed", "random seed", 0,
                 validator=lambda v: isinstance(v, int))
    minDivisibleClusterSize = Param(
        "minDivisibleClusterSize",
        "leaf is divisible when its size >= this (>= 1: count; < 1: "
        "fraction of all rows)", 1.0,
        validator=lambda v: float(v) > 0)
    predictionCol = Param("predictionCol", "output cluster-id column",
                          "prediction")
    useXlaDot = Param(
        "useXlaDot",
        "run the inner 2-means on the device (True) or host NumPy",
        True, validator=lambda v: isinstance(v, bool))
    dtype = Param("dtype", "device compute dtype: 'float32', 'float64', or "
                  "'auto' (float32)", "auto",
                  validator=lambda v: v in ("auto", "float32", "float64"))


class BisectingKMeans(BisectingKMeansParams):
    """``BisectingKMeans(k=4).fit(df)`` → BisectingKMeansModel."""

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "BisectingKMeans":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(BisectingKMeans, path)

    @observed_fit("bisecting_kmeans")
    def fit(self, dataset) -> "BisectingKMeansModel":
        timer = PhaseTimer()
        frame = as_vector_frame(dataset, self.getInputCol())
        with timer.phase("densify"):
            x = frame.vectors_as_matrix(self.getInputCol()).astype(
                np.float64, copy=False)
        if x.shape[0] == 0:
            raise ValueError("empty dataset")
        w = self._extract_weights(frame, x.shape[0])
        if w is None:
            w = np.ones(x.shape[0])
        k = int(self.getK())
        min_div = float(self.get_or_default("minDivisibleClusterSize"))
        min_size = (min_div if min_div >= 1.0
                    else min_div * x.shape[0])
        min_size = max(min_size, 2.0)   # a split needs two points

        def sse(idx, center):
            d = x[idx] - center[None, :]
            return float((w[idx] * (d * d).sum(axis=1)).sum())

        all_idx = np.arange(x.shape[0])
        center0 = np.average(x, axis=0, weights=w)
        leaves = [(all_idx, center0, sse(all_idx, center0))]
        seed = int(self.getSeed())
        n_splits = 0
        with timer.phase("fit_kernel"):
            while len(leaves) < k:
                # highest-cost divisible leaf splits next (Spark gives
                # larger/costlier clusters priority)
                order = sorted(
                    range(len(leaves)),
                    key=lambda i: leaves[i][2], reverse=True)
                target = next(
                    (i for i in order
                     if leaves[i][0].shape[0] >= min_size
                     # a leaf of identical points cannot be bisected
                     and np.ptp(x[leaves[i][0]], axis=0).any()),
                    None)
                if target is None:
                    break   # nothing divisible: fewer than k leaves
                idx, _center, _cost = leaves.pop(target)
                inner = KMeans().setK(2).setSeed(seed + n_splits) \
                    .setMaxIter(int(self.getMaxIter())) \
                    .setUseXlaDot(self.getUseXlaDot()) \
                    .setDtype(self.get_or_default("dtype")) \
                    .setDeviceId(self.get_or_default("deviceId"))
                if self.get_or_default("weightCol"):
                    inner = inner.setWeightCol("w")
                    sub = inner.fit(VectorFrame(
                        {"features": x[idx], "w": w[idx]}))
                else:
                    sub = inner.fit(x[idx])
                assign = np.asarray(
                    sub.transform(x[idx]).column("prediction"),
                    dtype=np.int64)
                n_splits += 1
                for side in (0, 1):
                    part = idx[assign == side]
                    if part.shape[0] == 0:
                        continue
                    c = np.average(x[part], axis=0, weights=w[part])
                    leaves.append((part, c, sse(part, c)))
        centers = np.stack([c for _i, c, _s in leaves])
        model = BisectingKMeansModel(cluster_centers=centers)
        model.uid = self.uid
        model.copy_values_from(self)
        model.training_cost_ = float(sum(s for *_x, s in leaves))
        model.fit_timings_ = timer.as_dict()
        return model


class BisectingKMeansModel(BisectingKMeansParams):
    """Leaf centers; transform assigns the nearest (delegating to the
    KMeans assignment)."""

    def __init__(self, cluster_centers: Optional[np.ndarray] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.cluster_centers = cluster_centers
        self.training_cost_ = None
        self.fit_timings_ = {}

    def _copy_internal_state(self, other) -> None:
        other.cluster_centers = self.cluster_centers
        other.training_cost_ = self.training_cost_

    def _as_kmeans_model(self) -> KMeansModel:
        km = KMeansModel(cluster_centers=self.cluster_centers)
        km.copy_values_from(self)
        # BisectingKMeans has no kmeans-only params; shared ones
        # (inputCol, predictionCol, useXlaDot, dtype, deviceId) carry
        return km

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        if self.cluster_centers is None:
            raise ValueError("model has no centers; fit first or load")
        return self._as_kmeans_model().transform(dataset)

    def computeCost(self, dataset) -> float:
        """Sum of squared distances to the nearest center (host float64,
        the (n, k) expanded form)."""
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        return float(_sqdist(x, self.cluster_centers).min(axis=1).sum())

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_bkm_model

        save_bkm_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "BisectingKMeansModel":
        from spark_rapids_ml_tpu_torch.io.persistence import load_bkm_model

        return load_bkm_model(path)
