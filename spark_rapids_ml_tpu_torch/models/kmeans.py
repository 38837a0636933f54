"""KMeans Estimator / Model with the Spark ML param surface, on PyTorch.

Counterpart of the JAX package's ``models/kmeans.py``, with the same params,
so saved metadata stays compatible. Param names follow Spark's
``org.apache.spark.ml.clustering.KMeans``: k, maxIter, tol, seed,
featuresCol (= inputCol), predictionCol, weightCol.

Fit routes:

* one shot (``useXlaDot``): k-means++ seeding and Lloyd on the device
  (``ops/kmeans_kernel.py``); ``weightCol`` rides the kernels' mask slot,
  which weights the D² draws, the cluster statistics and the cost;
* streamed: a zero-arg callable returning an iterable of row chunks, or an
  in-memory unweighted X above the streaming threshold, is seeded by
  k-means++ on a reservoir sample (numpy), then runs one streamed pass per
  Lloyd iteration, folding each bucket's statistics into a device
  accumulator with integer counts (``ops.kmeans_kernel
  .update_cluster_stats``), or into numpy float64 without ``useXlaDot``;
* host (``useXlaDot=False``): numpy float64 with the same init, update and
  empty-cluster semantics, never a device.

The numpy routes (``_fit_host``, ``_streamed_lloyd_host``,
``_reservoir_sample``, ``_host_kmeans_pp``) are the JAX package's,
unchanged, so they give its results. ``dtype='auto'`` is float32 here.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.data.batches import (
    BatchSource,
    stream_threshold_bytes,
    streaming_source,
)
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.models.params import (
    HasDeviceId,
    HasInputCol,
    HasWeightCol,
    Param,
)
from spark_rapids_ml_tpu_torch.models.pca import _resolve_dtype
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import (
    observed_transform,
    transform_phase,
)
from spark_rapids_ml_tpu_torch.ops import kmeans_kernel as _kk
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange


class KMeansParams(HasInputCol, HasDeviceId, HasWeightCol):
    k = Param("k", "number of clusters", 2,
              validator=lambda v: isinstance(v, int) and v >= 1)
    maxIter = Param("maxIter", "maximum Lloyd iterations", 20,
                    validator=lambda v: isinstance(v, int) and v >= 0)
    tol = Param("tol", "center-shift convergence tolerance", 1e-4,
                validator=lambda v: v >= 0)
    seed = Param("seed", "random seed for k-means++ init", 0,
                 validator=lambda v: isinstance(v, int))
    predictionCol = Param("predictionCol", "output cluster-id column",
                          "prediction")
    useXlaDot = Param(
        "useXlaDot",
        "run seeding+Lloyd on the device (True) or host NumPy (False)",
        True, validator=lambda v: isinstance(v, bool))
    dtype = Param("dtype", "device compute dtype: 'float32', 'float64', or "
                  "'auto' (float32)", "auto",
                  validator=lambda v: v in ("auto", "float32", "float64"))


class KMeans(KMeansParams):
    """``KMeans().setK(8).fit(df)`` → KMeansModel."""

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "KMeans":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(KMeans, path)

    @observed_fit("kmeans")
    def fit(self, dataset) -> "KMeansModel":
        """Also accepts an out-of-core source: a zero-arg callable returning
        an iterable of row chunks (re-iterable — Lloyd needs one pass per
        iteration); seeding runs k-means++ on a reservoir sample."""
        timer = PhaseTimer()
        k = self.getK()
        source = streaming_source(dataset, 0)
        weights = None
        if source is not None:
            self._reject_streamed_weights()
        else:
            frame = as_vector_frame(dataset, self.getInputCol())
            with timer.phase("densify"):
                x = frame.vectors_as_matrix(self.getInputCol())
            weights = self._extract_weights(frame, x.shape[0])
            if (self.getUseXlaDot() and weights is None
                    and x.nbytes > stream_threshold_bytes()):
                source = BatchSource(x)

        if source is not None:
            if not source.reiterable:
                raise ValueError(
                    "KMeans streaming requires a re-iterable source (a "
                    "zero-arg callable returning a fresh chunk iterator): "
                    "Lloyd makes one pass per iteration"
                )
            centers, cost, n_iter = self._fit_streamed(source, k, timer)
        else:
            if k > x.shape[0]:
                raise ValueError(
                    f"k = {k} must be at most the number of rows {x.shape[0]}"
                )
            if self.getUseXlaDot():
                centers, cost, n_iter = self._fit_device(x, k, timer, weights)
            else:
                centers, cost, n_iter = self._fit_host(x, k, timer, weights)
        model = KMeansModel(cluster_centers=np.asarray(centers,
                                                       dtype=np.float64))
        model.uid = self.uid
        model.copy_values_from(self)
        model.training_cost_ = float(cost)
        model.n_iter_ = int(n_iter)
        model.fit_timings_ = timer.as_dict()
        return model

    # -- device path (the JAX package's _fit_xla) -------------------------
    def _fit_device(self, x, k, timer, weights=None):
        device = resolve_device(self.getDeviceId())
        dtype = _resolve_dtype(self.getDtype())
        with timer.phase("h2d"):
            x_dev = torch.as_tensor(x, dtype=dtype, device=device)
            # the kernels' mask slot multiplies the D² draws, the cluster
            # statistics and the cost: weights through it ARE weighted
            # k-means
            w_dev = (None if weights is None
                     else torch.as_tensor(weights, dtype=dtype, device=device))
        with timer.phase("fit_kernel"), TraceRange("kmeans lloyd",
                                                   TraceColor.GREEN):
            init = _kk.kmeans_plus_plus_init(x_dev, k, self.getSeed(),
                                             mask=w_dev)
            result = _kk.kmeans_fit_kernel(
                x_dev, init, mask=w_dev, max_iter=self.getMaxIter(),
                tol=self.getTol())
            centers = result.centers.cpu().numpy()  # synchronises
        return centers, float(result.cost), int(result.n_iter)

    # -- streamed (out-of-core) paths ---------------------------------------
    def _fit_streamed(self, source, k, timer):
        """Out-of-core Lloyd: one streamed pass per iteration. Seeding is
        k-means++ on a uniform reservoir sample. As on the other fit paths,
        the reported cost is measured under the FINAL centers (one extra
        stats pass)."""
        rng = np.random.default_rng(self.getSeed())
        with timer.phase("seed"), TraceRange("kmeans seed", TraceColor.ORANGE):
            sample = _reservoir_sample(source, max(4096, 8 * k), rng)
            if k > sample.shape[0]:
                raise ValueError(
                    f"k = {k} must be at most the number of rows "
                    f"{sample.shape[0]}"
                )
            centers = _host_kmeans_pp(np.asarray(sample, dtype=np.float64),
                                      k, rng)
        if self.getUseXlaDot():
            return self._streamed_lloyd_device(source, centers, timer)
        return self._streamed_lloyd_host(source, centers, timer)

    def _streamed_lloyd_device(self, source, centers, timer):
        device = resolve_device(self.getDeviceId())
        dtype = _resolve_dtype(self.getDtype())
        k, n = centers.shape
        centers_dev = torch.as_tensor(centers, dtype=dtype, device=device)

        def pass_stats(c_dev):
            # integer counts: exact past 2²⁴ rows per cluster
            carry = (torch.zeros((k, n), dtype=dtype, device=device),
                     torch.zeros((k,), dtype=torch.int64, device=device),
                     torch.zeros((), dtype=dtype, device=device))
            for batch, mask in source.batches():
                carry = _kk.update_cluster_stats(
                    carry, c_dev,
                    torch.as_tensor(batch, dtype=dtype, device=device),
                    None if mask is None
                    else torch.as_tensor(mask, device=device))
            return carry

        n_iter = 0
        with timer.phase("fit_kernel"), TraceRange("kmeans streamed",
                                                   TraceColor.GREEN):
            for n_iter in range(1, self.getMaxIter() + 1):
                sums, counts, _ = pass_stats(centers_dev)
                safe = torch.clamp_min(counts, 1).to(dtype)[:, None]
                new_centers = torch.where(counts[:, None] > 0, sums / safe,
                                          centers_dev)
                moved = float(torch.sqrt(
                    ((new_centers - centers_dev) ** 2).sum(dim=1).max()))
                centers_dev = new_centers
                if moved <= self.getTol():
                    break
            _, _, cost = pass_stats(centers_dev)
            centers_host = centers_dev.cpu().numpy()
        return centers_host, float(cost), n_iter

    def _streamed_lloyd_host(self, source, centers, timer):
        k, n = centers.shape

        def pass_stats(c):
            sums = np.zeros((k, n))
            counts = np.zeros(k)
            cost = 0.0
            for batch, mask in source.batches():
                b = np.asarray(batch if mask is None else batch[mask],
                               dtype=np.float64)
                d = _sqdist(b, c)
                labels = d.argmin(axis=1)
                np.add.at(sums, labels, b)
                np.add.at(counts, labels, 1.0)
                cost += float(d.min(axis=1).sum())
            return sums, counts, cost

        n_iter = 0
        with timer.phase("fit_kernel"), TraceRange("kmeans host",
                                                   TraceColor.ORANGE):
            for n_iter in range(1, self.getMaxIter() + 1):
                sums, counts, _ = pass_stats(centers)
                new_centers = np.where(
                    counts[:, None] > 0,
                    sums / np.maximum(counts, 1.0)[:, None],
                    centers,
                )
                moved = float(np.sqrt(
                    ((new_centers - centers) ** 2).sum(axis=1).max()
                ))
                centers = new_centers
                if moved <= self.getTol():
                    break
            _, _, cost = pass_stats(centers)
        return centers, cost, n_iter

    # -- host path ----------------------------------------------------------
    def _fit_host(self, x, k, timer, weights=None):
        """NumPy Lloyd with the same init/update/empty-cluster semantics."""
        rng = np.random.default_rng(self.getSeed())
        w = np.ones(x.shape[0]) if weights is None else weights
        with timer.phase("fit_kernel"), TraceRange("kmeans host",
                                                   TraceColor.ORANGE):
            centers = _host_kmeans_pp(x, k, rng, weights=weights)
            n_iter = 0
            for n_iter in range(1, self.getMaxIter() + 1):
                d = _sqdist(x, centers)
                labels = d.argmin(axis=1)
                new_centers = centers.copy()
                for j in range(k):
                    sel = labels == j
                    wj = w[sel]
                    if wj.sum() > 0:
                        new_centers[j] = (
                            (x[sel] * wj[:, None]).sum(axis=0) / wj.sum()
                        )
                moved = np.sqrt(((new_centers - centers) ** 2).sum(axis=1)
                                .max())
                centers = new_centers
                if moved <= self.getTol():
                    break
            cost = (_sqdist(x, centers).min(axis=1) * w).sum()
        return centers, cost, n_iter


def _sqdist(x, centers):
    x2 = (x * x).sum(axis=1)[:, None]
    c2 = (centers * centers).sum(axis=1)[None, :]
    return np.maximum(x2 + c2 - 2.0 * (x @ centers.T), 0.0)


def _reservoir_sample(source, size: int, rng) -> np.ndarray:
    """Uniform-ish sample of up to ``size`` rows in one streamed pass.

    Vectorized batch reservoir: row t (0-based global index) replaces a
    random slot with probability size/(t+1) — per-batch vectorization of
    Algorithm R, accepted approximation for seeding purposes."""
    reservoir = None
    filled = 0
    seen = 0
    for batch, mask in source.batches():
        rows = batch if mask is None else batch[mask]
        if reservoir is None:
            reservoir = np.empty((size, rows.shape[1]), dtype=np.float64)
        take = min(size - filled, rows.shape[0])
        if take > 0:
            reservoir[filled:filled + take] = rows[:take]
            filled += take
            seen += take
            rows = rows[take:]
        if rows.shape[0] == 0:
            continue
        t = seen + np.arange(rows.shape[0])
        keep = rng.random(rows.shape[0]) < size / (t + 1)
        idx = np.nonzero(keep)[0]
        if idx.size:
            slots = rng.integers(0, size, size=idx.size)
            reservoir[slots] = rows[idx]
        seen += rows.shape[0]
    if reservoir is None:
        raise ValueError("empty dataset")
    return reservoir[:filled] if filled < size else reservoir


def _host_kmeans_pp(x, k, rng, weights=None):
    centers = np.empty((k, x.shape[1]), dtype=np.float64)
    if weights is None:
        centers[0] = x[rng.integers(len(x))]
    else:
        pw = weights / weights.sum()
        centers[0] = x[rng.choice(len(x), p=pw)]
    w = np.ones(len(x)) if weights is None else weights
    min_d = ((x - centers[0]) ** 2).sum(axis=1) * w
    for i in range(1, k):
        p = min_d / min_d.sum() if min_d.sum() > 0 else (
            w / w.sum() if weights is not None else None
        )
        centers[i] = x[rng.choice(len(x), p=p)]
        min_d = np.minimum(min_d, ((x - centers[i]) ** 2).sum(axis=1) * w)
    return centers


class KMeansModel(KMeansParams):
    def __init__(self, cluster_centers: Optional[np.ndarray] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.cluster_centers = cluster_centers
        self.training_cost_ = None
        self.n_iter_ = None
        self.fit_timings_ = {}

    def _copy_internal_state(self, other: "KMeansModel") -> None:
        other.cluster_centers = self.cluster_centers
        other.training_cost_ = self.training_cost_
        other.n_iter_ = self.n_iter_

    # Spark API naming
    def clusterCenters(self):
        return [c for c in self.cluster_centers]

    @observed_transform("kmeans")
    def transform(self, dataset) -> VectorFrame:
        """Nearest-centre labels as int32 in ``predictionCol``: one
        assignment over the whole batch on the device (no bucket padding:
        the port compiles nothing per shape), host numpy float64 when
        ``useXlaDot=False``."""
        if self.cluster_centers is None:
            raise ValueError("model has no centers; fit first or load")
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        if self.getUseXlaDot():
            device = resolve_device(self.getDeviceId())
            dtype = _resolve_dtype(self.getDtype())
            with TraceRange("device assign", TraceColor.GREEN):
                with transform_phase("device_put"):
                    x_dev = torch.as_tensor(x, dtype=dtype, device=device)
                    c_dev = torch.as_tensor(self.cluster_centers, dtype=dtype,
                                            device=device)
                with transform_phase("compute"):
                    labels_dev = _kk.assign_clusters(x_dev, c_dev)
                with transform_phase("host_sync"):
                    labels = labels_dev.cpu().numpy()
        else:
            with transform_phase("compute"):
                labels = _sqdist(x, self.cluster_centers).argmin(axis=1)
        return frame.with_column(
            self.getPredictionCol(), labels.astype(np.int32).tolist()
        )

    # -- serving ------------------------------------------------------------
    def _serving_weights(self, precision: str, device, dtype):
        """Device-staged centres for one precision, shared by the
        standalone serving program and the fused-pipeline stage: bf16
        pre-cast; int8 pre-quantized, transposed and padded
        (``ops.kmeans_kernel.pad_int8_centers``) with its float32 scale;
        native at the transform dtype."""
        from spark_rapids_ml_tpu_torch.ops.quantize import (
            quantize_symmetric_host,
        )

        centers = np.ascontiguousarray(self.cluster_centers, dtype=np.float64)
        if precision == "bf16":
            return (torch.as_tensor(centers, device=device)
                    .to(torch.bfloat16),)
        if precision == "int8":
            q, scale = quantize_symmetric_host(centers)
            return (torch.as_tensor(_kk.pad_int8_centers(q), device=device),
                    torch.tensor(scale, dtype=torch.float32, device=device))
        return (torch.as_tensor(centers, dtype=dtype, device=device),)

    def _serving_bodies(self):
        """precision → the assignment body; int8's takes the model's k."""
        bodies = dict(_kk.SERVING_STAGE_BODIES)
        bodies["int8"] = functools.partial(
            bodies["int8"], k=int(self.cluster_centers.shape[0]))
        return bodies

    def serving_stage(self, precision: str = "native", *,
                      device=None, dtype=None):
        """Composable fused-pipeline stage: the assignment body + staged
        centres. TERMINAL: labels are output-typed and cannot feed a
        downstream transformer. None for a host-path model."""
        if self.cluster_centers is None or not self.getUseXlaDot():
            return None
        from spark_rapids_ml_tpu_torch.models._serving import (
            ServingStage,
            resolve_serving_context,
        )

        if device is None or dtype is None:
            device, dtype = resolve_serving_context(self)
        body = self._serving_bodies().get(precision)
        if body is None:
            raise ValueError(f"unknown serving precision {precision!r}")
        return ServingStage(
            fn=body,
            weights=self._serving_weights(precision, device, dtype),
            algo="kmeans",
            terminal=True,
            fetch_dtype=np.dtype(np.int32),
        )

    def serving_transform_program(self, precision: str = "native",
                                  device=None):
        """The device-resident serving program for the pipelined batcher
        (``obs.serving.ServingProgram``): centres staged once, ``run``
        launching the assignment (the bf16 / int8 variants reduce only the
        cross-term product), ``fetch`` the one host sync, returning int32
        labels as ``transform`` does. None for a host-path model."""
        if self.cluster_centers is None or not self.getUseXlaDot():
            return None
        from spark_rapids_ml_tpu_torch.models._serving import (
            build_serving_program,
            resolve_serving_context,
        )

        device, dtype = resolve_serving_context(self, device=device)
        return build_serving_program(
            device=device, dtype=dtype, algo="kmeans", precision=precision,
            kernels=self._serving_bodies(),
            weights=self._serving_weights(precision, device, dtype),
            fetch_dtype=np.int32,
        )

    def compute_cost(self, dataset) -> float:
        """Sum of squared distances to nearest center (Spark computeCost)."""
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        return float(_sqdist(x, self.cluster_centers).min(axis=1).sum())

    computeCost = compute_cost

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_kmeans_model

        save_kmeans_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "KMeansModel":
        from spark_rapids_ml_tpu_torch.io.persistence import load_kmeans_model

        return load_kmeans_model(path)
