"""NearestNeighbors Estimator / Model: brute-force, IVF-Flat and IVF-PQ
k-nearest-neighbour search, on PyTorch.

Counterpart of the JAX package's ``models/nearest_neighbors.py``, with the
same params, defaults and validators, so saved metadata stays compatible:
``NearestNeighbors().setK(k).fit(items)`` keeps the item matrix, and
``model.kneighbors(queries)`` returns (distances, indices), each
(n_queries, k), distances ascending, euclidean.

Routes (``useXlaDot`` keeps the JAX package's param name):

* brute (exact): the items stay on the device and the queries stream
  through in chunks (``_stream_queries``); a chunk's float64 distance
  block is held to ``ops.knn_kernel.DIST_BLOCK_BYTES``, so at a million
  items a chunk is a few hundred queries (the JAX package pads every chunk
  to 1024);
* ivfflat: a k-means coarse quantizer (the port's ``ops/kmeans_kernel``,
  k-means++ seeded 0, Lloyd at max_iter 20, tol 1e-4), items laid out in
  padded per-list buckets on the device; a query searches its ``nprobe``
  nearest lists;
* ivfpq: the same quantizer, one k-means codebook per residual subspace
  (seeded m + 1, max_iter 15), uint8 codes laid out subspace-major
  (M, nlist, max_size) on the device, an ADC scan, and by default an exact
  re-rank of the top ceil(k·refineRatio) candidates;
* host (``useXlaDot=False``): numpy float64, the JAX package's
  ``_host_kneighbors``, never a device.

The indexes are built on the device from the item matrix and cached on the
JAX package's keys; seeding draws from a ``torch.Generator``, so the lists
and codebooks differ from the JAX package's on the same items (parity of
the searches holds on shared index arrays). ``dtype='auto'`` is float32
here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame
from spark_rapids_ml_tpu_torch.models.params import (
    HasDeviceId,
    HasInputCol,
    Param,
)
from spark_rapids_ml_tpu_torch.models.pca import _resolve_dtype
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.ops import kmeans_kernel as _kk
from spark_rapids_ml_tpu_torch.ops import knn_kernel as _knn
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

_QUERY_BUCKET = 1024  # the largest query chunk (the JAX package's bucket)


class NearestNeighborsParams(HasInputCol, HasDeviceId):
    k = Param(
        "k",
        "number of neighbors to return",
        5,
        validator=lambda v: isinstance(v, int) and v >= 1,
    )
    algorithm = Param(
        "algorithm",
        "brute (exact), ivfflat (approximate: k-means coarse quantizer, "
        "search the nprobe nearest buckets only), or ivfpq (ivfflat "
        "plus product-quantized residuals scanned via ADC tables) — "
        "the reference project's NearestNeighbors algorithm options",
        "brute",
        validator=lambda v: v in ("brute", "ivfflat", "ivfpq"),
    )
    nlist = Param(
        "nlist",
        "ivfflat: number of coarse-quantizer buckets (0 = sqrt(n_items))",
        0,
        validator=lambda v: isinstance(v, int) and v >= 0,
    )
    nprobe = Param(
        "nprobe",
        "ivfflat/ivfpq: buckets searched per query (== nlist recovers "
        "exact for ivfflat; ivfpq stays approximate — quantization error)",
        8,
        validator=lambda v: isinstance(v, int) and v >= 1,
    )
    pqM = Param(
        "pqM",
        "ivfpq: number of subquantizers (must divide the feature dim; "
        "0 = auto: the largest divisor whose subspace width dsub lands "
        "in [4, 8] — i.e. dsub=4 when dim allows, the recall-per-code "
        "sweet spot, and 2-4x wider subspaces than the old dsub=2 rule "
        "— falling back to narrower widths only when dim forces it)",
        0,
        validator=lambda v: isinstance(v, int) and v >= 0,
    )
    pqBits = Param(
        "pqBits",
        "ivfpq: bits per subquantizer code (codebook size 2^bits)",
        8,
        validator=lambda v: isinstance(v, int) and 2 <= v <= 8,
    )
    refineRatio = Param(
        "refineRatio",
        "ivfpq: exact-distance re-rank of the top ceil(k*refineRatio) ADC "
        "candidates (IndexRefineFlat pattern). Costs keeping the raw item "
        "rows resident in device memory alongside the codes; 0 disables "
        "for a compressed-codes-only memory footprint",
        2.0,
        validator=lambda v: v == 0 or v >= 1.0,
    )
    useXlaDot = Param(
        "useXlaDot",
        "pairwise distances on the device (True) or host NumPy (False)",
        True,
        validator=lambda v: isinstance(v, bool),
    )
    dtype = Param(
        "dtype",
        "device compute dtype: 'float32', 'float64', or 'auto' (float32)",
        "auto",
        validator=lambda v: v in ("auto", "float32", "float64"),
    )


class NearestNeighbors(NearestNeighborsParams):
    """``NearestNeighbors().setK(8).fit(items)`` → NearestNeighborsModel."""

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "NearestNeighbors":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(NearestNeighbors, path)

    @observed_fit("nearest_neighbors")
    def fit(self, dataset) -> "NearestNeighborsModel":
        timer = PhaseTimer()
        frame = as_vector_frame(dataset, self.getInputCol())
        with timer.phase("densify"):
            items = frame.vectors_as_matrix(self.getInputCol())
        if items.shape[0] < 1:
            raise ValueError("fit requires at least one item row")
        if self.getK() > items.shape[0]:
            raise ValueError(
                f"k = {self.getK()} must be at most the number of fitted "
                f"items {items.shape[0]}"
            )
        model = NearestNeighborsModel(
            items=np.asarray(items, dtype=np.float64))
        model.uid = self.uid
        model.copy_values_from(self)
        model.fit_timings_ = timer.as_dict()
        return model


class NearestNeighborsModel(NearestNeighborsParams):
    def __init__(self, items: Optional[np.ndarray] = None):
        super().__init__()
        self.items = items
        # device-resident item matrix, keyed on (device, dtype)
        self._device_items = None
        # IVF index, keyed on (device, dtype, nlist)
        self._ivf_index_cache = None
        # IVF-PQ index, keyed on (device, dtype, nlist, pqM, ksub)
        self._ivfpq_index_cache = None
        # the coarse quantizer both IVF indexes share, keyed on
        # (device, dtype, nlist)
        self._coarse_cache = None

    def _copy_internal_state(self, other: "NearestNeighborsModel") -> None:
        other.items = self.items

    def kneighbors(
        self, dataset, k: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(distances, indices), each (n_queries, k), distances ascending."""
        if self.items is None:
            raise ValueError("model has no fitted items")
        k = self.getK() if k is None else k
        if not (1 <= k <= self.items.shape[0]):
            raise ValueError(
                f"k = {k} must be in [1, {self.items.shape[0]}]"
            )
        frame = as_vector_frame(dataset, self.getInputCol())
        queries = frame.vectors_as_matrix(self.getInputCol())
        if queries.shape[1] != self.items.shape[1]:
            raise ValueError(
                f"query dim {queries.shape[1]} != fitted item dim "
                f"{self.items.shape[1]}"
            )
        if self.getUseXlaDot():
            algorithm = self.getAlgorithm()
            if algorithm == "ivfflat":
                return self._kneighbors_ivf(queries, k)
            if algorithm == "ivfpq":
                return self._kneighbors_ivfpq(queries, k)
            return self._kneighbors_brute(queries, k)
        return _host_kneighbors(queries, self.items, k)

    def _device_and_dtype(self):
        return (resolve_device(self.getDeviceId()),
                _resolve_dtype(self.getDtype()))

    # -- IVF approximate paths (shared coarse quantizer) -------------------
    def _resolve_nlist(self) -> int:
        n = self.items.shape[0]
        nlist = self.getNlist() or max(1, int(np.sqrt(n)))
        return min(nlist, n)

    def _coarse_quantizer(self, device, dtype, nlist):
        """k-means coarse quantizer: (device centroids, host assignment).

        Cached on (device, dtype, nlist): the whole-corpus k-means is the
        index build's largest cost, shared by the ivfflat and ivfpq
        builders."""
        cache_key = (device, dtype, nlist)
        if self._coarse_cache and self._coarse_cache[0] == cache_key:
            return self._coarse_cache[1]
        items = self._items_on_device(device, dtype)
        init = _kk.kmeans_plus_plus_init(items, nlist, seed=0)
        km = _kk.kmeans_fit_kernel(items, init, max_iter=20, tol=1e-4)
        assign = _kk.assign_clusters(items, km.centers).cpu().numpy()
        self._coarse_cache = (cache_key, (km.centers, assign))
        return km.centers, assign

    def _ivf_pool_check_and_step(self, algorithm: str, k: int, nprobe: int,
                                 max_size: int) -> int:
        """Shared candidate-pool guard + query-chunk sizing for the IVF
        modes; the candidate gather is (chunk, nprobe·max_size, …)."""
        if k > nprobe * max_size:
            raise ValueError(
                f"k = {k} exceeds the {algorithm} candidate pool "
                f"(nprobe {nprobe} x largest bucket {max_size}); raise "
                f"nprobe (or nlist) or use algorithm='brute'"
            )
        return max(1, _QUERY_BUCKET // max(1, nprobe // 4))

    @staticmethod
    def _bucket_layout(assign: np.ndarray, nlist: int):
        """Vectorized bucket fill plan: stable-sort rows by bucket, each
        row's slot is its rank within the bucket. Returns (order,
        sorted_assign, slots, max_size)."""
        n = assign.shape[0]
        order = np.argsort(assign, kind="stable")
        sorted_assign = assign[order]
        counts = np.bincount(assign, minlength=nlist)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slots = np.arange(n, dtype=np.int64) - starts[sorted_assign]
        return order, sorted_assign, slots, int(counts.max())

    @staticmethod
    def _layout_on_device(assign, nlist, device):
        """``_bucket_layout`` with its index arrays on ``device``: (order,
        sorted_assign, slots) as int64 tensors, and max_size."""
        order, sorted_assign, slots, max_size = (
            NearestNeighborsModel._bucket_layout(assign, nlist))
        return (tuple(torch.as_tensor(a, dtype=torch.int64, device=device)
                      for a in (order, sorted_assign, slots)), max_size)

    @staticmethod
    def _ids_and_mask(order, sorted_assign, slots, nlist, max_size, dtype,
                      device):
        bucket_ids = torch.zeros((nlist, max_size), dtype=torch.int32,
                                 device=device)
        bucket_mask = torch.zeros((nlist, max_size), dtype=dtype,
                                  device=device)
        bucket_ids[sorted_assign, slots] = order.to(torch.int32)
        bucket_mask[sorted_assign, slots] = 1.0
        return bucket_ids, bucket_mask

    def _ivf_index(self, device, dtype):
        """Build (and cache) the IVF-Flat index on the device: k-means
        centroids and the padded per-bucket items / ids / mask."""
        nlist = self._resolve_nlist()
        cache_key = (device, dtype, nlist)
        if self._ivf_index_cache and self._ivf_index_cache[0] == cache_key:
            return self._ivf_index_cache[1]
        centroids, assign = self._coarse_quantizer(device, dtype, nlist)
        (order, sorted_assign, slots), max_size = self._layout_on_device(
            assign, nlist, device)
        items = self._items_on_device(device, dtype)
        bucket_items = torch.zeros((nlist, max_size, items.shape[1]),
                                   dtype=dtype, device=device)
        bucket_items[sorted_assign, slots] = items[order]
        bucket_ids, bucket_mask = self._ids_and_mask(
            order, sorted_assign, slots, nlist, max_size, dtype, device)
        index = (centroids, bucket_items, bucket_ids, bucket_mask, nlist)
        self._ivf_index_cache = (cache_key, index)
        return index

    def _resolve_pq_m(self, dim: int) -> int:
        m_sub = self.getPqM()
        if m_sub == 0:
            # auto: the largest divisor with dsub in [4, 8], at least 2
            # subquantizers when dim allows; a narrower dsub only when dim
            # has no such divisor
            for cand in range(dim, 1, -1):
                if dim % cand == 0 and 4 <= dim // cand <= 8:
                    return cand
            for cand in range(max(1, dim // 2), 0, -1):
                if dim % cand == 0:
                    return cand
        if dim % m_sub != 0:
            raise ValueError(
                f"pqM = {m_sub} must divide the feature dimension {dim}"
            )
        return m_sub

    def _ivfpq_index(self, device, dtype):
        """Build (and cache) the IVF-PQ index on the device: the coarse
        quantizer, one k-means codebook per residual subspace and the
        per-bucket uint8 codes, laid out (M, nlist, max_size). The
        residuals are taken in float64, as the JAX package takes them on
        the host, and each subspace is cast to ``dtype`` for its k-means."""
        n, dim = self.items.shape
        nlist = self._resolve_nlist()
        m_sub = self._resolve_pq_m(dim)
        ksub = min(2 ** self.getPqBits(), n)
        cache_key = (device, dtype, nlist, m_sub, ksub)
        if (self._ivfpq_index_cache
                and self._ivfpq_index_cache[0] == cache_key):
            return self._ivfpq_index_cache[1]
        centroids, assign = self._coarse_quantizer(device, dtype, nlist)
        assign_dev = torch.as_tensor(assign, dtype=torch.int64, device=device)
        residuals = (torch.as_tensor(self.items, dtype=torch.float64,
                                     device=device)
                     - centroids.to(torch.float64)[assign_dev])
        del assign_dev
        dsub = dim // m_sub
        codebooks = torch.zeros((m_sub, ksub, dsub), dtype=torch.float64,
                                device=device)
        # uint8: pqBits is validated <= 8, so ksub <= 256 always; the codes
        # are the device-resident payload, n·M bytes
        codes = torch.zeros((n, m_sub), dtype=torch.uint8, device=device)
        for m in range(m_sub):
            sub = residuals[:, m * dsub:(m + 1) * dsub].to(dtype).contiguous()
            init = _kk.kmeans_plus_plus_init(sub, ksub, seed=m + 1)
            km = _kk.kmeans_fit_kernel(sub, init, max_iter=15, tol=1e-4)
            codebooks[m] = km.centers.to(torch.float64)
            codes[:, m] = _kk.assign_clusters(sub, km.centers).to(torch.uint8)
            del sub
        del residuals
        (order, sorted_assign, slots), max_size = self._layout_on_device(
            assign, nlist, device)
        bucket_codes = torch.zeros((m_sub, nlist, max_size),
                                   dtype=torch.uint8, device=device)
        bucket_codes[:, sorted_assign, slots] = codes[order].T
        del codes
        bucket_ids, bucket_mask = self._ids_and_mask(
            order, sorted_assign, slots, nlist, max_size, dtype, device)
        index = (centroids, codebooks.to(dtype), bucket_codes, bucket_ids,
                 bucket_mask, nlist)
        self._ivfpq_index_cache = (cache_key, index)
        return index

    def _kneighbors_ivf(self, queries, k):
        device, dtype = self._device_and_dtype()
        centroids, b_items, b_ids, b_mask, nlist = self._ivf_index(
            device, dtype
        )
        nprobe = min(self.getNprobe(), nlist)
        step = self._ivf_pool_check_and_step(
            "ivfflat", k, nprobe, int(b_items.shape[1])
        )

        def kernel(q):
            d2, ids = _knn.ivf_search(q, centroids, b_items, b_ids, b_mask,
                                      k, nprobe)
            return torch.sqrt(torch.clamp_min(d2, 0.0)), ids

        with TraceRange("knn ivf", TraceColor.GREEN):
            return self._stream_queries(queries, k, step, device, dtype,
                                        kernel)

    def _kneighbors_ivfpq(self, queries, k):
        device, dtype = self._device_and_dtype()
        (centroids, codebooks, b_codes, b_ids, b_mask,
         nlist) = self._ivfpq_index(device, dtype)
        nprobe = min(self.getNprobe(), nlist)
        step = self._ivf_pool_check_and_step(
            "ivfpq", k, nprobe, int(b_ids.shape[1])
        )
        refine = float(self.getRefineRatio())
        pool = nprobe * int(b_ids.shape[1])
        n_cand = (
            k if refine == 0
            else min(pool, max(k, int(np.ceil(k * refine))))
        )
        items_dev = self._items_on_device(device, dtype) if refine else None

        def kernel(q):
            d2, ids = _knn.ivfpq_search(q, centroids, codebooks, b_codes,
                                        b_ids, b_mask, n_cand, nprobe)
            if refine:
                d2, ids = _knn.exact_rerank(q, items_dev, ids, k)
            return torch.sqrt(torch.clamp_min(d2, 0.0)), ids

        with TraceRange("knn ivfpq", TraceColor.GREEN):
            return self._stream_queries(queries, k, step, device, dtype,
                                        kernel)

    # -- device paths ------------------------------------------------------
    def _stream_queries(self, queries, k, step, device, dtype, kernel_fn):
        """The one stream/copy-back loop every device path shares: query
        chunks of ``step`` rows, results copied into host arrays.
        ``kernel_fn(q_dev) -> (dist, idx)``. A chunk is not padded: the
        distances do not depend on the chunk (``ops/knn_kernel``)."""
        n_q = queries.shape[0]
        out_d = np.empty((n_q, k), dtype=np.float64)
        out_i = np.empty((n_q, k), dtype=np.int64)
        for start in range(0, n_q, step):
            q_dev = torch.as_tensor(queries[start:start + step], dtype=dtype,
                                    device=device)
            d, i = kernel_fn(q_dev)
            out_d[start:start + q_dev.shape[0]] = d.cpu().numpy()
            out_i[start:start + q_dev.shape[0]] = i.cpu().numpy()
        return out_d, out_i

    def _items_on_device(self, device, dtype):
        """Raw item rows on the device, cached per (device, dtype): shared
        by the brute-force path, the coarse quantizer and the ivfpq
        re-rank."""
        cache_key = (device, dtype)
        if self._device_items is None or self._device_items[0] != cache_key:
            self._device_items = None  # release the old copy first
            items = torch.as_tensor(self.items, dtype=dtype, device=device)
            self._device_items = (cache_key, items)
        return self._device_items[1]

    def _kneighbors_brute(self, queries, k):
        """Exact search (the JAX package's ``_kneighbors_xla``)."""
        device, dtype = self._device_and_dtype()
        items = self._items_on_device(device, dtype)
        step = _knn.query_step(items.shape[0], _QUERY_BUCKET)
        with TraceRange("knn kneighbors", TraceColor.GREEN):
            return self._stream_queries(
                queries, k, step, device, dtype,
                lambda q: _knn.knn_kernel(q, items, k),
            )

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_knn_model

        save_knn_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "NearestNeighborsModel":
        from spark_rapids_ml_tpu_torch.io.persistence import load_knn_model

        return load_knn_model(path)


def _host_kneighbors(queries, items, k):
    """NumPy oracle-identical fallback (same expansion, full argpartition)."""
    q = np.asarray(queries, dtype=np.float64)
    x = np.asarray(items, dtype=np.float64)
    d2 = (
        (q * q).sum(axis=1, keepdims=True)
        - 2.0 * (q @ x.T)
        + (x * x).sum(axis=1)[None, :]
    )
    np.maximum(d2, 0.0, out=d2)
    idx = np.argpartition(d2, k - 1, axis=1)[:, :k]
    part = np.take_along_axis(d2, idx, axis=1)
    order = np.argsort(part, axis=1, kind="stable")
    idx = np.take_along_axis(idx, order, axis=1)
    return np.sqrt(np.take_along_axis(d2, idx, axis=1)), idx
