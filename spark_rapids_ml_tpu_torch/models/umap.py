"""UMAP Estimator / Model (nonlinear dimensionality reduction), on PyTorch.

Counterpart of the JAX package's ``models/umap.py``, with the same params,
defaults and validators: ``UMAP().setNNeighbors(15).setNComponents(2)
.fit(df)`` learns an embedding of the fitted data; ``model.embedding_``
exposes it, ``model.transform(new_df)`` places NEW rows by
membership-weighted averaging over their nearest fitted points'
coordinates (the standard out-of-sample rule), with no further
optimization.

The construction is ``ops/umap_kernel.py``: the exact-kNN fuzzy graph,
the spectral init and the dense-force optimizer up to ``_DENSE_MAX_ROWS``
rows; past it, or wherever ``blockRows`` > 0, the tiled fit (query-chunked
kNN, the host sparse fuzzy union, the PCA init and the row-block streamed
optimizer, no n×n array anywhere). Embeddings match UMAP's objective and
structure, not umap-learn's per-coordinate output; the tests check
trustworthiness and cluster separation, and hold the operations to the
JAX package's. ``dtype='auto'`` is float32 here. Eager PyTorch needs no
padding, so neither the tiled fit's query chunks nor the transform's are
padded to one shape as the JAX package's are; each row's answer is the
same. The JAX package's model has no writer, so this one has none either.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.models.params import (
    HasDeviceId,
    HasInputCol,
    Param,
)
from spark_rapids_ml_tpu_torch.models.pca import _resolve_dtype
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import observed_transform
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

# query rows per chunk of the transform when blockRows is 0, and of the
# tiled fit's kNN when blockRows is 0 past the dense envelope
AUTO_BLOCK_ROWS = 4096


class UMAPParams(HasInputCol, HasDeviceId):
    nNeighbors = Param(
        "nNeighbors",
        "kNN graph width (local vs global structure trade-off)",
        15,
        validator=lambda v: isinstance(v, int) and v >= 2,
    )
    nComponents = Param(
        "nComponents",
        "embedding dimension",
        2,
        validator=lambda v: isinstance(v, int) and v >= 1,
    )
    minDist = Param(
        "minDist",
        "minimum embedding distance between close points",
        0.1,
        validator=lambda v: 0.0 <= float(v) < 3.0,
    )
    nEpochs = Param(
        "nEpochs",
        "dense-force optimization epochs",
        200,
        validator=lambda v: isinstance(v, int) and v >= 1,
    )
    learningRate = Param(
        "learningRate", "initial step size", 1.0,
        validator=lambda v: float(v) > 0,
    )
    repulsionStrength = Param(
        "repulsionStrength",
        "gamma weighting of the repulsive force",
        1.0,
        validator=lambda v: float(v) >= 0,
    )
    outputCol = Param("outputCol", "embedding output column", "embedding")
    dtype = Param(
        "dtype", "device compute dtype", "auto",
        validator=lambda v: v in ("auto", "float32", "float64"),
    )
    blockRows = Param(
        "blockRows",
        "rows per tiled force/kNN block. 0 = auto: the dense one-matmul "
        "optimizer (n×n forces in HBM, spectral init) up to 16384 rows, "
        "a tiled variant beyond — sparse-edge attraction + row-block "
        "streamed repulsion + PCA init, memory block×n instead of n×n, "
        "taking n to the hundreds of thousands. Explicit values force "
        "the tiled path.",
        0,
        validator=lambda v: isinstance(v, int) and v >= 0,
    )


def _sync(t: torch.Tensor) -> None:
    """End a timed phase on its device work (``utils/timing.py``)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def knn_without_self(queries: torch.Tensor, items: torch.Tensor,
                     k: int):
    """Each query's k nearest items after the first: the k + 1 search with
    column 0 dropped. A fitted row finds itself at distance 0; where a
    duplicate row ties with it, ``knn_kernel``'s order (``lax.top_k``'s:
    the lower index first) drops the column the JAX package drops."""
    from spark_rapids_ml_tpu_torch.ops.knn_kernel import knn_kernel

    dists, idx = knn_kernel(queries, items, k + 1)
    return dists[:, 1:], idx[:, 1:]


class UMAP(UMAPParams):
    """``UMAP().setNNeighbors(15).fit(df)`` → UMAPModel."""

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "UMAP":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(UMAP, path)

    @observed_fit("umap")
    def fit(self, dataset) -> "UMAPModel":
        from spark_rapids_ml_tpu_torch.ops.umap_kernel import (
            fit_ab,
            fuzzy_graph,
            optimize_embedding,
            spectral_init,
        )

        timer = PhaseTimer()
        frame = as_vector_frame(dataset, self.getInputCol())
        with timer.phase("densify"):
            x = frame.vectors_as_matrix(self.getInputCol())
        n = x.shape[0]
        k = self.getNNeighbors()
        if n <= k:
            raise ValueError(
                f"nNeighbors = {k} must be below the row count {n}"
            )
        device = resolve_device(self.getDeviceId())
        dtype = _resolve_dtype(self.getDtype())
        a, b = fit_ab(float(self.getMinDist()))

        block = self.getBlockRows()
        use_blocked = block > 0 or n > self._DENSE_MAX_ROWS
        x_dev = torch.as_tensor(x, dtype=dtype, device=device)
        # dense all-pairs repulsion stands in for UMAP's per-edge negative
        # sampling (n_neg=5): scale gamma so total repulsive mass matches
        # the sampled variant's ~(edges·n_neg) instead of n²
        gamma = float(self.getRepulsionStrength()) * (5.0 * 2.0 * k / n)
        if use_blocked:
            emb = self._fit_blocked(
                x_dev, n, k, a, b, gamma, min(block or AUTO_BLOCK_ROWS, n),
                timer,
            )
        else:
            with timer.phase("knn"), TraceRange("umap knn",
                                                TraceColor.GREEN):
                dists, idx = knn_without_self(x_dev, x_dev, k)
                _sync(dists)
            with timer.phase("graph"), TraceRange("umap graph",
                                                  TraceColor.RED):
                p = fuzzy_graph(dists, idx, n)
                _sync(p)
            with timer.phase("init"):
                emb0 = spectral_init(p, self.getNComponents())
                _sync(emb0)
            with timer.phase("optimize"), TraceRange("umap opt",
                                                     TraceColor.BLUE):
                emb = optimize_embedding(
                    p, emb0, a, b, float(self.getLearningRate()), gamma,
                    self.getNEpochs(),
                )
                emb = emb.cpu().numpy().astype(np.float64)
        if not np.isfinite(emb).all():
            raise FloatingPointError("UMAP optimization diverged")
        model = UMAPModel(
            embedding=emb,
            train_items=np.asarray(x, dtype=np.float64),
            ab=(a, b),
        )
        model.uid = self.uid
        model.copy_values_from(self)
        model.fit_timings_ = timer.as_dict()
        return model

    _DENSE_MAX_ROWS = 16384

    def _fit_blocked(self, x_dev, n, k, a, b, gamma, block, timer):
        """Large-n fit: tiled kNN-graph build (query chunks × all items),
        host sparse fuzzy union, PCA init, and the row-block streamed
        force optimizer — no n×n array anywhere."""
        from spark_rapids_ml_tpu_torch.ops.umap_kernel import (
            memberships,
            optimize_embedding_blocked,
            pca_init,
            symmetric_edge_list,
        )

        with timer.phase("knn"), TraceRange("umap knn", TraceColor.GREEN):
            parts = [knn_without_self(x_dev[s:s + block], x_dev, k)
                     for s in range(0, n, block)]
            dists = torch.cat([d for d, _ in parts])
            idx = torch.cat([i for _, i in parts]).cpu().numpy()
            del parts
        with timer.phase("graph"), TraceRange("umap graph", TraceColor.RED):
            mu = memberships(dists).cpu().numpy()
            e_i, e_j, e_p = symmetric_edge_list(mu, idx, n)
        with timer.phase("init"):
            emb0 = pca_init(x_dev, self.getNComponents())
            _sync(emb0)
        with timer.phase("optimize"), TraceRange("umap opt",
                                                 TraceColor.BLUE):
            emb = optimize_embedding_blocked(
                e_i, e_j,
                torch.as_tensor(e_p, dtype=x_dev.dtype, device=x_dev.device),
                emb0, None, a, b, float(self.getLearningRate()), gamma,
                self.getNEpochs(), block,
            )
            emb = emb.cpu().numpy().astype(np.float64)
        return emb


class UMAPModel(UMAPParams):
    def __init__(
        self,
        embedding: Optional[np.ndarray] = None,
        train_items: Optional[np.ndarray] = None,
        ab=None,
    ):
        super().__init__()
        self.embedding_ = embedding
        self.train_items_ = train_items
        self.ab_ = ab

    def _copy_internal_state(self, other: "UMAPModel") -> None:
        other.embedding_ = self.embedding_
        other.train_items_ = self.train_items_
        other.ab_ = self.ab_

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        """Out-of-sample placement: each new row lands at the
        membership-weighted average of its nNeighbors nearest FITTED
        points' embedding coordinates. A fitted row queried back lands
        NEAR (not exactly at) its own embedding: itself gets the largest
        membership weight, but its neighbors' weights also contribute —
        the standard smoothing of this out-of-sample rule."""
        if self.embedding_ is None:
            raise ValueError("model has no embedding; fit first")
        frame = as_vector_frame(dataset, self.getInputCol())
        q = frame.vectors_as_matrix(self.getInputCol())
        if q.shape[1] != self.train_items_.shape[1]:
            raise ValueError(
                f"query dim {q.shape[1]} != fitted dim "
                f"{self.train_items_.shape[1]}"
            )
        placed = place(q, self.train_items_, self.embedding_,
                       min(self.getNNeighbors(), self.train_items_.shape[0]),
                       int(self.getBlockRows() or AUTO_BLOCK_ROWS),
                       resolve_device(self.getDeviceId()),
                       _resolve_dtype(self.getDtype()))
        return frame.with_column(self.getOutputCol(), placed.tolist())


def place(q: np.ndarray, items: np.ndarray, embedding: np.ndarray, k: int,
          chunk: int, device, dtype) -> np.ndarray:
    """The out-of-sample rule over query chunks of ``chunk`` rows (device
    memory bounded at chunk × n_items): the k nearest fitted items, the
    fit's calibration, normalized memberships, and the weighted average of
    the items' coordinates. The average is an elementwise product and sum
    over the k neighbors, where the JAX package's is an ``einsum``: no
    TF32 setting reaches it."""
    from spark_rapids_ml_tpu_torch.ops.knn_kernel import knn_kernel
    from spark_rapids_ml_tpu_torch.ops.umap_kernel import memberships

    items = torch.as_tensor(items, dtype=dtype, device=device)
    emb = torch.as_tensor(embedding, dtype=dtype, device=device)
    placed = np.empty((q.shape[0], emb.shape[1]), dtype=np.float64)
    for s in range(0, q.shape[0], chunk):
        part = torch.as_tensor(q[s:s + chunk], dtype=dtype, device=device)
        dists, idx = knn_kernel(part, items, k)
        w = memberships(dists)
        w = w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1e-12)
        out = (w[:, :, None] * emb[idx]).sum(dim=1)
        placed[s:s + part.shape[0]] = out.cpu().numpy()
    return placed
