"""Data-parallel out-of-core PCA: streamed batches over the ranks.

Counterpart of the JAX package's ``parallel/streaming.py``, for data that is
too many rows for one device (stream it) and spread over several (shard
it). Every rank sees the same stream of host batches, takes its block of
each batch's rows and folds them into its own accumulator with
``ops.streaming.update_stats``: local compute only, no collective per batch
(the reference shipped one n×n partial per partition to the driver,
``RapidsRowMatrix.scala:168-202``). Each rank keeps one (n, n) accumulator
on its device, where the JAX package keeps a (devices, n, n) array sharded
over the mesh. ``finalize`` runs ONE collective, an all-reduce of the
packed (Gram, column sum, count), then covariance → eigensolve on every
rank.

On the card each batch's float32 Gram launches the hand kernel once per
rank (``ops.covariance.centered_gram``).

``distributed_streaming_pca_fit`` is instrumented as the JAX one is: a
fit report with the phases ``stream`` and ``finalize``, the finalize
all-reduce's payload, and fit-monitor steps (``obs.fitmon``): one
``stream_fold`` per batch, whose FLOPs are its Gram's, and one
``finalize``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from spark_rapids_ml_tpu_torch.obs.fitmon import current_run
from spark_rapids_ml_tpu_torch.obs.report import (
    current_fit,
    fit_instrumentation,
)
from spark_rapids_ml_tpu_torch.ops.covariance import covariance_from_stats
from spark_rapids_ml_tpu_torch.ops.eigh import pca_from_covariance
from spark_rapids_ml_tpu_torch.ops.pca_kernel import PCAFitResult
from spark_rapids_ml_tpu_torch.ops.streaming import (
    GramStats,
    init_stats,
    update_stats,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_size,
    collective_nbytes,
    mesh_device,
    pack_count,
    unpack_count,
)


def update_stats_sharded(stats: GramStats, batch, mask, *, mesh) -> GramStats:
    """Fold this rank's block of a host batch's rows (rank d of D takes the
    d-th of D equal blocks) into its accumulator, in place. Local compute
    only; the batch's rows must divide by D."""
    per = batch.shape[0] // axis_size(mesh, DATA_AXIS)
    d = mesh.get_local_rank(DATA_AXIS)
    rows = slice(d * per, (d + 1) * per)
    return update_stats(stats, batch[rows],
                        None if mask is None else mask[rows])


def finalize_stats_sharded(
    stats: GramStats, k: int, *, mesh, mean_centering: bool = True,
    flip_signs: bool = True, solver: str = "eigh",
) -> PCAFitResult:
    """One all-reduce of the packed statistics over the ``data`` group, then
    the covariance → eigensolve chain of every other fit, on every rank.
    ``stats`` is left as it was."""
    n = stats.col_sum.shape[0]
    dtype = stats.gram.dtype
    packed = torch.cat([stats.gram.reshape(-1), stats.col_sum,
                        pack_count(stats.count, dtype)])
    dist.all_reduce(packed, group=mesh.get_group(DATA_AXIS))
    g = packed[:n * n].view(n, n)
    s = packed[n * n:n * n + n]
    cnt = unpack_count(packed[n * n + n:])
    cov = covariance_from_stats(g, s, cnt, mean_centering=mean_centering)
    mean = s / cnt if mean_centering else torch.zeros_like(s)
    components, evr = pca_from_covariance(
        cov, k, flip_signs=flip_signs, solver=solver)
    return PCAFitResult(components, evr, mean)


class DistributedStreamingPCA:
    """``DistributedStreamingPCA(n, mesh).partial_fit(b)....finalize(k)``:
    bounded device memory per rank and data-parallel scale-out in one
    accumulator. Every rank makes the same calls with the same batches."""

    def __init__(self, n_features: int, mesh, dtype=torch.float32):
        self._mesh = mesh
        self._stats = init_stats(n_features, dtype=dtype,
                                 device=mesh_device(mesh))
        self._rows = 0

    def partial_fit(self, batch, mask=None) -> "DistributedStreamingPCA":
        batch = np.asarray(batch)
        d = axis_size(self._mesh, DATA_AXIS)
        if batch.shape[0] % d:
            raise ValueError(
                f"batch rows {batch.shape[0]} must divide evenly over the "
                f"{d}-device mesh (pad + mask the tail)"
            )
        self._stats = update_stats_sharded(self._stats, batch, mask,
                                           mesh=self._mesh)
        self._rows += (batch.shape[0] if mask is None
                       else int(np.count_nonzero(mask)))
        return self

    @property
    def rows_seen(self) -> int:
        """Valid rows over every rank, counted on the host from the batches
        each rank saw whole (no collective)."""
        return self._rows

    def finalize(
        self, k: int, mean_centering: bool = True, solver: str = "eigh"
    ) -> PCAFitResult:
        # the ONE collective of the streamed fit: the packed (Gram, column
        # sum, count) all-reduce
        n = self._stats.col_sum.shape[0]
        current_fit().record_collective(
            "all_reduce",
            nbytes=collective_nbytes((n * n + n + 2,), self._stats.gram.dtype))
        return finalize_stats_sharded(
            self._stats, k, mesh=self._mesh, mean_centering=mean_centering,
            solver=solver)


@fit_instrumentation("distributed_streaming_pca")
def distributed_streaming_pca_fit(
    source,
    k: int,
    mesh,
    mean_centering: bool = True,
    dtype=torch.float32,
    solver: str = "eigh",
) -> PCAFitResult:
    """Out-of-core fit of a ``data.batches.BatchSource`` over the ranks. The
    source's fixed batch shape must divide by the ``data`` axis, so every
    rank folds the same number of rows per batch."""
    d = axis_size(mesh, DATA_AXIS)
    if source.batch_rows % d:
        raise ValueError(
            f"source batch_rows {source.batch_rows} must be a multiple of "
            f"the mesh size {d}"
        )
    ctx = current_fit()
    acc = DistributedStreamingPCA(source.n_features, mesh, dtype=dtype)
    n_batches = 0
    with ctx.phase("stream"):
        for batch, mask in source.batches():
            # each fold's step ends in a device sync (obs.fitmon), so it
            # times the placement and the Gram, not the launch alone
            with current_run().step(
                "stream_fold", rows=batch.shape[0]
            ) as mon:
                acc.partial_fit(batch, mask)
                mon.note(fold=float(n_batches))
            n_batches += 1
    ctx.set_data(rows=acc.rows_seen, features=source.n_features)
    ctx.note(batches_streamed=n_batches)
    if mean_centering and acc.rows_seen < 2:
        raise ValueError("mean centering requires more than one row")
    with ctx.phase("finalize"), current_run().step(
        "finalize", rows=acc.rows_seen
    ):
        return acc.finalize(k, mean_centering=mean_centering, solver=solver)
