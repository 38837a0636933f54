"""Data-parallel KMeans: global k-means++ seeding, then Lloyd with each
iteration's statistics all-reduced.

Counterpart of the JAX package's ``parallel/distributed_kmeans.py``, the
same shape as ``distributed_pca``: rows split over the ``data`` group, and
per Lloyd iteration ONE ``all_reduce`` of (k·n sums, k counts, cost),
packed into one buffer, over NCCL (gloo on CPU ranks) — never rows. The
loop is ``ops.kmeans_kernel.lloyd_iterations`` with that reduction as its
``reduce_fn``, so every rank computes the same centres and returns the
same result.

Seeding draws over the WHOLE dataset, not one rank's rows (seeding from
local rows is biased under non-IID sharding: a rank holding one cluster's
points would seed every centre inside it). Exact global categorical
sampling without gathering rows, by the Gumbel-max trick: each rank
perturbs its local log-D² with Gumbel noise from a ``torch.Generator`` of
its own, seeded from (seed, rank), takes its local argmax, and an
``all_reduce`` MAX picks the global winner; then one ``all_reduce`` SUM of
(owner flag, owner-masked row) hands every rank the winning row (a tie
averages, a probability-zero event). Per centre: one MAX of a scalar and
one SUM of n + 1 elements. Draws differ from ``jax.random``'s, so the
parity is statistical (the blobs recovered), not draw for draw.

``distributed_kmeans_fit`` is instrumented as the JAX driver is: a fit
report with the phases ``prepare`` (pad, slice, cast), ``placement`` (the
host → device copy) and ``execute``, the iteration count, the
collectives at their true byte counts, and one fit-monitor step ``lloyd``
noting ``n_iter``, ``cost`` and ``converged``.
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
from spark_rapids_ml_tpu_torch.ops.kmeans_kernel import (
    KMeansResult,
    _gumbel,
    _valid,
    lloyd_iterations,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_size,
    collective_nbytes,
    mesh_device,
    pad_rows_to_multiple,
)


def _global_kmeans_pp(x_shard, mask_shard, seed: int, n_clusters: int,
                      group) -> torch.Tensor:
    """k-means++ seeding with GLOBAL D²-weighted sampling across the
    group's ranks (see the module docstring). Every rank must call it."""
    n = x_shard.shape[1]
    valid = _valid(x_shard, mask_shard)
    rank = dist.get_rank(group)
    gen = torch.Generator(device=x_shard.device).manual_seed(
        int(seed) * 1_000_003 + rank)
    neg_inf = torch.full((), float("-inf"), dtype=x_shard.dtype,
                         device=x_shard.device)
    tiny = torch.full((), 1e-30, dtype=x_shard.dtype, device=x_shard.device)

    def sample_global(logits):
        u = torch.rand(logits.shape, generator=gen, dtype=logits.dtype,
                       device=logits.device)
        g = _gumbel(u) + logits
        local_best = g.max()
        local_row = x_shard.index_select(0, g.argmax().reshape(1))[0]
        best = local_best.clone()
        dist.all_reduce(best, op=dist.ReduceOp.MAX, group=group)
        owner = (local_best >= best).to(x_shard.dtype)
        # (owner flag, owner's row) summed in one collective
        packed = torch.cat([owner.reshape(1), local_row * owner])
        dist.all_reduce(packed, group=group)
        return packed[1:] / torch.clamp_min(packed[0], 1.0)

    centers = torch.zeros((n_clusters, n), dtype=x_shard.dtype,
                          device=x_shard.device)
    first = sample_global(torch.where(valid > 0, torch.zeros_like(valid),
                                      neg_inf))
    centers[0] = first
    min_d = ((x_shard - first[None, :]) ** 2).sum(dim=1) * valid
    for i in range(1, n_clusters):
        logits = torch.where(valid > 0,
                             torch.log(torch.maximum(min_d, tiny)), neg_inf)
        c = sample_global(logits)
        centers[i] = c
        min_d = torch.minimum(min_d,
                              ((x_shard - c[None, :]) ** 2).sum(dim=1) * valid)
    return centers


def _all_reduce_stats(group):
    """``reduce_fn`` for ``lloyd_iterations``: (sums, counts, cost) summed
    over the group in ONE packed ``all_reduce``."""

    def reduce_fn(stats):
        sums, counts, cost = stats
        k, n = sums.shape
        packed = torch.cat([sums.reshape(-1), counts, cost.reshape(1)])
        dist.all_reduce(packed, group=group)
        return (packed[:k * n].view(k, n), packed[k * n:k * n + k],
                packed[k * n + k])

    return reduce_fn


def distributed_kmeans_fit_kernel(
    x,
    mask,
    seed: int = 0,
    *,
    mesh,
    n_clusters: int,
    max_iter: int = 20,
    tol: float = 1e-4,
) -> KMeansResult:
    """The sharded fit on this rank's rows ``x`` (rows, n) and 0/1
    ``mask``, placed on the mesh's device if they are not there. Every rank
    of the mesh's ``data`` group must call it; each returns the same
    replicated result."""
    device = mesh_device(mesh)
    x = torch.as_tensor(x, device=device)
    mask = torch.as_tensor(mask, device=device)
    group = mesh.get_group(DATA_AXIS)
    init_centers = _global_kmeans_pp(x, mask, seed, n_clusters, group)
    return lloyd_iterations(x, init_centers, mask, max_iter, tol,
                            reduce_fn=_all_reduce_stats(group))


@fit_instrumentation("distributed_kmeans")
def distributed_kmeans_fit(
    x_host: np.ndarray,
    n_clusters: int,
    mesh,
    max_iter: int = 20,
    tol: float = 1e-4,
    seed: int = 0,
    dtype=None,
) -> KMeansResult:
    """Host-side driver, called on every rank with the same full X: pad
    the rows to the mesh, take this rank's block (rank d of D takes the
    d-th of D equal blocks, as the JAX row sharding does), place it on the
    rank's device and run the kernel. ``dtype`` (a numpy dtype) casts the
    host rows first."""
    ctx = current_fit()
    x_host = np.asarray(x_host)
    n_dev = axis_size(mesh, DATA_AXIS)
    with ctx.phase("prepare"):
        x_padded, mask = pad_rows_to_multiple(x_host, n_dev)
        per = x_padded.shape[0] // n_dev
        d = mesh.get_local_rank(DATA_AXIS)
        rows = slice(d * per, (d + 1) * per)
        x_local, mask_local = x_padded[rows], mask[rows]
        if dtype is not None:
            x_local = x_local.astype(dtype)
            mask_local = mask_local.astype(dtype)
    with ctx.phase("placement"):
        device = mesh_device(mesh)
        x_dev = torch.as_tensor(x_local, device=device)
        mask_dev = torch.as_tensor(mask_local, dtype=x_dev.dtype,
                                   device=device)
    # The Lloyd loop runs on the host, one all-reduce per iteration; the
    # step covers seeding and the whole loop, with the iteration count and
    # final cost as its convergence notes.
    with ctx.phase("execute"), current_run().step(
        "lloyd", rows=x_host.shape[0]
    ) as step:
        result = distributed_kmeans_fit_kernel(
            x_dev, mask_dev, seed, mesh=mesh, n_clusters=n_clusters,
            max_iter=max_iter, tol=tol)
        n_iter = int(result.n_iter)
        step.note(n_iter=n_iter, cost=float(result.cost),
                  converged=int(result.converged))
    n = x_host.shape[1]
    dt = x_local.dtype
    ctx.set_iterations(n_iter)
    # k-means++ seeding: per centre one MAX (a scalar) and one SUM of the
    # owner flag with the winning row
    ctx.record_collective(
        "all_max", nbytes=collective_nbytes((1,), dt), count=n_clusters)
    ctx.record_collective(
        "all_reduce", nbytes=collective_nbytes((n + 1,), dt),
        count=n_clusters)
    # Lloyd: one packed SUM of (k×n sums, k counts, cost) per iteration,
    # and one more for the final cost under the final centres
    ctx.record_collective(
        "all_reduce",
        nbytes=collective_nbytes((n_clusters * n + n_clusters + 1,), dt),
        count=n_iter + 1)
    return result
