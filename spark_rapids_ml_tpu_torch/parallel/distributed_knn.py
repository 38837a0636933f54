"""Distributed brute-force KNN: items sharded over the ``data`` ranks.

Counterpart of the JAX package's ``parallel/distributed_knn.py``. The item
set is what grows, so items split over the ranks and queries replicate;
the exact global top-k comes from the two-level reduction: each rank's
top-k of its local distance block, one ``all_gather`` of the distances and
one of the global indices of those candidates (k·n_ranks per query), then
``ops.knn_kernel.knn_merge``, replicated. Traffic per query batch is
O(n_q·k·n_ranks), never the O(n_q·n_items) distance matrix.

Items pad to the rank multiple with masked (+inf-distance) rows, as the JAX
package pads its shards; local indices are offset by rank ·
rows_per_shard, so the merged indices address the original item matrix.
The collectives are recorded at their true byte counts: with k_local =
min(k, rows_per_shard), which is JAX's k except on shards smaller than k.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.obs.report import (
    current_fit,
    fit_instrumentation,
)
from spark_rapids_ml_tpu_torch.ops.knn_kernel import (
    _smallest_k,
    knn_merge,
    pairwise_sqdist,
    query_step,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    all_gather_rows,
    axis_size,
    collective_nbytes,
    mesh_device,
    pad_rows_to_multiple,
)


def gather_candidates(t: torch.Tensor, group) -> torch.Tensor:
    """(n_q, c) per rank → (n_q, n_ranks·c), rank-major along the candidate
    axis (the JAX package's tiled ``all_gather`` on axis 1)."""
    n_q, c = t.shape
    rows = all_gather_rows(t.contiguous(), group)
    return rows.view(-1, n_q, c).permute(1, 0, 2).reshape(n_q, -1)


def _sharded_knn(q, x_shard, mask_shard, k: int, offset: int, group):
    """This rank's candidates, gathered and merged: the replicated global
    (squared distances, int64 indices). The local search runs in query
    chunks (``query_step``), so one chunk's distance block stays bounded;
    the candidates of every chunk travel in the two gathers."""
    # a shard contributes at most its own row count; when rows < k its
    # whole item set becomes candidates, and n_ranks·k_local ≥ k
    k_local = min(k, x_shard.shape[0])
    parts = [_smallest_k(pairwise_sqdist(qc, x_shard, mask_shard), k_local)
             for qc in q.split(query_step(x_shard.shape[0]))]
    vals = torch.cat([v for v, _ in parts])
    gidx = (torch.cat([i for _, i in parts]) + offset).to(torch.int32)
    all_d = gather_candidates(vals, group)
    all_i = gather_candidates(gidx, group)
    return knn_merge(all_d, all_i.long(), k)


@fit_instrumentation("distributed_knn")
def distributed_kneighbors(
    queries: np.ndarray,
    items: np.ndarray,
    k: int,
    mesh,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact global (distances, indices) with items sharded over ``mesh``.

    Called on every rank with the same full ``items`` and ``queries``;
    rank d of D searches the d-th of D equal blocks of the padded items.
    Every rank returns the same result."""
    n_items = items.shape[0]
    if not (1 <= k <= n_items):
        raise ValueError(f"k = {k} must be in [1, {n_items}]")
    n_shards = axis_size(mesh, DATA_AXIS)
    items_p, mask = pad_rows_to_multiple(
        np.asarray(items, dtype=np.dtype(dtype)), n_shards
    )
    per = items_p.shape[0] // n_shards
    rank = mesh.get_local_rank(DATA_AXIS)
    rows = slice(rank * per, (rank + 1) * per)
    device = mesh_device(mesh)
    x_dev = torch.as_tensor(items_p[rows], device=device)
    mask_dev = torch.as_tensor(mask[rows], dtype=x_dev.dtype, device=device)
    q_dev = torch.as_tensor(np.asarray(queries, dtype=np.dtype(dtype)),
                            device=device)
    ctx = current_fit()
    n_q = q_dev.shape[0]
    k_local = min(k, per)
    # two all_gathers of the per-shard top-k candidates: (q, k·D)
    # distances + (q, k·D) global indices
    ctx.record_collective(
        "all_gather",
        nbytes=collective_nbytes((n_q, k_local * n_shards), x_dev.dtype))
    ctx.record_collective(
        "all_gather",
        nbytes=collective_nbytes((n_q, k_local * n_shards), np.int32))
    with ctx.phase("execute"):
        d, i = _sharded_knn(q_dev, x_dev, mask_dev, k, rank * per,
                            mesh.get_group(DATA_AXIS))
    # the square root in torch, as the model's searches take it
    return (
        torch.sqrt(torch.clamp_min(d, 0.0)).cpu().numpy(),
        i.cpu().numpy().astype(np.int64),
    )
