"""Distributed UMAP optimizer: force panels and edge slices over the ranks.

Counterpart of the JAX package's ``parallel/distributed_umap.py``. The
tiled one-device optimizer (``ops.umap_kernel.optimize_embedding_blocked``)
splits forces by support: sparse-edge attraction, row-panel streamed
repulsion. Here the same decomposition runs one rank per device: the
embedding is replicated (n×dim — tiny), each rank owns one row panel of
the all-pairs repulsion (streamed in blocks of ``block_rows``, so a rank
never holds its whole panel × n) and one masked slice of the symmetric
edge list, and each epoch exchanges one ``all_gather`` of the repulsion
panels and one ``all_reduce`` of the edge-force partials — O(n·dim)
traffic per epoch, never a distance matrix. NCCL on the card, gloo on the
CPU. n and the edges pad to a multiple of the world size, as the JAX
package's ``pad_rows_to_multiple`` does. The math is the tiled
optimizer's, so one rank and several agree to reduction-order rounding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from spark_rapids_ml_tpu_torch.obs.report import (
    current_fit,
    fit_instrumentation,
)
from spark_rapids_ml_tpu_torch.ops.umap_kernel import (
    EdgeForces,
    _scalar,
    _step,
    repulsion,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    all_gather_rows,
    axis_size,
    collective_nbytes,
    mesh_device,
    pad_rows_to_multiple,
)


def _sharded_umap_optimize(edge_i, edge_j, edge_p, edge_mask, emb0, valid,
                           a, b, learning_rate, repulsion_strength,
                           n_epochs: int, block_rows: int, rank: int,
                           n_dev: int, group) -> torch.Tensor:
    """The replicated (n_pad, dim) embedding after ``n_epochs``, on every
    rank. The edge arrays are the whole padded lists; this rank takes its
    slice."""
    y = emb0
    n = y.shape[0]
    rows_per = n // n_dev
    e_per = edge_i.shape[0] // n_dev
    mine = slice(rank * e_per, (rank + 1) * e_per)
    a, b = _scalar(a, y), _scalar(b, y)
    lr = _scalar(learning_rate, y)
    gamma = _scalar(repulsion_strength, y)
    valid_f = valid.to(y.dtype)
    edges = EdgeForces(edge_i[mine], edge_j[mine], edge_p[mine], n,
                       mask=edge_mask[mine])
    for epoch in range(n_epochs):
        yp = y[rank * rows_per:(rank + 1) * rows_per]
        f_rep = all_gather_rows(
            repulsion(yp, y, a, b, gamma, valid_f, block_rows), group)
        f_att = edges(y, a, b, gamma)
        dist.all_reduce(f_att, group=group)
        y = _step(y, f_rep + f_att, lr, epoch, n_epochs)
    return y


@fit_instrumentation("distributed_umap")
def distributed_umap_optimize(
    edge_i: np.ndarray,
    edge_j: np.ndarray,
    edge_p: np.ndarray,
    emb0: np.ndarray,
    mesh,
    a: float,
    b: float,
    learning_rate: float = 1.0,
    repulsion_strength: float = 1.0,
    n_epochs: int = 200,
    dtype=np.float32,
    block_rows: int = 4096,
) -> np.ndarray:
    """Optimize a UMAP embedding over ``mesh`` from a symmetric edge list
    (``ops.umap_kernel.symmetric_edge_list``) and an init (e.g.
    ``pca_init``). Called on every rank with the same arguments; every rank
    returns the optimized (n, dim) embedding. ``block_rows`` bounds the
    rows of a rank's panel streamed at once."""
    n_dev = axis_size(mesh, DATA_AXIS)
    n = np.asarray(emb0).shape[0]
    emb_pad, row_mask = pad_rows_to_multiple(
        np.asarray(emb0, dtype=np.dtype(dtype)), n_dev
    )
    ei, e_mask = pad_rows_to_multiple(np.asarray(edge_i, dtype=np.int32),
                                      n_dev)
    ej, _ = pad_rows_to_multiple(np.asarray(edge_j, dtype=np.int32), n_dev)
    ep, _ = pad_rows_to_multiple(np.asarray(edge_p, dtype=np.dtype(dtype)),
                                 n_dev)
    ctx = current_fit()
    ctx.set_data(rows=n, features=np.asarray(emb0).shape[1])
    ctx.set_iterations(n_epochs)
    # per epoch: one all_gather of repulsion panels + one all_reduce of the
    # edge-force partials, each O(n·dim), as the JAX package accounts them
    emb_nbytes = collective_nbytes(emb_pad.shape, dtype)
    ctx.record_collective("all_gather", nbytes=emb_nbytes, count=n_epochs)
    ctx.record_collective("all_reduce", nbytes=emb_nbytes, count=n_epochs)
    device = mesh_device(mesh)
    with ctx.phase("execute"):
        out = _sharded_umap_optimize(
            ei, ej, torch.as_tensor(ep, device=device),
            torch.as_tensor(e_mask.astype(ep.dtype), device=device),
            torch.as_tensor(emb_pad, device=device),
            torch.as_tensor(row_mask > 0, device=device),
            a, b, learning_rate, repulsion_strength, n_epochs, block_rows,
            mesh.get_local_rank(DATA_AXIS), n_dev,
            mesh.get_group(DATA_AXIS),
        )
    return out.cpu().numpy().astype(np.float64)[:n]
