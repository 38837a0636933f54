"""Distributed DBSCAN: ε-graph row panels sharded over the ``data`` ranks.

Counterpart of the JAX package's ``parallel/distributed_dbscan.py``. The
tiled kernel (``ops.dbscan_kernel.dbscan_labels_blocked``) streams
(block × n) distance panels one after another; here each rank computes the
panels of its own row range: ``x`` is replicated (n·d, small; it is the n²
adjacency this formulation never materialises), each rank sweeps
min-label propagation over its rows, and the updated label slices are
exchanged with one ``all_gather`` per sweep. The label vector is the only
traffic, O(n) per sweep. The convergence test runs on the gathered labels,
identical on every rank, so it needs no collective of its own. Semantics
match the one-device kernels exactly: core = degree ≥ min_pts, min-label
propagation to the fixed point, the minimum-core-neighbour border
assignment, noise −1.

Collectives, as the JAX package accounts them: the core mask and one
sweep's labels, (n_pad,) each in the data's dtype (count 2), with the
per-sweep payload in the report's notes; plus the final labels' gather
that hands every rank the whole result, which the JAX package's sharded
output does on fetch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.obs.report import (
    current_fit,
    fit_instrumentation,
)
from spark_rapids_ml_tpu_torch.ops.dbscan_kernel import (
    LABEL_ENVELOPE,
    _eps_squared,
)
from spark_rapids_ml_tpu_torch.ops.knn_kernel import _inf, pairwise_sqdist
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    all_gather_rows,
    axis_size,
    collective_nbytes,
    mesh_device,
    pad_rows_to_multiple,
)


def _sharded_dbscan(x, valid, eps, min_pts: int, inner_block: int, rank: int,
                    n_dev: int, group):
    """(labels int32, core bool), each (n_pad,), on every rank."""
    n = x.shape[0]
    rows_per = n // n_dev
    mine = slice(rank * rows_per, (rank + 1) * rows_per)
    eps2 = _eps_squared(eps, x)
    inf = _inf(x)
    tiles = x[mine].split(inner_block)

    def panels(columns):
        for xi in tiles:
            yield (pairwise_sqdist(xi, x) <= eps2) & columns[None, :]

    degree = torch.cat([adj.sum(dim=1) for adj in panels(valid)])
    core_local = (degree >= min_pts) & valid[mine]
    core = all_gather_rows(core_local.to(x.dtype), group) > 0

    def neighbor_min(labels):
        return torch.cat([torch.where(adj, labels[None, :], inf).amin(dim=1)
                          for adj in panels(core)])

    labels = torch.where(core, torch.arange(n, dtype=x.dtype,
                                            device=x.device), inf)
    while True:
        nxt_local = torch.minimum(
            labels[mine], torch.where(core_local, neighbor_min(labels), inf))
        nxt = all_gather_rows(nxt_local, group)
        moved = bool((nxt != labels).any())  # the one scalar read a sweep
        labels = nxt
        if not moved:
            break
    final = torch.where(core_local, labels[mine], neighbor_min(labels))
    final = torch.where(valid[mine], final, inf)
    final = torch.where(torch.isfinite(final), final,
                        torch.full((), -1, dtype=x.dtype, device=x.device))
    return all_gather_rows(final, group).to(torch.int32), core


@fit_instrumentation("distributed_dbscan")
def distributed_dbscan_labels(
    x_host: np.ndarray,
    eps: float,
    min_pts: int,
    mesh,
    dtype=np.float32,
    inner_block: int = 1024,
) -> Tuple[np.ndarray, np.ndarray]:
    """(labels, core_mask) with the ε-graph row panels computed one per
    rank, each panel streamed in (inner_block × n) tiles. Called on every
    rank with the same ``x_host``; every rank returns the same result.
    Labels are cluster representatives (minimum row index), noise −1 —
    relabel with the estimator's helper for consecutive ids."""
    x_host = np.asarray(x_host, dtype=np.dtype(dtype))
    n = x_host.shape[0]
    if n > LABEL_ENVELOPE:
        raise ValueError(
            f"{n} rows exceeds the f32 label-lane envelope (2^24)"
        )
    n_dev = axis_size(mesh, DATA_AXIS)
    # rows pad to a multiple of n_dev·inner so each rank's panel tiles
    # evenly; the tile shrinks to fit rather than the input padding up to
    # the tile, so padding stays under n_dev·(tiles per rank) rows
    per_dev = -(-n // n_dev)
    nb = max(1, -(-per_dev // inner_block))
    inner = -(-per_dev // nb)
    x_pad, mask = pad_rows_to_multiple(x_host, n_dev * inner)
    device = mesh_device(mesh)
    x_dev = torch.as_tensor(x_pad, device=device)
    valid_dev = torch.as_tensor(mask > 0, device=device)
    ctx = current_fit()
    n_pad = x_pad.shape[0]
    payload = collective_nbytes((n_pad,), x_dev.dtype)
    # the core mask's and one sweep's all_gather (the sweep count is
    # data-dependent: its payload is noted so consumers can scale it), and
    # the final labels' gather
    ctx.record_collective("all_gather", nbytes=payload, count=2)
    ctx.note(dbscan_sweep_payload_bytes=payload)
    ctx.record_collective("all_gather", nbytes=payload)
    with ctx.phase("execute"):
        labels, core = _sharded_dbscan(
            x_dev, valid_dev, eps, min_pts, inner,
            mesh.get_local_rank(DATA_AXIS), n_dev,
            mesh.get_group(DATA_AXIS))
    return (
        labels.cpu().numpy()[:n],
        core.cpu().numpy().astype(bool)[:n],
    )
