"""Distributed PowerIterationClustering over the ``data`` ranks.

Counterpart of the JAX package's ``parallel/distributed_pic.py``. The local
PIC's envelope is the dense n × n affinity resident on one device
(``maxDenseNodes``); here each rank keeps one row panel of the
row-stochastic affinity on its device, so a rank holds n²/P and the
envelope grows with the ranks. Each power iteration is one panel
``torch.mv`` and one ``all_gather`` of the (n + pad,) iterate
(``parallel/mesh.all_gather_rows``); the L1 norm and the divide run on the
gathered vector, identical on every rank, so the loop needs no other
collective and no host synchronisation. Every rank builds the padded
affinity on the host with the one ``models.pic.build_affinity``, as JAX
does, and the final 1-D k-means on the iterate runs replicated on every
rank (``models.pic.cluster_iterate``; O(n·k) beside the O(n²) products).

Collectives, as the JAX package accounts them: one ``all_gather`` of the
(n + pad,) iterate per power iteration, ``max_iter`` of them.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.obs.report import (
    current_fit,
    fit_instrumentation,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    all_gather_rows,
    axis_size,
    collective_nbytes,
    mesh_device,
)


def distributed_power_iterate_kernel(w_panel: torch.Tensor, v0: torch.Tensor,
                                     *, group, max_iter: int) -> torch.Tensor:
    """``max_iter`` steps of v ← normalize(W v) with W's rows split over
    the group's ranks: ``w_panel`` is this rank's (rows, n + pad) panel,
    ``v0`` the replicated start. Padding rows are all-zero W rows, so their
    entries of v are 0 after the first step and never reach the L1 norm."""
    floor = torch.full((), 1e-30, dtype=w_panel.dtype, device=w_panel.device)
    v = v0
    for _ in range(max_iter):
        full = all_gather_rows(torch.mv(w_panel, v), group)
        v = full / torch.maximum(full.abs().sum(), floor)
    return v


@fit_instrumentation("distributed_pic")
def distributed_pic_assign(
    src,
    dst,
    weights=None,
    *,
    k: int,
    mesh,
    max_iter: int = 20,
    seed: int = 0,
    init_mode: str = "random",
    max_dense_nodes: int = None,
    dtype=np.float32,
):
    """Edge list → (ids, cluster labels), int64 each, on every rank.

    ``max_dense_nodes`` defaults to ``32768·⌊√P⌋`` so each rank's panel
    stays within the single-device envelope (n²/P bytes) as the ranks
    grow; every host still builds the full n² affinity, which bounds very
    large graphs.
    """
    from spark_rapids_ml_tpu_torch.models.pic import (
        build_affinity,
        cluster_iterate,
        initial_vector,
    )

    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    wts = (np.ones(src.shape[0]) if weights is None
           else np.asarray(weights, dtype=np.float64))
    n_dev = axis_size(mesh, DATA_AXIS)
    if max_dense_nodes is None:
        max_dense_nodes = 32_768 * max(1, int(np.sqrt(n_dev)))
    # the pad depends only on n = |unique ids|: resolved first, so
    # build_affinity allocates the padded buffer up front
    n = len(np.unique(np.concatenate([src, dst])))
    pad = (-n) % n_dev
    np_dtype = np.dtype(dtype)
    ids, w, deg = build_affinity(src, dst, wts, max_dense_nodes, np_dtype,
                                 pad_rows=pad)
    device = mesh_device(mesh)
    rows_per = (n + pad) // n_dev
    rank = mesh.get_local_rank(DATA_AXIS)
    w_panel = torch.tensor(w[rank * rows_per:(rank + 1) * rows_per],
                           device=device)
    del w
    v0 = initial_vector(deg, n, pad, init_mode, seed)
    v0_dev = torch.as_tensor(v0.astype(np_dtype), device=device)

    ctx = current_fit()
    ctx.set_iterations(max_iter)
    # one all_gather of the (n + pad,) iterate per power iteration
    ctx.record_collective(
        "all_gather", nbytes=collective_nbytes((n + pad,), np_dtype),
        count=max_iter,
    )
    with ctx.phase("execute"):
        v = distributed_power_iterate_kernel(
            w_panel, v0_dev, group=mesh.get_group(DATA_AXIS),
            max_iter=max_iter)
    # the trailing 1-D k-means runs at the iteration's dtype, as the local
    # path's does
    labels = cluster_iterate(v, n, k, seed)
    return ids.astype(np.int64), labels.astype(np.int64)
