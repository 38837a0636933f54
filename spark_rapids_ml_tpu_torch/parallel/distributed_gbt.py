"""Distributed gradient-boosted trees: rows split over the ``data`` ranks,
each level's histogram all-reduced.

Counterpart of the JAX package's ``parallel/distributed_gbt.py``. Each
boosting round grows ONE regression tree on the current residuals with
the rows split over the ranks — per-rank (count, Σr, Σr²) level
histograms, one float64 ``all_reduce`` per level, replicated split
selection (``parallel/distributed_forest.py``) — and the round's
residuals, Newton leaf refit and margin update run on the host in
``models/gbt.py::boosting_loop``, exactly as the local and JAX fits run
them.

Called on every rank with the same full ``x`` and ``y``, so every rank
holds every row's residual. A rank knows only its own rows' leaf ids; one
``all_gather`` a round hands every rank all of them (the JAX package's
sharded leaf ids, gathered to its one host), so the refit's per-leaf sums
and the margin update are the JAX package's, in its order, and every rank
returns the same result. That gather is recorded beside the JAX
package's accounting: per round, one ``all_gather`` of the padded rows'
int64 leaf ids, besides ``max_depth`` ``all_reduce``s of a (3, 2^depth,
d, n_bins) operand at 8 bytes an element (the JAX package counts the
fit's dtype). One fit-monitor step ``boost_tree`` a round.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.obs.fitmon import current_run
from spark_rapids_ml_tpu_torch.obs.report import (
    current_fit,
    fit_instrumentation,
)
from spark_rapids_ml_tpu_torch.ops.forest_kernel import (
    TreeEnsemble,
    grow_tree_regression,
    quantile_bins,
)
from spark_rapids_ml_tpu_torch.parallel.distributed_forest import (
    rank_rows,
    torch_dtype,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    all_gather_rows,
    axis_size,
    collective_nbytes,
    mesh_device,
    pad_rows_to_multiple,
)


@fit_instrumentation("distributed_gbt")
def distributed_gbt_fit(
    x: np.ndarray,
    y: np.ndarray,
    mesh,
    max_iter: int = 20,
    max_depth: int = 5,
    n_bins: int = 32,
    min_leaf: int = 1,
    step_size: float = 0.1,
    classification: bool = False,
    subsampling_rate: float = 1.0,
    seed: int = 0,
    dtype=np.float32,
) -> Tuple[TreeEnsemble, np.ndarray, float, np.ndarray]:
    """(ensemble, bin_edges, init_margin, split_gains) — the triple the
    local GBT model consumes plus the per-node gains for
    ``ops.forest_kernel.feature_importances``, fitted with rows split
    over ``mesh``'s ``data`` ranks."""
    from spark_rapids_ml_tpu_torch.models.gbt import (
        boosting_loop,
        gbt_init_margin,
    )

    n_dev = axis_size(mesh, DATA_AXIS)
    x = np.asarray(x)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    n, d = x.shape
    if y.shape[0] != n:
        raise ValueError(f"labels length {y.shape[0]} != rows {n}")
    binned_np, edges = quantile_bins(x, n_bins)
    binned_p, mask = pad_rows_to_multiple(binned_np, n_dev)
    y_p = np.zeros(binned_p.shape[0])
    y_p[:n] = y
    rng = np.random.default_rng(seed)

    rows = rank_rows(mesh, binned_p.shape[0])
    device = mesh_device(mesh)
    tdt = torch_dtype(dtype)
    binned_dev = torch.as_tensor(binned_p[rows], device=device)
    full_mask = torch.ones((max_depth, d), dtype=tdt, device=device)
    group = mesh.get_group(DATA_AXIS)

    init = gbt_init_margin(y, classification)

    ctx = current_fit()
    # per boosted tree, one (count, Σr, Σr²) histogram all_reduce per
    # depth level, and the gather of every row's leaf id
    hist_nbytes = collective_nbytes(
        (3, 2 ** max_depth, d, n_bins), np.float64)
    ids_nbytes = collective_nbytes((binned_p.shape[0],), np.int64)

    def grow_fn(r, w):
        ctx.record_collective(
            "all_reduce", nbytes=hist_nbytes, count=max_depth)
        ctx.record_collective("all_gather", nbytes=ids_nbytes)
        # the copies to the host end the step, so its wall time covers
        # the whole boosted-tree growth
        with current_run().step("boost_tree", rows=n):
            ft, tt, leaf, g_tree, leaf_ids = grow_tree_regression(
                binned_dev,
                torch.as_tensor(r[rows], dtype=tdt, device=device),
                torch.as_tensor(w[rows], dtype=tdt, device=device),
                full_mask, max_depth, n_bins, min_leaf, group=group,
                return_leaf_ids=True,
            )
            all_ids = all_gather_rows(leaf_ids, group)
            return (ft.cpu().numpy(), tt.cpu().numpy(), leaf.cpu().numpy(),
                    g_tree.cpu().numpy(), all_ids.cpu().numpy())

    ensemble, gains = boosting_loop(
        y_padded=y_p, mask=mask, n_real=n, init=init, max_iter=max_iter,
        step_size=step_size, classification=classification,
        subsampling_rate=subsampling_rate, rng=rng, max_depth=max_depth,
        grow_fn=grow_fn,
    )
    return ensemble, edges, init, gains
