"""Distributed RandomForest: rows split over the ``data`` ranks, each
level's histogram all-reduced.

Counterpart of the JAX package's ``parallel/distributed_forest.py``. The
level-synchronous histogram grower (``ops/forest_kernel.py``) distributes
as the JAX package's does under ``shard_map``: each rank histograms ITS
rows into the small (channels, nodes, features, bins) statistics tensor,
one ``all_reduce`` per level combines them over NCCL (gloo on CPU ranks),
in float64, and split selection runs replicated, so every rank grows the
same tree; the leaf statistics follow in one more ``all_reduce`` a tree.
No data row moves; routing stays on each rank's own rows.

Called on every rank with the same full ``x`` and ``y``: the binning, the
padding to the rank multiple and the bootstrap draws are the JAX
package's on the whole padded row set (rank d of D takes the d-th of D
equal blocks), so a world of D ranks grows the ensemble of the JAX
package's mesh of D devices. Feature subsets are all-ones, as there.

Instrumented as the JAX function is: a fit report whose collectives are
the per-tree histogram ``all_reduce``, counted as the JAX package counts
it — ``max_depth`` a tree of a (channels, 2^max_depth, d, n_bins) operand
with channels = len(classes) + 1 for classification, 3 for regression —
but at 8 bytes an element, the float64 the port reduces (the JAX package
counts the fit's dtype); the small leaf-statistics reduction is not
counted, as in the JAX package. One fit-monitor step ``grow_tree`` a
tree, noted with its index.
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
    grow_trees_classification_batch,
    grow_trees_regression_batch,
    quantile_bins,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_size,
    collective_nbytes,
    mesh_device,
    pad_rows_to_multiple,
)


def torch_dtype(dtype) -> torch.dtype:
    """The torch float dtype of a numpy or torch float ``dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.float64 if np.dtype(dtype) == np.float64 else torch.float32


def rank_rows(mesh, padded_rows: int) -> slice:
    """This rank's block of the padded rows: rank d of D takes the d-th of
    D equal blocks, as the JAX row sharding does."""
    per = padded_rows // axis_size(mesh, DATA_AXIS)
    rank = mesh.get_local_rank(DATA_AXIS)
    return slice(rank * per, (rank + 1) * per)


@fit_instrumentation("distributed_forest")
def distributed_forest_fit(
    x: np.ndarray,
    y: np.ndarray,
    mesh,
    n_trees: int = 20,
    max_depth: int = 5,
    n_bins: int = 32,
    min_leaf: int = 1,
    subsampling_rate: float = 1.0,
    classification: bool = False,
    seed: int = 0,
    dtype=np.float32,
) -> Tuple[TreeEnsemble, np.ndarray, np.ndarray, np.ndarray]:
    """(ensemble, edges, classes, split_gains) with rows split over
    ``mesh``'s ``data`` ranks; every rank returns the same result.

    Bootstrap weights are drawn on host per tree over the padded rows;
    padding rows carry weight 0 so they contribute to no histogram.
    ``classes`` is None for regression; feed (ensemble.feature,
    split_gains) to ``ops.forest_kernel.feature_importances`` for
    Spark-style importances."""
    n_dev = axis_size(mesh, DATA_AXIS)
    binned_np, edges = quantile_bins(x, n_bins)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    if classification:
        classes = np.unique(y)
        y_payload = np.eye(len(classes))[np.searchsorted(classes, y)]
    else:
        classes = None
        y_payload = y
    binned_p, mask = pad_rows_to_multiple(binned_np, n_dev)
    y_p, _ = pad_rows_to_multiple(y_payload, n_dev)
    rng = np.random.default_rng(seed)
    d = x.shape[1]
    rows = rank_rows(mesh, binned_p.shape[0])
    device = mesh_device(mesh)
    tdt = torch_dtype(dtype)
    binned_dev = torch.as_tensor(binned_p[rows], device=device)
    y_dev = torch.as_tensor(y_p[rows], dtype=tdt, device=device)
    group = mesh.get_group(DATA_AXIS)

    ctx = current_fit()
    # per tree, one histogram all_reduce per depth level: (channels,
    # nodes ≤ 2^depth, features, bins), bounded program-level accounting
    channels = (len(classes) + 1) if classification else 3
    hist_nbytes = collective_nbytes(
        (channels, 2 ** max_depth, d, n_bins), np.float64)
    fm = torch.ones((1, max_depth, d), dtype=tdt, device=device)
    feats_l, thrs_l, leaves_l, gains_l = [], [], [], []
    for tree in range(n_trees):
        ctx.record_collective(
            "all_reduce", nbytes=hist_nbytes, count=max_depth)
        w = rng.poisson(subsampling_rate, binned_p.shape[0]) * mask
        w_dev = torch.as_tensor(w[rows], dtype=tdt, device=device)[None]
        # the copies to the host end the step, so its wall time covers
        # the whole level-synchronous growth
        with current_run().step("grow_tree", rows=x.shape[0]) as mon:
            if classification:
                out = grow_trees_classification_batch(
                    binned_dev, y_dev, w_dev, fm, max_depth, n_bins,
                    len(classes), min_leaf, group=group)
            else:
                out = grow_trees_regression_batch(
                    binned_dev, y_dev, w_dev, fm, max_depth, n_bins,
                    min_leaf, group=group)
            for acc, t in zip((feats_l, thrs_l, leaves_l, gains_l), out):
                acc.append(t[0].cpu().numpy())
            mon.note(tree=float(tree))
    ensemble = TreeEnsemble(
        feature=np.stack(feats_l),
        threshold=np.stack(thrs_l),
        leaf_value=np.stack(leaves_l),
    )
    return ensemble, edges, classes, np.stack(gains_l)
