"""Data-parallel NaiveBayes: each rank's per-class statistics, all-reduced.

Counterpart of the JAX package's ``parallel/distributed_nb.py``. Rows
split over the ``data`` group; each rank forms its shard's per-class
sufficient statistics (Σ one-hot, one-hotᵀ·X, and for gaussian
one-hotᵀ·X²: ``models/naive_bayes.class_products``, a float32 product
taken in float64 and rounded once) on its device, ONE ``all_reduce`` sums
them packed into one buffer in the fit's dtype (NCCL on cards, gloo on
CPU ranks), and every rank runs the per-family closed forms of
``spark/aggregate.py::finalize_nb_from_stats`` (the single copy the local
fit and the Spark statistics plane share), so every rank returns the
same model. Padding rows carry an all-zero one-hot row and contribute
nothing.

The reduction runs in the fit's dtype, float32 by default, as the JAX
function's ``psum`` does: a class count above 2²⁴ rows is no longer exact
there (ROADMAP queue 3 item 9).

Instrumented as the JAX function is: one fit-monitor step
``class_stats`` and the collective accounted as K·(1 + d) elements of the
dtype (K·(1 + 2d) for gaussian).
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
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_size,
    collective_nbytes,
    mesh_device,
    pad_rows_to_multiple,
)


def distributed_nb_stats_kernel(x, y_oh, *, mesh, need_sq: bool):
    """Global (counts, Σx per class, Σx² per class) from this rank's rows
    ``x`` (rows, d) and one-hot ``y_oh`` (rows, K), tensors on the mesh's
    device. Every rank of the mesh's ``data`` group must call it; each
    returns the same replicated tensors (the Σx² slot is zeros unless
    ``need_sq``)."""
    from spark_rapids_ml_tpu_torch.models.naive_bayes import class_products

    counts, sums, sq = class_products(x, y_oh, need_sq)
    k, d = sums.shape
    parts = [counts, sums.reshape(-1)] + ([sq.reshape(-1)] if need_sq
                                          else [])
    packed = torch.cat(parts)
    dist.all_reduce(packed, group=mesh.get_group(DATA_AXIS))
    counts = packed[:k]
    sums = packed[k:k + k * d].view(k, d)
    sq = (packed[k + k * d:].view(k, d) if need_sq
          else torch.zeros_like(sums))
    return counts, sums, sq


@fit_instrumentation("distributed_nb")
def distributed_nb_fit(
    x_host: np.ndarray,
    y_host: np.ndarray,
    mesh,
    model_type: str = "multinomial",
    smoothing: float = 1.0,
    weights: np.ndarray = None,
    dtype=np.float32,
):
    """Host-side entry point, called on every rank with the same full
    (X, y): pads the rows to the mesh and places this rank's block (rank d
    of D takes the d-th of D equal blocks, as the JAX row sharding does).
    Returns the standard ``NaiveBayesModel`` (the class the local fit and
    the Spark plane produce)."""
    from spark_rapids_ml_tpu_torch.models.naive_bayes import (
        NaiveBayesModel,
        _prepare_nb_inputs,
    )
    from spark_rapids_ml_tpu_torch.spark.aggregate import (
        finalize_nb_from_stats,
    )

    x_host = np.asarray(x_host)
    classes, y_oh = _prepare_nb_inputs(x_host, y_host, weights,
                                       model_type)

    n_dev = axis_size(mesh, DATA_AXIS)
    x_padded, _mask = pad_rows_to_multiple(x_host, n_dev)
    oh_padded = np.zeros((x_padded.shape[0], classes.size))
    oh_padded[: y_oh.shape[0]] = y_oh
    per = x_padded.shape[0] // n_dev
    rank = mesh.get_local_rank(DATA_AXIS)
    rows = slice(rank * per, (rank + 1) * per)
    nd = np.dtype(dtype)
    device = mesh_device(mesh)
    x_dev = torch.as_tensor(np.asarray(x_padded[rows], dtype=nd),
                            device=device)
    oh_dev = torch.as_tensor(np.asarray(oh_padded[rows], dtype=nd),
                             device=device)
    ctx = current_fit()
    n_classes, n_feat = classes.size, x_host.shape[1]
    need_sq = model_type == "gaussian"
    # one packed all-reduce of (counts, Σx per class[, Σx² per class])
    ctx.record_collective(
        "all_reduce",
        nbytes=collective_nbytes(
            (n_classes * (1 + n_feat * (2 if need_sq else 1)),), nd
        ),
    )
    with ctx.phase("execute"), current_run().step(
        "class_stats", rows=x_host.shape[0]
    ):
        stats = distributed_nb_stats_kernel(x_dev, oh_dev, mesh=mesh,
                                            need_sq=need_sq)
        counts, sums, sq = (t.cpu().numpy().astype(np.float64)
                            for t in stats)
    pi, theta, sigma = finalize_nb_from_stats(
        classes, counts, sums, sq, model_type, float(smoothing),
    )
    model = NaiveBayesModel(pi=pi, theta=theta, sigma=sigma,
                            classes=classes)
    model.set("modelType", model_type)
    model.set("smoothing", float(smoothing))
    return model
