"""Data-parallel BisectingKMeans: the divisive hierarchy over sharded rows.

Counterpart of the JAX package's ``parallel/distributed_bisecting.py``.
Rows split over the ``data`` group and stay on their rank for the whole
fit; each rank keeps its rows' leaf assignment as an int32 tensor on its
device, updated there by each committed split. Every bisection is one
function on each rank (``_bisect_split``): the global k-means++(2)
seeding over the target leaf's rows (``distributed_kmeans.
_global_kmeans_pp``, Gumbel-max across ranks), the Lloyd loop of
``ops.kmeans_kernel.lloyd_iterations`` with its statistics all-reduced,
the side assignment, and the children's (count, Σx, Σ‖x‖²) summed in one
``all_reduce``. The host driver sees O(d) statistics per split, never
rows.

Differences from the JAX package, by design:

* seeding draws from a ``torch.Generator`` seeded from (seed + split,
  rank), where JAX folds the split into a ``jax.random`` key, so the
  parity is held to the JAX tests' bars, and each split's Lloyd from a
  shared initial pair;
* the children's moments are taken in float64 and all-reduced in float64
  (JAX sums them in the data's dtype), so the SSE identity
  Σ‖x‖² − ‖Σx‖²/n does not cancel in float32;
* the collectives are recorded at their true counts and sizes: per split,
  per centre one MAX of a scalar and one SUM of (flag, row), one packed
  SUM per Lloyd iteration and one for its final cost, and one SUM of the
  children's moments.

``centers`` of the result is host float64 numpy (the driver's leaf
statistics), ``labels`` the compact leaf index per row, gathered from
every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from spark_rapids_ml_tpu_torch.obs.fitmon import current_run
from spark_rapids_ml_tpu_torch.obs.report import (
    current_fit,
    fit_instrumentation,
)
from spark_rapids_ml_tpu_torch.ops.kmeans_kernel import (
    _pairwise_sqdist,
    lloyd_iterations,
)
from spark_rapids_ml_tpu_torch.parallel.distributed_kmeans import (
    _all_reduce_stats,
    _global_kmeans_pp,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    all_gather_rows,
    axis_size,
    collective_nbytes,
    mesh_device,
    pad_rows_to_multiple,
)


class BisectingKMeansResult(NamedTuple):
    centers: np.ndarray         # (n_leaves, d) leaf centers, float64
    cost: float                 # Σ per-leaf SSE about its mean
    labels: np.ndarray          # (n_rows,) compact center index per row


def _bisect_split(x, mask, leaf, seed: int, target: int, new_id: int, *,
                  group, max_iter: int = 20, tol: float = 1e-4):
    """One bisection of leaf ``target`` on this rank's rows ``x`` with 0/1
    ``mask`` and leaf ids ``leaf``. Every rank of ``group`` must call it.

    Returns (2-means centres, the Lloyd iteration count, the proposed
    leaf tensor with the target's side-1 rows relabelled ``new_id``,
    per-side float64 (count (2,), Σx (2, d), Σ‖x‖² (2,))), the same on
    every rank but the leaf tensor."""
    m2 = mask * (leaf == target).to(x.dtype)
    init = _global_kmeans_pp(x, m2, seed, 2, group)
    centers, _cost, n_iter, _conv = lloyd_iterations(
        x, init, m2, max_iter, tol, reduce_fn=_all_reduce_stats(group))
    side = torch.argmin(_pairwise_sqdist(x, centers), dim=1)
    new_leaf = torch.where(
        m2 > 0,
        torch.where(side == 0, torch.full_like(leaf, target),
                    torch.full_like(leaf, new_id)),
        leaf)
    xw = x.double()
    mw = m2.double()
    w = torch.stack([mw * (side == 0), mw * (side == 1)])   # (2, m)
    d = x.shape[1]
    packed = torch.cat([w.sum(dim=1), (w @ xw).reshape(-1),
                        w @ (xw * xw).sum(dim=1)])
    dist.all_reduce(packed, group=group)
    return (centers, int(n_iter), new_leaf, packed[:2],
            packed[2:2 + 2 * d].view(2, d), packed[2 + 2 * d:])


@fit_instrumentation("distributed_bisecting")
def distributed_bisecting_kmeans_fit(
    x_host: np.ndarray,
    k: int,
    mesh,
    max_iter: int = 20,
    tol: float = 1e-4,
    seed: int = 0,
    min_divisible: float = 2.0,
    dtype=None,
) -> BisectingKMeansResult:
    """Host-side driver, called on every rank with the same full X: pad
    the rows to the mesh, place this rank's block (rank d of D takes the
    d-th of D equal blocks) once, then one ``_bisect_split`` per split;
    the hierarchy bookkeeping (which leaf splits next, divisibility) runs
    on O(leaves) statistics only. ``dtype`` (a numpy dtype) casts the
    rows first."""
    ctx = current_fit()
    x_host = np.asarray(x_host)
    n_rows = x_host.shape[0]
    if n_rows == 0:
        raise ValueError("empty dataset")
    n_dev = axis_size(mesh, DATA_AXIS)
    x_padded, mask = pad_rows_to_multiple(x_host, n_dev)
    if dtype is not None:
        x_padded = x_padded.astype(dtype)
    per = x_padded.shape[0] // n_dev
    rank = mesh.get_local_rank(DATA_AXIS)
    rows = slice(rank * per, (rank + 1) * per)
    device = mesh_device(mesh)
    x_dev = torch.as_tensor(x_padded[rows], device=device)
    mask_dev = torch.as_tensor(mask[rows], dtype=x_dev.dtype, device=device)
    leaf = torch.zeros(per, dtype=torch.int32, device=device)
    group = mesh.get_group(DATA_AXIS)

    # root stats on host (the driver already holds x_host — the same
    # posture as distributed_kmeans_fit's input contract)
    center0 = x_host.mean(axis=0)
    sse0 = float(((x_host - center0[None, :]) ** 2).sum())
    leaves = {0: {"center": center0, "sse": sse0,
                  "count": float(n_rows), "divisible": True}}

    d = x_host.shape[1]
    dt = x_dev.dtype
    n_splits = 0
    while len(leaves) < k:
        order = sorted(leaves, key=lambda lf: leaves[lf]["sse"],
                       reverse=True)
        target = next(
            (lf for lf in order
             if leaves[lf]["divisible"]
             and leaves[lf]["count"] >= min_divisible),
            None,
        )
        if target is None:
            break
        new_id = max(leaves) + 1
        with current_run().step("bisect_split", rows=n_rows) as mon:
            _centers2, n_iter, new_leaf, cnt, sums, sqs = _bisect_split(
                x_dev, mask_dev, leaf, seed + n_splits, target, new_id,
                group=group, max_iter=max_iter, tol=tol)
            cnt = cnt.cpu().numpy()         # synchronises
            mon.note(n_leaves=float(len(leaves)), target=float(target))
        # seeding: per centre one MAX and one SUM of (flag, row); Lloyd:
        # one packed SUM per iteration and one for the final cost; then
        # the children's float64 moments
        ctx.record_collective(
            "all_max", nbytes=collective_nbytes((1,), dt), count=2)
        ctx.record_collective(
            "all_reduce", nbytes=collective_nbytes((d + 1,), dt), count=2)
        ctx.record_collective(
            "all_reduce", nbytes=collective_nbytes((2 * d + 3,), dt),
            count=n_iter + 1)
        ctx.record_collective(
            "all_reduce",
            nbytes=collective_nbytes((2 * d + 4,), np.float64))
        n_splits += 1
        if (cnt <= 0).any():
            # degenerate split (identical points / emptied side): keep
            # the leaf, stop re-trying it
            leaves[target]["divisible"] = False
            continue
        leaf = new_leaf  # commit the on-device assignment
        sums = sums.cpu().numpy()
        sqs = sqs.cpu().numpy()
        for side, lf in ((0, target), (1, new_id)):
            mean = sums[side] / cnt[side]
            sse = float(max(
                sqs[side] - (sums[side] @ sums[side]) / cnt[side], 0.0))
            leaves[lf] = {"center": mean, "sse": sse,
                          "count": float(cnt[side]), "divisible": True}

    order = sorted(leaves)
    centers = np.stack([leaves[lf]["center"] for lf in order])
    lut = np.full(max(leaves) + 1, -1, dtype=np.int64)
    lut[order] = np.arange(len(order))
    all_leaf = all_gather_rows(leaf, group).cpu().numpy()
    ctx.record_collective(
        "all_gather", nbytes=collective_nbytes((per,), np.int32))
    labels = lut[all_leaf[:n_rows]]
    return BisectingKMeansResult(
        centers=centers,
        cost=float(sum(v["sse"] for v in leaves.values())),
        labels=labels,
    )
