"""Distributed IVF-Flat / IVF-PQ search: inverted lists sharded over the
``data`` ranks.

Counterpart of the JAX package's ``parallel/distributed_ivf.py``: the INDEX
is what grows, so the lists split over the ranks (each holds nlist/n_ranks
coarse cells: centroid and bucket of items or PQ codes), queries and PQ
codebooks replicate. Each rank probes the ``nprobe`` nearest of its OWN
lists and takes its local top-k; the global answer is
``distributed_knn``'s all_gather + merge.

Semantics, as the JAX package's: probing the top ``nprobe`` lists per rank
probes every list the one-device search would, plus up to
``nprobe·(n_ranks−1)`` more, so recall is ≥ the one-device search at the
same nprobe. The PQ variant returns ADC-ranked results (the exact re-rank
stays a one-device refinement, where the raw rows live).

The lists pad to the rank multiple with empty cells whose centroids are
``_FAR`` (1e30) in every coordinate. Distances are taken in float64
(``ops/knn_kernel``), where |c|² = dim·1e60 is finite: a float32 distance
to a padded cell rounds to +inf and a float64 one stays finite and huge,
so a padded cell sorts after every real one and no inf − inf appears.
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
    ivf_search,
    ivfpq_search,
    knn_merge,
)
from spark_rapids_ml_tpu_torch.parallel.distributed_knn import (
    gather_candidates,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_size,
    collective_nbytes,
    mesh_device,
)

_FAR = 1e30  # padded-cell centroid fill: sorts after every real cell


def _pad_lists(t: torch.Tensor, nlist_padded: int, axis: int, fill=0):
    """``t`` with its list axis padded to ``nlist_padded`` with ``fill``."""
    pad = nlist_padded - t.shape[axis]
    if pad == 0:
        return t
    shape = list(t.shape)
    shape[axis] = pad
    return torch.cat([t, torch.full(shape, fill, dtype=t.dtype,
                                    device=t.device)], dim=axis)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


@fit_instrumentation("distributed_ivf")
def distributed_ivf_search(
    model,
    queries: np.ndarray,
    mesh,
    k=None,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray]:
    """(distances, indices) for a fitted approximate
    ``NearestNeighborsModel`` with its lists sharded over ``mesh``.

    Called on every rank: each builds (or reuses) the model's index on its
    device, takes its share of the lists (padded to the rank multiple with
    far-centroid empty cells) and runs its local search; every rank returns
    the same result. ``algorithm`` on the model selects ivfflat vs ivfpq."""
    algorithm = model.getAlgorithm()
    if algorithm not in ("ivfflat", "ivfpq"):
        raise ValueError(
            f"distributed_ivf_search needs algorithm ivfflat/ivfpq, "
            f"got {algorithm!r}"
        )
    k = model.getK() if k is None else k
    tdtype = _torch_dtype(dtype)
    n_shards = axis_size(mesh, DATA_AXIS)
    device = mesh_device(mesh)
    if algorithm == "ivfflat":
        centroids, b_items, b_ids, b_mask, nlist = model._ivf_index(
            device, tdtype)
    else:
        centroids, books, b_codes, b_ids, b_mask, nlist = (
            model._ivfpq_index(device, tdtype))
    nprobe = min(model.getNprobe(), nlist)
    nlist_p = -(-nlist // n_shards) * n_shards
    # the sharded analogue of the model's candidate-pool guard: every rank
    # contributes min(k, local pool) candidates; the merged set must still
    # cover k
    lists_per_shard = nlist_p // n_shards
    max_size = int(b_ids.shape[1])
    np_local = min(nprobe, lists_per_shard)
    per_shard = min(k, np_local * max_size)
    if n_shards * per_shard < k:
        raise ValueError(
            f"k = {k} exceeds the sharded candidate pool "
            f"({n_shards} shards x {per_shard}): raise nprobe or nlist, "
            "or use fewer shards"
        )
    rank = mesh.get_local_rank(DATA_AXIS)
    mine = slice(rank * lists_per_shard, (rank + 1) * lists_per_shard)
    cent = _pad_lists(centroids.to(tdtype), nlist_p, 0, fill=_FAR)[mine]
    ids = _pad_lists(b_ids, nlist_p, 0)[mine]
    mask = _pad_lists(b_mask.to(tdtype), nlist_p, 0)[mine]
    q_dev = torch.as_tensor(np.asarray(queries), dtype=tdtype, device=device)
    ctx = current_fit()
    ctx.set_data(rows=q_dev.shape[0], features=q_dev.shape[1])
    # two-level reduction: all_gather of per-rank top-k distances + ids
    ctx.record_collective(
        "all_gather",
        nbytes=collective_nbytes((q_dev.shape[0], per_shard * n_shards),
                                 tdtype))
    ctx.record_collective(
        "all_gather",
        nbytes=collective_nbytes((q_dev.shape[0], per_shard * n_shards),
                                 np.int32))
    if algorithm == "ivfflat":
        items = _pad_lists(b_items.to(tdtype), nlist_p, 0)[mine]

        def search(q):
            return ivf_search(q, cent, items, ids, mask, per_shard, np_local)
    else:
        codes = _pad_lists(b_codes, nlist_p, 1)[:, mine]
        books = books.to(tdtype)

        def search(q):
            return ivfpq_search(q, cent, books, codes, ids, mask, per_shard,
                                np_local)
    # the local search in the model's query chunks, so the candidate
    # gather stays (chunk, np_local·max_size, …)
    step = model._ivf_pool_check_and_step(algorithm, per_shard, np_local,
                                          max_size)
    parts = [search(q) for q in q_dev.split(step)]
    d2 = torch.cat([d for d, _ in parts])
    i = torch.cat([i for _, i in parts])
    group = mesh.get_group(DATA_AXIS)
    d2, i = knn_merge(gather_candidates(d2, group),
                      gather_candidates(i.to(torch.int32), group), k)
    # the square root in torch, as the model's searches take it
    return (
        torch.sqrt(torch.clamp_min(d2, 0.0)).cpu().numpy(),
        i.cpu().numpy().astype(np.int64),
    )
