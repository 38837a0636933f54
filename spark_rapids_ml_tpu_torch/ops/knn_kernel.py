"""k-nearest-neighbour searches on the device: brute force, IVF-Flat and
IVF-PQ.

Counterpart of the JAX package's ``ops/knn_kernel.py``. The JAX package
computes these as XLA programs (a distance product, then ``lax.top_k``),
not in a Pallas kernel, so here they are PyTorch ops on tensors of an
explicit device: the cross term a cuBLAS product, the selection
``torch.topk``, the bucket scans gathers.

Distance policy. The squared distance is the expanded form
``(|q|² − 2·q·x) + |x|²``, in the JAX package's order. For float32 inputs
every distance is taken in float64 and rounded once to float32, as in
``ops/kmeans_kernel._pairwise_sqdist``: (a) no process-wide TF32 setting
(``torch.set_float32_matmul_precision("high")``) reaches a float64
product, where it would put ~1e-3 relative error on the cross term and
reorder neighbours; (b) the cancellation of the expanded form stays in
float64; (c) a query's distances do not depend on the chunk it is batched
with, so any chunking gives the same answer. Float64 inputs take the JAX
package's arithmetic as it is. The IVF scans take their cross terms per
probed list with ``bmm`` and the IVF-PQ tables with one ``einsum``, both
in float64 for float32 inputs, so no candidate tensor is widened whole.

Selection order. ``lax.top_k`` puts the lower index first among equal
values; ``torch.topk`` promises no order for ties. ``_smallest_k`` gives
``lax.top_k``'s order on −d²: the k smallest values, ascending, equal
values by ascending position, and where a tie straddles the k-th place
the lower positions are kept. So duplicated items, padding slots at +inf
and merged shard candidates come out as the JAX package's do.

Padding contract, as in the JAX package: masked items (``item_mask`` 0)
and padding bucket slots get +inf distance and are never selected ahead of
a real item; a padding slot surfaces as id −1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spark_rapids_ml_tpu_torch.ops.kmeans_kernel import _wide

# the largest float64 distance block (queries × items) one chunk of a
# brute-force search may hold
DIST_BLOCK_BYTES = 1 << 31


def query_step(n_items: int, limit: int = 1024) -> int:
    """Queries per chunk of a brute-force search over ``n_items``: at most
    ``limit``, and few enough that the chunk's float64 distance block stays
    within ``DIST_BLOCK_BYTES``."""
    return max(1, min(limit, DIST_BLOCK_BYTES // (8 * max(1, n_items))))


def _inf(t: torch.Tensor) -> torch.Tensor:
    return torch.full((), float("inf"), dtype=t.dtype, device=t.device)


def _smallest_k(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int64 positions) of each row's k smallest entries in
    ``lax.top_k(−d2, k)``'s order (see the module docstring).

    ``torch.topk`` finds the k smallest values; a row whose k-th value is
    shared past the k-th place (one pass, one scalar read) is sorted in
    full with a stable sort instead. The k kept are then ordered by value
    and position."""
    vals, pos = torch.topk(d2, k, dim=1, largest=False)
    if k < d2.shape[1]:
        crowded = (d2 <= vals[:, -1:]).sum(dim=1) > k
        rows = crowded.nonzero().flatten()
        if rows.numel():
            full_vals, full_pos = torch.sort(d2[rows], dim=1, stable=True)
            vals[rows] = full_vals[:, :k]
            pos[rows] = full_pos[:, :k]
    pos, order = torch.sort(pos, dim=1)
    vals = vals.gather(1, order)
    vals, order = torch.sort(vals, dim=1, stable=True)
    return vals, pos.gather(1, order)


def pairwise_sqdist(
    queries: torch.Tensor,
    items: torch.Tensor,
    item_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(n_q, n_items) squared euclidean distances in the queries' dtype,
    masked items → +inf."""
    qw = _wide(queries)
    xw = _wide(items).to(qw.dtype)
    d2 = qw @ xw.T
    d2.mul_(-2.0).add_((qw * qw).sum(dim=1, keepdim=True))
    d2.add_((xw * xw).sum(dim=1)[None, :]).clamp_min_(0.0)
    d2 = d2.to(queries.dtype)
    if item_mask is not None:
        d2.masked_fill_(~(item_mask > 0)[None, :], float("inf"))
    return d2


def knn_kernel(
    queries: torch.Tensor,
    items: torch.Tensor,
    k: int,
    item_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest items for each query row: ``(distances, indices)``,
    each (n_q, k), euclidean distances ascending and item-row indices."""
    vals, idx = _smallest_k(pairwise_sqdist(queries, items, item_mask), k)
    return torch.sqrt(torch.clamp_min(vals, 0.0)), idx


def knn_merge(
    dist_parts: torch.Tensor, idx_parts: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k candidate lists into the global top-k.

    ``dist_parts``/``idx_parts`` are (n_q, n_candidates) with indices
    already in the global item numbering; the second selection over the
    candidate axis gives the exact global result, ties to the lower
    candidate position."""
    vals, pos = _smallest_k(dist_parts, k)
    return vals, idx_parts.gather(1, pos)


def exact_rerank(
    queries: torch.Tensor,     # (n_q, dim)
    items: torch.Tensor,       # (n_items, dim) raw rows
    cand_ids: torch.Tensor,    # (n_q, C) ADC candidates, −1 = padding
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-distance re-rank of approximate candidates (the
    IndexRefineFlat pattern): gather the C candidate rows per query, take
    their true squared distances (the difference form, as the JAX
    package), keep the top k. Returns (squared distances, ids)."""
    rows = _wide(items[torch.clamp_min(cand_ids, 0).long()])   # (Q, C, dim)
    diff = _wide(queries).to(rows.dtype)[:, None, :] - rows
    d2 = (diff * diff).sum(dim=2).to(items.dtype)
    d2.masked_fill_(cand_ids < 0, float("inf"))
    vals, pos = _smallest_k(d2, k)
    return vals, cand_ids.gather(1, pos)


def _probe(queries, centroids, nprobe):
    """The ``nprobe`` nearest lists of each query, (n_q, nprobe) int64."""
    return _smallest_k(pairwise_sqdist(queries, centroids), nprobe)[1]


def _candidates(probes, bucket_ids, bucket_mask, d2):
    """The probed lists' slots flattened per query: (distances with padding
    at +inf, ids with padding at −1)."""
    n_q = probes.shape[0]
    cand_mask = bucket_mask[probes].reshape(n_q, -1) > 0
    cand_ids = torch.where(cand_mask, bucket_ids[probes].reshape(n_q, -1),
                           torch.full((), -1, dtype=bucket_ids.dtype,
                                      device=bucket_ids.device))
    d2 = torch.where(cand_mask, d2.reshape(n_q, -1), _inf(d2))
    return d2, cand_ids


def ivf_search(
    queries: torch.Tensor,       # (n_q, dim)
    centroids: torch.Tensor,     # (nlist, dim)
    bucket_items: torch.Tensor,  # (nlist, max_size, dim), zero-padded
    bucket_ids: torch.Tensor,    # (nlist, max_size) int32 original row ids
    bucket_mask: torch.Tensor,   # (nlist, max_size) 1 = real item
    k: int,
    nprobe: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k: search only the ``nprobe`` nearest lists.

    Returns (squared distances, ids) each (n_q, k); ids address the
    ORIGINAL item numbering via ``bucket_ids``. Exact when
    nprobe == nlist. The probed rows are gathered one probe at a time,
    (n_q, max_size, dim), and their cross terms taken with ``bmm``."""
    n_q = queries.shape[0]
    probes = _probe(queries, centroids, nprobe)
    qw = _wide(queries)
    qn = (qw * qw).sum(dim=1, keepdim=True)
    d2 = torch.empty((n_q, nprobe, bucket_items.shape[1]),
                     dtype=queries.dtype, device=queries.device)
    for p in range(nprobe):
        rows = _wide(bucket_items[probes[:, p]])            # (Q, m, dim)
        cross = torch.bmm(rows, qw.to(rows.dtype)[:, :, None])[:, :, 0]
        d2[:, p] = torch.clamp_min(qn - 2.0 * cross + (rows * rows).sum(2),
                                   0.0)
    d2, cand_ids = _candidates(probes, bucket_ids, bucket_mask, d2)
    vals, pos = _smallest_k(d2, k)
    return vals, cand_ids.gather(1, pos)


def ivfpq_search(
    queries: torch.Tensor,       # (n_q, dim)
    centroids: torch.Tensor,     # (nlist, dim) coarse quantizer
    codebooks: torch.Tensor,     # (M, ksub, dsub) per-subspace codewords
    bucket_codes: torch.Tensor,  # (M, nlist, max_size) uint8 PQ codes
    bucket_ids: torch.Tensor,    # (nlist, max_size) int32 original row ids
    bucket_mask: torch.Tensor,   # (nlist, max_size) 1 = real item
    k: int,
    nprobe: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate top-k via ADC over the ``nprobe`` nearest lists.

    d²(q, item) ≈ Σ_m ‖(q − c_list)|_m − codebook_m[code_m]‖², the
    residual-PQ estimator. Returns (squared distances, ids), ids in the
    ORIGINAL item numbering (−1 on padding).

    The lookup tables (n_q, nprobe, M, ksub) are one ``einsum`` of the
    query residuals against the codebooks. The scan runs over the M
    subspaces in order, as the JAX package's, each gathering its table
    with that subspace's codes widened to int64 one slice at a time, so
    the resident codes stay uint8 (n·M bytes)."""
    n_q = queries.shape[0]
    m_sub, _, dsub = codebooks.shape
    probes = _probe(queries, centroids, nprobe)
    qr = _wide((queries[:, None, :] - centroids[probes])
               .reshape(n_q, nprobe, m_sub, dsub))
    books = _wide(codebooks).to(qr.dtype)
    cross = torch.einsum("qpmd,mjd->mqpj", qr, books)
    qn = (qr * qr).sum(dim=3).permute(2, 0, 1)[..., None]
    cn = (books * books).sum(dim=2)[:, None, None, :]
    lut = (qn - 2.0 * cross + cn).to(queries.dtype)          # (M, Q, P, ksub)
    d2 = torch.zeros((n_q, nprobe, bucket_ids.shape[1]), dtype=queries.dtype,
                     device=queries.device)
    for m in range(m_sub):
        codes_m = bucket_codes[m][probes].long()            # (Q, P, max_size)
        d2 = d2 + torch.gather(lut[m], 2, codes_m)
    d2, cand_ids = _candidates(probes, bucket_ids, bucket_mask,
                               torch.clamp_min(d2, 0.0))
    vals, pos = _smallest_k(d2, k)
    return vals, cand_ids.gather(1, pos)
