"""Random-forest kernels on PyTorch: level-synchronous histogram trees.

Counterpart of the JAX package's ``ops/forest_kernel.py``, which is
``jnp``/``lax`` code XLA compiled (no Pallas kernel), so this is torch ops
on the card. The formulation is the same: every node of a level grows at
once with dense algebra and static shapes.

* Features are quantile-binned to small ints once, on the host
  (``quantile_bins``: the JAX package's edges and bins bit for bit, its
  columns on a thread pool), and fit and predict bin through the one
  helper ``apply_bin_edges``.
* A level's per-channel (node, feature, bin) statistics are one dense
  contraction, H = (node one-hot · channels)ᵀ · (bin one-hot)
  (``channel_histograms``). It is always taken in float64 (float64 GEMMs
  have no TF32 mode, so no global matmul switch changes a tree), and the
  split selection and the leaf statistics run on it in float64 too; only
  a fit's outputs — leaf values and split gains — are rounded once to its
  dtype. So a float32 fit grows the float64 fit's trees wherever its
  float32 inputs are exact (class counts under integer weights), where
  float32 Gini or variance gains, cancelling in sums of ~n² terms, would
  flip splits whose gains agree to ~1e-4 at a million rows. The rows are
  contracted in blocks of
  ``ROW_CHUNK``, each block's two one-hots built on the fly and its GEMM
  accumulated in a fixed block order, so neither the n × d·B bin one-hot
  nor the n × nodes node one-hot is ever held whole, and no float atomics
  are used: a fit repeated on the card is bit-identical.
* Split selection (``level_split``) is a cumulative sum over bins, a
  validity mask and a first-maximum ``argmax`` over (feature, bin) per
  node, as ``jnp.argmax`` picks; gains at or below 1e-12 make the node a
  pass-through (threshold = n_bins sends every row left).
* Rows route by ``node ← 2·node + (x_bin > threshold)``.

Trees of a group grow together: the group's channels stack along the
contraction's output rows, so a level of T trees is one GEMM per row
block. Under ``torch.distributed`` (``group`` given) each level's
histogram and the leaf statistics are ``all_reduce``d in float64 (the JAX
package's ``psum``); split selection then runs replicated on every rank.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Tuple

import numpy as np
import torch

# rows per block of the histogram contraction: a block's float64 bin
# one-hot is ROW_CHUNK × d·n_bins (0.94 GB at 28 features × 32 bins)
ROW_CHUNK = 1 << 17


def _by_column(fn, n_cols: int) -> list:
    """``[fn(j) for j in range(n_cols)]`` on a thread pool: numpy's
    partition and search release the GIL, so the columns bin in parallel
    (a column's result is the same as in the serial loop)."""
    workers = max(1, min(n_cols, os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(fn, range(n_cols)))


def quantile_bins(
    x: np.ndarray, n_bins: int = 32
) -> Tuple[np.ndarray, np.ndarray]:
    """(binned int32 (n,d), edges (d, n_bins−1)): per-feature quantile
    binning on host (one pass over the data, done once per fit). The JAX
    package's ``np.quantile(x, qs, axis=0)``, taken a column at a time:
    the same edges bit for bit."""
    x = np.asarray(x, dtype=np.float64)
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    edges = np.stack(_by_column(lambda j: np.quantile(x[:, j], qs),
                                x.shape[1])).reshape(x.shape[1], len(qs))
    return apply_bin_edges(x, edges), edges


def apply_bin_edges(x: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Bin rows with fitted edges — the ONE binning implementation shared
    by fit and predict (side='right': bin b ⇔ edges[b−1] < v ≤ edges[b])."""
    x = np.asarray(x, dtype=np.float64)
    binned = np.empty(x.shape, dtype=np.int32)

    def one(j):
        binned[:, j] = np.searchsorted(edges[j], x[:, j], side="right")

    _by_column(one, x.shape[1])
    return binned


class TreeEnsemble(NamedTuple):
    """Complete-binary-tree ensemble, all arrays (trees, 2**depth − 1 …).

    ``feature``/``threshold`` index internal nodes in level order;
    ``leaf_value`` holds 2**depth leaves per tree (regression: mean;
    classification: per-class probabilities with an extra trailing axis).
    Host numpy arrays in a model, tensors inside a fit.
    """

    feature: np.ndarray     # (T, n_internal) int32
    threshold: np.ndarray   # (T, n_internal) int32 (bin id; go right if >)
    leaf_value: np.ndarray  # (T, n_leaves) or (T, n_leaves, n_classes)


def channel_histograms(node: torch.Tensor, n_nodes: int,
                       binned: torch.Tensor, channels: torch.Tensor,
                       n_bins: int, dtype=None) -> torch.Tensor:
    """H[t, c, k, j·n_bins + b] = Σ_s [node[t, s] = k]·[binned[s, j] = b]
    · channels[t, s, c], for T trees at once.

    ``node`` (T, n) int64 local node ids in [0, n_nodes); ``binned`` (n, d)
    ints in [0, n_bins); ``channels`` (T, n, C). Taken in float64 over
    row blocks of ``ROW_CHUNK`` (each block one GEMM, the blocks summed in
    order) and returned as float64, or rounded once to ``dtype``."""
    n_trees, n, n_ch = channels.shape
    d = binned.shape[1]
    device = channels.device
    f64 = torch.float64
    width = d * n_bins
    offsets = torch.arange(d, device=device, dtype=torch.int64) * n_bins
    h = torch.zeros((n_trees * n_nodes * n_ch, width), dtype=f64,
                    device=device)
    for start in range(0, n, ROW_CHUNK):
        stop = min(n, start + ROW_CHUNK)
        rows = stop - start
        # (rows, T, nodes, C): each row's channels in its node's slot
        a = torch.zeros((rows, n_trees, n_nodes, n_ch), dtype=f64,
                        device=device)
        slot = node[:, start:stop].t().reshape(rows, n_trees, 1, 1)
        a.scatter_(2, slot.expand(rows, n_trees, 1, n_ch),
                   channels[:, start:stop].to(f64).transpose(0, 1)
                   .unsqueeze(2))
        b = torch.zeros((rows, width), dtype=f64, device=device)
        b.scatter_(1, binned[start:stop].long() + offsets, 1.0)
        h.addmm_(a.view(rows, -1).t(), b)
        del a, b
    h = h.view(n_trees, n_nodes, n_ch, width).transpose(1, 2)
    return h if dtype is None else h.to(dtype)


def variance_gain_fn(h_l, h_t):
    """Regression split criterion from (count, Σy, Σy²) channel
    histograms: gain = SSE(parent) − SSE(left) − SSE(right)."""

    def sse(h):
        c, s, q = h[0], h[1], h[2]
        return q - (s * s) / torch.clamp_min(c, 1e-12)

    return sse(h_t) - sse(h_l) - sse(h_t - h_l)


def gini_gain_fn(h_l, h_t):
    """Classification split criterion from per-class weighted-count
    channel histograms: Gini impurity mass reduction."""

    def gini_mass(h):  # Σ n·gini = n − Σ_k n_k²/n
        total = torch.sum(h, dim=0)
        return total - torch.sum(h * h, dim=0) / torch.clamp_min(total,
                                                                 1e-12)

    return gini_mass(h_t) - gini_mass(h_l) - gini_mass(h_t - h_l)


def level_split(
    h, gain_fn, count_channel_slice, feat_mask_level, min_leaf, n_bins
):
    """Split selection for ONE level from its fully-reduced channel
    histograms ``h`` (C, …, nodes, d, bins), any batch axes between the
    channel and node axes (``feat_mask_level`` (…, d) matches them):
    cumulative-sum scan over bins, validity masking, first-maximum argmax
    over (feature, bin) per node. Returns (best_feature, best_threshold,
    kept_gain); no-positive-gain nodes become pass-through (threshold =
    n_bins routes every sample LEFT)."""
    n_nodes, d = h.shape[-3], h.shape[-2]
    h_l = torch.cumsum(h, dim=-1)  # stats of LEFT child if split at bin b
    h_t = h_l[..., -1:]
    gain = gain_fn(h_l, h_t)
    c_l = h_l[count_channel_slice].sum(dim=0)
    c_t = h_t[count_channel_slice].sum(dim=0)
    valid = (c_l >= min_leaf) & (c_t - c_l >= min_leaf)
    valid &= (torch.as_tensor(feat_mask_level, device=h.device) > 0)[
        ..., None, :, None]
    gain = torch.where(valid, gain,
                       torch.full((), float("-inf"), dtype=gain.dtype,
                                  device=gain.device))
    flat = gain.reshape(*gain.shape[:-3], n_nodes, d * n_bins)
    best = torch.argmax(flat, dim=-1)
    best_gain = torch.gather(flat, -1, best[..., None])[..., 0]
    keep = best_gain > 1e-12
    bf = torch.where(keep, best // n_bins, 0).to(torch.int32)
    bt = torch.where(keep, best % n_bins, n_bins).to(torch.int32)
    kept = torch.where(keep, best_gain, torch.zeros_like(best_gain))
    return bf, bt, kept


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` (None: ``t`` itself). NCCL reduces only
    contiguous tensors, so a strided view is reduced as a contiguous
    copy, which is returned."""
    if group is None:
        return t
    import torch.distributed as dist

    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def _grow_trees(
    binned, channels, count_channel_slice, gain_fn, feat_mask,
    max_depth, n_bins, min_leaf, dtype, group=None,
):
    """Shared level-synchronous scaffold for T trees at once.

    ``channels`` (T, n, C): per-sample statistics to histogram.
    ``count_channel_slice``: channels summed to get sample counts.
    ``gain_fn(H_left, H_total) -> gain``: split criterion from the
    prefix-sum (left) and total histograms, both (C, T, nodes, d, B), in
    float64. ``feat_mask`` (T, max_depth, d). Returns (feature, threshold,
    each row's local leaf id (T, n), split gains), the gains rounded to
    ``dtype``.

    ``group``: rows sharded over a ``torch.distributed`` group; each
    level's float64 histogram is ``all_reduce``d over it — the ONLY
    collective a level needs.
    """
    n_trees, n, n_ch = channels.shape
    d = binned.shape[1]
    device = channels.device
    n_internal = 2 ** max_depth - 1
    feats = torch.zeros((n_trees, n_internal), dtype=torch.int32,
                        device=device)
    thrs = torch.full((n_trees, n_internal), n_bins, dtype=torch.int32,
                      device=device)
    gains = torch.zeros((n_trees, n_internal), dtype=dtype, device=device)
    node = torch.zeros((n_trees, n), dtype=torch.int64, device=device)
    for level in range(max_depth):
        n_nodes = 2 ** level
        base = n_nodes - 1  # level-order offset of this level's nodes
        h = _all_reduce(
            channel_histograms(node, n_nodes, binned, channels, n_bins),
            group)
        h = h.view(n_trees, n_ch, n_nodes, d, n_bins).transpose(0, 1)
        bf, bt, kept = level_split(
            h, gain_fn, count_channel_slice, feat_mask[:, level],
            min_leaf, n_bins,
        )
        feats[:, base:base + n_nodes] = bf
        thrs[:, base:base + n_nodes] = bt
        gains[:, base:base + n_nodes] = kept.to(dtype)
        x_bin = torch.gather(binned, 1,
                             torch.gather(bf, 1, node).long().t()).t()
        go_right = (x_bin > torch.gather(bt, 1, node)).long()
        node = node * 2 + go_right
    return feats, thrs, node, gains


def _leaf_sums(leaf_ids, n_leaves, binned_rows, values):
    """Σ_s [leaf_ids[t, s] = k]·values[t, s, c] in float64: (T, C,
    n_leaves) — the histogram contraction with one bin."""
    zeros = torch.zeros((binned_rows, 1), dtype=torch.int32,
                        device=values.device)
    return channel_histograms(leaf_ids, n_leaves, zeros, values, 1)[..., 0]


def grow_trees_regression_batch(
    binned: torch.Tensor,           # (n, d) int bins
    y: torch.Tensor,                # (n,)
    w_batch: torch.Tensor,          # (T, n) per-tree bootstrap weights
    feat_mask_batch: torch.Tensor,  # (T, max_depth, d)
    max_depth: int,
    n_bins: int,
    min_leaf: int = 1,
    group=None,
    return_leaf_ids: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """T regression trees in one pass per level; returns (feature,
    threshold, leaf_value, split_gains) — plus each row's leaf id when
    ``return_leaf_ids`` — each with a leading tree axis. The fit's dtype
    is ``y``'s.

    Split criterion: weighted variance reduction from the (count, Σy, Σy²)
    channel histograms, which are taken in float64 from ``y`` and the
    weights. Leaves: Σw·y / Σw per leaf in float64, rounded once to the
    fit's dtype; empty leaves take the global weighted mean.
    ``group``: rows sharded over a ``torch.distributed`` group."""
    dtype = y.dtype
    n = binned.shape[0]
    y64 = y.to(torch.float64)
    w64 = w_batch.to(torch.float64)
    wy = w64 * y64
    channels = torch.stack([w64, wy, wy * y64], dim=2)
    feats, thrs, leaf_ids, gains = _grow_trees(
        binned, channels, slice(0, 1), variance_gain_fn, feat_mask_batch,
        max_depth, n_bins, min_leaf, dtype, group,
    )
    n_trees = channels.shape[0]
    sums = _leaf_sums(leaf_ids, 2 ** max_depth, n, channels[..., :2])
    packed = _all_reduce(torch.cat(
        [sums.reshape(n_trees, -1), w64.sum(1, keepdim=True),
         wy.sum(1, keepdim=True)], dim=1), group)
    cnt = packed[:, :2 ** max_depth]
    tot = packed[:, 2 ** max_depth:2 ** (max_depth + 1)]
    # empty leaves fall back to the global weighted mean
    gmean = packed[:, -1:] / torch.clamp_min(packed[:, -2:-1], 1e-12)
    leaf = torch.where(cnt > 0, tot / torch.clamp_min(cnt, 1e-12),
                       gmean).to(dtype)
    if return_leaf_ids:
        return feats, thrs, leaf, gains, leaf_ids
    return feats, thrs, leaf, gains


def grow_trees_classification_batch(
    binned: torch.Tensor,           # (n, d) shared across trees
    y_onehot: torch.Tensor,         # (n, C) shared
    w_batch: torch.Tensor,          # (T, n) per-tree bootstrap weights
    feat_mask_batch: torch.Tensor,  # (T, max_depth, d)
    max_depth: int,
    n_bins: int,
    n_classes: int,
    min_leaf: int = 1,
    group=None,
) -> Tuple[torch.Tensor, ...]:
    """T classification trees (Gini impurity) in one pass per level;
    leaves are per-class probability vectors (T, leaves, C), plus each
    split's realized gain. The fit's dtype is ``y_onehot``'s; the class
    counts and probabilities are taken in float64 and rounded once."""
    dtype = y_onehot.dtype
    n = binned.shape[0]
    channels = (y_onehot.to(torch.float64)[None]
                * w_batch.to(torch.float64)[:, :, None])
    feats, thrs, leaf_ids, gains = _grow_trees(
        binned, channels, slice(0, n_classes), gini_gain_fn,
        feat_mask_batch, max_depth, n_bins, min_leaf, dtype, group,
    )
    n_trees = channels.shape[0]
    n_leaves = 2 ** max_depth
    cls_cnt = _leaf_sums(leaf_ids, n_leaves, n, channels)  # (T, C, leaves)
    packed = _all_reduce(torch.cat(
        [cls_cnt.reshape(n_trees, -1), channels.sum(1)], dim=1), group)
    cls_cnt = packed[:, :n_classes * n_leaves] \
        .view(n_trees, n_classes, n_leaves).transpose(1, 2)
    prior = packed[:, n_classes * n_leaves:]
    tot = torch.sum(cls_cnt, dim=2, keepdim=True)
    prior = prior / torch.clamp_min(torch.sum(prior, dim=1, keepdim=True),
                                    1e-12)
    proba = torch.where(tot > 0, cls_cnt / torch.clamp_min(tot, 1e-12),
                        prior[:, None, :]).to(dtype)
    return feats, thrs, proba, gains


def grow_tree_regression(
    binned: torch.Tensor,     # (n, d) int bins
    y: torch.Tensor,          # (n,)
    w: torch.Tensor,          # (n,) bootstrap weights (Poisson)
    feat_mask: torch.Tensor,  # (max_depth, d) 0/1 per-level subsample
    max_depth: int,
    n_bins: int,
    min_leaf: int = 1,
    group=None,
    return_leaf_ids: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """One regression tree; returns (feature, threshold, leaf_value,
    split_gains) — plus each row's leaf id when ``return_leaf_ids``
    (boosting callers need the assignment the grower already computed).
    ``split_gains`` holds each internal node's realized criterion gain (0
    at pass-through nodes), the accumulation behind featureImportances."""
    out = grow_trees_regression_batch(
        binned, y, w[None], torch.as_tensor(feat_mask)[None], max_depth,
        n_bins, min_leaf, group, return_leaf_ids)
    return tuple(t[0] for t in out)


def grow_tree_classification(
    binned: torch.Tensor,
    y_onehot: torch.Tensor,  # (n, n_classes)
    w: torch.Tensor,
    feat_mask: torch.Tensor,
    max_depth: int,
    n_bins: int,
    n_classes: int,
    min_leaf: int = 1,
    group=None,
) -> Tuple[torch.Tensor, ...]:
    """One classification tree (Gini impurity); leaves are per-class
    probability vectors, plus each split's realized gain."""
    out = grow_trees_classification_batch(
        binned, y_onehot, w[None], torch.as_tensor(feat_mask)[None],
        max_depth, n_bins, n_classes, min_leaf, group)
    return tuple(t[0] for t in out)


def route_to_leaves(
    binned: torch.Tensor,
    feature: torch.Tensor,
    threshold: torch.Tensor,
    max_depth: int,
) -> torch.Tensor:
    """Leaf index (0..2**depth−1) of every row under ONE tree: one gather
    and compare per level, in the JAX package's level-order arithmetic.
    Shared by ensemble apply and the boosting leaf refit."""
    node = torch.zeros((binned.shape[0],), dtype=torch.int64,
                       device=binned.device)
    feature = feature.long()
    for level in range(max_depth):
        base = 2 ** level - 1
        f = feature[node]
        t = threshold[node]
        x_bin = torch.gather(binned, 1, f[:, None])[:, 0]
        go_right = (x_bin > t).long()
        node = (node - base) * 2 + go_right + (2 ** (level + 1) - 1)
    return node - (2 ** max_depth - 1)


def forest_apply(
    binned: torch.Tensor, ensemble: TreeEnsemble, max_depth: int
) -> torch.Tensor:
    """Route every row through every tree; leaf values averaged over
    trees (``ensemble`` holds tensors on ``binned``'s device)."""
    per_tree = torch.stack([
        leaf_value[route_to_leaves(binned, feature, threshold, max_depth)]
        for feature, threshold, leaf_value in zip(
            ensemble.feature, ensemble.threshold, ensemble.leaf_value)
    ])  # (T, n) or (T, n, C)
    return torch.mean(per_tree, dim=0)


def feature_importances(features, gains, n_features: int):
    """Split-gain feature importances, Spark's convention: per tree, sum
    each internal node's realized gain onto its split feature and
    normalize the tree to 1; average the trees; normalize again. Host
    NumPy — runs once per fit on tiny (trees, nodes) arrays."""
    features = np.asarray(features)
    gains = np.asarray(gains, dtype=np.float64)
    if features.ndim == 1:
        features = features[None, :]
        gains = gains[None, :]
    total = np.zeros(n_features)
    for f_tree, g_tree in zip(features, gains):
        per = np.bincount(
            f_tree, weights=np.maximum(g_tree, 0.0), minlength=n_features
        )
        tree_sum = per.sum()
        if tree_sum > 0:
            total += per / tree_sum
    grand = total.sum()
    return total / grand if grand > 0 else total


def route_to_level_np(
    binned: np.ndarray,
    feature: np.ndarray,
    threshold: np.ndarray,
    level: int,
) -> np.ndarray:
    """Each row's LOCAL node index at ``level`` under a partial tree —
    the NumPy mirror of the per-level routing rule
    ``node ← 2·node + (x_bin > threshold)`` (a copy of the JAX package's
    ``spark/forest_plane.py::route_to_level_np``; GBT's validation hook
    routes held-out rows with it)."""
    n = binned.shape[0]
    node = np.zeros(n, dtype=np.int64)  # absolute level-order index
    rows = np.arange(n)
    for lvl in range(level):
        f = feature[node]
        t = threshold[node]
        x_bin = binned[rows, f]
        base = 2 ** lvl - 1
        node = (node - base) * 2 + (x_bin > t) + (2 ** (lvl + 1) - 1)
    return node - (2 ** level - 1)
