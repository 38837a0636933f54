"""Executor-side statistics plane for tree ensembles (RF and GBT).

The reference's defining architecture is per-partition accelerator compute
on executors with tiny additive partials flowing to one reduce
(``RapidsRowMatrix.scala:168-202`` — partitions produce n×n Gram partials,
the driver sums). Histogram trees have exactly that shape per level: each
partition bins ITS rows, routes them through the tree-so-far, and emits a
(channels, nodes, features, bins) statistics tensor; the driver (or a
collective) sums the partials and runs split selection — rows never move.
These are the partition tasks of that plane (host NumPy float64; the
card's contraction is ``spark/device_aggregate.py``); the per-level driver
loop lives in ``spark/forest_estimator.py``, and split selection is the
SAME ``ops.forest_kernel.level_split`` the local and distributed growers
run, so the three fits can never diverge.

The port's copy of the JAX package's ``spark/forest_plane.py``: the same
NumPy operations in the same order, so every partial is bit-equal to the
JAX package's on the same batches. ``route_to_level_np`` is the one in
``ops/forest_kernel.py``. Everything here imports without pyspark, pandas
or pyarrow: the partition functions take Arrow batches or plain (x, y)
tuples and yield plain row dicts; only the Arrow schemas import pyarrow,
when a real ``mapInArrow`` asks for them.

Determinism: bootstrap weights are drawn from
``default_rng([seed, tree, partition_id])`` and streamed across a
partition's batches in row order — every per-level job regenerates the
identical weights for its partition, so the histogram jobs of one tree
all see one consistent bootstrap (requires a ``persist()``-stable
partitioning, which the estimator enforces).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from spark_rapids_ml_tpu_torch.ops.forest_kernel import (
    apply_bin_edges,
    route_to_level_np,
)
from spark_rapids_ml_tpu_torch.spark.aggregate import vector_column_to_matrix
from spark_rapids_ml_tpu_torch.utils.numeric import sigmoid as _sigmoid


# --------------------------------------------------------------------------
# task identity + batch access
# --------------------------------------------------------------------------

def partition_identity() -> int:
    """This task's partition id: pyspark's TaskContext when running under
    real Spark, the local engine's exported env otherwise (same facts the
    barrier plane reads, ``spark/device_aggregate.py``)."""
    try:  # pragma: no cover - pyspark environments
        from pyspark import TaskContext

        ctx = TaskContext.get()
        if ctx is not None:
            return int(ctx.partitionId())
    except ImportError:
        pass
    return int(os.environ.get("LOCALSPARK_PARTITION_ID", 0))


def _batch_xy(batch, features_col: str, label_col: str):
    """(x float64 (n,d), y float64 (n,)) from one Arrow batch (or a plain
    (x, y) tuple in direct tests)."""
    if hasattr(batch, "column"):
        x = vector_column_to_matrix(batch.column(features_col))
        y = np.asarray(
            batch.column(label_col).to_pylist(), dtype=np.float64
        )
    else:
        x, y = batch
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64).reshape(-1)
    return x, y


def _batch_weights(batch, weight_col: Optional[str], n: int):
    """Validated per-row weightCol values for one batch (None when the
    fit is unweighted or the batch is a plain test tuple)."""
    if not weight_col or not hasattr(batch, "column"):
        return None
    w = np.asarray(
        batch.column(weight_col).to_pylist(), dtype=np.float64
    ).reshape(-1)
    if w.shape[0] != n:
        raise ValueError(
            f"weight column length {w.shape[0]} != batch rows {n}"
        )
    if not np.isfinite(w).all() or (w < 0).any():
        raise ValueError("weights must be finite and non-negative")
    return w


# --------------------------------------------------------------------------
# pass 1: per-partition row sample (bin edges) + label facts
# --------------------------------------------------------------------------

def sample_cap_rows(d: int, n_partitions: int) -> int:
    """Per-partition sample-row cap: bounded by a ~1M-element per-partition
    payload (wide features shrink the row cap) and a 128k-row total-budget
    share, floored at 256 rows for quantile quality. The floor can exceed
    the total budget on many-partition fits — ``sample_partition_stride``
    then thins WHICH partitions emit sample rows, so the driver merge
    stays ≤ ~64 MB no matter what (Spark ML's findSplits samples with the
    same total-budget shape)."""
    return max(
        256,
        min(8192, (1 << 20) // max(d, 1), 131072 // max(n_partitions, 1)),
    )


def sample_partition_stride(cap: int, d: int, n_partitions: int) -> int:
    """Stride between sampling partitions in pass 1 (all partitions still
    contribute counts/labels; every stride-th contributes sample ROWS):
    chosen so the total sample payload stays under ~64 MB f64. A STRIDE —
    not a prefix — so partition-ordered/clustered data still yields bin
    edges from across the whole dataset, and a run of empty leading
    partitions can't starve the sample."""
    budget_elems = 1 << 23
    n_sampling = int(np.clip(
        budget_elems // max(cap * d, 1), 1, n_partitions
    ))
    # ceil division: floor would admit up to ~2x n_sampling emitters
    # (e.g. 15 partitions / 8 budgeted -> stride 1 = all 15), breaking
    # the 64 MB driver-merge bound
    return -(-n_partitions // n_sampling)


def partition_forest_sample(
    batches: Iterable,
    features_col: str,
    label_col: str,
    seed: int,
    cap: int = 8192,
    sample_stride: int = 1,
    weight_col: Optional[str] = None,
) -> Iterator[Dict[str, object]]:
    """One row per partition: a ≤``cap``-row uniform sample of (x, y) for
    driver-side quantile-bin fitting, plus the partition's row count,
    label sum, and distinct labels (≤101 retained — enough to detect both
    a class set and a continuous target). One cheap pass, the analogue of
    Spark ML's sampled ``findSplits``; callers size ``cap`` with
    ``sample_cap_rows`` and ``sample_stride`` with
    ``sample_partition_stride`` — only every stride-th partition
    contributes sample ROWS (counts/labels flow from all), bounding the
    driver merge without biasing toward a partition prefix."""
    pid = partition_identity()
    emit_sample = pid % max(sample_stride, 1) == 0
    rng = np.random.default_rng([seed & 0x7FFFFFFF, pid])
    buf_x: List[np.ndarray] = []
    buf_y: List[np.ndarray] = []
    buffered = 0
    n_seen = 0
    y_sum = 0.0
    w_sum = 0.0
    labels: set = set()
    for batch in batches:
        x, y = _batch_xy(batch, features_col, label_col)
        if x.shape[0] == 0:
            continue
        if not np.isfinite(y).all():
            raise ValueError("labels must be finite")
        n_seen += x.shape[0]
        w_user = _batch_weights(batch, weight_col, x.shape[0])
        if w_user is None:
            y_sum += float(y.sum())
            w_sum += float(x.shape[0])
        else:
            # weighted label mean for the GBT init margin
            y_sum += float((w_user * y).sum())
            w_sum += float(w_user.sum())
        if len(labels) <= 101:
            labels.update(np.unique(y).tolist())
        # approximately-uniform vectorized sampling: buffer whole batches,
        # random-downsample to 4·cap whenever the buffer overflows, take
        # cap at the end (exact uniformity doesn't matter for quantile
        # edges; per-row reservoir updates would be Python-loop slow)
        if emit_sample:
            buf_x.append(x)
            buf_y.append(y)
            buffered += x.shape[0]
            if buffered > 4 * cap:
                xa = np.concatenate(buf_x)
                ya = np.concatenate(buf_y)
                keep = rng.choice(xa.shape[0], 4 * cap, replace=False)
                buf_x, buf_y = [xa[keep]], [ya[keep]]
                buffered = 4 * cap
        else:
            d_seen = x.shape[1]
    if n_seen == 0:
        return
    if emit_sample:
        xa = np.concatenate(buf_x)
        ya = np.concatenate(buf_y)
        if xa.shape[0] > cap:
            keep = rng.choice(xa.shape[0], cap, replace=False)
            xa, ya = xa[keep], ya[keep]
        sample_x = xa.ravel().tolist()
        sample_y = ya.tolist()
        d = int(xa.shape[1])
    else:
        sample_x = []
        sample_y = []
        d = int(d_seen)
    yield {
        "n": n_seen,
        "y_sum": y_sum,
        "w_sum": w_sum,
        "labels": sorted(labels)[:102],
        "sample_x": sample_x,
        "sample_y": sample_y,
        "d": d,
    }


def sample_arrow_schema():
    import pyarrow as pa

    return pa.schema([
        ("n", pa.int64()),
        ("y_sum", pa.float64()),
        ("w_sum", pa.float64()),
        ("labels", pa.list_(pa.float64())),
        ("sample_x", pa.list_(pa.float64())),
        ("sample_y", pa.list_(pa.float64())),
        ("d", pa.int64()),
    ])


def sample_spark_ddl() -> str:
    return ("n long, y_sum double, w_sum double, labels array<double>, "
            "sample_x array<double>, sample_y array<double>, d long")


# --------------------------------------------------------------------------
# routing + histogramming (shared by RF and GBT partition tasks)
# --------------------------------------------------------------------------

def histogram_channels_np(
    local_node: np.ndarray,
    binned: np.ndarray,
    channels: np.ndarray,
    n_nodes: int,
    n_bins: int,
) -> np.ndarray:
    """H[c, node·d·B + j·B + b] — the partition's additive partial of the
    (C, nodes, d, bins) statistics tensor, via one ``bincount`` per
    channel over a combined index (C-speed scatter-add on host)."""
    n, d = binned.shape
    idx = (
        (local_node[:, None] * d + np.arange(d)[None, :]) * n_bins + binned
    ).ravel()
    size = n_nodes * d * n_bins
    out = np.empty((channels.shape[1], size))
    for c in range(channels.shape[1]):
        out[c] = np.bincount(
            idx, weights=np.repeat(channels[:, c], d), minlength=size
        )
    return out


def _tree_weight_stream(rate: float, seed: int, tree: int, pid: int,
                        always_poisson: bool, bootstrap: bool = True):
    """Per-(tree, partition) bootstrap-weight generator, streamed across
    batches in row order. RF always draws Poisson(rate) (rate-sized
    bootstrap); GBT follows Spark's convention that rate ≥ 1.0 means NO
    subsampling (unit weights). ``bootstrap=False`` (DecisionTree's
    single-tree contract) forces unit weights unconditionally — the gate
    lives HERE so no caller can forget it and silently re-enable
    Poisson resampling for a deterministic family."""
    if not bootstrap:
        return None  # unit weights, deterministic fit
    if not always_poisson and rate >= 1.0:
        return None  # unit weights
    return np.random.default_rng(
        [seed & 0x7FFFFFFF, tree, pid]
    )


def _draw_weights(stream, rate: float, n: int) -> np.ndarray:
    if stream is None:
        return np.ones(n)
    return stream.poisson(rate, n).astype(np.float64)


# --------------------------------------------------------------------------
# RF: per-level histogram partials + leaf partials
# --------------------------------------------------------------------------

def partition_forest_histograms(
    batches: Iterable,
    features_col: str,
    label_col: str,
    spec: Dict,
) -> Iterator[Dict[str, object]]:
    """One row per tree in the group: this partition's summed
    (C, nodes, d, bins) histogram partial for the spec'd level.

    ``spec`` (driver-broadcast, all small): edges (d, B−1), n_bins,
    level, subsampling_rate, seed, classes (None for regression),
    trees: [{tree, feature (n_int,), threshold (n_int,)}].
    """
    edges = np.asarray(spec["edges"])
    n_bins = int(spec["n_bins"])
    level = int(spec["level"])
    rate = float(spec["subsampling_rate"])
    seed = int(spec["seed"])
    classes = spec.get("classes")
    trees: Sequence[Dict] = spec["trees"]
    pid = partition_identity()
    n_nodes = 2 ** level
    d = edges.shape[0]
    n_ch = 3 if classes is None else len(classes)

    streams = [
        _tree_weight_stream(rate, seed, int(t["tree"]), pid,
                            always_poisson=True,
                            bootstrap=bool(spec.get("bootstrap", True)))
        for t in trees
    ]
    hists = [
        np.zeros((n_ch, n_nodes * d * n_bins)) for _ in trees
    ]
    seen = False
    for batch in batches:
        x, y = _batch_xy(batch, features_col, label_col)
        if x.shape[0] == 0:
            continue
        seen = True
        w_user = _batch_weights(batch, spec.get("weight_col"), x.shape[0])
        binned = apply_bin_edges(x, edges)
        if classes is not None:
            y_idx = np.searchsorted(np.asarray(classes), y)
            onehot = np.eye(len(classes))[y_idx]
        for ti, t in enumerate(trees):
            w = _draw_weights(streams[ti], rate, x.shape[0])
            if w_user is not None:
                w = w * w_user
            if classes is None:
                channels = np.stack([w, w * y, w * y * y], axis=1)
            else:
                channels = onehot * w[:, None]
            local = route_to_level_np(
                binned, np.asarray(t["feature"]),
                np.asarray(t["threshold"]), level,
            )
            hists[ti] += histogram_channels_np(
                local, binned, channels, n_nodes, n_bins
            )
    if not seen:
        return
    for ti, t in enumerate(trees):
        yield {"tree": int(t["tree"]), "hist": hists[ti].ravel().tolist()}


def partition_forest_leaf_stats(
    batches: Iterable,
    features_col: str,
    label_col: str,
    spec: Dict,
) -> Iterator[Dict[str, object]]:
    """One row per tree: per-leaf channel sums under the COMPLETE tree
    (depth-level routing) — regression (Σw, Σw·y) + global sums for the
    empty-leaf fallback; classification per-class weighted counts."""
    edges = np.asarray(spec["edges"])
    depth = int(spec["depth"])
    rate = float(spec["subsampling_rate"])
    seed = int(spec["seed"])
    classes = spec.get("classes")
    trees: Sequence[Dict] = spec["trees"]
    pid = partition_identity()
    n_leaves = 2 ** depth
    n_ch = 2 if classes is None else len(classes)

    streams = [
        _tree_weight_stream(rate, seed, int(t["tree"]), pid,
                            always_poisson=True,
                            bootstrap=bool(spec.get("bootstrap", True)))
        for t in trees
    ]
    stats = [np.zeros((n_ch, n_leaves)) for _ in trees]
    seen = False
    for batch in batches:
        x, y = _batch_xy(batch, features_col, label_col)
        if x.shape[0] == 0:
            continue
        seen = True
        w_user = _batch_weights(batch, spec.get("weight_col"), x.shape[0])
        binned = apply_bin_edges(x, edges)
        if classes is not None:
            y_idx = np.searchsorted(np.asarray(classes), y)
            onehot = np.eye(len(classes))[y_idx]
        for ti, t in enumerate(trees):
            w = _draw_weights(streams[ti], rate, x.shape[0])
            if w_user is not None:
                w = w * w_user
            leaf = route_to_level_np(
                binned, np.asarray(t["feature"]),
                np.asarray(t["threshold"]), depth,
            )
            if classes is None:
                stats[ti][0] += np.bincount(
                    leaf, weights=w, minlength=n_leaves
                )
                stats[ti][1] += np.bincount(
                    leaf, weights=w * y, minlength=n_leaves
                )
            else:
                for c in range(n_ch):
                    stats[ti][c] += np.bincount(
                        leaf, weights=w * onehot[:, c],
                        minlength=n_leaves,
                    )
    if not seen:
        return
    for ti, t in enumerate(trees):
        yield {"tree": int(t["tree"]), "hist": stats[ti].ravel().tolist()}


def hist_arrow_schema():
    import pyarrow as pa

    return pa.schema([
        ("tree", pa.int64()),
        ("hist", pa.list_(pa.float64())),
    ])


def hist_spark_ddl() -> str:
    return "tree long, hist array<double>"


def combine_hist_rows(rows, n_elems: int) -> Dict[int, np.ndarray]:
    """Sum the per-partition partials into one flat histogram per tree —
    the driver-side reduce (associative adds of tiny tensors, the same
    shape as ``combine_stats`` for PCA)."""
    out: Dict[int, np.ndarray] = {}
    for r in rows:
        t = int(r["tree"])
        h = np.asarray(r["hist"], dtype=np.float64)
        if h.shape[0] != n_elems:
            raise ValueError(
                f"histogram partial for tree {t} has {h.shape[0]} elems, "
                f"expected {n_elems}"
            )
        if t in out:
            out[t] += h
        else:
            out[t] = h
    return out


# --------------------------------------------------------------------------
# GBT: residual histograms + Newton leaf partials
# --------------------------------------------------------------------------

def _gbt_margin(
    binned: np.ndarray,
    ens_feature: Optional[np.ndarray],
    ens_threshold: Optional[np.ndarray],
    ens_leaf: Optional[np.ndarray],
    init: float,
    step: float,
    depth: int,
) -> np.ndarray:
    """F(x) = init + step·Σ_m leaf_m[route_m(x)] under the prior trees —
    recomputed per partition task from the broadcast ensemble (stateless
    executors hold no per-row margin cache; routing m trees costs
    m·depth vectorized gathers)."""
    n = binned.shape[0]
    f = np.full(n, float(init))
    if ens_feature is None or len(ens_feature) == 0:
        return f
    for m in range(len(ens_feature)):
        leaf = route_to_level_np(
            binned, ens_feature[m], ens_threshold[m], depth
        )
        f += step * np.asarray(ens_leaf[m])[leaf]
    return f


def _gbt_residual_hess(y, f, classification: bool):
    if classification:
        p = _sigmoid(f)
        return y - p, np.maximum(p * (1.0 - p), 1e-12)
    return y - f, np.ones_like(f)


def partition_gbt_histograms(
    batches: Iterable,
    features_col: str,
    label_col: str,
    spec: Dict,
) -> Iterator[Dict[str, object]]:
    """One row: this partition's (3, nodes, d, bins) variance-channel
    histogram of the CURRENT tree's level, computed on boosting residuals
    r = y − F (regression) or y − σ(F) (logistic). ``spec`` adds to the
    RF spec: init, step_size, classification, the prior ensemble
    (ens_feature/ens_threshold/ens_leaf), and the current partial tree
    (feature/threshold)."""
    edges = np.asarray(spec["edges"])
    n_bins = int(spec["n_bins"])
    level = int(spec["level"])
    depth = int(spec["depth"])
    rate = float(spec["subsampling_rate"])
    seed = int(spec["seed"])
    tree_idx = int(spec["tree"])
    pid = partition_identity()
    n_nodes = 2 ** level
    d = edges.shape[0]

    stream = _tree_weight_stream(rate, seed, tree_idx, pid,
                                 always_poisson=False)
    hist = np.zeros((3, n_nodes * d * n_bins))
    seen = False
    for batch in batches:
        x, y = _batch_xy(batch, features_col, label_col)
        if x.shape[0] == 0:
            continue
        seen = True
        binned = apply_bin_edges(x, edges)
        f = _gbt_margin(
            binned, spec.get("ens_feature"), spec.get("ens_threshold"),
            spec.get("ens_leaf"), spec["init"], spec["step_size"], depth,
        )
        r, _ = _gbt_residual_hess(y, f, bool(spec["classification"]))
        w = _draw_weights(stream, rate, x.shape[0])
        w_user = _batch_weights(batch, spec.get("weight_col"), x.shape[0])
        if w_user is not None:
            w = w * w_user
        channels = np.stack([w, w * r, w * r * r], axis=1)
        local = route_to_level_np(
            binned, np.asarray(spec["feature"]),
            np.asarray(spec["threshold"]), level,
        )
        hist += histogram_channels_np(
            local, binned, channels, n_nodes, n_bins
        )
    if not seen:
        return
    yield {"tree": tree_idx, "hist": hist.ravel().tolist()}


def partition_gbt_leaf_stats(
    batches: Iterable,
    features_col: str,
    label_col: str,
    spec: Dict,
) -> Iterator[Dict[str, object]]:
    """One row: per-leaf (Σw, Σw·r, Σw·h) under the COMPLETED current
    tree — squared-loss leaves are Σw·r/Σw; classification leaves get
    the one-step Newton refit Σw·r/Σw·h on the driver (the same formula
    ``models.gbt.boosting_loop`` applies locally)."""
    edges = np.asarray(spec["edges"])
    depth = int(spec["depth"])
    rate = float(spec["subsampling_rate"])
    seed = int(spec["seed"])
    tree_idx = int(spec["tree"])
    pid = partition_identity()
    n_leaves = 2 ** depth

    stream = _tree_weight_stream(rate, seed, tree_idx, pid,
                                 always_poisson=False)
    stats = np.zeros((3, n_leaves))
    seen = False
    for batch in batches:
        x, y = _batch_xy(batch, features_col, label_col)
        if x.shape[0] == 0:
            continue
        seen = True
        binned = apply_bin_edges(x, edges)
        f = _gbt_margin(
            binned, spec.get("ens_feature"), spec.get("ens_threshold"),
            spec.get("ens_leaf"), spec["init"], spec["step_size"], depth,
        )
        r, h = _gbt_residual_hess(y, f, bool(spec["classification"]))
        w = _draw_weights(stream, rate, x.shape[0])
        w_user = _batch_weights(batch, spec.get("weight_col"), x.shape[0])
        if w_user is not None:
            w = w * w_user
        leaf = route_to_level_np(
            binned, np.asarray(spec["feature"]),
            np.asarray(spec["threshold"]), depth,
        )
        stats[0] += np.bincount(leaf, weights=w, minlength=n_leaves)
        stats[1] += np.bincount(leaf, weights=w * r, minlength=n_leaves)
        stats[2] += np.bincount(leaf, weights=w * h, minlength=n_leaves)
    if not seen:
        return
    yield {"tree": tree_idx, "hist": stats.ravel().tolist()}


def quantile_sample_cap(d: int, n_partitions: int) -> int:
    """Per-partition row cap for the QUANTILE sampling planes
    (RobustScaler / median Imputer): unlike the tree-plane sampler, every
    partition must contribute (a skipped partition would bias the
    model-defining medians on partition-clustered data), so the budget is
    divided across ALL partitions instead of striding — small
    per-partition samples rather than skipped partitions."""
    budget_elems = 1 << 23
    return int(np.clip(
        budget_elems // max(d * n_partitions, 1), 16, 8192
    ))
