"""DataFrame tree fits on the executor statistics plane.

Replaces the generic adapter's driver-collect for RandomForest, GBT and
the DecisionTree estimators (Spark's single tree IS
``RandomForest.run(numTrees=1, all features, no bootstrap)``; the spec
carries ``bootstrap=False`` so the weight streams stay unit and the fit is
deterministic): the reference's architecture keeps rows on executors and
moves only additive partials (``RapidsRowMatrix.scala:168-202``);
histogram trees decompose the same way PER LEVEL — executors bin + route +
histogram their partitions (``spark/forest_plane.py`` on the host,
``spark/device_aggregate.py`` on the card), the driver sums the tiny
(C, nodes, features, bins) tensors and runs the SAME
``ops.forest_kernel.level_split`` selection the local and distributed
growers run, then broadcasts the split decisions into the next level's
job closure. The input DataFrame is ``persist()``-ed once; no driver ever
materializes rows.

Job count: RandomForest runs (maxDepth + 1) jobs per tree GROUP (trees
grown level-synchronously together, group size bounded so a partition's
histogram payload stays ≤ ~64 MB); GBT is sequential by nature —
maxIter × (maxDepth + 1) jobs, margins recomputed from the broadcast
prior ensemble (stateless executors, no per-row cache).

The classes subclass the adapter front-ends, so the param surface,
setters, persistence, and the transform path are IDENTICAL — only the
fit strategy changes.

The port's copy of the JAX package's ``spark/forest_estimator.py``.
Split selection runs on float64 tensors on the estimator's resolved
device (the CPU when it was requested, else the card). The partition
functions yield plain row dicts; a ``RecordBatch`` is built only inside
the job a real ``mapInArrow`` (pyspark's or the local engine's) runs. The
streamed fits' shim (``_StreamFrame``) collects the row dicts directly —
the dicts an Arrow round trip gives, key for key — so the streamed tree
fits need neither pyarrow nor pandas. ``PartitionFrame`` does the same
over partitions of numpy batches for every front end that collects its
jobs through ``_collect_rows`` (the moments plane's and NaiveBayes').
"""

from __future__ import annotations

import os

import numpy as np

from spark_rapids_ml_tpu_torch.spark import adapter as _adapter
from spark_rapids_ml_tpu_torch.spark import adapter2 as _adapter2
from spark_rapids_ml_tpu_torch.spark.forest_plane import (
    combine_hist_rows,
    hist_arrow_schema,
    hist_spark_ddl,
    partition_forest_histograms,
    partition_forest_leaf_stats,
    partition_forest_sample,
    partition_gbt_histograms,
    partition_gbt_leaf_stats,
    sample_arrow_schema,
    sample_cap_rows,
    sample_partition_stride,
    sample_spark_ddl,
)
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer

# the partition id the local engine exports to its executors
_PARTITION_ENV = "LOCALSPARK_PARTITION_ID"


def _group_budget_bytes(local_est=None) -> int:
    """One budget seam for tree groups everywhere — delegates to
    ``utils.resources.tree_group_budget_bytes`` (shared with the local
    forest fit)."""
    from spark_rapids_ml_tpu_torch.utils.resources import (
        tree_group_budget_bytes,
    )

    return tree_group_budget_bytes(local_est)


def _num_partitions(df) -> int:
    try:
        return int(df.rdd.getNumPartitions())
    except Exception:  # noqa: BLE001 - local engine
        pass
    try:
        return len(df._partitions)
    except Exception:  # noqa: BLE001
        return 8


def _collect_rows(df, rows_fn, schema_fn, ddl: str) -> list:
    """``rows_fn``'s row dicts over every partition of ``df``: the stream
    and partition shims collect them directly; any other frame runs them
    as a ``mapInArrow`` job that packs each row into a ``RecordBatch`` of
    ``schema_fn()`` on the executor."""
    if isinstance(df, (_StreamFrame, PartitionFrame)):
        return df.collect_rows(rows_fn)

    def job(batches):
        import pyarrow as pa

        schema = schema_fn()
        for row in rows_fn(batches):
            yield pa.RecordBatch.from_pylist([row], schema=schema)

    return df.mapInArrow(job, ddl).collect()


def _collect_sample(df, fcol, lcol, seed, wcol=None):
    """Pass 1: driver-side merge of the per-partition samples → (edges
    input sample, y stats, distinct labels, n, Σw, d). The per-partition
    cap shrinks with feature width and partition count
    (``forest_plane.sample_cap_rows``) so this merge — the ONLY data that
    ever reaches the driver — stays bounded at MBs."""
    first = df.first()
    if first is None:
        raise ValueError("empty dataset")
    width = len(first[0])
    n_parts = _num_partitions(df)
    cap = sample_cap_rows(width, n_parts)
    stride = sample_partition_stride(cap, width, n_parts)

    def rows_fn(batches):
        return partition_forest_sample(
            batches, fcol, lcol, seed, cap=cap, sample_stride=stride,
            weight_col=wcol,
        )

    rows = _collect_rows(df, rows_fn, sample_arrow_schema,
                         sample_spark_ddl())
    if not rows:
        raise ValueError("empty dataset")
    d = int(rows[0]["d"])
    xs, ys = [], []
    n_total = 0
    y_sum = 0.0
    w_sum = 0.0
    labels: set = set()
    for r in rows:
        if int(r["d"]) != d:
            raise ValueError(
                f"inconsistent feature dim across partitions: {r['d']} != {d}"
            )
        n_total += int(r["n"])
        y_sum += float(r["y_sum"])
        w_sum += float(r["w_sum"])
        labels.update(float(v) for v in r["labels"])
        if len(r["sample_x"]):  # non-sampling partitions send empty arrays
            xs.append(
                np.asarray(r["sample_x"], dtype=np.float64).reshape(-1, d)
            )
            ys.append(np.asarray(r["sample_y"], dtype=np.float64))
    if not xs:
        raise ValueError("no sampled rows (all sampling partitions empty)")
    return (
        np.concatenate(xs), np.concatenate(ys), n_total, y_sum, w_sum,
        sorted(labels), d,
    )


def _hist_job(df, partition_fn, fcol, lcol, spec, device_sel=None):
    """One per-level statistics job. ``device_sel`` = (device_partition_fn,
    executorDevice, deviceId): when given, the executor task runs the
    histogram contraction on its OWN card (auto/on) or the host f64 plane
    (off) — the same chooser the PCA/LogReg planes use."""
    if device_sel is not None:
        from spark_rapids_ml_tpu_torch.spark.estimator import (
            _select_stats_plane,
        )

        device_fn, executor_device, device_id = device_sel
        fn = _select_stats_plane(
            executor_device,
            lambda b, _s=spec: device_fn(b, fcol, lcol, _s, device_id),
            lambda b, _s=spec: partition_fn(b, fcol, lcol, _s),
        )
    else:
        def fn(b, _s=spec):
            return partition_fn(b, fcol, lcol, _s)

    return _collect_rows(df, fn, hist_arrow_schema, hist_spark_ddl())


def _level_split_np(h, classification, feat_mask_level, min_leaf, n_bins,
                    device):
    """Driver-side split selection: ``ops.forest_kernel.level_split`` over
    the executor-reduced histograms (tiny tensors), in float64 on
    ``device``. Returns (feature, threshold, kept gain) as numpy."""
    import torch

    from spark_rapids_ml_tpu_torch.ops.forest_kernel import (
        gini_gain_fn,
        level_split,
        variance_gain_fn,
    )

    n_ch = h.shape[0]
    gain_fn = gini_gain_fn if classification else variance_gain_fn
    ccs = slice(0, n_ch) if classification else slice(0, 1)
    bf, bt, kept = level_split(
        torch.as_tensor(h, dtype=torch.float64, device=device), gain_fn,
        ccs, torch.as_tensor(feat_mask_level, dtype=torch.float64,
                             device=device),
        min_leaf, n_bins,
    )
    return bf.cpu().numpy(), bt.cpu().numpy(), kept.cpu().numpy()


def _device_sel(local_est, device_fn):
    return (device_fn, local_est.getExecutorDevice(),
            int(local_est.getDeviceId()))


def _fit_forest_plane(local_est, dataset, classification):
    """Grow the whole forest level-synchronously over executor histogram
    partials; returns the fitted LOCAL model (same class the local fit
    produces, so transform/persistence are shared)."""
    from spark_rapids_ml_tpu_torch.models.random_forest import _subset_counts
    from spark_rapids_ml_tpu_torch.ops.forest_kernel import (
        TreeEnsemble,
        feature_importances,
        quantile_bins,
    )
    from spark_rapids_ml_tpu_torch.spark.device_aggregate import (
        partition_forest_histograms_device,
    )
    from spark_rapids_ml_tpu_torch.utils.resources import resolve_device

    timer = PhaseTimer()
    fcol = local_est.getInputCol()
    lcol = local_est.getLabelCol()
    n_trees = int(local_est.getNumTrees())
    depth = int(local_est.getMaxDepth())
    n_bins = int(local_est.getMaxBins())
    min_leaf = int(local_est.getMinInstancesPerNode())
    rate = float(local_est.getSubsamplingRate())
    seed = int(local_est.getSeed())
    wcol = local_est.get_or_default("weightCol") or None
    bootstrap = getattr(local_est, "_bootstrap", True)
    device = resolve_device(local_est.getDeviceId())
    device_sel = _device_sel(local_est, partition_forest_histograms_device)

    cols = [fcol, lcol] + ([wcol] if wcol else [])
    df = dataset.select(*cols).persist()
    try:
        with timer.phase("sample"):
            sx, sy, n_total, _y_sum, _w_sum, labels, d = _collect_sample(
                df, fcol, lcol, seed, wcol=wcol
            )
            _, edges = quantile_bins(sx, n_bins)
        classes = None
        if classification:
            if len(labels) > 100:
                raise ValueError(
                    f"{len(labels)} distinct label values: looks like a "
                    "continuous target, not classes"
                )
            classes = np.asarray(labels)

        n_ch = len(classes) if classification else 3
        per_tree_bytes = n_ch * 2 ** (depth - 1) * d * n_bins * 8
        group = int(np.clip(
            _group_budget_bytes(local_est) // max(per_tree_bytes, 1),
            1, n_trees
        ))

        rng = np.random.default_rng(seed)
        k_feats = _subset_counts(
            local_est.getFeatureSubsetStrategy(), d, classification
        )
        masks = np.zeros((n_trees, depth, d))
        for t in range(n_trees):
            for lvl in range(depth):
                chosen = rng.choice(d, size=k_feats, replace=False)
                masks[t, lvl, chosen] = 1.0

        n_int = 2 ** depth - 1
        n_leaves = 2 ** depth
        feature_arr = np.zeros((n_trees, n_int), dtype=np.int32)
        threshold_arr = np.full((n_trees, n_int), n_bins, dtype=np.int32)
        gains_arr = np.zeros((n_trees, n_int))
        leaves = [None] * n_trees

        def group_spec(g_trees, **level_keys):
            return {
                "edges": edges, "subsampling_rate": rate, "seed": seed,
                "classes": classes, "weight_col": wcol,
                "bootstrap": bootstrap,
                "trees": [
                    {"tree": t, "feature": feature_arr[t],
                     "threshold": threshold_arr[t]}
                    for t in g_trees
                ],
                **level_keys,
            }

        with timer.phase("grow"):
            for g0 in range(0, n_trees, group):
                g_trees = list(range(g0, min(g0 + group, n_trees)))
                for level in range(depth):
                    n_nodes = 2 ** level
                    spec = group_spec(g_trees, n_bins=n_bins, level=level)
                    rows = _hist_job(
                        df, partition_forest_histograms, fcol, lcol, spec,
                        device_sel=device_sel,
                    )
                    with timer.phase("combine"):
                        per_tree = combine_hist_rows(
                            rows, n_ch * n_nodes * d * n_bins
                        )
                    base = n_nodes - 1
                    with timer.phase("level_split"):
                        for t in g_trees:
                            h = per_tree[t].reshape(n_ch, n_nodes, d, n_bins)
                            bf, bt, kept = _level_split_np(
                                h, classification, masks[t, level],
                                min_leaf, n_bins, device,
                            )
                            feature_arr[t, base:base + n_nodes] = bf
                            threshold_arr[t, base:base + n_nodes] = bt
                            gains_arr[t, base:base + n_nodes] = kept
                # leaf pass for the finished group
                leaf_ch = len(classes) if classification else 2
                spec = group_spec(g_trees, depth=depth)
                rows = _hist_job(
                    df, partition_forest_leaf_stats, fcol, lcol, spec
                )
                per_tree = combine_hist_rows(rows, leaf_ch * n_leaves)
                for t in g_trees:
                    s = per_tree[t].reshape(leaf_ch, n_leaves)
                    if classification:
                        cls_cnt = s.T  # (n_leaves, K)
                        tot = cls_cnt.sum(axis=1, keepdims=True)
                        prior = cls_cnt.sum(axis=0)
                        prior = prior / max(prior.sum(), 1e-12)
                        leaves[t] = np.where(
                            tot > 0,
                            cls_cnt / np.maximum(tot, 1e-12),
                            prior[None, :],
                        )
                    else:
                        cnt, tot = s[0], s[1]
                        gmean = tot.sum() / max(cnt.sum(), 1e-12)
                        leaves[t] = np.where(
                            cnt > 0, tot / np.maximum(cnt, 1e-12), gmean
                        )
    finally:
        df.unpersist()

    ensemble = TreeEnsemble(
        feature=feature_arr,
        threshold=threshold_arr,
        leaf_value=np.stack(leaves),
    )
    model = local_est._model_cls()(
        ensemble=ensemble, edges=edges,
        classes=classes if classification else None,
    )
    model.feature_importances_ = feature_importances(
        feature_arr, gains_arr, d
    )
    model.uid = local_est.uid
    model.copy_values_from(local_est)
    model.fit_timings_ = timer.as_dict()
    model.trees_per_group_ = group
    return model


def _fit_gbt_plane(local_est, dataset, classification):
    """Sequential boosting over the statistics plane: each round grows one
    regression tree on residuals via per-level executor histograms, then a
    leaf pass supplies the (squared-loss or one-step-Newton) leaf values —
    the same formulas ``models.gbt.boosting_loop`` applies locally."""
    from spark_rapids_ml_tpu_torch.models.gbt import gbt_init_from_mean
    from spark_rapids_ml_tpu_torch.ops.forest_kernel import (
        TreeEnsemble,
        feature_importances,
        quantile_bins,
    )
    from spark_rapids_ml_tpu_torch.spark.device_aggregate import (
        partition_gbt_histograms_device,
    )
    from spark_rapids_ml_tpu_torch.utils.resources import resolve_device

    timer = PhaseTimer()
    if local_est.get_or_default("validationIndicatorCol"):
        raise ValueError(
            "validationIndicatorCol early stopping is not supported on "
            "the DataFrame/streamed statistics plane yet; fit the local "
            "estimator on in-memory data for early stopping"
        )
    fcol = local_est.getInputCol()
    lcol = local_est.getLabelCol()
    max_iter = int(local_est.getMaxIter())
    step = float(local_est.getStepSize())
    depth = int(local_est.getMaxDepth())
    n_bins = int(local_est.getMaxBins())
    min_leaf = int(local_est.getMinInstancesPerNode())
    rate = float(local_est.getSubsamplingRate())
    seed = int(local_est.getSeed())
    wcol = local_est.get_or_default("weightCol") or None
    device = resolve_device(local_est.getDeviceId())
    device_sel = _device_sel(local_est, partition_gbt_histograms_device)

    cols = [fcol, lcol] + ([wcol] if wcol else [])
    df = dataset.select(*cols).persist()
    try:
        with timer.phase("sample"):
            sx, _sy, n_total, y_sum, w_sum, labels, d = _collect_sample(
                df, fcol, lcol, seed, wcol=wcol
            )
            _, edges = quantile_bins(sx, n_bins)
        if classification and not set(labels) <= {0.0, 1.0}:
            raise ValueError("GBT classification requires 0/1 labels")
        # weighted label mean (w_sum == n when unweighted)
        init = gbt_init_from_mean(y_sum / max(w_sum, 1e-300), classification)

        n_int = 2 ** depth - 1
        n_leaves = 2 ** depth
        full_mask = np.ones(d)
        ens_f, ens_t, ens_l, gains_l = [], [], [], []

        with timer.phase("boost"):
            for m in range(max_iter):
                feature = np.zeros(n_int, dtype=np.int32)
                threshold = np.full(n_int, n_bins, dtype=np.int32)
                gains = np.zeros(n_int)
                base_spec = {
                    "edges": edges, "n_bins": n_bins, "depth": depth,
                    "subsampling_rate": rate, "seed": seed, "tree": m,
                    "init": init, "step_size": step,
                    "classification": classification,
                    "weight_col": wcol,
                    "ens_feature": np.stack(ens_f) if ens_f else None,
                    "ens_threshold": np.stack(ens_t) if ens_t else None,
                    "ens_leaf": np.stack(ens_l) if ens_l else None,
                }
                for level in range(depth):
                    n_nodes = 2 ** level
                    spec = dict(
                        base_spec, level=level,
                        feature=feature, threshold=threshold,
                    )
                    rows = _hist_job(
                        df, partition_gbt_histograms, fcol, lcol, spec,
                        device_sel=device_sel,
                    )
                    with timer.phase("combine"):
                        h = combine_hist_rows(
                            rows, 3 * n_nodes * d * n_bins
                        )[m].reshape(3, n_nodes, d, n_bins)
                    with timer.phase("level_split"):
                        bf, bt, kept = _level_split_np(
                            h, False, full_mask, min_leaf, n_bins, device
                        )
                    base = n_nodes - 1
                    feature[base:base + n_nodes] = bf
                    threshold[base:base + n_nodes] = bt
                    gains[base:base + n_nodes] = kept
                spec = dict(base_spec, feature=feature, threshold=threshold)
                rows = _hist_job(
                    df, partition_gbt_leaf_stats, fcol, lcol, spec
                )
                s = combine_hist_rows(rows, 3 * n_leaves)[m].reshape(
                    3, n_leaves
                )
                cnt, wr, wh = s[0], s[1], s[2]
                if classification:
                    # one-step Newton leaves: Σw·r / Σw·h
                    leaf = np.where(
                        wh > 0, wr / np.maximum(wh, 1e-12), 0.0
                    )
                else:
                    gmean = wr.sum() / max(cnt.sum(), 1e-12)
                    leaf = np.where(
                        cnt > 0, wr / np.maximum(cnt, 1e-12), gmean
                    )
                ens_f.append(feature)
                ens_t.append(threshold)
                ens_l.append(leaf)
                gains_l.append(gains)
    finally:
        df.unpersist()

    ensemble = TreeEnsemble(
        feature=np.stack(ens_f),
        threshold=np.stack(ens_t),
        leaf_value=np.stack(ens_l),
    )
    model = local_est._model_cls()(
        ensemble=ensemble, edges=edges, init=init, step_size=step
    )
    model.feature_importances_ = feature_importances(
        np.stack(ens_f), np.stack(gains_l), d
    )
    model.uid = local_est.uid
    model.copy_values_from(local_est)
    model.fit_timings_ = timer.as_dict()
    return model


class RandomForestClassifier(_adapter.RandomForestClassifier):
    """DataFrame RandomForestClassifier on the executor statistics plane
    (histograms reduced per level; rows never leave executors)."""

    def _fit(self, dataset):
        local_model = _fit_forest_plane(
            self._local, dataset, classification=True
        )
        return self._model_cls(local_model)


class RandomForestRegressor(_adapter.RandomForestRegressor):
    """DataFrame RandomForestRegressor on the executor statistics plane."""

    def _fit(self, dataset):
        local_model = _fit_forest_plane(
            self._local, dataset, classification=False
        )
        return self._model_cls(local_model)


class GBTClassifier(_adapter.GBTClassifier):
    """DataFrame GBTClassifier on the executor statistics plane."""

    def _fit(self, dataset):
        local_model = _fit_gbt_plane(
            self._local, dataset, classification=True
        )
        return self._model_cls(local_model)


class GBTRegressor(_adapter.GBTRegressor):
    """DataFrame GBTRegressor on the executor statistics plane."""

    def _fit(self, dataset):
        local_model = _fit_gbt_plane(
            self._local, dataset, classification=False
        )
        return self._model_cls(local_model)


class DecisionTreeClassifier(_adapter2.DecisionTreeClassifier):
    """DataFrame DecisionTreeClassifier on the executor statistics plane:
    Spark's own factoring (a single tree IS RandomForest.run with
    numTrees=1, all features, no bootstrap) applied to the per-level
    histogram plane — the driver-collect adapter fit is replaced by
    executor partials; transform stays the adapter pandas_udf."""

    def _fit(self, dataset):
        local_model = _fit_forest_plane(
            self._local, dataset, classification=True
        )
        return self._model_cls(local_model)


class DecisionTreeRegressor(_adapter2.DecisionTreeRegressor):
    """DataFrame DecisionTreeRegressor on the executor statistics
    plane."""

    def _fit(self, dataset):
        local_model = _fit_forest_plane(
            self._local, dataset, classification=False
        )
        return self._model_cls(local_model)


class _StreamFrame:
    """Minimal DataFrame-shaped shim over a RE-ITERABLE (x, y) chunk
    factory, letting the LOCAL out-of-core tree fits reuse the Spark
    statistics-plane driver loop verbatim: the whole stream is one
    'partition', each per-level job is one pass over the factory. The
    partition functions already accept plain (x, y) tuples alongside
    Arrow batches, and ``_collect_rows`` takes their row dicts as they
    come, so no Arrow buffer is ever built."""

    def __init__(self, factory):
        self._factory = factory

    def select(self, *_cols):
        return self

    def persist(self, *_):
        return self

    def unpersist(self, *_):
        return self

    def first(self):
        for x, y in self._factory():
            x = np.asarray(x)
            if x.shape[0]:
                return [x[0], float(np.asarray(y).ravel()[0])]
        return None

    def collect_rows(self, rows_fn) -> list:
        """``rows_fn``'s row dicts over one pass of the factory."""
        def tuples():
            for x, y in self._factory():
                yield (
                    np.asarray(x, dtype=np.float64),
                    np.asarray(y, dtype=np.float64).reshape(-1),
                )

        return list(rows_fn(tuples()))


class PartitionFrame:
    """DataFrame-shaped shim over partitions of numpy batches, so a
    statistics-plane front end's ``_fit`` runs its driver loop without
    pyarrow, pandas or pyspark. Each partition is a list of batches:
    (m, d) feature arrays, or (x, y) tuples where a label takes part (the
    partition functions' non-Arrow inputs, which carry no weight or
    offset column). ``collect_rows`` runs a partition function once per
    partition, in order, with ``LOCALSPARK_PARTITION_ID`` exported as the
    local engine exports it to its executors (``forest_plane.
    partition_identity`` reads it), and takes its row dicts as they come:
    the dicts an Arrow round trip gives, key for key. ``select`` of one
    column keeps only the features of each batch, as a DataFrame's
    projection does; ``count`` and ``collect`` give a driver-collect front
    end (``spark/adapter.py``) its rows."""

    def __init__(self, partitions):
        self._partitions = [list(p) for p in partitions]

    def select(self, *cols):
        if len(cols) != 1:
            return self
        return PartitionFrame(
            [[b[0] if isinstance(b, tuple) else b for b in part]
             for part in self._partitions])

    def persist(self, *_):
        return self

    def unpersist(self, *_):
        return self

    def first(self):
        for part in self._partitions:
            for batch in part:
                if isinstance(batch, tuple):
                    x = np.asarray(batch[0])
                    if x.shape[0]:
                        return [x[0], float(np.asarray(batch[1]).ravel()[0])]
                else:
                    x = np.asarray(batch)
                    if x.shape[0]:
                        return [x[0]]
        return None

    def count(self) -> int:
        return sum(len(np.asarray(b[0] if isinstance(b, tuple) else b))
                   for part in self._partitions for b in part)

    def collect(self) -> list:
        """Every row as a DataFrame's ``collect`` gives it, in partition
        order: ``(features,)``, or ``(features, label)`` where a label
        takes part — what the generic adapter's driver-collect fits
        (``spark/adapter.py``) read."""
        rows = []
        for part in self._partitions:
            for batch in part:
                if isinstance(batch, tuple):
                    x, y = (np.asarray(v) for v in batch)
                    rows.extend(zip(x, (float(v) for v in y.ravel())))
                else:
                    rows.extend((r,) for r in np.asarray(batch))
        return rows

    def collect_rows(self, rows_fn) -> list:
        """``rows_fn``'s row dicts over every partition."""
        saved = os.environ.get(_PARTITION_ENV)
        rows = []
        try:
            for pid, part in enumerate(self._partitions):
                os.environ[_PARTITION_ENV] = str(pid)
                rows.extend(rows_fn(iter(part)))
        finally:
            if saved is None:
                os.environ.pop(_PARTITION_ENV, None)
            else:
                os.environ[_PARTITION_ENV] = saved
        return rows


def fit_forest_streamed(local_est, factory, classification):
    """Out-of-core LOCAL RandomForest fit: one bin-edge sampling pass +
    (depth+1) histogram passes per tree group over the chunk factory —
    bounded memory (sample + per-level statistics tensors), never the
    dense matrix. Returns the fitted local model."""
    return _fit_forest_plane(local_est, _StreamFrame(factory),
                             classification)


def fit_gbt_streamed(local_est, factory, classification):
    """Out-of-core LOCAL GBT fit over the same shim (maxIter × (depth+1)
    passes; margins recomputed from the growing ensemble per pass)."""
    return _fit_gbt_plane(local_est, _StreamFrame(factory), classification)
