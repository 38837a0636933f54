"""Executor-side DEVICE aggregation: Arrow batches → stats on this
executor's card.

The reference's defining architecture puts the GPU on every executor: each
Spark partition is centered and multiplied on that executor's GPU
(``RapidsRowMatrix.scala:168-202``, native GEMM ``rapidsml_jni.cu:172-258``),
with ``spark.executor.resource.gpu`` scheduling the cards.
``spark/aggregate.py`` is the host-CPU (NumPy float64) plane; THIS module
is the card's: the partition's batches accumulate through the port's
streamed statistics (``ops/streaming.py``, ``ops/logreg_kernel.py``,
``ops/kmeans_kernel.py``) on the executor's own CUDA device, so every
float32 Gram — PCA's and LinearRegression's (Σxxᵀ of Z = [X | y]) and
LogisticRegression's Newton Hessian — is the hand kernel
``csrc/fused_gram.cu``; executor CPUs only densify Arrow batches.

Executor device selection mirrors the reference's ``gpuId`` task-resource
semantics (``RapidsRowMatrix.scala:171-175``): ``device_id=-1`` resolves
through ``utils.resources.resolve_device`` (task env /
``CUDA_VISIBLE_DEVICES`` pinning from ``scripts/get_gpus_resources.sh``
discovery), so one pinned executor process sees one card.

The port's copy of the JAX package's ``spark/device_aggregate.py``, with
three differences by design:

* ragged batches go in unpadded. The JAX package pads every batch to a
  power-of-two row bucket so XLA compiles a handful of shapes; eager
  PyTorch compiles nothing per shape and the CUDA kernel masks ragged rows
  itself, so padding would only add work (a 65,537-row batch padded to
  131,072 doubles its Gram);
* a device failure raises. ``executorDevice='auto'`` takes the card when
  there is one and the host plane when the CPU was requested
  (``SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu``); with neither it raises, as
  every port entry point does;
* the collective partial reduces float64 statistics and an int64 count
  with one ``all_reduce`` each. The JAX package packs float32 and splits
  the count into two int32 lanes, because XLA on the TPU has no x64; NCCL
  and gloo take both types.

The forest histogram partials (``partition_forest_histograms_device``,
``partition_gbt_histograms_device``) keep binning, routing and the
bootstrap draws on the host, as the JAX package does, and contract a tree
group's batch on the card in one ``ops.forest_kernel.channel_histograms``
call. Two more differences by design: the histograms accumulate in
float64 (the JAX package accumulates in the fit's dtype, float32 on an
accelerator; the port's grower takes its histograms in float64 since
float32 Gini gains flipped splits at a million rows), and the batches go
in unpadded, as above.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator

import numpy as np

from spark_rapids_ml_tpu_torch.spark.aggregate import (
    stats_arrow_schema,
    vector_column_to_matrix,
)


def executor_device_available() -> bool:
    """Whether this executor's statistics run on its card: True with a
    CUDA device, False when the CPU was requested
    (``SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu``: the host plane, as the JAX
    package takes it on a CPU-only executor); raises with neither."""
    import torch

    from spark_rapids_ml_tpu_torch.utils.resources import (
        PLATFORM_ENV,
        cpu_requested,
    )

    if cpu_requested():
        return False
    if torch.cuda.is_available():
        return True
    raise RuntimeError(
        "no CUDA device is available on this executor; set "
        f"{PLATFORM_ENV}=cpu to take the host plane explicitly")


def _host_matrix(batch) -> np.ndarray:
    """A non-Arrow batch as a float array: a float32 or float64 ndarray as
    it is (the device takes it in its own dtype, which equals widening it
    first), anything else as float64."""
    if isinstance(batch, np.ndarray) and batch.dtype in (np.float32,
                                                         np.float64):
        return batch
    return np.asarray(batch, dtype=np.float64)


def _to_device(x, device, dt):
    import torch

    return torch.as_tensor(x, device=device).to(dt).contiguous()


def _device_gram_accumulate(matrices: Iterable, device, dt):
    """Stream (m, n) host matrices (or tensors) through the device accumulator
    (``ops.streaming.update_stats``: one Gram launch a float32 batch on
    the card). Returns the ``GramStats``, or None when every batch was
    empty."""
    from spark_rapids_ml_tpu_torch.ops.streaming import (
        init_stats,
        update_stats,
    )

    stats = None
    for x in matrices:
        if x.shape[0] == 0:
            continue
        if stats is None:
            stats = init_stats(x.shape[1], dtype=dt, device=device)
        stats = update_stats(stats, _to_device(x, device, dt))
    return stats


def _gram_stats_row(stats) -> Dict[str, object]:
    """The accumulator as the mapInArrow row (``stats_arrow_schema``): the
    Gram flattened row-major as a list of float64."""
    return {
        "gram": stats.gram.cpu().numpy().astype(np.float64).ravel().tolist(),
        "col_sum": stats.col_sum.cpu().numpy().astype(np.float64).tolist(),
        "count": int(stats.count),
    }


def _device_gram_stats(matrices: Iterable, device, dt):
    """Core of the gram and the Z=[X|y] device paths: the accumulated
    statistics as one row, or None."""
    stats = _device_gram_accumulate(matrices, device, dt)
    return None if stats is None else _gram_stats_row(stats)


def _resolve(device_id: int, dtype: str):
    from spark_rapids_ml_tpu_torch.models.pca import _resolve_dtype
    from spark_rapids_ml_tpu_torch.utils.resources import resolve_device

    return resolve_device(device_id), _resolve_dtype(dtype)


def _gram_matrices(batches, input_col: str):
    for batch in batches:
        if hasattr(batch, "column"):
            yield vector_column_to_matrix(batch.column(input_col))
        else:
            yield _host_matrix(batch)


def partition_gram_stats_device(
    batches: Iterable,
    input_col: str,
    device_id: int = -1,
    dtype: str = "auto",
) -> Iterator[Dict[str, object]]:
    """One partition's (Σxxᵀ, Σx, n), accumulated ON this executor's card.

    Same contract and output row as ``aggregate.partition_gram_stats`` (so
    the driver-side ``combine_stats`` is shared), but the Gram runs as the
    hand kernel into a device accumulator instead of NumPy on the executor
    CPU. ``dtype='auto'`` is float32, and the Gram's precision is the
    port's default (``TPUML_GRAM_PRECISION``, bfloat16_3x): the precision
    envelope of every other streamed float32 fit in the port.
    """
    device, dt = _resolve(device_id, dtype)
    row = _device_gram_stats(_gram_matrices(batches, input_col), device, dt)
    if row is not None:
        yield row


def _xy_matrices(batches, features_col: str, label_col: str):
    for batch in batches:
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(features_col))
            y = np.asarray(batch.column(label_col).to_pylist(),
                           dtype=np.float64)
        else:
            x, y = batch
            x = _host_matrix(x)
            y = np.asarray(y, dtype=np.float64).reshape(-1)
        yield x, y


def partition_xy_stats_device(
    batches: Iterable,
    features_col: str,
    label_col: str,
    device_id: int = -1,
    dtype: str = "auto",
) -> Iterator[Dict[str, object]]:
    """Device counterpart of ``aggregate.partition_xy_stats``: the (n+1)²
    Gram of Z = [X | y] accumulated on this executor's card (the
    augmented-column trick shared with the streamed LinearRegression)."""
    import torch

    device, dt = _resolve(device_id, dtype)

    def matrices():
        for x, y in _xy_matrices(batches, features_col, label_col):
            yield torch.cat([_to_device(x, device, dt),
                             _to_device(y.reshape(-1, 1), device, dt)], dim=1)

    row = _device_gram_stats(matrices(), device, dt)
    if row is not None:
        yield row


def partition_xy_stats_device_arrow(batches, features_col: str,
                                    label_col: str, device_id: int = -1):
    import pyarrow as pa

    for row in partition_xy_stats_device(batches, features_col, label_col,
                                         device_id):
        yield pa.RecordBatch.from_pylist([row], schema=stats_arrow_schema())


def partition_logreg_stats_device(
    batches: Iterable,
    features_col: str,
    label_col: str,
    w: np.ndarray,
    b: float,
    device_id: int = -1,
    dtype: str = "auto",
) -> Iterator[Dict[str, object]]:
    """Device counterpart of ``aggregate.partition_logreg_stats``: one
    partition's Newton/IRLS partials under the closure-broadcast (w, b),
    folded into a device accumulator
    (``ops.logreg_kernel.update_logreg_stats``): the Hessian's XᵀSX is
    the hand kernel at highest, one launch a batch."""
    import torch

    from spark_rapids_ml_tpu_torch.models.logistic_regression import (
        _check_binary,
    )
    from spark_rapids_ml_tpu_torch.ops.logreg_kernel import (
        update_logreg_stats,
    )

    device, dt = _resolve(device_id, dtype)
    w = np.asarray(w, dtype=np.float64).reshape(-1)
    n = w.shape[0]
    carry = None
    w_dev = b_dev = None
    loss = 0.0
    rows_seen = 0   # host-exact: the device carry's count lane is float
    for x, y in _xy_matrices(batches, features_col, label_col):
        m = x.shape[0]
        if m == 0:
            continue
        rows_seen += m
        _check_binary(y)
        if carry is None:
            carry = (
                torch.zeros((n,), dtype=dt, device=device),
                torch.zeros((n, n), dtype=dt, device=device),
                torch.zeros((n,), dtype=dt, device=device),
                torch.zeros((), dtype=dt, device=device),
                torch.zeros((), dtype=dt, device=device),
                torch.zeros((), dtype=dt, device=device),
            )
            w_dev = torch.as_tensor(w, dtype=dt, device=device)
            b_dev = torch.as_tensor(float(b), dtype=dt, device=device)
        z = torch.cat([_to_device(x, device, dt),
                       _to_device(y.reshape(-1, 1), device, dt)], dim=1)
        carry = update_logreg_stats(carry, z, w_dev, b_dev)
        # stable per-row NLL on host (one matvec — a rounding error next
        # to the device XᵀSX): log(1+e^z) − y·z
        zlin = x @ w + float(b)
        loss += float(np.logaddexp(0.0, zlin).sum() - y @ zlin)
    if carry is None:
        return
    gx, hxx, hxb, rsum, ssum, _ = (
        v.cpu().numpy().astype(np.float64) for v in carry
    )
    yield {
        "gx": gx.tolist(),
        "hxx": hxx.ravel().tolist(),
        "hxb": hxb.tolist(),
        "rsum": float(rsum),
        "ssum": float(ssum),
        "loss": loss,
        "count": rows_seen,
    }


def partition_logreg_stats_device_arrow(batches, features_col: str,
                                        label_col: str, w: np.ndarray,
                                        b: float, device_id: int = -1):
    import pyarrow as pa

    from spark_rapids_ml_tpu_torch.spark.aggregate import (
        logreg_stats_arrow_schema,
    )

    for row in partition_logreg_stats_device(
        batches, features_col, label_col, w, b, device_id
    ):
        yield pa.RecordBatch.from_pylist(
            [row], schema=logreg_stats_arrow_schema()
        )


def partition_kmeans_stats_device(
    batches: Iterable,
    input_col: str,
    centers: np.ndarray,
    device_id: int = -1,
    dtype: str = "auto",
) -> Iterator[Dict[str, object]]:
    """Device counterpart of ``aggregate.partition_kmeans_stats``: one
    Lloyd assignment half-step per partition on the executor's card
    (``ops.kmeans_kernel.update_cluster_stats``: float32 distances taken in
    float64 and rounded once, the cluster sums as a one-hot product, the
    per-cluster counts in an int64 lane, so they stay exact past 2²⁴
    rows). No Gram: no hand kernel runs here."""
    import torch

    from spark_rapids_ml_tpu_torch.ops.kmeans_kernel import (
        update_cluster_stats,
    )

    device, dt = _resolve(device_id, dtype)
    centers = np.asarray(centers, dtype=np.float64)
    k, n = centers.shape

    c_dev = None
    carry = None
    rows_seen = 0   # host-exact: float cluster counts are a result, the
    # partition row count must not ride float32
    for x in _gram_matrices(batches, input_col):
        m = x.shape[0]
        if m == 0:
            continue
        rows_seen += m
        if carry is None:
            c_dev = torch.as_tensor(centers, dtype=dt, device=device)
            carry = (
                torch.zeros((k, n), dtype=dt, device=device),
                torch.zeros((k,), dtype=torch.int64, device=device),
                torch.zeros((), dtype=dt, device=device),
            )
        carry = update_cluster_stats(carry, c_dev, _to_device(x, device, dt))
    if carry is None:
        return
    sums, counts, cost = (v.cpu().numpy().astype(np.float64) for v in carry)
    yield {
        "sums": sums.ravel().tolist(),
        "counts": counts.tolist(),
        "cost": float(cost),
        "count": rows_seen,
    }


def partition_kmeans_stats_device_arrow(batches, input_col: str,
                                        centers: np.ndarray,
                                        device_id: int = -1):
    import pyarrow as pa

    from spark_rapids_ml_tpu_torch.spark.aggregate import (
        kmeans_stats_arrow_schema,
    )

    for row in partition_kmeans_stats_device(
        batches, input_col, centers, device_id
    ):
        yield pa.RecordBatch.from_pylist(
            [row], schema=kmeans_stats_arrow_schema()
        )


def partition_gram_stats_device_arrow(
    batches, input_col: str, device_id: int = -1
):
    """``mapInArrow`` adapter for the device path — same output schema as
    the host adapter, so driver combine/finalize code is shared."""
    import pyarrow as pa

    for row in partition_gram_stats_device(batches, input_col, device_id):
        yield pa.RecordBatch.from_pylist([row], schema=stats_arrow_schema())


def _task_identity():
    """(partition_id, num_partitions) of the running barrier task.

    pyspark's ``TaskContext`` when available (real clusters); the local
    engine's exported env otherwise."""
    import os

    try:  # pragma: no cover - pyspark environments
        from pyspark import TaskContext

        ctx = TaskContext.get()
        if ctx is not None:
            return int(ctx.partitionId()), int(ctx.numPartitions())
    except ImportError:
        pass
    pid = os.environ.get("LOCALSPARK_PARTITION_ID")
    n = os.environ.get("LOCALSPARK_NUM_PARTITIONS")
    if pid is None or n is None:
        raise RuntimeError(
            "collective executor aggregation needs barrier task identity "
            "(pyspark TaskContext or the local engine's process executors)"
        )
    return int(pid), int(n)


def partition_gram_stats_device_collective(
    batches,
    input_col: str,
    coordinator: str,
    n_features: int,
    device_id: int = -1,
    dtype: str = "auto",
):
    """Barrier-stage executor aggregation with an ON-DEVICE global reduce.

    Every barrier task streams its partition through its own card's
    accumulator (as ``partition_gram_stats_device``), then all tasks join
    one ``torch.distributed`` job (``parallel.multihost``; coordinator =
    the partition-0 host; NCCL between cards, gloo between CPU ranks) and
    the partial (Σxxᵀ, Σx, n) are summed by ``all_reduce``: float64
    statistics and an int64 count, one collective each. This replaces the
    reference's executor→driver Spark-RPC reduce of n×n partials
    (``RapidsRowMatrix.scala:202``). Only partition 0 emits the combined
    row; the driver-side ``combine_stats`` sees exactly one row and adds
    nothing.

    Reachability note: the coordinator's store binds inside the
    partition-0 task, so ``coordinator`` must be an address the other
    executors can reach — automatic for single-host executor fleets (the
    local engine, one-box Spark); multi-host fleets pre-set
    ``SPARK_RAPIDS_ML_TORCH_COORDINATOR`` to a routable host:port.
    """
    import os

    import pyarrow as pa

    part_id, n_parts = _task_identity()
    os.environ["SPARK_RAPIDS_ML_TORCH_COORDINATOR"] = coordinator
    os.environ["SPARK_RAPIDS_ML_TORCH_NUM_PROCESSES"] = str(n_parts)
    os.environ["SPARK_RAPIDS_ML_TORCH_PROCESS_ID"] = str(part_id)

    from spark_rapids_ml_tpu_torch.parallel.multihost import (
        initialize_multihost,
        local_device,
    )

    joined = initialize_multihost()
    if not joined and n_parts > 1:
        raise RuntimeError(
            "collective aggregation: failed to join the "
            f"{n_parts}-process torch.distributed job at {coordinator}"
        )

    local = list(partition_gram_stats_device(
        batches, input_col, device_id, dtype
    ))
    n = int(n_features)
    if local:
        gram = np.asarray(local[0]["gram"], dtype=np.float64)
        col_sum = np.asarray(local[0]["col_sum"], dtype=np.float64)
        count = int(local[0]["count"])
        if col_sum.shape[0] != n:
            raise ValueError(
                f"partition feature dim {col_sum.shape[0]} != driver-"
                f"announced {n}"
            )
    else:
        # empty partition still joins the collective with zeros — bailing
        # out here would strand every other barrier task inside the reduce
        gram = np.zeros(n * n)
        col_sum = np.zeros(n)
        count = 0

    if n_parts == 1:
        if local:
            yield pa.RecordBatch.from_pylist([local[0]],
                                             schema=stats_arrow_schema())
        return

    import torch
    import torch.distributed as dist

    device = local_device()
    packed = torch.as_tensor(np.concatenate([gram, col_sum]),
                             dtype=torch.float64, device=device)
    total_count = torch.tensor([count], dtype=torch.int64, device=device)
    dist.all_reduce(packed)
    dist.all_reduce(total_count)
    if part_id != 0:
        return
    total = packed.cpu().numpy()
    yield pa.RecordBatch.from_pylist(
        [{
            "gram": total[: n * n].tolist(),
            "col_sum": total[n * n:].tolist(),
            "count": int(total_count.item()),
        }],
        schema=stats_arrow_schema(),
    )


def partition_multinomial_stats_device(
    batches,
    features_col: str,
    label_col: str,
    classes: np.ndarray,
    wb: np.ndarray,
    device_id: int = -1,
    dtype: str = "auto",
):
    """Device counterpart of ``aggregate.partition_multinomial_stats``:
    the raw softmax partials fold into a device accumulator
    (``ops.logreg_kernel.update_multinomial_stats``): each of the
    K(K+1)/2 distinct Hessian blocks a batch is one hand-kernel launch at
    highest. Loss accumulates on host (one (m, K) logits pass —
    negligible next to the Hessian)."""
    import torch

    from spark_rapids_ml_tpu_torch.models.logistic_regression import (
        class_indices,
        softmax_log_loss,
    )
    from spark_rapids_ml_tpu_torch.ops.logreg_kernel import (
        update_multinomial_stats,
    )

    device, dt = _resolve(device_id, dtype)
    classes = np.asarray(classes, dtype=np.float64)
    k = classes.size
    wb = np.asarray(wb, dtype=np.float64)
    n = wb.shape[1] - 1
    dim = n + 1
    eye_k = np.eye(k)
    carry = None
    wb_dev = None
    loss = 0.0
    rows_seen = 0
    for x, y in _xy_matrices(batches, features_col, label_col):
        m = x.shape[0]
        if m == 0:
            continue
        idx = class_indices(y, classes)
        rows_seen += m
        if carry is None:
            carry = (
                torch.zeros((k, dim), dtype=dt, device=device),
                torch.zeros((k * dim, k * dim), dtype=dt, device=device),
                torch.zeros((), dtype=dt, device=device),
            )
            wb_dev = torch.as_tensor(wb, dtype=dt, device=device)
        carry = update_multinomial_stats(
            carry, _to_device(x, device, dt),
            _to_device(eye_k[idx], device, dt), wb_dev,
        )
        loss += softmax_log_loss(np.asarray(x, dtype=np.float64), wb, idx)
    if carry is None:
        return
    gxa, h_raw, _ = (v.cpu().numpy().astype(np.float64) for v in carry)
    yield {
        "gxa": gxa.ravel().tolist(),
        "h": h_raw.ravel().tolist(),
        "loss": loss,
        "count": rows_seen,
    }


# --------------------------------------------------------------------------
# tree-ensemble histogram partials ON the executor's card
# --------------------------------------------------------------------------

def forest_batch_host(x, y, w_user, spec, streams):
    """The host half of one batch of a forest group's level job: bin the
    rows, draw each tree's bootstrap weights (in the host plane's stream
    order), route every row to its node. Returns (binned (m, d) int32,
    nodes (T, m) int64, channels (T, m, C) float64), the channels the
    host plane's ``partition_forest_histograms`` builds."""
    from spark_rapids_ml_tpu_torch.spark.forest_plane import (
        _draw_weights,
        apply_bin_edges,
        route_to_level_np,
    )

    classes = spec.get("classes")
    rate = float(spec["subsampling_rate"])
    level = int(spec["level"])
    trees = spec["trees"]
    m = x.shape[0]
    binned = apply_bin_edges(x, np.asarray(spec["edges"]))
    if classes is not None:
        y_idx = np.searchsorted(np.asarray(classes), y)
        onehot = np.eye(len(classes))[y_idx]
    n_ch = 3 if classes is None else len(classes)
    nodes = np.empty((len(trees), m), dtype=np.int64)
    channels = np.empty((len(trees), m, n_ch))
    for ti, t in enumerate(trees):
        w = _draw_weights(streams[ti], rate, m)
        if w_user is not None:
            w = w * w_user
        if classes is None:
            channels[ti] = np.stack([w, w * y, w * y * y], axis=1)
        else:
            channels[ti] = onehot * w[:, None]
        nodes[ti] = route_to_level_np(
            binned, np.asarray(t["feature"]), np.asarray(t["threshold"]),
            level,
        )
    return binned, nodes, channels


def group_histograms_device(binned, nodes, channels, n_nodes: int,
                            n_bins: int, device):
    """One batch's (T, C, nodes·d·bins) float64 histograms of a tree group
    on ``device``: one ``ops.forest_kernel.channel_histograms`` call (a
    float64 GEMM a row block, the blocks summed in order), laid out as the
    host plane's ``histogram_channels_np``."""
    import torch

    from spark_rapids_ml_tpu_torch.ops.forest_kernel import (
        channel_histograms,
    )

    h = channel_histograms(
        torch.as_tensor(nodes, device=device), n_nodes,
        torch.as_tensor(binned, device=device),
        torch.as_tensor(channels, dtype=torch.float64, device=device),
        n_bins,
    )
    return h.reshape(h.shape[0], h.shape[1], -1)


def partition_forest_histograms_device(
    batches: Iterable,
    features_col: str,
    label_col: str,
    spec: dict,
    device_id: int = -1,
):
    """Device counterpart of ``forest_plane.partition_forest_histograms``:
    the same spec and row contract (the driver's combine is shared), with
    each batch's (C, nodes, d, bins) statistics of the whole tree group
    contracted on this executor's card (``group_histograms_device``) and
    accumulated there in float64. The host does the cheap parts
    (``forest_batch_host``: binning, partial-tree routing, the bootstrap
    draws in the host plane's order), so classification partials, sums
    of integer-weighted counts, equal the host plane's exactly."""
    from spark_rapids_ml_tpu_torch.spark.forest_plane import (
        _batch_weights,
        _batch_xy,
        _tree_weight_stream,
        partition_identity,
    )
    from spark_rapids_ml_tpu_torch.utils.resources import resolve_device

    device = resolve_device(device_id)
    rate = float(spec["subsampling_rate"])
    seed = int(spec["seed"])
    trees = spec["trees"]
    pid = partition_identity()
    streams = [
        _tree_weight_stream(rate, seed, int(t["tree"]), pid,
                            always_poisson=True,
                            bootstrap=bool(spec.get("bootstrap", True)))
        for t in trees
    ]
    acc = None
    for batch in batches:
        x, y = _batch_xy(batch, features_col, label_col)
        if x.shape[0] == 0:
            continue
        w_user = _batch_weights(batch, spec.get("weight_col"), x.shape[0])
        binned, nodes, channels = forest_batch_host(x, y, w_user, spec,
                                                    streams)
        out = group_histograms_device(binned, nodes, channels,
                                      2 ** int(spec["level"]),
                                      int(spec["n_bins"]), device)
        acc = out if acc is None else acc + out
    if acc is None:
        return
    acc_np = acc.cpu().numpy()
    for ti, t in enumerate(trees):
        yield {"tree": int(t["tree"]), "hist": acc_np[ti].ravel().tolist()}


def partition_gbt_histograms_device(
    batches: Iterable,
    features_col: str,
    label_col: str,
    spec: dict,
    device_id: int = -1,
):
    """Device counterpart of ``forest_plane.partition_gbt_histograms``:
    margins and residuals on the host from the broadcast prior ensemble
    (the host plane's ``_gbt_margin`` / ``_gbt_residual_hess``), the
    variance-channel contraction on this executor's card in float64. The
    same row contract as the host plane."""
    from spark_rapids_ml_tpu_torch.spark.forest_plane import (
        _batch_weights,
        _batch_xy,
        _draw_weights,
        _gbt_margin,
        _gbt_residual_hess,
        _tree_weight_stream,
        apply_bin_edges,
        partition_identity,
        route_to_level_np,
    )
    from spark_rapids_ml_tpu_torch.utils.resources import resolve_device

    device = resolve_device(device_id)
    edges = np.asarray(spec["edges"])
    level = int(spec["level"])
    depth = int(spec["depth"])
    rate = float(spec["subsampling_rate"])
    tree_idx = int(spec["tree"])
    stream = _tree_weight_stream(rate, int(spec["seed"]), tree_idx,
                                 partition_identity(), always_poisson=False)
    feature = np.asarray(spec["feature"])
    threshold = np.asarray(spec["threshold"])
    acc = None
    for batch in batches:
        x, y = _batch_xy(batch, features_col, label_col)
        m = x.shape[0]
        if m == 0:
            continue
        binned = apply_bin_edges(x, edges)
        f = _gbt_margin(
            binned, spec.get("ens_feature"), spec.get("ens_threshold"),
            spec.get("ens_leaf"), spec["init"], spec["step_size"], depth,
        )
        r, _ = _gbt_residual_hess(y, f, bool(spec["classification"]))
        w = _draw_weights(stream, rate, m)
        w_user = _batch_weights(batch, spec.get("weight_col"), m)
        if w_user is not None:
            w = w * w_user
        channels = np.stack([w, w * r, w * r * r], axis=1)[None]
        nodes = route_to_level_np(binned, feature, threshold, level)[None]
        out = group_histograms_device(binned, nodes, channels, 2 ** level,
                                      int(spec["n_bins"]), device)
        acc = out if acc is None else acc + out
    if acc is None:
        return
    yield {"tree": tree_idx, "hist": acc[0].cpu().numpy().ravel().tolist()}
