"""Executor-side partition aggregation: Arrow batches → sufficient statistics.

The data-plane core of the Spark integration, kept free of any ``pyspark``
import so it is unit-testable anywhere and ships to executors as plain
functions. Mirrors the reference's per-partition covariance kernel
(``RapidsRowMatrix.scala:168-202``: center rows → one GEMM per partition →
driver-side reduce of n×n partials), with two changes:

* ingestion is Arrow columnar batches (Spark's ``mapInArrow``), densified
  without a JVM round-trip per row;
* the per-partition payload is the ONE-PASS sufficient-statistics triple
  (Σxxᵀ, Σx, n) rather than a centered Gram, so no global mean broadcast
  pass is needed before partition work — the driver combines partials and
  finalizes ``(G − n·μμᵀ)/(n−1)``.

This module is the HOST plane: executor-CPU NumPy float64, exact enough
that the one-pass cancellation hazard of float32 does not bite, with no
device requirement on the workers. ``spark/device_aggregate.py`` is the
plane on each executor's card.

The port's copy of the JAX package's ``spark/aggregate.py``, the same
operations in the same order: the Gram, Z = [X | y] and LinearRegression's
solve, the binary and multinomial LogisticRegression partials, the
label-value pass, KMeans, the NaiveBayes partials and
``finalize_nb_from_stats``, ``combine_stats`` and
``finalize_pca_from_stats``; then the moments plane's partials: the
per-feature moments and their combine, the Summarizer partials, the
LinearSVC and GLM Newton / IRLS partials and the feature sample; then the
GaussianMixture EM partial and the BisectingKMeans routing, moments,
Lloyd and sample partials, and the Imputer's missing-aware (count, Σx)
partial. The LDA partial comes with its family (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np

from spark_rapids_ml_tpu_torch.utils.numeric import sigmoid as _sigmoid

from spark_rapids_ml_tpu_torch.data.vector import rows_to_matrix

# Spark VectorUDT struct tags (pyspark.ml.linalg.VectorUDT.serialize)
_SPARSE, _DENSE = 0, 1


def vector_column_to_matrix(column, n_features: Optional[int] = None) -> np.ndarray:
    """Densify one Arrow (or pylist) VectorUDT column to an (m, n) matrix.

    Handles dense rows (type=1: values), sparse rows (type=0: size, indices,
    values), plain list rows, and mixed encodings — the dense/sparse
    equivalence contract of ``PCASuite.scala:155-190``.
    """
    if hasattr(column, "to_pylist"):
        dense = _dense_struct_matrix(column)
        if dense is not None:
            return dense
        column = column.to_pylist()
    rows = []
    for entry in column:
        if entry is None:
            raise ValueError("null vector row in input column")
        if isinstance(entry, dict):
            if entry.get("type") == _DENSE or (
                entry.get("type") is None and entry.get("indices") is None
            ):
                rows.append(np.asarray(entry["values"], dtype=np.float64))
            elif entry.get("type") == _SPARSE:
                size = int(entry["size"])
                dense = np.zeros(size)
                idx = np.asarray(entry["indices"], dtype=np.int64)
                dense[idx] = np.asarray(entry["values"], dtype=np.float64)
                rows.append(dense)
            else:
                raise ValueError(f"unrecognized vector struct: {entry!r}")
        else:
            rows.append(np.asarray(entry, dtype=np.float64).reshape(-1))
    if not rows:
        return np.zeros((0, n_features or 0))
    return rows_to_matrix(rows)


def _dense_struct_matrix(column) -> Optional[np.ndarray]:
    """The (m, n) float64 matrix of an Arrow VectorUDT column whose rows
    are all dense, non-null and of one size, read from its buffers without
    a Python float per element; None for any other column, which the row
    loop of ``vector_column_to_matrix`` then reads (and checks) as before.
    """
    import pyarrow as pa

    if isinstance(column, pa.ChunkedArray):
        column = column.combine_chunks()
    if (not isinstance(column, pa.StructArray) or len(column) == 0
            or column.null_count):
        return None
    kind = column.type
    fields = dict(zip((kind.field(i).name for i in range(kind.num_fields)),
                      column.flatten()))
    values = fields.get("values")
    if not isinstance(values, pa.ListArray) or values.null_count:
        return None
    tags = fields.get("type")
    if tags is not None and not (
            tags.null_count == 0
            and (tags.to_numpy(zero_copy_only=False) == _DENSE).all()):
        return None
    if tags is None and fields.get("indices") is not None and (
            fields["indices"].null_count != len(column)):
        return None
    sizes = np.diff(values.offsets.to_numpy())
    if sizes[0] == 0 or (sizes != sizes[0]).any():
        return None
    flat = values.flatten()
    if flat.null_count:
        return None
    return (flat.to_numpy(zero_copy_only=False).astype(np.float64)
            .reshape(len(column), int(sizes[0])))


def _batch_weights_agg(batch, weight_col: Optional[str]):
    """Validated weightCol values for one batch (None when unweighted).
    Raises for non-Arrow test batches rather than silently fitting
    unweighted — the tuple/array forms carry no named columns."""
    if not weight_col:
        return None
    if not hasattr(batch, "column"):
        raise ValueError(
            "weight_col requires Arrow batches with named columns; "
            "plain (x, y) tuple batches cannot carry weights"
        )
    wt = np.asarray(batch.column(weight_col).to_pylist(),
                    dtype=np.float64).reshape(-1)
    if not np.isfinite(wt).all() or (wt < 0).any():
        raise ValueError("weights must be finite and non-negative")
    return wt


def partition_gram_stats(
    batches: Iterable, input_col: str
) -> Iterator[Dict[str, object]]:
    """One partition's (Σxxᵀ, Σx, n) from an iterator of Arrow batches.

    Shaped for ``DataFrame.mapInArrow``: consumes ``pyarrow.RecordBatch``es,
    yields exactly one stats row (Gram flattened row-major). Also accepts an
    iterable of plain (m, n) arrays for testing / non-Spark use.
    """
    gram: Optional[np.ndarray] = None
    col_sum: Optional[np.ndarray] = None
    count = 0
    for batch in batches:
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(input_col))
        else:
            x = np.asarray(batch, dtype=np.float64)
        if x.shape[0] == 0:
            continue
        if gram is None:
            n = x.shape[1]
            gram = np.zeros((n, n))
            col_sum = np.zeros(n)
        gram += x.T @ x
        col_sum += x.sum(axis=0)
        count += x.shape[0]
    if gram is None:
        return
    yield {
        "gram": gram.ravel().tolist(),
        "col_sum": col_sum.tolist(),
        "count": count,
    }


def partition_gram_stats_arrow(batches, input_col: str):
    """``mapInArrow`` adapter: yields the stats row as an Arrow RecordBatch
    (schema ``stats_arrow_schema()``). Empty partitions yield nothing — the
    driver-side combine treats them as zero."""
    import pyarrow as pa

    for row in partition_gram_stats(batches, input_col):
        yield pa.RecordBatch.from_pylist([row], schema=stats_arrow_schema())


def stats_arrow_schema():
    import pyarrow as pa

    return pa.schema(
        [
            ("gram", pa.list_(pa.float64())),
            ("col_sum", pa.list_(pa.float64())),
            ("count", pa.float64()),  # Σw (= row count unweighted)
        ]
    )


def stats_spark_ddl() -> str:
    """The same schema as a Spark DDL string (mapInArrow's schema arg)."""
    return "gram array<double>, col_sum array<double>, count double"


def partition_xy_stats(
    batches: Iterable, features_col: str, label_col: str,
    weight_col: Optional[str] = None,
) -> Iterator[Dict[str, object]]:
    """One partition's sufficient statistics over Z = [X | y].

    Shaped for ``mapInArrow`` on a (features, label[, weight]) selection;
    the (n+1)² Gram of Z carries XᵀX, Xᵀy and yᵀy at once — the same
    augmented-column trick the local streamed LinearRegression uses.
    With ``weight_col`` every statistic is the weighted sum (Σw·zzᵀ,
    Σw·z, Σw) — weighted least squares."""
    gram: Optional[np.ndarray] = None
    col_sum: Optional[np.ndarray] = None
    count = 0.0
    for batch in batches:
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(features_col))
            y = np.asarray(batch.column(label_col).to_pylist(),
                           dtype=np.float64)
        else:
            x, y = batch
            x = np.asarray(x, dtype=np.float64)
            y = np.asarray(y, dtype=np.float64)
        if x.shape[0] == 0:
            continue
        wt = _batch_weights_agg(batch, weight_col)
        z = np.concatenate([x, y.reshape(-1, 1)], axis=1)
        if gram is None:
            nz = z.shape[1]
            gram = np.zeros((nz, nz))
            col_sum = np.zeros(nz)
        if wt is None:
            gram += z.T @ z
            col_sum += z.sum(axis=0)
            count += z.shape[0]
        else:
            gram += z.T @ (z * wt[:, None])
            col_sum += (z * wt[:, None]).sum(axis=0)
            count += float(wt.sum())
    if gram is None:
        return
    yield {
        "gram": gram.ravel().tolist(),
        "col_sum": col_sum.tolist(),
        "count": count,
    }


def partition_xy_stats_arrow(batches, features_col: str, label_col: str,
                             weight_col: Optional[str] = None):
    import pyarrow as pa

    for row in partition_xy_stats(batches, features_col, label_col,
                                  weight_col=weight_col):
        yield pa.RecordBatch.from_pylist([row], schema=stats_arrow_schema())


def solve_linreg_from_stats(
    gram: np.ndarray,
    col_sum: np.ndarray,
    count: int,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
) -> Tuple[np.ndarray, float]:
    """Normal-equations solve from combined Z=[X|y] statistics — identical
    math to the local streamed fit (``models/linear_regression.py``)."""
    if count < 1:
        raise ValueError("empty dataset")
    n = col_sum.shape[0] - 1
    gxx, gxy = gram[:n, :n], gram[:n, n]
    if fit_intercept:
        mu = col_sum / count
        mu_x, mu_y = mu[:n], mu[n]
        a = gxx / count - np.outer(mu_x, mu_x)
        b = gxy / count - mu_x * mu_y
        coef = np.linalg.solve(a + reg_param * np.eye(n), b)
        return coef, float(mu_y - mu_x @ coef)
    coef = np.linalg.solve(gxx / count + reg_param * np.eye(n), gxy / count)
    return coef, 0.0


def partition_logreg_stats(
    batches: Iterable,
    features_col: str,
    label_col: str,
    w: np.ndarray,
    b: float,
    weight_col: Optional[str] = None,
) -> Iterator[Dict[str, object]]:
    """One partition's Newton/IRLS partials under broadcast coefficients.

    Given the current (w, b) captured by closure (the small-state broadcast
    of ``RapidsRowMatrix.scala:162-166``, here per Newton iteration), emits
    (Xᵀr, XᵀSX, XᵀS, Σr, Σs, loss, n) where r = σ(Xw+b) − y and
    S = diag(σ(1−σ)) — everything the driver needs to assemble one
    (n+1)² Newton system (``models.logistic_regression._assemble_newton``).
    One Spark job per iteration, mirroring the per-pass streamed fit.
    """
    w = np.asarray(w, dtype=np.float64).reshape(-1)
    b = float(b)
    n = w.shape[0]
    gx = np.zeros(n)
    hxx = np.zeros((n, n))
    hxb = np.zeros(n)
    rsum = ssum = loss = 0.0
    count = 0
    for batch in batches:
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(features_col))
            y = np.asarray(batch.column(label_col).to_pylist(),
                           dtype=np.float64)
        else:
            x, y = batch
            x = np.asarray(x, dtype=np.float64)
            y = np.asarray(y, dtype=np.float64).reshape(-1)
        if x.shape[0] == 0:
            continue
        from spark_rapids_ml_tpu_torch.models.logistic_regression import (
            _check_binary,
        )

        _check_binary(y)
        wt = _batch_weights_agg(batch, weight_col)
        z = x @ w + b
        p = _sigmoid(z)
        r = p - y
        s = p * (1.0 - p)
        if wt is not None:
            # weightCol: every Newton partial is a weighted sum
            r = r * wt
            s = s * wt
        gx += x.T @ r
        hxx += x.T @ (x * s[:, None])
        hxb += x.T @ s
        rsum += float(r.sum())
        ssum += float(s.sum())
        # stable per-row NLL: log(1+e^z) − y·z
        nll = np.logaddexp(0.0, z) - y * z
        loss += float((nll * wt).sum() if wt is not None else nll.sum())
        count += float(wt.sum()) if wt is not None else x.shape[0]
    if count == 0:
        return
    yield {
        "gx": gx.tolist(),
        "hxx": hxx.ravel().tolist(),
        "hxb": hxb.tolist(),
        "rsum": rsum,
        "ssum": ssum,
        "loss": loss,
        "count": count,
    }


def partition_logreg_stats_arrow(batches, features_col: str, label_col: str,
                                 w: np.ndarray, b: float,
                                 weight_col: Optional[str] = None):
    import pyarrow as pa

    for row in partition_logreg_stats(batches, features_col, label_col, w, b,
                                      weight_col=weight_col):
        yield pa.RecordBatch.from_pylist([row], schema=logreg_stats_arrow_schema())


def logreg_stats_arrow_schema():
    import pyarrow as pa

    return pa.schema(
        [
            ("gx", pa.list_(pa.float64())),
            ("hxx", pa.list_(pa.float64())),
            ("hxb", pa.list_(pa.float64())),
            ("rsum", pa.float64()),
            ("ssum", pa.float64()),
            ("loss", pa.float64()),
            ("count", pa.float64()),  # Σw (= row count unweighted)
        ]
    )


def logreg_stats_spark_ddl() -> str:
    return ("gx array<double>, hxx array<double>, hxb array<double>, "
            "rsum double, ssum double, loss double, count double")


def combine_logreg_stats(rows: Iterable):
    """Driver-side reduce of per-partition IRLS partials →
    (gx, hxx, hxb, rsum, ssum, loss, count)."""
    gx = hxx = hxb = None
    rsum = ssum = loss = 0.0
    count = 0
    for row in rows:
        get = row.get if isinstance(row, dict) else row.__getitem__
        g = np.asarray(get("gx"), dtype=np.float64)
        if gx is None:
            n = g.shape[0]
            gx, hxx, hxb = np.zeros(n), np.zeros((n, n)), np.zeros(n)
        gx += g
        hxx += np.asarray(get("hxx"), dtype=np.float64).reshape(hxb.shape[0],
                                                                hxb.shape[0])
        hxb += np.asarray(get("hxb"), dtype=np.float64)
        rsum += float(get("rsum"))
        ssum += float(get("ssum"))
        loss += float(get("loss"))
        count += float(get("count"))  # Σw: fractional under weightCol
    if gx is None:
        raise ValueError("no partition statistics to combine (empty dataset)")
    return gx, hxx, hxb, rsum, ssum, loss, count


def logreg_newton_step_from_stats(
    gx: np.ndarray,
    hxx: np.ndarray,
    hxb: np.ndarray,
    rsum: float,
    ssum: float,
    count: int,
    w: np.ndarray,
    b: float,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
) -> Tuple[np.ndarray, float, float]:
    """One damped-free Newton update from combined statistics; returns
    (w', b', max|Δ|) with the same Spark-convention (1/n)-scaled system as
    the local fits (shared ``_assemble_newton``)."""
    from spark_rapids_ml_tpu_torch.models.logistic_regression import _assemble_newton

    n = w.shape[0]
    g, h = _assemble_newton(gx, hxx, hxb, rsum, ssum, float(count),
                            w, reg_param, fit_intercept)
    delta = np.linalg.solve(h, g)
    w_new = w - delta[:n]
    b_new = b - delta[n] if fit_intercept else b
    return w_new, float(b_new), float(np.max(np.abs(delta)))


def partition_label_values(
    batches: Iterable, label_col: str
) -> Iterator[Dict[str, object]]:
    """One row: the distinct (finite-validated) label values this
    partition saw — the cheap discovery pass Spark's family='auto' needs
    before choosing binary vs multinomial. Runs over a LABEL-ONLY column
    selection (no feature densify), and raises as soon as a partition
    exceeds the 100-class multinomial cap rather than shipping an
    unbounded set (a continuous target would otherwise collect every
    distinct double)."""
    seen = set()
    for batch in batches:
        if hasattr(batch, "column"):
            y = np.asarray(batch.column(label_col).to_pylist(),
                           dtype=np.float64)
        else:
            y = np.asarray(batch, dtype=np.float64).reshape(-1)
        if y.size == 0:
            continue
        if not np.isfinite(y).all():
            raise ValueError("labels must be finite")
        seen.update(np.unique(y).tolist())
        if len(seen) > 100:
            raise ValueError(
                "more than 100 distinct label values: looks like a "
                "continuous target, not classes (multinomial supports "
                "up to 100)"
            )
    if not seen:
        return
    yield {"labels": sorted(seen)}


def partition_multinomial_stats(
    batches: Iterable,
    features_col: str,
    label_col: str,
    classes: np.ndarray,
    wb: np.ndarray,
    weight_col: Optional[str] = None,
) -> Iterator[Dict[str, object]]:
    """One partition's raw softmax-Newton partials at the broadcast
    (K, d+1) parameters: (gxa, h_raw, loss, count) — the additive unit of
    ``ops.logreg_kernel.multinomial_raw_stats``, here in executor-CPU
    NumPy f64 (the host plane)."""
    from spark_rapids_ml_tpu_torch.models.logistic_regression import (
        class_indices,
        softmax_log_loss,
    )

    classes = np.asarray(classes, dtype=np.float64)
    k = classes.size
    wb = np.asarray(wb, dtype=np.float64)
    n = wb.shape[1] - 1
    gxa = np.zeros((k, n + 1))
    h_raw = np.zeros((k * (n + 1), k * (n + 1)))
    loss = 0.0
    count = 0
    for batch in batches:
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(features_col))
            y = np.asarray(batch.column(label_col).to_pylist(),
                           dtype=np.float64)
        else:
            x, y = batch
            x = np.asarray(x, dtype=np.float64)
            y = np.asarray(y, dtype=np.float64).reshape(-1)
        if x.shape[0] == 0:
            continue
        idx = class_indices(y, classes)
        wt = _batch_weights_agg(batch, weight_col)
        z = x @ wb[:, :n].T + wb[:, n][None, :]
        z = z - z.max(axis=1, keepdims=True)
        e = np.exp(z)
        p = e / e.sum(axis=1, keepdims=True)
        y_oh = np.eye(k)[idx]
        r = p - y_oh
        if wt is not None:
            r = r * wt[:, None]
        xa = np.concatenate([x, np.ones((x.shape[0], 1))], axis=1)
        gxa += r.T @ xa
        for kk in range(k):
            for ll in range(k):
                s = p[:, kk] * ((kk == ll) * 1.0 - p[:, ll])
                if wt is not None:
                    s = s * wt
                h_raw[kk * (n + 1):(kk + 1) * (n + 1),
                      ll * (n + 1):(ll + 1) * (n + 1)] += (
                    (xa * s[:, None]).T @ xa
                )
        if wt is None:
            loss += softmax_log_loss(x, wb, idx)
            count += x.shape[0]
        else:
            # per-row weighted NLL from the shifted logits already in
            # scope (z, e computed above for the gradient)
            lse = np.log(e.sum(axis=1))
            nll = lse - z[np.arange(x.shape[0]), idx]
            loss += float((wt * nll).sum())
            count += float(wt.sum())
    if count == 0:
        return
    yield {
        "gxa": gxa.ravel().tolist(),
        "h": h_raw.ravel().tolist(),
        "loss": loss,
        "count": count,
    }


def multinomial_stats_arrow_schema():
    import pyarrow as pa

    return pa.schema(
        [
            ("gxa", pa.list_(pa.float64())),
            ("h", pa.list_(pa.float64())),
            ("loss", pa.float64()),
            ("count", pa.float64()),  # Σw (= row count unweighted)
        ]
    )


def multinomial_stats_spark_ddl() -> str:
    return "gxa array<double>, h array<double>, loss double, count double"


def combine_multinomial_stats(rows: Iterable, k: int, dim: int):
    """Driver-side reduce → (gxa (k, dim), h_raw (k·dim)², loss, Σw)."""
    gxa = np.zeros((k, dim))
    h_raw = np.zeros((k * dim, k * dim))
    loss = 0.0
    count = 0
    for row in rows:
        get = row.get if isinstance(row, dict) else row.__getitem__
        gxa += np.asarray(get("gxa"), dtype=np.float64).reshape(k, dim)
        h_raw += np.asarray(get("h"), dtype=np.float64).reshape(
            k * dim, k * dim
        )
        loss += float(get("loss"))
        count += float(get("count"))
    if count == 0:
        raise ValueError("no partition statistics to combine (empty dataset)")
    return gxa, h_raw, loss, count


def partition_kmeans_stats(
    batches: Iterable, input_col: str, centers: np.ndarray,
    weight_col: Optional[str] = None,
) -> Iterator[Dict[str, object]]:
    """One partition's per-cluster (Σw·x, Σw, Σw·cost) under fixed
    centers — one Lloyd assignment half-step, shaped for ``mapInArrow``
    with the (small) centers broadcast via closure capture (w ≡ 1
    unweighted — Spark 3.0 weightCol semantics otherwise)."""
    k, n = centers.shape
    sums = np.zeros((k, n))
    counts = np.zeros(k)
    cost = 0.0
    seen = 0
    c2 = (centers * centers).sum(axis=1)[None, :]
    for batch in batches:
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(input_col))
        else:
            x = np.asarray(batch, dtype=np.float64)
        if x.shape[0] == 0:
            continue
        wt = _batch_weights_agg(batch, weight_col)
        d = np.maximum(
            (x * x).sum(axis=1)[:, None] + c2 - 2.0 * (x @ centers.T), 0.0
        )
        labels = d.argmin(axis=1)
        if wt is None:
            np.add.at(sums, labels, x)
            np.add.at(counts, labels, 1.0)
            cost += float(d.min(axis=1).sum())
        else:
            np.add.at(sums, labels, x * wt[:, None])
            np.add.at(counts, labels, wt)
            cost += float((wt * d.min(axis=1)).sum())
        seen += x.shape[0]
    if seen == 0:
        return
    yield {
        "sums": sums.ravel().tolist(),
        "counts": counts.tolist(),
        "cost": cost,
        "count": seen,
    }


def kmeans_stats_arrow_schema():
    import pyarrow as pa

    return pa.schema(
        [
            ("sums", pa.list_(pa.float64())),
            ("counts", pa.list_(pa.float64())),
            ("cost", pa.float64()),
            ("count", pa.int64()),
        ]
    )


def kmeans_stats_spark_ddl() -> str:
    return "sums array<double>, counts array<double>, cost double, count bigint"


def combine_kmeans_stats(rows: Iterable, k: int, n: int):
    """Driver-side reduce of per-partition Lloyd stats →
    (sums (k,n), counts (k,), cost, rows_seen)."""
    sums = np.zeros((k, n))
    counts = np.zeros(k)
    cost = 0.0
    seen = 0
    for row in rows:
        get = row.get if isinstance(row, dict) else row.__getitem__
        sums += np.asarray(get("sums"), dtype=np.float64).reshape(k, n)
        counts += np.asarray(get("counts"), dtype=np.float64)
        cost += float(get("cost"))
        seen += int(get("count"))
    return sums, counts, cost, seen


def partition_nb_stats(
    batches: Iterable, features_col: str, label_col: str, model_type: str,
    weight_col: Optional[str] = None,
) -> Iterator[Dict[str, object]]:
    """One partition's per-class NaiveBayes statistics.

    Emits the label values this partition saw with their (Σw, Σw·x, Σw·x²)
    rows (w ≡ 1 unweighted) — additively combinable on the driver even
    when partitions see different class subsets. Input validation
    (multinomial/complement non-negative, bernoulli {0,1}, weights
    finite/non-negative) runs here, where the rows are."""
    sums: Dict[float, np.ndarray] = {}
    sqs: Dict[float, np.ndarray] = {}
    counts: Dict[float, float] = {}
    for batch in batches:
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(features_col))
            y = np.asarray(batch.column(label_col).to_pylist(),
                           dtype=np.float64)
        else:
            x, y = batch
            x = np.asarray(x, dtype=np.float64)
            y = np.asarray(y, dtype=np.float64).reshape(-1)
        if x.shape[0] == 0:
            continue
        w = _batch_weights_agg(batch, weight_col)
        if model_type in ("multinomial", "complement") and (x < 0).any():
            raise ValueError(
                f"{model_type} NaiveBayes requires non-negative features"
            )
        if model_type == "bernoulli" and not np.isin(x, (0.0, 1.0)).all():
            raise ValueError(
                "bernoulli NaiveBayes requires {0,1} features"
            )
        for cls in np.unique(y):
            sel = y == cls
            rows_c = x[sel]
            w_c = w[sel] if w is not None else None
            key = float(cls)
            if key not in sums:
                sums[key] = np.zeros(x.shape[1])
                sqs[key] = np.zeros(x.shape[1])
                counts[key] = 0.0
            if w_c is None:
                sums[key] += rows_c.sum(axis=0)
                sqs[key] += (rows_c * rows_c).sum(axis=0)
                counts[key] += float(rows_c.shape[0])
            else:
                sums[key] += (w_c[:, None] * rows_c).sum(axis=0)
                sqs[key] += (w_c[:, None] * rows_c * rows_c).sum(axis=0)
                counts[key] += float(w_c.sum())
    if not counts:
        return
    labels = sorted(counts)
    yield {
        "labels": labels,
        "counts": [counts[c] for c in labels],
        "sums": np.concatenate([sums[c] for c in labels]).tolist(),
        "sq": np.concatenate([sqs[c] for c in labels]).tolist(),
    }


def nb_stats_arrow_schema():
    import pyarrow as pa

    return pa.schema(
        [
            ("labels", pa.list_(pa.float64())),
            ("counts", pa.list_(pa.float64())),  # Σw (= row count unweighted)
            ("sums", pa.list_(pa.float64())),
            ("sq", pa.list_(pa.float64())),
        ]
    )


def nb_stats_spark_ddl() -> str:
    return ("labels array<double>, counts array<double>, "
            "sums array<double>, sq array<double>")


def combine_nb_stats(rows: Iterable):
    """Driver-side union+sum of per-partition per-class statistics →
    (classes, counts (K,), sums (K,d), sq (K,d))."""
    acc: Dict[float, list] = {}
    d = None
    for row in rows:
        get = row.get if isinstance(row, dict) else row.__getitem__
        labels = list(get("labels"))
        counts = list(get("counts"))
        sums = np.asarray(get("sums"), dtype=np.float64)
        sq = np.asarray(get("sq"), dtype=np.float64)
        d = sums.shape[0] // len(labels)
        sums = sums.reshape(len(labels), d)
        sq = sq.reshape(len(labels), d)
        for i, cls in enumerate(labels):
            if cls not in acc:
                acc[cls] = [0, np.zeros(d), np.zeros(d)]
            acc[cls][0] += float(counts[i])
            acc[cls][1] += sums[i]
            acc[cls][2] += sq[i]
    if not acc:
        raise ValueError("no partition statistics to combine (empty dataset)")
    classes = np.asarray(sorted(acc), dtype=np.float64)
    counts = np.asarray([acc[c][0] for c in classes], dtype=np.float64)
    sums = np.stack([acc[c][1] for c in classes])
    sq = np.stack([acc[c][2] for c in classes])
    return classes, counts, sums, sq


def finalize_nb_from_stats(
    classes: np.ndarray,
    counts: np.ndarray,
    sums: np.ndarray,
    sq: np.ndarray,
    model_type: str,
    smoothing: float,
):
    """(pi, theta, sigma) from combined class statistics — the same math
    as the local ``models.naive_bayes`` fit, with the gaussian variance
    floor derived from the GLOBAL per-feature variance (itself exactly
    recoverable from the class sums)."""
    lam = float(smoothing)
    pi = np.log(counts / counts.sum())
    if model_type == "multinomial":
        theta = np.log(
            (sums + lam)
            / (sums.sum(axis=1, keepdims=True) + lam * sums.shape[1])
        )
        return pi, theta, None
    if model_type == "complement":
        # Rennie et al. 2003 (Spark 3.0 / sklearn ComplementNB,
        # norm=False): per-class COMPLEMENT feature mass, theta stored
        # NEGATED so the likelihood stays the one x @ thetaᵀ contraction
        comp = sums.sum(axis=0, keepdims=True) - sums
        theta = -np.log(
            (comp + lam)
            / (comp.sum(axis=1, keepdims=True) + lam * comp.shape[1])
        )
        return pi, theta, None
    if model_type == "bernoulli":
        theta = np.log((sums + lam) / (counts[:, None] + 2.0 * lam))
        return pi, theta, None
    n = counts.sum()
    mean = sums / counts[:, None]
    var = sq / counts[:, None] - mean * mean
    # clamp at 0: the E[x²]−E[x]² form can cancel to a tiny negative,
    # unlike the local fit's x.var() which is non-negative by construction
    global_var = np.maximum(
        sq.sum(axis=0) / n - (sums.sum(axis=0) / n) ** 2, 0.0
    )
    var = np.maximum(var, 1e-9 * float(global_var.max() or 1.0))
    return pi, mean, var


def combine_stats(
    rows: Iterable,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Driver-side reduce of per-partition stats rows → (G, Σx, n).

    The analogue of the reference's ``cov.reduce(_ + _)``
    (``RapidsRowMatrix.scala:202``), summing n×n partials on the driver —
    but over ~P small rows collected once, not a shuffle."""
    gram = None
    col_sum = None
    count = 0
    for row in rows:
        get = row.get if isinstance(row, dict) else row.__getitem__
        g = np.asarray(get("gram"), dtype=np.float64)
        s = np.asarray(get("col_sum"), dtype=np.float64)
        if gram is None:
            n = s.shape[0]
            gram = np.zeros((n, n))
            col_sum = np.zeros(n)
        gram += g.reshape(col_sum.shape[0], col_sum.shape[0])
        col_sum += s
        count += float(get("count"))  # Σw: fractional under weightCol
    if gram is None:
        raise ValueError("no partition statistics to combine (empty dataset)")
    return gram, col_sum, count


def finalize_pca_from_stats(
    gram: np.ndarray,
    col_sum: np.ndarray,
    count: int,
    k: int,
    mean_centering: bool = True,
    use_xla_svd: bool = True,
    device_id: int = -1,
):
    """Driver-side finalization: covariance from global stats → top-k eigh.

    The covariance assembly from already-reduced statistics is a cheap host
    NumPy step either way; ``use_xla_svd`` selects where the EIGENSOLVE runs
    — the driver's card (``ops.eigh.pca_from_covariance`` at the port's
    'auto' dtype, float32; the CPU when it is requested), like the
    reference's driver-GPU ``calSVD`` (``RapidsRowMatrix.scala:94-95``), or
    NumPy/LAPACK float64. Returns (pc, explained_variance, mean) float64.
    """
    if count < 2 and mean_centering:
        raise ValueError("mean centering requires more than one row")
    denom = max(count - 1, 1)
    mean = col_sum / max(count, 1) if mean_centering else np.zeros_like(col_sum)
    if mean_centering:
        cov = (gram - count * np.outer(mean, mean)) / denom
    else:
        cov = gram / denom
    if use_xla_svd:
        import torch

        from spark_rapids_ml_tpu_torch.models.pca import _resolve_dtype
        from spark_rapids_ml_tpu_torch.ops.eigh import pca_from_covariance
        from spark_rapids_ml_tpu_torch.utils.resources import resolve_device

        device = resolve_device(device_id)
        cov_dev = torch.as_tensor(cov, dtype=_resolve_dtype("auto"),
                                  device=device)
        pc, evr = pca_from_covariance(cov_dev, k)
        return (
            pc.cpu().numpy().astype(np.float64),
            evr.cpu().numpy().astype(np.float64),
            mean,
        )
    from spark_rapids_ml_tpu_torch.models.pca import _host_eig_topk

    pc, evr = _host_eig_topk(cov, k)
    return np.asarray(pc), np.asarray(evr), mean


def discover_label_values(dataset, label_col: str) -> np.ndarray:
    """One label-only discovery job → sorted distinct label values — the
    family='auto' pre-pass shared by LogisticRegression and OneVsRest
    (never densifies the feature vectors)."""
    import pyarrow as pa

    def job(batches):
        for row in partition_label_values(batches, label_col):
            yield pa.RecordBatch.from_pylist(
                [row],
                schema=pa.schema([("labels", pa.list_(pa.float64()))]),
            )

    rows = dataset.select(label_col).mapInArrow(
        job, "labels array<double>"
    ).collect()
    return np.asarray(sorted({float(v) for r in rows for v in r["labels"]}))


# --------------------------------------------------------------------------
# per-feature moment partials (the scaler statistics plane)
# --------------------------------------------------------------------------

def partition_moment_stats(
    batches: Iterable, input_col: str,
    weight_col: Optional[str] = None,
) -> Iterator[Dict[str, object]]:
    """One partition's per-feature (n, Σx, Σx², min, max) — the additive
    partial that serves EVERY scaler fit (StandardScaler needs Σx/Σx²/n,
    MinMaxScaler needs min/max, MaxAbsScaler needs max(|min|, |max|)), so
    one executor pass replaces three driver collects. Same shape contract
    as ``partition_gram_stats``: Arrow batches or plain arrays, exactly
    one row, empty partitions yield nothing."""
    s1: Optional[np.ndarray] = None
    s2: Optional[np.ndarray] = None
    lo: Optional[np.ndarray] = None
    hi: Optional[np.ndarray] = None
    count = 0.0
    for batch in batches:
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(input_col))
        else:
            x = np.asarray(batch, dtype=np.float64)
        if x.shape[0] == 0:
            continue
        wt = _batch_weights_agg(batch, weight_col)
        if s1 is None:
            d = x.shape[1]
            s1 = np.zeros(d)
            s2 = np.zeros(d)
            lo = np.full(d, np.inf)
            hi = np.full(d, -np.inf)
        if wt is None:
            s1 += x.sum(axis=0)
            s2 += (x * x).sum(axis=0)
            count += x.shape[0]
        else:
            # weighted first/second moments (min/max stay unweighted —
            # a weight scales mass, it does not move the value range)
            s1 += (wt[:, None] * x).sum(axis=0)
            s2 += (wt[:, None] * x * x).sum(axis=0)
            count += float(wt.sum())
        lo = np.minimum(lo, x.min(axis=0))
        hi = np.maximum(hi, x.max(axis=0))
    if s1 is None:
        return
    yield {
        "count": count,
        "s1": s1.tolist(),
        "s2": s2.tolist(),
        "lo": lo.tolist(),
        "hi": hi.tolist(),
    }


def partition_moment_stats_arrow(batches, input_col: str,
                                 weight_col: Optional[str] = None):
    import pyarrow as pa

    for row in partition_moment_stats(batches, input_col,
                                      weight_col=weight_col):
        yield pa.RecordBatch.from_pylist(
            [row], schema=moment_stats_arrow_schema()
        )


def moment_stats_arrow_schema():
    import pyarrow as pa

    return pa.schema([
        ("count", pa.float64()),  # Σw (= row count unweighted)
        ("s1", pa.list_(pa.float64())),
        ("s2", pa.list_(pa.float64())),
        ("lo", pa.list_(pa.float64())),
        ("hi", pa.list_(pa.float64())),
    ])


def moment_stats_spark_ddl() -> str:
    return ("count double, s1 array<double>, s2 array<double>, "
            "lo array<double>, hi array<double>")


def summary_accumulate(x: np.ndarray, wt: Optional[np.ndarray],
                       acc: Optional[Dict[str, object]]) -> Dict[str, object]:
    """The ONE Summarizer accumulation step (Spark
    MultivariateOnlineSummarizer semantics): zero-weight rows are
    skipped entirely; count/nnz are UNWEIGHTED row/entry counts;
    s1/s2/l1 are weighted; wsq carries sum(w^2) for the
    reliability-weighted variance denominator. Shared by the executor
    partial and stat.Summarizer's in-memory path."""
    if wt is not None:
        keep = wt > 0
        x, wt = x[keep], wt[keep]
    if x.shape[0] == 0:
        return acc
    if acc is None:
        d = x.shape[1]
        acc = {
            "count": 0.0, "wsum": 0.0, "wsq": 0.0,
            "s1": np.zeros(d), "s2": np.zeros(d),
            "lo": np.full(d, np.inf), "hi": np.full(d, -np.inf),
            "nnz": np.zeros(d), "l1": np.zeros(d),
        }
    w = np.ones(x.shape[0]) if wt is None else wt
    xw = x * w[:, None]
    acc["count"] += float(x.shape[0])
    acc["wsum"] += float(w.sum())
    acc["wsq"] += float((w * w).sum())
    acc["s1"] += xw.sum(axis=0)
    acc["s2"] += (xw * x).sum(axis=0)
    acc["nnz"] += (x != 0).sum(axis=0)
    acc["l1"] += np.abs(xw).sum(axis=0)
    acc["lo"] = np.minimum(acc["lo"], x.min(axis=0))
    acc["hi"] = np.maximum(acc["hi"], x.max(axis=0))
    return acc


def partition_summary_stats(
    batches: Iterable, input_col: str,
    weight_col: Optional[str] = None,
) -> Iterator[Dict[str, object]]:
    """The moments partial extended with Summarizer's extra metrics —
    one executor pass serves ``stat.Summarizer`` on DataFrames."""
    acc = None
    for batch in batches:
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(input_col))
        else:
            x = np.asarray(batch, dtype=np.float64)
        if x.shape[0] == 0:
            continue
        acc = summary_accumulate(x, _batch_weights_agg(batch, weight_col),
                                 acc)
    if acc is None:
        return
    yield {k: (v.tolist() if isinstance(v, np.ndarray) else v)
           for k, v in acc.items()}


_SUMMARY_FIELDS = ("count", "wsum", "wsq", "s1", "s2", "lo", "hi", "nnz",
                   "l1")


def summary_stats_arrow_schema():
    import pyarrow as pa

    return pa.schema(
        [(f, pa.float64()) for f in ("count", "wsum", "wsq")]
        + [(f, pa.list_(pa.float64()))
           for f in ("s1", "s2", "lo", "hi", "nnz", "l1")]
    )


def summary_stats_spark_ddl() -> str:
    return ("count double, wsum double, wsq double, s1 array<double>, "
            "s2 array<double>, lo array<double>, hi array<double>, "
            "nnz array<double>, l1 array<double>")


def combine_summary_stats(rows: Iterable) -> Dict[str, object]:
    """Sum/min/max-merge of summary_accumulate partials."""
    acc = None
    for row in rows:
        get = row.get if isinstance(row, dict) else row.__getitem__
        if acc is None:
            acc = {f: (np.asarray(get(f), dtype=np.float64).copy()
                       if f not in ("count", "wsum", "wsq")
                       else float(get(f)))
                   for f in _SUMMARY_FIELDS}
        else:
            for f in ("count", "wsum", "wsq"):
                acc[f] += float(get(f))
            for f in ("s1", "s2", "nnz", "l1"):
                acc[f] += np.asarray(get(f), dtype=np.float64)
            acc["lo"] = np.minimum(
                acc["lo"], np.asarray(get("lo"), dtype=np.float64))
            acc["hi"] = np.maximum(
                acc["hi"], np.asarray(get("hi"), dtype=np.float64))
    if acc is None:
        raise ValueError("no partition statistics to combine (empty dataset)")
    return acc


def combine_moment_stats(rows: Iterable):
    """(n, Σx, Σx², min, max) over all partitions."""
    s1 = s2 = lo = hi = None
    count = 0
    for row in rows:
        get = row.get if isinstance(row, dict) else row.__getitem__
        if s1 is None:
            s1 = np.asarray(get("s1"), dtype=np.float64).copy()
            s2 = np.asarray(get("s2"), dtype=np.float64).copy()
            lo = np.asarray(get("lo"), dtype=np.float64).copy()
            hi = np.asarray(get("hi"), dtype=np.float64).copy()
        else:
            s1 += np.asarray(get("s1"), dtype=np.float64)
            s2 += np.asarray(get("s2"), dtype=np.float64)
            lo = np.minimum(lo, np.asarray(get("lo"), dtype=np.float64))
            hi = np.maximum(hi, np.asarray(get("hi"), dtype=np.float64))
        count += float(get("count"))
    if s1 is None:
        raise ValueError("no partition statistics to combine (empty dataset)")
    return count, s1, s2, lo, hi


def partition_svc_stats(
    batches: Iterable,
    features_col: str,
    label_col: str,
    w: np.ndarray,
    b: float,
    scale: Optional[np.ndarray] = None,
    weight_col: Optional[str] = None,
) -> Iterator[Dict[str, object]]:
    """One partition's squared-hinge Newton partials under broadcast
    (w, b) — the LinearSVC analogue of ``partition_logreg_stats``,
    emitting the SAME row shape (gx, hxx, hxb, rsum≡Σaỹ, ssum≡Σs,
    loss≡Σw·max(margin,0)², count≡Σw) so the logreg schema/combine are
    shared. ``scale`` (per-feature stds, broadcast) makes executors
    optimize in the standardized space, matching the local
    ``standardization=True`` semantics; the driver unscales at the end.
    """
    from spark_rapids_ml_tpu_torch.models.logistic_regression import _check_binary

    w = np.asarray(w, dtype=np.float64).reshape(-1)
    b = float(b)
    n = w.shape[0]
    gx = np.zeros(n)
    hxx = np.zeros((n, n))
    hxb = np.zeros(n)
    aysum = ssum = loss = 0.0
    count = 0.0
    for batch in batches:
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(features_col))
            y = np.asarray(batch.column(label_col).to_pylist(),
                           dtype=np.float64)
        else:
            x, y = batch
            x = np.asarray(x, dtype=np.float64)
            y = np.asarray(y, dtype=np.float64).reshape(-1)
        if x.shape[0] == 0:
            continue
        _check_binary(y, estimator="LinearSVC")
        wt = _batch_weights_agg(batch, weight_col)
        if scale is not None:
            x = x / np.asarray(scale)[None, :]
        ypm = 2.0 * y - 1.0
        margin = 1.0 - ypm * (x @ w + b)
        a = np.maximum(margin, 0.0)
        s = (margin > 0).astype(np.float64)
        if wt is not None:
            a = a * wt
            s = s * wt
        xs = x * s[:, None]
        ay = a * ypm
        gx += x.T @ ay
        hxx += x.T @ xs
        hxb += xs.sum(axis=0)
        aysum += float(ay.sum())
        ssum += float(s.sum())
        loss += float((a * np.maximum(margin, 0.0)).sum())
        count += float(wt.sum()) if wt is not None else x.shape[0]
    if count == 0:
        return
    yield {
        "gx": gx.tolist(),
        "hxx": hxx.ravel().tolist(),
        "hxb": hxb.tolist(),
        "rsum": aysum,
        "ssum": ssum,
        "loss": loss,
        "count": count,
    }


def partition_svc_stats_arrow(batches, features_col: str, label_col: str,
                              w: np.ndarray, b: float,
                              scale: Optional[np.ndarray] = None,
                              weight_col: Optional[str] = None):
    import pyarrow as pa

    for row in partition_svc_stats(batches, features_col, label_col, w, b,
                                   scale=scale, weight_col=weight_col):
        yield pa.RecordBatch.from_pylist(
            [row], schema=logreg_stats_arrow_schema()
        )


def partition_glm_stats(
    batches: Iterable,
    features_col: str,
    label_col: str,
    coef: np.ndarray,
    intercept: float,
    *,
    family: str,
    link: str,
    var_power: float,
    link_power: float,
    first: bool,
    weight_col: Optional[str] = None,
    offset_col: Optional[str] = None,
) -> Iterator[Dict[str, object]]:
    """One partition's GLM IRLS partials under broadcast (coef,
    intercept) — the weighted-least-squares working statistics
    (X'WX, X'Wz, sum(wx), sum(wz), sum(w)) plus the deviance, emitted in
    the SAME row shape as ``partition_logreg_stats`` (gx≡X'Wz, hxx≡X'WX,
    hxb≡sum(wx), rsum≡sum(wz), ssum≡sum(w), loss≡deviance, count≡rows)
    so the logreg schema/combine are shared. ``first`` runs the
    mustart-style starting iteration (``ops.glm_kernel.irls_step_math``).
    """
    from spark_rapids_ml_tpu_torch.ops.glm_kernel import (
        irls_step_math,
        validate_label_range,
    )

    coef = np.asarray(coef, dtype=np.float64).reshape(-1)
    totals = None
    count = 0.0
    for batch in batches:
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(features_col))
            y = np.asarray(batch.column(label_col).to_pylist(),
                           dtype=np.float64)
        else:
            x, y = batch
            x = np.asarray(x, dtype=np.float64)
            y = np.asarray(y, dtype=np.float64).reshape(-1)
        if x.shape[0] == 0:
            continue
        validate_label_range(y, family=family, var_power=var_power)
        wt = _batch_weights_agg(batch, weight_col)
        if offset_col:
            if not hasattr(batch, "column"):
                raise ValueError(
                    "plain (x, y) tuple batches cannot carry an offset "
                    "column; use Arrow batches"
                )
            off = np.asarray(batch.column(offset_col).to_pylist(),
                             dtype=np.float64)
        else:
            off = np.zeros(x.shape[0])
        # count carries sum(prior weights), matching partition_logreg_stats
        count += float(wt.sum()) if wt is not None else float(x.shape[0])
        if wt is None:
            wt = np.ones(x.shape[0])
        out = irls_step_math(
            np, x, y, wt, off, coef, float(intercept), family=family,
            link=link, var_power=var_power, link_power=link_power,
            use_init_mu=first,
        )
        totals = out if totals is None else type(out)(
            *(a + b for a, b in zip(totals, out)))
    if totals is None:
        return
    yield {
        "gx": [float(v) for v in np.asarray(totals.xtz)],
        "hxx": [float(v) for v in np.asarray(totals.xtx).reshape(-1)],
        "hxb": [float(v) for v in np.asarray(totals.x_sum)],
        "rsum": float(totals.z_sum),
        "ssum": float(totals.w_sum),
        "loss": float(totals.deviance),
        "count": count,
    }


def partition_glm_stats_arrow(batches, features_col: str, label_col: str,
                              coef: np.ndarray, intercept: float, **kw):
    import pyarrow as pa

    for row in partition_glm_stats(batches, features_col, label_col, coef,
                                   intercept, **kw):
        yield pa.RecordBatch.from_pylist(
            [row], schema=logreg_stats_arrow_schema()
        )


def partition_feature_sample(
    batches: Iterable,
    input_col: str,
    seed: int,
    cap: int = 8192,
    sample_stride: int = 1,
) -> Iterator[Dict[str, object]]:
    """One row per partition: a ≤``cap``-row approximately-uniform sample
    of the feature vectors (NaNs preserved) plus the partition row count —
    the features-only sibling of ``forest_plane.partition_forest_sample``,
    feeding driver-side quantile statistics (RobustScaler / median
    Imputer, the approxQuantile analogue). Strided partition gating keeps
    the driver merge bounded exactly as the forest sampler does."""
    from spark_rapids_ml_tpu_torch.spark.forest_plane import partition_identity

    pid = partition_identity()
    emit_sample = pid % max(sample_stride, 1) == 0
    rng = np.random.default_rng([seed & 0x7FFFFFFF, pid])
    buf = []
    buffered = 0
    n_seen = 0
    d_seen = 0
    for batch in batches:
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(input_col))
        else:
            x = np.asarray(batch, dtype=np.float64)
        if x.shape[0] == 0:
            continue
        n_seen += x.shape[0]
        d_seen = x.shape[1]
        if emit_sample:
            buf.append(x)
            buffered += x.shape[0]
            if buffered > 4 * cap:
                xa = np.concatenate(buf)
                keep = rng.choice(xa.shape[0], 4 * cap, replace=False)
                buf, buffered = [xa[keep]], 4 * cap
    if n_seen == 0:
        return
    if emit_sample:
        xa = np.concatenate(buf)
        if xa.shape[0] > cap:
            keep = rng.choice(xa.shape[0], cap, replace=False)
            xa = xa[keep]
        sample = xa.ravel().tolist()
        d = int(xa.shape[1])
    else:
        sample = []
        d = int(d_seen)
    yield {"n": n_seen, "sample": sample, "d": d}


def feature_sample_arrow_schema():
    import pyarrow as pa

    return pa.schema([
        ("n", pa.int64()),
        ("sample", pa.list_(pa.float64())),
        ("d", pa.int64()),
    ])


def feature_sample_spark_ddl() -> str:
    return "n long, sample array<double>, d long"


def partition_imputer_stats(
    batches: Iterable, input_col: str, missing_value: float
) -> Iterator[Dict[str, object]]:
    """One partition's PER-FEATURE non-missing (count, Σx) — the
    missing-aware moments the mean Imputer needs exactly (NaN entries
    and the sentinel are excluded per feature, Spark's null semantics)."""
    s1: Optional[np.ndarray] = None
    cnt: Optional[np.ndarray] = None
    for batch in batches:
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(input_col))
        else:
            x = np.asarray(batch, dtype=np.float64)
        if x.shape[0] == 0:
            continue
        missing = np.isnan(x)
        if not np.isnan(missing_value):
            missing |= x == missing_value
        if s1 is None:
            s1 = np.zeros(x.shape[1])
            cnt = np.zeros(x.shape[1])
        xv = np.where(missing, 0.0, x)
        s1 += xv.sum(axis=0)
        cnt += (~missing).sum(axis=0)
    if s1 is None:
        return
    yield {"count_vec": cnt.tolist(), "s1": s1.tolist()}


def imputer_stats_arrow_schema():
    import pyarrow as pa

    return pa.schema([
        ("count_vec", pa.list_(pa.float64())),
        ("s1", pa.list_(pa.float64())),
    ])


def imputer_stats_spark_ddl() -> str:
    return "count_vec array<double>, s1 array<double>"


# --------------------------------------------------------------------------
# GaussianMixture plane: one EM pass's partials under the broadcast state
# --------------------------------------------------------------------------

def gmm_stats_spark_ddl() -> str:
    return ("nk array<double>, mk array<double>, sk array<double>, "
            "loglik double, wsum double")


def gmm_stats_arrow_schema():
    import pyarrow as pa

    return pa.schema(
        [
            ("nk", pa.list_(pa.float64())),
            ("mk", pa.list_(pa.float64())),
            ("sk", pa.list_(pa.float64())),
            ("loglik", pa.float64()),
            ("wsum", pa.float64()),
        ]
    )


def partition_gmm_stats(
    batches: Iterable,
    features_col: str,
    means: np.ndarray,
    prec_chol: np.ndarray,
    log_det: np.ndarray,
    log_weights: np.ndarray,
    weight_col: Optional[str] = None,
) -> Iterator[Dict[str, object]]:
    """One partition's GaussianMixture EM partials under the broadcast
    mixture state: (sum r, sum r x, sum r x x^T, loglik, sum w) — the
    per-iteration statistics-plane shape of ``ops.gmm_kernel``
    (``estep_stats_math`` with numpy is the shared math)."""
    from spark_rapids_ml_tpu_torch.ops.gmm_kernel import (
        GmmStats,
        estep_stats_math,
    )

    means = np.asarray(means, dtype=np.float64)
    totals = None
    for batch in batches:
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(features_col))
        else:
            x = np.asarray(batch, dtype=np.float64)
        if x.shape[0] == 0:
            continue
        wt = _batch_weights_agg(batch, weight_col)
        if wt is None:
            wt = np.ones(x.shape[0])
        out = estep_stats_math(
            np, x, wt, means, np.asarray(prec_chol), np.asarray(log_det),
            np.asarray(log_weights))
        totals = out if totals is None else GmmStats(
            *(a + b for a, b in zip(totals, out)))
    if totals is None:
        return
    yield {
        "nk": [float(v) for v in np.asarray(totals.resp_sum)],
        "mk": [float(v) for v in np.asarray(totals.mean_sum).reshape(-1)],
        "sk": [float(v) for v in np.asarray(totals.sq_sum).reshape(-1)],
        "loglik": float(totals.loglik),
        "wsum": float(totals.w_sum),
    }


def partition_gmm_stats_arrow(batches, features_col: str, means, prec_chol,
                              log_det, log_weights, **kw):
    import pyarrow as pa

    for row in partition_gmm_stats(batches, features_col, means, prec_chol,
                                   log_det, log_weights, **kw):
        yield pa.RecordBatch.from_pylist(
            [row], schema=gmm_stats_arrow_schema()
        )


def combine_gmm_stats(rows: Iterable, k: int, d: int):
    """Driver-side reduce of per-partition GMM partials → GmmStats."""
    from spark_rapids_ml_tpu_torch.ops.gmm_kernel import GmmStats

    nk = np.zeros(k)
    mk = np.zeros((k, d))
    sk = np.zeros((k, d, d))
    loglik = wsum = 0.0
    seen = False
    for row in rows:
        get = row.get if isinstance(row, dict) else row.__getitem__
        nk += np.asarray(get("nk"), dtype=np.float64)
        mk += np.asarray(get("mk"), dtype=np.float64).reshape(k, d)
        sk += np.asarray(get("sk"), dtype=np.float64).reshape(k, d, d)
        loglik += float(get("loglik"))
        wsum += float(get("wsum"))
        seen = True
    if not seen:
        raise ValueError("no partition statistics to combine (empty dataset)")
    return GmmStats(resp_sum=nk, mean_sum=mk, sq_sum=sk, loglik=loglik,
                    w_sum=wsum)


# --------------------------------------------------------------------------
# BisectingKMeans plane: hierarchical routing + per-leaf / 2-means partials
# --------------------------------------------------------------------------

def route_rows_bisecting(x: np.ndarray, nodes) -> np.ndarray:
    """Leaf id per row under the bisecting hierarchy.

    ``nodes``: list of internal nodes ``{"cl", "cr", "l", "r"}`` — the
    two ROUTING centers a split's 2-means produced, and the child ids
    (``>= 0``: another internal node; ``< 0``: leaf ``-(child) - 1``).
    A row descends from node 0, taking the nearer routing center at
    each internal node — membership is a pure function of the broadcast
    hierarchy, so executors re-derive it without the driver ever
    shipping row indices. Empty ``nodes`` = the single root leaf 0.
    """
    n_rows = x.shape[0]
    if not nodes:
        return np.zeros(n_rows, dtype=np.int64)
    leaf = np.full(n_rows, -1, dtype=np.int64)
    cur = np.zeros(n_rows, dtype=np.int64)
    active = np.ones(n_rows, dtype=bool)
    while active.any():
        for nid in np.unique(cur[active]):
            rows = np.flatnonzero(active & (cur == nid))
            node = nodes[int(nid)]
            dl = ((x[rows] - np.asarray(node["cl"])[None, :]) ** 2).sum(1)
            dr = ((x[rows] - np.asarray(node["cr"])[None, :]) ** 2).sum(1)
            nxt = np.where(dr < dl, int(node["r"]), int(node["l"]))
            into_leaf = nxt < 0
            leaf_rows = rows[into_leaf]
            leaf[leaf_rows] = -nxt[into_leaf] - 1
            active[leaf_rows] = False
            desc = rows[~into_leaf]
            cur[desc] = nxt[~into_leaf]
    return leaf


def partition_bisecting_moments(
    batches: Iterable, input_col: str, nodes, n_leaves: int,
    weight_col: Optional[str] = None,
) -> Iterator[Dict[str, object]]:
    """Per-leaf (Σw·x, Σw, raw count, Σw·‖x−0‖² pieces, min, max) under
    the broadcast hierarchy — one pass gives every leaf's weighted mean,
    SSE (via the moments identity Σw‖x‖² − ‖Σwx‖²/Σw), divisibility
    (raw size + per-feature spread), all additively combinable."""
    d = None
    sums = counts = raws = sqs = mins = maxs = None
    seen = 0
    for batch in batches:
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(input_col))
        else:
            x = np.asarray(batch, dtype=np.float64)
        if x.shape[0] == 0:
            continue
        if d is None:
            d = x.shape[1]
            sums = np.zeros((n_leaves, d))
            counts = np.zeros(n_leaves)
            raws = np.zeros(n_leaves)
            sqs = np.zeros(n_leaves)
            mins = np.full((n_leaves, d), np.inf)
            maxs = np.full((n_leaves, d), -np.inf)
        wt = _batch_weights_agg(batch, weight_col)
        w = np.ones(x.shape[0]) if wt is None else wt
        leaf = route_rows_bisecting(x, nodes)
        np.add.at(sums, leaf, x * w[:, None])
        np.add.at(counts, leaf, w)
        np.add.at(raws, leaf, 1.0)
        np.add.at(sqs, leaf, w * (x * x).sum(axis=1))
        for lf in np.unique(leaf):
            rows = leaf == lf
            mins[lf] = np.minimum(mins[lf], x[rows].min(axis=0))
            maxs[lf] = np.maximum(maxs[lf], x[rows].max(axis=0))
        seen += x.shape[0]
    if d is None:
        return
    yield {
        "sums": sums.ravel().tolist(),
        "counts": counts.tolist(),
        "extra": np.concatenate(
            [raws, sqs, mins.ravel(), maxs.ravel()]).tolist(),
        "cost": 0.0,
        "count": seen,
    }


def partition_bisecting_lloyd(
    batches: Iterable, input_col: str, nodes, target_leaf: int,
    centers: np.ndarray, weight_col: Optional[str] = None,
) -> Iterator[Dict[str, object]]:
    """One Lloyd half-step of the target leaf's 2-means: rows routed to
    ``target_leaf`` are assigned to the nearer of the two broadcast
    centers; emits per-side (Σw·x, Σw, raw count) + assignment cost."""
    c = np.asarray(centers, dtype=np.float64)
    d = c.shape[1]
    sums = np.zeros((2, d))
    counts = np.zeros(2)
    raws = np.zeros(2)
    cost = 0.0
    seen = 0
    for batch in batches:
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(input_col))
        else:
            x = np.asarray(batch, dtype=np.float64)
        if x.shape[0] == 0:
            continue
        wt = _batch_weights_agg(batch, weight_col)
        w = np.ones(x.shape[0]) if wt is None else wt
        leaf = route_rows_bisecting(x, nodes)
        rows = leaf == target_leaf
        if not rows.any():
            seen += x.shape[0]
            continue
        xs, ws = x[rows], w[rows]
        dist = np.maximum(
            (xs * xs).sum(axis=1)[:, None]
            + (c * c).sum(axis=1)[None, :] - 2.0 * (xs @ c.T), 0.0)
        side = dist.argmin(axis=1)
        np.add.at(sums, side, xs * ws[:, None])
        np.add.at(counts, side, ws)
        np.add.at(raws, side, 1.0)
        cost += float((ws * dist.min(axis=1)).sum())
        seen += x.shape[0]
    yield {
        "sums": sums.ravel().tolist(),
        "counts": counts.tolist(),
        "extra": raws.tolist(),
        "cost": cost,
        "count": seen,
    }


def partition_bisecting_sample(
    batches: Iterable, input_col: str, nodes, target_leaf: int,
    m: int,
) -> Iterator[Dict[str, object]]:
    """Up to ``m`` rows of the target leaf from this partition — the
    bounded seeding sample the driver runs k-means++(2) on (the same
    sample-seeded posture as the KMeans plane's ``df.limit`` seeding)."""
    kept = []
    total = 0
    for batch in batches:
        if total >= m:
            break  # quota full: skip even the Arrow decode
        if hasattr(batch, "column"):
            x = vector_column_to_matrix(batch.column(input_col))
        else:
            x = np.asarray(batch, dtype=np.float64)
        if x.shape[0] == 0:
            continue
        leaf = route_rows_bisecting(x, nodes)
        rows = x[leaf == target_leaf]
        take = rows[: m - total]
        if take.shape[0]:
            kept.append(take)
            total += take.shape[0]
    if not kept:
        return
    sample = np.concatenate(kept)
    yield {
        "rows": sample.ravel().tolist(),
        "count": int(sample.shape[0]),
    }


def bisecting_stats_spark_ddl() -> str:
    return ("sums array<double>, counts array<double>, "
            "extra array<double>, cost double, count bigint")


def bisecting_sample_spark_ddl() -> str:
    return "rows array<double>, count bigint"


def combine_bisecting_stats(rows: Iterable, n_groups: int, d: int,
                            extra_per_group: int):
    """Driver reduce: (sums (G,d), counts (G,), extra stacked per the
    job's layout, cost, rows seen). ``extra`` combines additively for
    the first ``2·G`` entries (raw counts / sq-sums) and by min/max for
    the trailing min/max blocks when present (moments job)."""
    sums = np.zeros((n_groups, d))
    counts = np.zeros(n_groups)
    extra = None
    cost = 0.0
    seen = 0
    for row in rows:
        get = row.get if isinstance(row, dict) else row.__getitem__
        sums += np.asarray(get("sums"), dtype=np.float64).reshape(
            n_groups, d)
        counts += np.asarray(get("counts"), dtype=np.float64)
        e = np.asarray(get("extra"), dtype=np.float64)
        if extra is None:
            extra = e.copy()
        else:
            if extra_per_group > 2:
                # moments layout: [raws G | sqs G | mins G*d | maxs G*d]
                add = 2 * n_groups
                extra[:add] += e[:add]
                half = (e.shape[0] - add) // 2
                extra[add:add + half] = np.minimum(
                    extra[add:add + half], e[add:add + half])
                extra[add + half:] = np.maximum(
                    extra[add + half:], e[add + half:])
            else:
                extra += e
        cost += float(get("cost"))
        seen += int(get("count"))
    return sums, counts, extra, cost, seen


def bisecting_stats_arrow_schema():
    import pyarrow as pa

    return pa.schema([
        ("sums", pa.list_(pa.float64())),
        ("counts", pa.list_(pa.float64())),
        ("extra", pa.list_(pa.float64())),
        ("cost", pa.float64()),
        ("count", pa.int64()),
    ])


def bisecting_sample_arrow_schema():
    import pyarrow as pa

    return pa.schema([
        ("rows", pa.list_(pa.float64())),
        ("count", pa.int64()),
    ])


def partition_bisecting_moments_arrow(batches, input_col, nodes, n_leaves,
                                      weight_col=None):
    import pyarrow as pa

    for row in partition_bisecting_moments(batches, input_col, nodes,
                                           n_leaves,
                                           weight_col=weight_col):
        yield pa.RecordBatch.from_pylist(
            [row], schema=bisecting_stats_arrow_schema())


def partition_bisecting_lloyd_arrow(batches, input_col, nodes, target_leaf,
                                    centers, weight_col=None):
    import pyarrow as pa

    for row in partition_bisecting_lloyd(batches, input_col, nodes,
                                         target_leaf, centers,
                                         weight_col=weight_col):
        yield pa.RecordBatch.from_pylist(
            [row], schema=bisecting_stats_arrow_schema())


def partition_bisecting_sample_arrow(batches, input_col, nodes,
                                     target_leaf, m):
    import pyarrow as pa

    for row in partition_bisecting_sample(batches, input_col, nodes,
                                          target_leaf, m):
        yield pa.RecordBatch.from_pylist(
            [row], schema=bisecting_sample_arrow_schema())
