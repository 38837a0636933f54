"""pyspark.ml.stat parity: Correlation, ChiSquareTest, Summarizer,
KolmogorovSmirnovTest, ANOVATest, FValueTest — on PyTorch.

The port's copy of the JAX package's ``stat.py``, itself beyond-parity
surface following upstream ``pyspark.ml.stat`` semantics (the reference
repo, spark-rapids-ml 21.12, ships none of these). Every entry accepts a
feature matrix, a ``VectorFrame``, or a DataFrame (pyspark / local
engine): DataFrame inputs ride the executor statistics planes where the
statistic decomposes (Pearson correlation = the PCA plane's Gram partial,
``spark/aggregate.py::partition_gram_stats``; Summarizer = an extended
moments partial), and fall back to an envelope-guarded collect only for
the rank/contingency statistics that need global state (Spearman,
chi-square).

Card mapping: Pearson's sufficient statistics (XᵀX, Σx, n) of an
in-memory matrix are one ``ops.streaming.update_stats`` on the card (the
card unless the CPU is requested, ``utils.resources.resolve_device``),
which at float32 is one launch of the hand Gram kernel
(``csrc/fused_gram.cu``) at its default precision, bfloat16_3x — the
precision of the JAX package's ``partial_gram_stats`` default. Everything
after is tiny host float64. The JAX package picks that Gram's dtype from
``jax_enable_x64``; the port computes in float32, its ``'auto'`` dtype,
and ``_DTYPE`` below is a module-level seam that the parity tests set to
``torch.float64`` (as ``linalg/row_matrix.py`` does). Like the JAX
package, the correlation is formed from the uncentred G/n − μμᵀ, which
cancels on columns whose mean is large against their spread (ROADMAP
queue 3 item 9).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# The device dtype of Pearson's Gram (see the module docstring): a seam
# for the parity tests.
_DTYPE = torch.float32

__all__ = ["ANOVATest", "ChiSquareTest", "Correlation", "FValueTest",
           "KolmogorovSmirnovTest", "Summarizer"]


def _is_dataframe(dataset) -> bool:
    return hasattr(dataset, "mapInArrow") and hasattr(dataset, "select")


def _collect_matrix(dataset, column: str) -> np.ndarray:
    """Envelope-guarded DataFrame feature collect (the adapter
    convention, ``spark/adapter.py::_check_collect_envelope``)."""
    from spark_rapids_ml_tpu_torch.spark.adapter import _check_collect_envelope

    _check_collect_envelope(dataset, "ml.stat")
    rows = dataset.select(column).collect()
    return np.asarray(
        [np.asarray(r[0], dtype=np.float64)
         if not hasattr(r[0], "toArray") else r[0].toArray()
         for r in rows],
        dtype=np.float64,
    )


def _gram_stats(dataset, column: str, use_device: bool):
    """(G = X'X, sum x, n) from any input shape."""
    if _is_dataframe(dataset):
        import pyarrow as pa

        from spark_rapids_ml_tpu_torch.spark.aggregate import (
            combine_stats,
            partition_gram_stats,
            stats_arrow_schema,
            stats_spark_ddl,
        )

        def job(batches):
            for row in partition_gram_stats(batches, column):
                yield pa.RecordBatch.from_pylist(
                    [row], schema=stats_arrow_schema())

        rows = dataset.select(column).mapInArrow(
            job, stats_spark_ddl()).collect()
        return combine_stats(rows)
    from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame

    frame = as_vector_frame(dataset, column)
    x = frame.vectors_as_matrix(column)
    if use_device:
        from spark_rapids_ml_tpu_torch.ops.streaming import (
            init_stats,
            update_stats,
        )

        stats = init_stats(x.shape[1], dtype=_DTYPE)
        stats = update_stats(stats, x)
        return (stats.gram.cpu().numpy().astype(np.float64),
                stats.col_sum.cpu().numpy().astype(np.float64),
                float(stats.count))
    x = np.asarray(x, dtype=np.float64)
    return x.T @ x, x.sum(axis=0), float(x.shape[0])


def _corr_from_gram(gram: np.ndarray, col_sum: np.ndarray, n: float):
    mu = col_sum / n
    cov = gram / n - np.outer(mu, mu)
    sd = np.sqrt(np.maximum(np.diag(cov), 0.0))
    denom = np.outer(sd, sd)
    with np.errstate(invalid="ignore", divide="ignore"):
        corr = cov / denom
    corr[denom == 0] = np.nan   # constant columns: Spark emits NaN
    np.fill_diagonal(corr, 1.0)
    return corr


class Correlation:
    """``Correlation.corr(df, "features")`` -> (d, d) matrix.

    ``pyspark.ml.stat.Correlation`` semantics: method 'pearson'
    (default) or 'spearman'; constant columns correlate as NaN.
    Pearson decomposes onto the executor Gram plane; Spearman needs
    global ranks, so DataFrame inputs collect under the adapter
    envelope.
    """

    @staticmethod
    def corr(dataset, column: str = "features",
             method: str = "pearson") -> np.ndarray:
        if method not in ("pearson", "spearman"):
            raise ValueError(f"unknown correlation method {method!r}")
        if method == "spearman":
            if _is_dataframe(dataset):
                x = _collect_matrix(dataset, column)
            else:
                from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame

                x = as_vector_frame(dataset, column) \
                    .vectors_as_matrix(column).astype(np.float64)
            from scipy.stats import rankdata

            ranks = np.apply_along_axis(rankdata, 0, x)
            g, s, n = ranks.T @ ranks, ranks.sum(axis=0), float(
                ranks.shape[0])
            return _corr_from_gram(g, s, n)
        g, s, n = _gram_stats(dataset, column, use_device=True)
        return _corr_from_gram(g, s, n)


class ChiSquareTest:
    """``ChiSquareTest.test(df, "features", "label")`` ->
    {pValues, degreesOfFreedom, statistics} (one entry per feature).

    ``pyspark.ml.stat.ChiSquareTest`` semantics: Pearson's independence
    test on the (feature value x label value) contingency table of each
    categorical feature.
    """

    @staticmethod
    def test(dataset, featuresCol: str = "features",
             labelCol: str = "label") -> dict:
        from scipy.stats import chi2 as chi2_dist

        if _is_dataframe(dataset):
            from spark_rapids_ml_tpu_torch.spark.adapter import (
                _check_collect_envelope,
            )

            _check_collect_envelope(dataset, "ChiSquareTest")
            rows = dataset.select(featuresCol, labelCol).collect()
            x = np.asarray(
                [r[0].toArray() if hasattr(r[0], "toArray")
                 else np.asarray(r[0], dtype=np.float64) for r in rows])
            y = np.asarray([float(r[1]) for r in rows])
        else:
            from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame

            frame = as_vector_frame(dataset, featuresCol)
            x = frame.vectors_as_matrix(featuresCol).astype(np.float64)
            y = np.asarray(frame.column(labelCol), dtype=np.float64)
        labels, y_idx = np.unique(y, return_inverse=True)
        n = x.shape[0]
        stats, dofs, pvals = [], [], []
        for j in range(x.shape[1]):
            values, v_idx = np.unique(x[:, j], return_inverse=True)
            table = np.zeros((values.size, labels.size))
            np.add.at(table, (v_idx, y_idx), 1.0)
            row_tot = table.sum(axis=1, keepdims=True)
            col_tot = table.sum(axis=0, keepdims=True)
            expected = row_tot @ col_tot / n
            with np.errstate(invalid="ignore", divide="ignore"):
                contrib = (table - expected) ** 2 / expected
            stat = float(np.nansum(contrib))
            dof = int((values.size - 1) * (labels.size - 1))
            stats.append(stat)
            dofs.append(dof)
            pvals.append(
                float(chi2_dist.sf(stat, dof)) if dof > 0 else 1.0)
        return {
            "statistics": np.asarray(stats),
            "degreesOfFreedom": np.asarray(dofs, dtype=np.int64),
            "pValues": np.asarray(pvals),
        }


class Summarizer:
    """``Summarizer.summarize(df, "features")`` -> dict of per-feature
    vectors: mean, variance, std, count, numNonZeros, max, min, normL1,
    normL2 (``pyspark.ml.stat.Summarizer``'s metric set, sample
    variance like Spark). DataFrame inputs reduce one extended moments
    partial on the executor plane."""

    METRICS = ("mean", "variance", "std", "count", "numNonZeros",
               "max", "min", "normL1", "normL2")

    @staticmethod
    def summarize(dataset, column: str = "features",
                  weightCol: Optional[str] = None) -> dict:
        from spark_rapids_ml_tpu_torch.spark.aggregate import summary_accumulate

        if _is_dataframe(dataset):
            import pyarrow as pa

            from spark_rapids_ml_tpu_torch.spark.aggregate import (
                combine_summary_stats,
                partition_summary_stats,
                summary_stats_arrow_schema,
                summary_stats_spark_ddl,
            )

            cols = [column] + ([weightCol] if weightCol else [])

            def job(batches):
                for row in partition_summary_stats(
                        batches, column, weight_col=weightCol):
                    yield pa.RecordBatch.from_pylist(
                        [row], schema=summary_stats_arrow_schema())

            rows = dataset.select(*cols).mapInArrow(
                job, summary_stats_spark_ddl()).collect()
            acc = combine_summary_stats(rows)
        else:
            from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame

            frame = as_vector_frame(dataset, column)
            x = frame.vectors_as_matrix(column).astype(np.float64)
            w = (np.asarray(frame.column(weightCol), dtype=np.float64)
                 if weightCol else None)
            acc = summary_accumulate(x, w, None)
            if acc is None:
                raise ValueError("empty dataset")
        wsum = acc["wsum"]
        mean = acc["s1"] / wsum
        # Spark's reliability-weighted sample variance:
        # M2n / (sum(w) - sum(w^2)/sum(w)); unweighted this is the usual
        # (n-1) denominator
        m2n = np.maximum(acc["s2"] - acc["s1"] ** 2 / wsum, 0.0)
        denom = wsum - acc["wsq"] / wsum
        var = m2n / denom if denom > 0 else np.zeros_like(m2n)
        return {
            "mean": mean,
            "variance": var,
            "std": np.sqrt(var),
            "count": acc["count"],          # unweighted, Spark semantics
            "numNonZeros": acc["nnz"],      # unweighted, Spark semantics
            "max": acc["hi"],
            "min": acc["lo"],
            "normL1": acc["l1"],
            "normL2": np.sqrt(acc["s2"]),
        }


class KolmogorovSmirnovTest:
    """``ml.stat.KolmogorovSmirnovTest`` parity: one-sample, two-sided
    KS test of a numeric column against a theoretical distribution.

    ``test(dataset, sampleCol, "norm", mean, std)`` mirrors Spark's
    surface (Spark supports 'norm' plus a user CDF; a Python callable
    CDF is accepted here the way Spark accepts a lambda). Returns a
    one-row frame (pValue, statistic). The p-value uses the asymptotic
    Kolmogorov distribution Q(√n·D) with the Stephens √n correction —
    the same approximation Spark inherits from commons-math.
    """

    @staticmethod
    def test(dataset, sampleCol: str, distName="norm", *params):
        from spark_rapids_ml_tpu_torch.data.frame import (
            VectorFrame,
            as_vector_frame,
        )

        frame = as_vector_frame(dataset, sampleCol)
        x = np.sort(np.asarray(frame.column(sampleCol),
                               dtype=np.float64))
        n = x.shape[0]
        if n == 0:
            raise ValueError("cannot run the KS test on an empty column")
        if callable(distName):
            cdf_vals = np.asarray([distName(v) for v in x],
                                  dtype=np.float64)
        elif distName == "norm":
            mean = float(params[0]) if len(params) > 0 else 0.0
            std = float(params[1]) if len(params) > 1 else 1.0
            if std <= 0:
                raise ValueError("std must be positive")
            from spark_rapids_ml_tpu_torch.ops.glm_kernel import _ndtr

            cdf_vals = np.asarray(_ndtr(np, (x - mean) / std),
                                  dtype=np.float64)
        else:
            raise ValueError(
                f"unsupported distName {distName!r}: 'norm' or a "
                "callable CDF")
        ecdf_hi = np.arange(1, n + 1) / n
        ecdf_lo = np.arange(0, n) / n
        d = float(np.maximum(np.abs(ecdf_hi - cdf_vals),
                             np.abs(cdf_vals - ecdf_lo)).max())
        # asymptotic two-sided p-value Q(t) with the Stephens finite-n
        # correction. Two series, switched at t=1 like scipy's
        # kolmogorov: the alternating form converges fast for large t
        # but its paired terms cancel catastrophically for small t (a
        # 100-term truncation reported p≈0 for PERFECT fits at n≥1e4);
        # the Jacobi-theta transform converges fast exactly there.
        t = d * (np.sqrt(n) + 0.12 + 0.11 / np.sqrt(n))
        if t < 1e-3:
            p = 1.0
        elif t < 1.0:
            s = sum(np.exp(-((2 * j - 1) ** 2) * np.pi ** 2
                           / (8.0 * t * t)) for j in range(1, 21))
            p = 1.0 - float(np.sqrt(2.0 * np.pi) / t * s)
        else:
            p = float(sum(
                2.0 * (-1.0) ** (j - 1) * np.exp(-2.0 * j * j * t * t)
                for j in range(1, 101)))
        p = float(min(max(p, 0.0), 1.0))
        return VectorFrame({"pValue": [p], "statistic": [d]})


class _FeatureTestBase:
    """Shared frame plumbing for the per-feature hypothesis tests
    (``ml.stat.ANOVATest`` / ``FValueTest``, Spark 3.1): one row out,
    with parallel pValues / degreesOfFreedom / fValues arrays."""

    @classmethod
    def test(cls, dataset, featuresCol: str = "features",
             labelCol: str = "label"):
        from spark_rapids_ml_tpu_torch.data.frame import (
            VectorFrame,
            as_vector_frame,
        )

        if _is_dataframe(dataset):
            # same envelope-guarded collect as ChiSquareTest: these are
            # global per-feature tests, not partition-decomposable
            from spark_rapids_ml_tpu_torch.spark.adapter import (
                _check_collect_envelope,
            )

            _check_collect_envelope(dataset, type(cls).__name__)
            rows = dataset.select(featuresCol, labelCol).collect()
            x = np.asarray(
                [r[0].toArray() if hasattr(r[0], "toArray")
                 else np.asarray(r[0], dtype=np.float64) for r in rows])
            y = np.asarray([float(r[1]) for r in rows])
        else:
            frame = as_vector_frame(dataset, featuresCol)
            x = frame.vectors_as_matrix(featuresCol)
            y = np.asarray(frame.column(labelCol), dtype=np.float64)
        p, dof, f = cls._scores(x, y)
        return VectorFrame({
            "pValues": [list(map(float, p))],
            "degreesOfFreedom": [list(map(int, dof))],
            "fValues": [list(map(float, f))],
        })


def anova_f_scores(x: np.ndarray, y: np.ndarray):
    """Per-feature one-way ANOVA (p, F) of continuous features against
    a categorical label — the ONE copy shared by ``ANOVATest`` and
    ``UnivariateFeatureSelector``."""
    from scipy import stats

    classes = np.unique(y)
    if classes.size < 2:
        raise ValueError("ANOVA needs at least 2 classes")
    groups = [x[y == c] for c in classes]
    d = x.shape[1]
    p = np.empty(d)
    f = np.empty(d)
    for j in range(d):
        res = stats.f_oneway(*(g[:, j] for g in groups))
        p[j], f[j] = res.pvalue, res.statistic
    return p, f


def f_regression_scores(x: np.ndarray, y: np.ndarray):
    """Per-feature F-regression (p, F) of continuous features against a
    continuous label (squared correlation scaled by the residual dof);
    non-finite correlations (constant columns) score (p=1, F=0)."""
    from scipy import stats

    n, d = x.shape
    dof = n - 2
    p = np.empty(d)
    f = np.empty(d)
    for j in range(d):
        r = np.corrcoef(x[:, j], y)[0, 1]
        if not np.isfinite(r):
            p[j], f[j] = 1.0, 0.0
            continue
        f[j] = r * r * dof / max(1.0 - r * r, 1e-300)
        p[j] = stats.f.sf(f[j], 1, dof)
    return p, f


class ANOVATest(_FeatureTestBase):
    """One-way ANOVA F-test of each continuous feature against a
    categorical label (``ml.stat.ANOVATest``). degreesOfFreedom follows
    Spark's convention: dfbn + dfwn = (k−1) + (n−k) = n−1."""

    @staticmethod
    def _scores(x, y):
        p, f = anova_f_scores(x, y)
        d = x.shape[1]
        return p, np.full(d, x.shape[0] - 1, dtype=np.int64), f


class FValueTest(_FeatureTestBase):
    """F-test of each continuous feature against a continuous label
    (F-regression; dof = n − 2, the residual degrees)."""

    @staticmethod
    def _scores(x, y):
        p, f = f_regression_scores(x, y)
        d = x.shape[1]
        return p, np.full(d, x.shape[0] - 2, dtype=np.int64), f
