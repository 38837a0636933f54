"""Evaluators: the metric half of the Spark ML tuning API, on the host.

The port's copy of the JAX package's ``models/evaluation.py``. Param
names and defaults follow ``org.apache.spark.ml.evaluation``
(RegressionEvaluator / BinaryClassificationEvaluator / ...) — the API
surface the reference plugs into, since its Estimators are consumed by
Spark's own CrossValidator. Metrics are NumPy float64 on the host, the
same operations in the same order as the JAX package's: they are O(rows)
scalar reductions over already-computed predictions, not card work. The
port's models leave numpy arrays or lists in the columns an evaluator
reads, never a device tensor.
"""

from __future__ import annotations

import numpy as np

from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame
from spark_rapids_ml_tpu_torch.models.params import Param, Params


def _metric_frame(dataset, *cols):
    """The metric columns of ``dataset`` as a VectorFrame. DataFrames
    (pyspark or the local engine) are pruned to ``cols`` BEFORE the
    driver materialization ``as_vector_frame`` performs — an evaluator
    input is a transformed fold, and collecting the feature/probability
    columns a scalar metric never reads would scale the collect with
    feature width instead of O(rows)."""
    if (hasattr(dataset, "select") and hasattr(dataset, "columns")
            and hasattr(dataset, "collect")):
        dataset = dataset.select(*cols)
    return as_vector_frame(dataset, cols[0])


class _KwargsInit:
    """Shared evaluator base: the kwargs constructor
    (``Ev(metricName=..)``) and Spark's DefaultParamsWritable-style
    params-only persistence — one copy instead of six."""

    def __init__(self, uid=None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    def save(self, path, overwrite=False):
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @classmethod
    def load(cls, path):
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(cls, path)


class RegressionEvaluator(_KwargsInit, Params):
    """rmse (default) / mse / mae / r2 over (labelCol, predictionCol)."""

    labelCol = Param("labelCol", "label column name", "label")
    predictionCol = Param(
        "predictionCol", "prediction column name", "prediction"
    )
    metricName = Param(
        "metricName",
        "rmse | mse | mae | r2",
        "rmse",
        validator=lambda v: v in ("rmse", "mse", "mae", "r2"),
    )

    def is_larger_better(self) -> bool:
        return self.getMetricName() == "r2"

    def evaluate(self, dataset) -> float:
        frame = _metric_frame(dataset, self.getPredictionCol(),
                              self.getLabelCol())
        y = np.asarray(frame.column(self.getLabelCol()), dtype=np.float64)
        pred = np.asarray(
            frame.column(self.getPredictionCol()), dtype=np.float64
        )
        resid = y - pred
        name = self.getMetricName()
        if name == "mse":
            return float((resid**2).mean())
        if name == "rmse":
            return float(np.sqrt((resid**2).mean()))
        if name == "mae":
            return float(np.abs(resid).mean())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        if ss_tot <= 0:
            return 0.0
        return 1.0 - float((resid**2).sum()) / ss_tot


class BinaryClassificationEvaluator(_KwargsInit, Params):
    """areaUnderROC (default) / areaUnderPR over (labelCol, score column).

    ``rawPredictionCol`` accepts any monotone score — this framework's
    LogisticRegression writes P(y=1) to ``probabilityCol``, so the default
    column name here is ``probability``. AUC is computed by the exact
    rank statistic (Mann-Whitney), ties handled by midranks, matching
    sklearn's roc_auc_score.
    """

    labelCol = Param("labelCol", "label column name", "label")
    rawPredictionCol = Param(
        "rawPredictionCol", "score column name", "probability"
    )
    metricName = Param(
        "metricName",
        "areaUnderROC | areaUnderPR",
        "areaUnderROC",
        validator=lambda v: v in ("areaUnderROC", "areaUnderPR"),
    )

    def is_larger_better(self) -> bool:
        return True

    def evaluate(self, dataset) -> float:
        frame = _metric_frame(dataset, self.getRawPredictionCol(),
                              self.getLabelCol())
        y = np.asarray(frame.column(self.getLabelCol()), dtype=np.float64)
        y = (y >= 0.5).astype(np.int64)
        score = np.asarray(
            frame.column(self.getRawPredictionCol()), dtype=np.float64
        )
        n_pos = int(y.sum())
        n_neg = int(y.size - n_pos)
        if n_pos == 0 or n_neg == 0:
            raise ValueError(
                "AUC requires both classes present in the evaluation set"
            )
        if self.getMetricName() == "areaUnderROC":
            # vectorized midranks: group ties via boundary detection, mean
            # rank of a tie group = first_rank + (count−1)/2
            order = np.argsort(score, kind="mergesort")
            s_sorted = score[order]
            new_grp = np.concatenate([[False], s_sorted[1:] != s_sorted[:-1]])
            grp_id = np.cumsum(new_grp)
            grp_start = np.concatenate([[0], np.nonzero(new_grp)[0]])
            counts = np.bincount(grp_id)
            mean_rank = grp_start + 1 + (counts - 1) / 2.0
            ranks = np.empty(y.size, dtype=np.float64)
            ranks[order] = mean_rank[grp_id]
            return float(
                (ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2.0)
                / (n_pos * n_neg)
            )
        # areaUnderPR: trapezoid over the PR curve sampled at DISTINCT
        # thresholds only — a tie group is one operating point, so cumsums
        # collapse to each group's last row (per-row sampling would make
        # tied scores order-dependent and skew the area)
        order = np.argsort(-score, kind="mergesort")
        s_sorted = score[order]
        tp = np.cumsum(y[order] == 1)
        fp = np.cumsum(y[order] == 0)
        last = np.nonzero(
            np.concatenate([s_sorted[1:] != s_sorted[:-1], [True]])
        )[0]
        tp, fp = tp[last], fp[last]
        precision = tp / np.maximum(tp + fp, 1)
        recall = tp / n_pos
        # prepend the (recall=0, precision=first) anchor, as Spark does
        recall = np.concatenate([[0.0], recall])
        precision = np.concatenate([[precision[0]], precision])
        trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy<2
        return float(trapezoid(precision, recall))


class MulticlassClassificationEvaluator(_KwargsInit, Params):
    """Spark's multiclass metric set over (labelCol, predictionCol):
    accuracy | f1 (default) | weightedPrecision | weightedRecall —
    ``org.apache.spark.ml.evaluation.MulticlassClassificationEvaluator``
    semantics: per-class precision/recall/F1 weighted by TRUE-class
    frequency; absent predicted classes contribute precision 0 (Spark's
    convention, matching sklearn's f1_score(average='weighted') with
    zero_division=0)."""

    labelCol = Param("labelCol", "label column name", "label")
    predictionCol = Param(
        "predictionCol", "prediction column name", "prediction"
    )
    metricName = Param(
        "metricName",
        "f1 | accuracy | weightedPrecision | weightedRecall",
        "f1",
        validator=lambda v: v in (
            "f1", "accuracy", "weightedPrecision", "weightedRecall"
        ),
    )

    def is_larger_better(self) -> bool:
        return True

    def evaluate(self, dataset) -> float:
        frame = _metric_frame(dataset, self.getPredictionCol(),
                              self.getLabelCol())
        y = np.asarray(frame.column(self.getLabelCol()), dtype=np.float64)
        pred = np.asarray(
            frame.column(self.getPredictionCol()), dtype=np.float64
        )
        if y.shape[0] == 0:
            raise ValueError("empty dataset")
        name = self.getMetricName()
        if name == "accuracy":
            return float((pred == y).mean())
        classes = np.unique(np.concatenate([y, pred]))
        weights = np.zeros(len(classes))
        precision = np.zeros(len(classes))
        recall = np.zeros(len(classes))
        for i, c in enumerate(classes):
            tp = float(((pred == c) & (y == c)).sum())
            pp = float((pred == c).sum())
            ap = float((y == c).sum())
            weights[i] = ap / y.shape[0]
            precision[i] = tp / pp if pp > 0 else 0.0
            recall[i] = tp / ap if ap > 0 else 0.0
        if name == "weightedPrecision":
            return float((weights * precision).sum())
        if name == "weightedRecall":
            return float((weights * recall).sum())
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall
                      / np.maximum(denom, 1e-300), 0.0)
        return float((weights * f1).sum())


class ClusteringEvaluator(_KwargsInit, Params):
    """Silhouette over (featuresCol, predictionCol) — Spark's
    ``ml.evaluation.ClusteringEvaluator`` (metricName='silhouette',
    distanceMeasure 'squaredEuclidean' default | 'cosine').

    Uses Spark's own aggregate trick rather than O(n²) pairwise
    distances: with per-cluster sums ``S_C = Σy`` and squared norms
    ``Q_C = Σ‖y‖²``, the total squared distance from point i to cluster
    C is ``n_C·‖x_i‖² − 2·x_i·S_C + Q_C`` — so the whole silhouette is
    one (n, d)×(d, k) matmul plus O(n·k) elementwise work. The cosine
    variant applies the same identity to L2-normalized rows.
    """

    featuresCol = Param("featuresCol", "feature vector column",
                        "features")
    predictionCol = Param("predictionCol", "cluster id column",
                          "prediction")
    metricName = Param("metricName", "silhouette", "silhouette",
                       validator=lambda v: v == "silhouette")
    distanceMeasure = Param(
        "distanceMeasure", "squaredEuclidean | cosine",
        "squaredEuclidean",
        validator=lambda v: v in ("squaredEuclidean", "cosine"))

    def is_larger_better(self) -> bool:
        return True

    def evaluate(self, dataset) -> float:
        frame = _metric_frame(dataset, self.get_or_default("featuresCol"),
                              self.get_or_default("predictionCol"))
        x = frame.vectors_as_matrix(self.get_or_default("featuresCol"))
        labels = np.asarray(
            frame.column(self.get_or_default("predictionCol")))
        if x.shape[0] < 2:
            raise ValueError("silhouette needs at least 2 points")
        if self.get_or_default("distanceMeasure") == "cosine":
            norms = np.linalg.norm(x, axis=1, keepdims=True)
            if (norms == 0).any():
                raise ValueError(
                    "cosine distance undefined for zero vectors")
            x = x / norms
        clusters, inv = np.unique(labels, return_inverse=True)
        k = len(clusters)
        if k < 2:
            raise ValueError("silhouette needs at least 2 clusters")
        n_c = np.bincount(inv, minlength=k).astype(np.float64)
        # per-cluster aggregates
        s_c = np.zeros((k, x.shape[1]))
        np.add.at(s_c, inv, x)
        sq = (x * x).sum(axis=1)
        q_c = np.zeros(k)
        np.add.at(q_c, inv, sq)
        # total squared distance from each point to each cluster:
        # (n, k) = n_C·‖x‖² − 2·X·S_Cᵀ + Q_C
        tot = (n_c[None, :] * sq[:, None] - 2.0 * (x @ s_c.T)
               + q_c[None, :])
        own = inv
        n_own = n_c[own]
        # a(i): mean distance to OTHER members of own cluster
        a = np.where(n_own > 1,
                     tot[np.arange(len(x)), own] / np.maximum(
                         n_own - 1, 1.0),
                     0.0)
        mean_others = tot / n_c[None, :]
        mean_others[np.arange(len(x)), own] = np.inf
        b = mean_others.min(axis=1)
        denom = np.maximum(a, b)
        with np.errstate(invalid="ignore"):
            ratio = np.where(denom > 0, (b - a) / np.where(
                denom > 0, denom, 1.0), 0.0)
        # singleton clusters AND coincident-duplicate points (a=b=0)
        # score 0, the sklearn/Spark convention — a bare (b−a)/max(a,b)
        # would put NaN into the mean for exact duplicates split
        # across clusters
        s = np.where(n_own > 1, ratio, 0.0)
        return float(s.mean())


class RankingEvaluator(_KwargsInit, Params):
    """Spark 3.0 ``ml.evaluation.RankingEvaluator`` over array columns:
    predictionCol holds ranked predicted ids, labelCol the relevant-id
    ground truth. meanAveragePrecision (default) / precisionAtK /
    ndcgAtK / recallAtK / meanAveragePrecisionAtK with param ``k``."""

    labelCol = Param("labelCol", "ground-truth id arrays", "label")
    predictionCol = Param("predictionCol", "ranked predicted id arrays",
                          "prediction")
    metricName = Param(
        "metricName",
        "meanAveragePrecision | meanAveragePrecisionAtK | precisionAtK "
        "| ndcgAtK | recallAtK",
        "meanAveragePrecision",
        validator=lambda v: v in (
            "meanAveragePrecision", "meanAveragePrecisionAtK",
            "precisionAtK", "ndcgAtK", "recallAtK"))
    k = Param("k", "ranking cutoff for the @K metrics", 10,
              validator=lambda v: isinstance(v, int) and v >= 1)

    def is_larger_better(self) -> bool:
        return True

    @staticmethod
    def _avg_precision(pred, truth, cutoff, denom) -> float:
        if not truth:
            return 0.0
        hits = 0
        score = 0.0
        for rank, p in enumerate(pred[:cutoff]):
            if p in truth:
                hits += 1
                score += hits / (rank + 1.0)
        return score / denom

    def evaluate(self, dataset) -> float:
        frame = _metric_frame(dataset, self.getPredictionCol(),
                              self.getLabelCol())
        preds = frame.column(self.getPredictionCol())
        labels = frame.column(self.getLabelCol())
        name = self.getMetricName()
        k = int(self.get_or_default("k"))
        scores = []
        for pred, truth in zip(preds, labels):
            pred = list(pred)
            truth = set(truth)
            if name == "meanAveragePrecision":
                # Spark's RankingMetrics: precSum / labSet.size — a
                # truth set longer than the prediction list still
                # divides by its FULL size (unreturned relevant items
                # count against the score)
                scores.append(self._avg_precision(
                    pred, truth, len(pred), max(len(truth), 1)))
            elif name == "meanAveragePrecisionAtK":
                scores.append(self._avg_precision(
                    pred, truth, k,
                    min(max(len(truth), 1), k)))
            elif name == "precisionAtK":
                top = pred[:k]
                scores.append(
                    sum(p in truth for p in top) / float(k))
            elif name == "recallAtK":
                top = pred[:k]
                scores.append(
                    sum(p in truth for p in top)
                    / max(len(truth), 1) if truth else 0.0)
            else:  # ndcgAtK (binary relevance, Spark semantics)
                dcg = sum(
                    1.0 / np.log2(rank + 2.0)
                    for rank, p in enumerate(pred[:k]) if p in truth)
                ideal = sum(
                    1.0 / np.log2(rank + 2.0)
                    for rank in range(min(len(truth), k)))
                scores.append(dcg / ideal if ideal > 0 else 0.0)
        return float(np.mean(scores)) if scores else 0.0


class MultilabelClassificationEvaluator(_KwargsInit, Params):
    """Spark 3.0 ``ml.evaluation.MultilabelClassificationEvaluator``
    over array columns (predicted label sets vs true label sets):
    f1Measure (default) / subsetAccuracy / accuracy / hammingLoss /
    precision / recall / microPrecision / microRecall / microF1Measure
    / precisionByLabel / recallByLabel / f1MeasureByLabel (with
    ``metricLabel``)."""

    labelCol = Param("labelCol", "true label-set arrays", "label")
    predictionCol = Param("predictionCol", "predicted label-set arrays",
                          "prediction")
    metricName = Param(
        "metricName",
        "f1Measure | subsetAccuracy | accuracy | hammingLoss | "
        "precision | recall | microPrecision | microRecall | "
        "microF1Measure | precisionByLabel | recallByLabel | "
        "f1MeasureByLabel",
        "f1Measure",
        validator=lambda v: v in (
            "f1Measure", "subsetAccuracy", "accuracy", "hammingLoss",
            "precision", "recall", "microPrecision", "microRecall",
            "microF1Measure", "precisionByLabel", "recallByLabel",
            "f1MeasureByLabel"))
    metricLabel = Param("metricLabel", "target label for the ByLabel "
                        "metrics", 0.0)

    def is_larger_better(self) -> bool:
        return self.getMetricName() != "hammingLoss"

    def evaluate(self, dataset) -> float:
        frame = _metric_frame(dataset, self.getPredictionCol(),
                              self.getLabelCol())
        preds = [set(p) for p in frame.column(self.getPredictionCol())]
        labels = [set(t) for t in frame.column(self.getLabelCol())]
        name = self.getMetricName()
        n = len(preds)
        if n == 0:
            return 0.0
        if name.endswith("ByLabel"):
            lab = self.get_or_default("metricLabel")
            tp = sum(lab in p and lab in t
                     for p, t in zip(preds, labels))
            pp = sum(lab in p for p in preds)
            ap = sum(lab in t for t in labels)
            prec = tp / pp if pp else 0.0
            rec = tp / ap if ap else 0.0
            if name == "precisionByLabel":
                return prec
            if name == "recallByLabel":
                return rec
            return (2 * prec * rec / (prec + rec)
                    if prec + rec else 0.0)
        if name in ("microPrecision", "microRecall", "microF1Measure"):
            tp = sum(len(p & t) for p, t in zip(preds, labels))
            fp = sum(len(p - t) for p, t in zip(preds, labels))
            fn = sum(len(t - p) for p, t in zip(preds, labels))
            if name == "microPrecision":
                return tp / (tp + fp) if tp + fp else 0.0
            if name == "microRecall":
                return tp / (tp + fn) if tp + fn else 0.0
            return (2 * tp / (2 * tp + fp + fn)
                    if 2 * tp + fp + fn else 0.0)
        per_doc = []
        for p, t in zip(preds, labels):
            inter = len(p & t)
            if name == "subsetAccuracy":
                per_doc.append(float(p == t))
            elif name == "accuracy":
                union = len(p | t)
                per_doc.append(inter / union if union else 1.0)
            elif name == "hammingLoss":
                per_doc.append(len(p ^ t))
            elif name == "precision":
                per_doc.append(inter / len(p) if p else 0.0)
            elif name == "recall":
                per_doc.append(inter / len(t) if t else 0.0)
            else:  # f1Measure: 2|p∩t| / (|p| + |t|), Spark's per-doc F1
                denom = len(p) + len(t)
                per_doc.append(2 * inter / denom if denom else 0.0)
        if name == "hammingLoss":
            # Spark's MultilabelMetrics: numLabels counts distinct
            # GROUND-TRUTH labels only — stray predicted labels do not
            # enlarge the denominator
            true_labels = set().union(*labels) if labels else set()
            denom = n * max(len(true_labels), 1)
            return float(sum(per_doc)) / denom
        return float(np.mean(per_doc))
