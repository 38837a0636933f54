"""The six evaluators in the port against the JAX package's, on the same
seeded numpy frames.

``models/evaluation.py`` is host numpy in both packages, the same
operations in the same order, so every metric is held to JAX's within
1e-12 (absolute; the metrics are O(1)), and ``is_larger_better`` equal.
Beside that, the cases of the JAX files ``tests/test_tuning.py`` and
``tests/test_evaluation_extra.py`` that test the evaluators (the O(n²)
silhouette oracle, Spark's hand-computed ranking and multilabel values,
the PR-AUC tie collapse, the errors), evaluators on local-engine
DataFrames (pruned to the metric columns before the collect), and
save → load both ways. Last, every ported family's ``transform`` leaves
numpy or list columns, never a tensor, where an evaluator reads them.
"""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
from spark_rapids_ml_tpu_torch.models import evaluation as pe

METRIC_ATOL = 1e-12

EVALUATORS = {
    "RegressionEvaluator": ("rmse", "mse", "mae", "r2"),
    "BinaryClassificationEvaluator": ("areaUnderROC", "areaUnderPR"),
    "MulticlassClassificationEvaluator": (
        "f1", "accuracy", "weightedPrecision", "weightedRecall"),
    "ClusteringEvaluator": ("silhouette",),
    "RankingEvaluator": (
        "meanAveragePrecision", "meanAveragePrecisionAtK", "precisionAtK",
        "ndcgAtK", "recallAtK"),
    "MultilabelClassificationEvaluator": (
        "f1Measure", "subsetAccuracy", "accuracy", "hammingLoss",
        "precision", "recall", "microPrecision", "microRecall",
        "microF1Measure", "precisionByLabel", "recallByLabel",
        "f1MeasureByLabel"),
}
CASES = [(cls, metric) for cls, metrics in EVALUATORS.items()
         for metric in metrics]


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def _jax():
    from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxFrame
    from spark_rapids_ml_tpu.models import evaluation as je

    return je, JaxFrame


def _columns(cls, seed=3):
    """Seeded columns each evaluator reads (ties in the binary scores)."""
    rng = np.random.default_rng(seed)
    n = 240
    if cls == "RegressionEvaluator":
        y = rng.normal(size=n)
        return {"label": y, "prediction": y + rng.normal(0.3, 0.5, size=n)}
    if cls == "BinaryClassificationEvaluator":
        y = (rng.uniform(size=n) > 0.4).astype(float)
        score = np.round(y * 0.6 + rng.normal(size=n), 1)
        return {"label": y, "probability": score}
    if cls == "MulticlassClassificationEvaluator":
        y = rng.integers(0, 4, n).astype(float)
        pred = np.where(rng.random(n) < 0.7, y, rng.integers(0, 5, n))
        return {"label": y, "prediction": pred.astype(float)}
    if cls == "ClusteringEvaluator":
        labels = rng.integers(0, 3, n)
        x = rng.normal(size=(n, 5)) + 3.0 * labels[:, None]
        return {"features": x, "prediction": list(labels)}
    if cls == "RankingEvaluator":
        preds = [list(rng.permutation(12)[:rng.integers(3, 10)])
                 for _ in range(40)]
        truth = [list(rng.choice(12, size=rng.integers(0, 6),
                                 replace=False)) for _ in range(40)]
        return {"prediction": preds, "label": truth}
    preds = [[float(v) for v in rng.choice(4, size=rng.integers(0, 4),
                                           replace=False)]
             for _ in range(50)]
    truth = [[float(v) for v in rng.choice(4, size=rng.integers(1, 4),
                                           replace=False)]
             for _ in range(50)]
    return {"prediction": preds, "label": truth}


def _params(cls, metric):
    params = {"metricName": metric}
    if cls == "RankingEvaluator":
        params["k"] = 3
    if cls == "MultilabelClassificationEvaluator" and metric.endswith(
            "ByLabel"):
        params["metricLabel"] = 2.0
    return params


@pytest.mark.parametrize("cls,metric", CASES)
def test_metric_equals_jax(cls, metric):
    je, JaxFrame = _jax()
    cols = _columns(cls)
    ours = getattr(pe, cls)(**_params(cls, metric))
    ref = getattr(je, cls)(**_params(cls, metric))
    got = ours.evaluate(VectorFrame(cols))
    want = ref.evaluate(JaxFrame(cols))
    assert abs(got - want) <= METRIC_ATOL
    assert isinstance(got, float)
    assert ours.is_larger_better() == ref.is_larger_better()


@pytest.mark.parametrize("cls", sorted(EVALUATORS))
def test_params_and_defaults_equal_jax(cls):
    je, _ = _jax()
    ours, ref = getattr(pe, cls)(), getattr(je, cls)()
    assert ours.param_map_for_metadata() == ref.param_map_for_metadata()
    assert ours.getMetricName() == EVALUATORS[cls][0]
    bad = "noSuchMetric"
    for ev in (ours, ref):
        with pytest.raises(ValueError):
            ev.set("metricName", bad)


# -- the JAX files' evaluator cases ---------------------------------------------

def test_regression_evaluator_metrics():
    rng = np.random.default_rng(42)
    y = rng.normal(size=100)
    frame = VectorFrame({"label": y, "prediction": y + 0.5})
    ev = pe.RegressionEvaluator()
    assert ev.evaluate(frame) == pytest.approx(0.5)
    assert ev.copy(extra={"metricName": "mse"}).evaluate(frame) == \
        pytest.approx(0.25)
    assert ev.copy(extra={"metricName": "mae"}).evaluate(frame) == \
        pytest.approx(0.5)
    r2 = ev.copy(extra={"metricName": "r2"}).evaluate(frame)
    assert r2 == pytest.approx(
        1.0 - 25.0 / float(((y - y.mean()) ** 2).mean() * 100))
    # a constant label has no variance to explain: r2 is 0, as in JAX
    const = VectorFrame({"label": np.ones(5), "prediction": np.zeros(5)})
    assert ev.copy(extra={"metricName": "r2"}).evaluate(const) == 0.0


def test_auc_matches_rank_oracle():
    rng = np.random.default_rng(42)
    y = (rng.uniform(size=300) > 0.5).astype(float)
    score = np.where(y > 0, rng.normal(1.0, 1.0, 300),
                     rng.normal(0.0, 1.0, 300))
    frame = VectorFrame({"label": y, "probability": score})
    ev = pe.BinaryClassificationEvaluator()
    pos, neg = score[y > 0], score[y <= 0]
    wins = (pos[:, None] > neg[None, :]).sum() + 0.5 * (
        pos[:, None] == neg[None, :]).sum()
    assert ev.evaluate(frame) == pytest.approx(wins / (len(pos) * len(neg)))
    pr = ev.copy(extra={"metricName": "areaUnderPR"}).evaluate(frame)
    assert 0.5 < pr <= 1.0


def test_pr_auc_tie_collapse_is_order_independent():
    ev = pe.BinaryClassificationEvaluator().set("metricName", "areaUnderPR")
    a = ev.evaluate(VectorFrame({"label": [1.0, 0.0],
                                 "probability": [0.5, 0.5]}))
    b = ev.evaluate(VectorFrame({"label": [0.0, 1.0],
                                 "probability": [0.5, 0.5]}))
    assert a == b == pytest.approx(0.5)


def _silhouette_oracle(x, labels):
    n = x.shape[0]
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    s = np.zeros(n)
    for i in range(n):
        own = labels == labels[i]
        if own.sum() <= 1:
            continue
        a = d2[i, own].sum() / (own.sum() - 1)
        b = min(d2[i, labels == c].mean()
                for c in np.unique(labels) if c != labels[i])
        s[i] = (b - a) / max(a, b)
    return float(s.mean())


def test_silhouette_matches_pairwise_oracle():
    rng = np.random.default_rng(42)
    x = rng.normal(size=(60, 5))
    labels = rng.integers(0, 3, size=60)
    got = pe.ClusteringEvaluator().evaluate(
        VectorFrame({"features": x, "prediction": list(labels)}))
    np.testing.assert_allclose(got, _silhouette_oracle(x, labels),
                               atol=1e-10)


def test_silhouette_separated_blobs_and_alternating_labels():
    rng = np.random.default_rng(42)
    x = np.vstack([rng.normal(size=(40, 3)) + 50.0,
                   rng.normal(size=(40, 3)) - 50.0])
    score = pe.ClusteringEvaluator().evaluate(
        VectorFrame({"features": x, "prediction": [0] * 40 + [1] * 40}))
    bad = pe.ClusteringEvaluator().evaluate(
        VectorFrame({"features": x, "prediction": [i % 2 for i in
                                                   range(80)]}))
    assert bad < 0.1 < 0.95 < score


@pytest.mark.parametrize("case", ["one cluster", "one point", "zero vector",
                                  "empty multiclass", "one class AUC"])
def test_errors_equal_jax(case):
    je, JaxFrame = _jax()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(30, 4))
    cls, params, cols = {
        "one cluster": ("ClusteringEvaluator", {},
                        {"features": x, "prediction": [0] * 30}),
        "one point": ("ClusteringEvaluator", {},
                      {"features": x[:1], "prediction": [0]}),
        "zero vector": ("ClusteringEvaluator",
                        {"distanceMeasure": "cosine"},
                        {"features": np.vstack([x[:3], np.zeros((1, 4))]),
                         "prediction": [0, 1, 0, 1]}),
        "empty multiclass": ("MulticlassClassificationEvaluator", {},
                             {"label": [], "prediction": []}),
        "one class AUC": ("BinaryClassificationEvaluator", {},
                          {"label": [1.0, 1.0], "probability": [0.2, 0.7]}),
    }[case]
    with pytest.raises(ValueError) as ours:
        getattr(pe, cls)(**params).evaluate(VectorFrame(cols))
    with pytest.raises(ValueError) as ref:
        getattr(je, cls)(**params).evaluate(JaxFrame(cols))
    assert str(ours.value) == str(ref.value)


def test_silhouette_coincident_duplicates_zero_not_nan():
    score = pe.ClusteringEvaluator().evaluate(
        VectorFrame({"features": np.zeros((4, 2)),
                     "prediction": [0, 0, 1, 1]}))
    assert score == 0.0


def test_ranking_metrics_hand_values():
    frame = VectorFrame({
        "prediction": [[1, 6, 2, 7, 8, 3, 9, 10, 4, 5],
                       [4, 1, 5, 6, 2, 7, 3, 8, 9, 10]],
        "label": [[1, 2, 3, 4, 5], [1, 2, 3]],
    })
    d1 = (1 / 1 + 2 / 3 + 3 / 6 + 4 / 9 + 5 / 10) / 5
    d2 = (1 / 2 + 2 / 5 + 3 / 7) / 3
    ev = pe.RankingEvaluator(metricName="meanAveragePrecision")
    np.testing.assert_allclose(ev.evaluate(frame), (d1 + d2) / 2,
                               atol=1e-12)
    np.testing.assert_allclose(
        pe.RankingEvaluator(metricName="precisionAtK", k=3).evaluate(frame),
        ((2 / 3) + (1 / 3)) / 2, atol=1e-12)
    np.testing.assert_allclose(
        pe.RankingEvaluator(metricName="recallAtK", k=3).evaluate(frame),
        ((2 / 5) + (1 / 3)) / 2, atol=1e-12)
    short = VectorFrame({"prediction": [[1, 2]], "label": [[1, 2, 3]]})
    np.testing.assert_allclose(ev.evaluate(short), (1 / 1 + 2 / 2) / 3,
                               atol=1e-12)
    ideal = 1 / np.log2(2) + 1 / np.log2(3) + 1 / np.log2(4)
    want = ((1 / np.log2(2) + 1 / np.log2(4)) / ideal
            + (1 / np.log2(3)) / ideal) / 2
    np.testing.assert_allclose(
        pe.RankingEvaluator(metricName="ndcgAtK", k=3).evaluate(frame),
        want, atol=1e-12)
    assert ev.is_larger_better()


def test_multilabel_evaluator_hand_values():
    frame = VectorFrame({
        "prediction": [[0.0, 1.0], [0.0, 2.0], [], [2.0],
                       [2.0, 0.0], [0.0, 1.0, 2.0], [1.0]],
        "label": [[0.0, 1.0], [0.0, 2.0], [0.0], [2.0],
                  [2.0, 0.0], [0.0, 1.0], [1.0, 2.0]],
    })

    def ev(name, **kw):
        return pe.MultilabelClassificationEvaluator(
            metricName=name, **kw).evaluate(frame)

    np.testing.assert_allclose(ev("subsetAccuracy"), 4 / 7, atol=1e-12)
    np.testing.assert_allclose(
        ev("accuracy"), (1 + 1 + 0 + 1 + 1 + 2 / 3 + 1 / 2) / 7, atol=1e-12)
    np.testing.assert_allclose(ev("hammingLoss"), 3 / 21, atol=1e-12)
    np.testing.assert_allclose(
        ev("precision"), (1 + 1 + 0 + 1 + 1 + 2 / 3 + 1) / 7, atol=1e-12)
    np.testing.assert_allclose(
        ev("recall"), (1 + 1 + 0 + 1 + 1 + 1 + 1 / 2) / 7, atol=1e-12)
    np.testing.assert_allclose(ev("microPrecision"), 10 / 11, atol=1e-12)
    np.testing.assert_allclose(ev("microRecall"), 10 / 12, atol=1e-12)
    np.testing.assert_allclose(ev("microF1Measure"), 20 / 23, atol=1e-12)
    np.testing.assert_allclose(ev("precisionByLabel", metricLabel=0.0),
                               1.0, atol=1e-12)
    np.testing.assert_allclose(ev("recallByLabel", metricLabel=0.0),
                               4 / 5, atol=1e-12)
    assert not pe.MultilabelClassificationEvaluator(
        metricName="hammingLoss").is_larger_better()
    # a stray predicted label does not enlarge hamming's denominator
    stray = VectorFrame({"prediction": [[0.0, 2.0]], "label": [[0.0, 1.0]]})
    np.testing.assert_allclose(pe.MultilabelClassificationEvaluator(
        metricName="hammingLoss").evaluate(stray), 1.0, atol=1e-12)


# -- DataFrames and persistence ---------------------------------------------------

@pytest.mark.parametrize("cls", ["RegressionEvaluator",
                                 "BinaryClassificationEvaluator",
                                 "ClusteringEvaluator"])
def test_dataframe_input_equals_jax_and_collects_only_its_columns(
        cls, monkeypatch):
    """Each package's evaluator on its own local engine, built from the same
    rows with a wide column no metric reads: equal metrics, and the port
    collects only the two metric columns."""
    from spark_rapids_ml_tpu.spark.local_engine import (
        DenseVector as JaxDense,
        LocalSparkSession as JaxSession,
    )
    from spark_rapids_ml_tpu_torch.spark import local_engine as le

    je, _ = _jax()
    cols = _columns(cls)
    wide = np.random.default_rng(1).normal(size=(240, 50))

    def rows(dense):
        out = []
        for i in range(240):
            row = {k: (dense(v[i]) if np.ndim(v[i]) else float(v[i]))
                   for k, v in cols.items()}
            row["wide"] = dense(wide[i])
            out.append(row)
        return out

    df = le.LocalSparkSession(n_partitions=3).createDataFrame(
        rows(le.DenseVector))
    jdf = JaxSession(n_partitions=3).createDataFrame(rows(JaxDense))
    collected = []
    collect = le.LocalDataFrame.collect

    def spy(self):
        collected.append(list(self.columns))
        return collect(self)

    monkeypatch.setattr(le.LocalDataFrame, "collect", spy)
    got = getattr(pe, cls)().evaluate(df)
    assert abs(got - getattr(je, cls)().evaluate(jdf)) <= METRIC_ATOL
    assert len(collected) == 1 and "wide" not in collected[0]
    assert sorted(collected[0]) == sorted(cols)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port",
                                       "load_model"])
def test_evaluator_save_load_both_ways(tmp_path, direction):
    je, _ = _jax()
    from spark_rapids_ml_tpu_torch.io.persistence import load_model

    params = {"metricName": "ndcgAtK", "k": 4, "labelCol": "truth"}
    path = str(tmp_path / "ev")
    if direction == "jax_to_port":
        je.RankingEvaluator(**params).save(path)
        loaded = pe.RankingEvaluator.load(path)
    elif direction == "port_to_jax":
        pe.RankingEvaluator(**params).save(path)
        loaded = je.RankingEvaluator.load(path)
    else:
        je.RankingEvaluator(**params).save(path)
        loaded = load_model(path)
        assert type(loaded) is pe.RankingEvaluator
    for name, value in params.items():
        assert loaded.get_or_default(name) == value
    with pytest.raises(FileExistsError):
        pe.RankingEvaluator().save(path)
    pe.RankingEvaluator().save(path, overwrite=True)


# -- every ported family leaves host columns for the evaluators ------------------

def _fitted_families():
    from spark_rapids_ml_tpu_torch import (
        PCA, BisectingKMeans, DecisionTreeClassifier, GBTRegressor,
        GaussianMixture, GeneralizedLinearRegression, KMeans, LinearRegression,
        LinearSVC, LogisticRegression, MaxAbsScaler, MinMaxScaler, NaiveBayes,
        RandomForestClassifier, RobustScaler, StandardScaler, TruncatedSVD)

    return {
        "PCA": lambda: PCA().setK(2),
        "TruncatedSVD": lambda: TruncatedSVD().setK(2),
        "KMeans": lambda: KMeans().setK(2).setSeed(1),
        "BisectingKMeans": lambda: BisectingKMeans().setK(2).setSeed(1),
        "GaussianMixture": lambda: GaussianMixture().setK(2).setSeed(1),
        "StandardScaler": StandardScaler,
        "MinMaxScaler": MinMaxScaler,
        "MaxAbsScaler": MaxAbsScaler,
        "RobustScaler": RobustScaler,
        "LinearRegression": LinearRegression,
        "LogisticRegression": LogisticRegression,
        "multinomial LogisticRegression": LogisticRegression,
        "LinearSVC": LinearSVC,
        "GeneralizedLinearRegression": GeneralizedLinearRegression,
        "NaiveBayes": lambda: NaiveBayes().setModelType("gaussian"),
        "RandomForestClassifier": lambda: RandomForestClassifier()
        .setNumTrees(2).setMaxDepth(2),
        "DecisionTreeClassifier": lambda: DecisionTreeClassifier()
        .setMaxDepth(2),
        "GBTRegressor": lambda: GBTRegressor().setMaxIter(2).setMaxDepth(2),
    }


FAMILIES = sorted(_fitted_families())


@pytest.mark.parametrize("family", FAMILIES)
def test_transform_leaves_no_tensor_for_an_evaluator(family):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, 4))
    x[:32] += 3.0
    classes = 3 if family.startswith("multinomial") else 2
    y = (np.arange(64) % classes).astype(float)
    frame = VectorFrame({"features": x, "label": y})
    model = _fitted_families()[family]().fit(frame)
    out = model.transform(frame)
    for name in out.columns:
        col = out.column(name)
        assert not isinstance(col, torch.Tensor), (family, name)
        assert isinstance(col, (np.ndarray, list)), (family, name)
        assert not any(isinstance(v, torch.Tensor) for v in list(col)[:4]), \
            (family, name)
