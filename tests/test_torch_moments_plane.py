"""The moments plane in the port against the JAX package's, on the same
seeded numpy rows.

``spark_rapids_ml_tpu_torch.spark`` (the moments, Summarizer, LinearSVC,
GLM and feature-sample partials of ``aggregate``, ``moments_estimator``,
``forest_estimator.PartitionFrame`` and the routing of ``__init__``)
against the JAX package's ``spark`` modules of the same names. Bars:

* every partial and combine (host NumPy float64, the same operations in
  the same order): equal, element for element, weighted and offset too,
  on Arrow batches and on the plain numpy batches;
* the front ends in the port's local engine against the JAX front ends in
  a JAX ``LocalSparkSession`` on the same rows: the scalers equal;
  RobustScaler equal and equal to ``np.nanquantile`` over every row (the
  partitions fit under the sample cap); TruncatedSVD at float64 |cos| ≥
  1 − 1e-9 and σ within 1e-9 relative; LinearSVC and GLM within 1e-10
  relative;
* ``PartitionFrame`` (the numpy-partition shim the card's machine drives,
  with no pyarrow) gives each front end exactly the local engine's fit on
  the same partitions.
"""

import numpy as np
import pytest

from spark_rapids_ml_tpu.obs import devmon as jax_devmon
from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu.spark import aggregate as jagg
from spark_rapids_ml_tpu.spark import local_engine as jle
import spark_rapids_ml_tpu.spark as jax_spark
import spark_rapids_ml_tpu_torch.spark as port_spark
from spark_rapids_ml_tpu_torch.obs import devmon, fitmon, metrics
from spark_rapids_ml_tpu_torch.spark import adapter
from spark_rapids_ml_tpu_torch.spark import aggregate as pagg
from spark_rapids_ml_tpu_torch.spark import estimator
from spark_rapids_ml_tpu_torch.spark import forest_estimator as fe
from spark_rapids_ml_tpu_torch.spark import local_engine as le
from spark_rapids_ml_tpu_torch.spark import moments_estimator as me

N, D, PARTS = 240, 5, 3
SCALE = np.array([1.0, 10.0, 0.1, 5.0, 2.0])
FIT_RTOL = 1e-10
SVD_TOL = 1e-9


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """The CPU requested, and metrics registries of this test's own in both
    packages (the front ends' ``observed_transform`` and the fits'
    ``observed_fit`` write into them)."""
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    monkeypatch.delenv("LOCALSPARK_PARTITION_ID", raising=False)
    monkeypatch.setattr(metrics, "_default_registry",
                        metrics.MetricsRegistry())
    monkeypatch.setattr(jax_metrics, "_default_registry",
                        jax_metrics.MetricsRegistry())
    resets = (devmon.reset_device_monitor, jax_devmon.reset_device_monitor,
              fitmon.reset_fitmon, jax_fitmon.reset_fitmon)
    for reset in resets:
        reset()
    yield
    for reset in resets:
        reset()


def _design(seed=0, n=N, d=D):
    """Rows with unequal column scales and offsets, a binary label from a
    noisy linear margin, Poisson counts from a log-linear rate, positive
    weights and a finite offset."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * SCALE[:d] + 1.0
    margin = x @ np.linspace(1.0, -0.5, d) / SCALE[:d].sum() + 0.2
    y = (margin + 0.3 * rng.normal(size=n) > margin.mean()).astype(float)
    off = 0.1 * rng.normal(size=n)
    rate = np.exp(0.05 * (x - 1.0) @ (1.0 / SCALE[:d]) + off)
    counts = rng.poisson(rate).astype(float)
    w = rng.uniform(0.5, 2.0, size=n)
    return x, y, counts, w, off


def _arrow_batch(x, **cols):
    import pyarrow as pa

    arrays = [pa.array([list(r) for r in x], type=pa.list_(pa.float64()))]
    names = ["features"]
    for name, values in cols.items():
        arrays.append(pa.array(np.asarray(values, dtype=np.float64)))
        names.append(name)
    return pa.RecordBatch.from_arrays(arrays, names=names)


def _arrow_batches(x, chunks=3, **cols):
    edges = np.linspace(0, x.shape[0], chunks + 1).astype(int)
    return [_arrow_batch(x[a:b], **{k: v[a:b] for k, v in cols.items()})
            for a, b in zip(edges[:-1], edges[1:])]


def _assert_rows_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            a, b = np.asarray(g[key]), np.asarray(w[key])
            assert a.shape == b.shape, key
            assert np.array_equal(a, b, equal_nan=True), key


# -- the partials, equal to JAX's --------------------------------------------

@pytest.mark.parametrize("form", ["arrow", "arrow_weighted", "numpy"])
def test_moment_partial_equals_jax(form):
    x, _y, _c, w, _o = _design()
    if form == "numpy":
        batches, kw = np.array_split(x, 3), {}
    else:
        batches = _arrow_batches(x, w=w)
        kw = {"weight_col": "w"} if form == "arrow_weighted" else {}
    _assert_rows_equal(
        pagg.partition_moment_stats(batches, "features", **kw),
        jagg.partition_moment_stats(batches, "features", **kw))
    assert list(pagg.partition_moment_stats([x[:0]], "features")) == []


def test_combine_moment_stats_equals_jax():
    x, _y, _c, w, _o = _design()
    rows = [next(jagg.partition_moment_stats(_arrow_batches(part, w=wp),
                                             "features", weight_col="w"))
            for part, wp in zip(np.array_split(x, 4), np.array_split(w, 4))]
    for got, want in zip(pagg.combine_moment_stats(rows),
                         jagg.combine_moment_stats(rows)):
        assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="empty dataset"):
        pagg.combine_moment_stats([])


@pytest.mark.parametrize("weighted", [False, True])
def test_summary_partials_equal_jax(weighted):
    x, _y, _c, w, _o = _design()
    x = x.copy()
    x[::7, 1] = 0.0
    w = w.copy()
    w[::11] = 0.0   # zero-weight rows are skipped entirely
    kw = {"weight_col": "w"} if weighted else {}
    parts = [_arrow_batches(p, w=q, chunks=2)
             for p, q in zip(np.array_split(x, 3), np.array_split(w, 3))]
    got_rows = [next(pagg.partition_summary_stats(b, "features", **kw))
                for b in parts]
    want_rows = [next(jagg.partition_summary_stats(b, "features", **kw))
                 for b in parts]
    for g, want in zip(got_rows, want_rows):
        _assert_rows_equal([g], [want])
    got = pagg.combine_summary_stats(want_rows)
    want = jagg.combine_summary_stats(want_rows)
    assert set(got) == set(want) == set(pagg._SUMMARY_FIELDS)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    wt = w if weighted else None
    acc_p = pagg.summary_accumulate(x, wt, None)
    acc_j = jagg.summary_accumulate(x, wt, None)
    for key in acc_j:
        assert np.array_equal(acc_p[key], acc_j[key]), key


@pytest.mark.parametrize("case", ["plain", "scaled", "weighted", "tuples"])
def test_svc_partial_equals_jax(case):
    x, y, _c, w, _o = _design()
    coef = np.linspace(0.3, -0.2, D)
    scale = x.std(axis=0) if case == "scaled" else None
    kw = {"scale": scale}
    if case == "tuples":
        batches = list(zip(np.array_split(x, 3), np.array_split(y, 3)))
    else:
        batches = _arrow_batches(x, label=y, w=w)
        if case == "weighted":
            kw["weight_col"] = "w"
    _assert_rows_equal(
        pagg.partition_svc_stats(batches, "features", "label", coef, 0.1,
                                 **kw),
        jagg.partition_svc_stats(batches, "features", "label", coef, 0.1,
                                 **kw))


@pytest.mark.parametrize("case", [
    ("poisson", "log", True, True, True),
    ("poisson", "log", False, True, True),
    ("gamma", "log", False, False, False),
    ("gaussian", "identity", True, False, False),
    ("binomial", "logit", False, True, False),
])
def test_glm_partial_equals_jax(case):
    family, link, first, weighted, offset = case
    x, y, counts, w, off = _design()
    label = {"poisson": counts, "gamma": counts + 0.5, "gaussian": x[:, 0],
             "binomial": y}[family]
    kw = dict(family=family, link=link, var_power=0.0, link_power=0.0,
              first=first)
    if weighted:
        kw["weight_col"] = "w"
    if offset:
        kw["offset_col"] = "off"
    coef = np.full(D, 0.01)
    batches = _arrow_batches(x, label=label, w=w, off=off)
    _assert_rows_equal(
        pagg.partition_glm_stats(batches, "features", "label", coef, 0.05,
                                 **kw),
        jagg.partition_glm_stats(batches, "features", "label", coef, 0.05,
                                 **kw))
    if not (weighted or offset):
        tuples = list(zip(np.array_split(x, 3), np.array_split(label, 3)))
        _assert_rows_equal(
            pagg.partition_glm_stats(tuples, "features", "label", coef,
                                     0.05, **kw),
            jagg.partition_glm_stats(tuples, "features", "label", coef,
                                     0.05, **kw))


def test_tuple_batches_refuse_weights_and_offsets_as_jax_does():
    x, y, _c, _w, _o = _design()
    tuples = [(x, y)]
    coef = np.zeros(D)
    for mod in (pagg, jagg):
        with pytest.raises(ValueError, match="weight_col requires Arrow"):
            list(mod.partition_svc_stats(tuples, "f", "l", coef, 0.0,
                                         weight_col="w"))
        with pytest.raises(ValueError, match="offset column"):
            list(mod.partition_glm_stats(
                tuples, "f", "l", coef, 0.0, family="gaussian",
                link="identity", var_power=0.0, link_power=0.0,
                first=True, offset_col="o"))
        with pytest.raises(ValueError, match="weight_col requires Arrow"):
            list(mod.partition_moment_stats([x], "f", weight_col="w"))


@pytest.mark.parametrize("case", [
    # (rows, cap, stride, partition id): all kept; subsampled (the
    # buffer's 4·cap rolling trim too); a gated partition sends no sample
    (240, 8192, 1, 0), (240, 16, 1, 2), (240, 16, 3, 4),
])
def test_feature_sample_partial_equals_jax(monkeypatch, case):
    rows, cap, stride, pid = case
    monkeypatch.setenv("LOCALSPARK_PARTITION_ID", str(pid))
    x, _y, _c, _w, _o = _design(n=rows)
    x = x.copy()
    x[3, 2] = np.nan   # NaNs are preserved
    batches = _arrow_batches(x, chunks=6)
    got = list(pagg.partition_feature_sample(batches, "features", 7,
                                             cap=cap, sample_stride=stride))
    want = list(jagg.partition_feature_sample(batches, "features", 7,
                                              cap=cap, sample_stride=stride))
    _assert_rows_equal(got, want)
    n_sampled = len(want[0]["sample"]) // D
    assert n_sampled == (0 if pid % stride else min(rows, cap))


# -- the front ends, in both packages' local engines --------------------------

def _frames(x, n_partitions=PARTS, **cols):
    """(port DataFrame, JAX DataFrame) of the same rows and partitions."""
    def rows(dense):
        out = []
        for i, r in enumerate(x):
            row = {"features": dense(r)}
            for name, values in cols.items():
                row[name] = float(values[i])
            out.append(row)
        return out

    return (le.LocalSparkSession(n_partitions=n_partitions)
            .createDataFrame(rows(le.DenseVector)),
            jle.LocalSparkSession(n_partitions=n_partitions)
            .createDataFrame(rows(jle.DenseVector)))


def _rel(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def test_scaler_front_ends_equal_jax():
    x, _y, _c, _w, _o = _design()
    pdf, jdf = _frames(x)
    fits = [("StandardScaler", {"withMean": True}, ("mean", "std")),
            ("MinMaxScaler", {}, ("original_min", "original_max")),
            ("MaxAbsScaler", {}, ("max_abs",))]
    for name, kw, attrs in fits:
        got = getattr(port_spark, name)(**kw).fit(pdf)
        want = getattr(jax_spark, name)(**kw).fit(jdf)
        assert type(got) is getattr(adapter, f"{name}Model")
        for attr in attrs:
            assert np.array_equal(getattr(got._local, attr),
                                  getattr(want._local, attr)), (name, attr)
    np.testing.assert_allclose(
        port_spark.StandardScaler().fit(pdf)._local.std,
        x.std(axis=0, ddof=1), rtol=1e-12)


def test_robust_scaler_front_end_equals_jax_and_every_row_quantiles():
    x, _y, _c, _w, _o = _design()
    x = x.copy()
    x[5, 1] = np.nan
    pdf, jdf = _frames(x)
    got = port_spark.RobustScaler(lower=0.1, upper=0.9).fit(pdf)._local
    want = jax_spark.RobustScaler(lower=0.1, upper=0.9).fit(jdf)._local
    assert np.array_equal(got.median, want.median)
    assert np.array_equal(got.qrange, want.qrange)
    qs = np.nanquantile(x, [0.1, 0.5, 0.9], axis=0)
    assert np.array_equal(got.median, qs[1])
    assert np.array_equal(got.qrange, qs[2] - qs[0])
    with pytest.raises(ValueError, match="lower must be below upper"):
        port_spark.RobustScaler(lower=0.9, upper=0.1).fit(pdf)


@pytest.mark.parametrize("solver", ["auto", "randomized"])
def test_truncated_svd_front_end_matches_jax_at_float64(solver):
    x, _y, _c, _w, _o = _design()
    pdf, jdf = _frames(x)
    kw = {"k": 3, "dtype": "float64", "svdSolver": solver}
    got = port_spark.TruncatedSVD(**kw).fit(pdf)._local
    want = jax_spark.TruncatedSVD(**kw).fit(jdf)._local
    cos = np.abs(np.sum(got.components * want.components, axis=0))
    assert cos.min() >= 1.0 - SVD_TOL
    assert _rel(got.singular_values, want.singular_values) <= SVD_TOL
    assert got.svd_solver_used_ == want.svd_solver_used_
    _, s_ref, _ = np.linalg.svd(x, full_matrices=False)
    np.testing.assert_allclose(got.singular_values, s_ref[:3], rtol=1e-8)


@pytest.mark.parametrize("case", ["standardized", "raw", "weighted"])
def test_linear_svc_front_end_matches_jax(case):
    x, y, _c, w, _o = _design()
    pdf, jdf = _frames(x, label=y, w=w)
    kw = {"regParam": 0.01, "standardization": case != "raw"}
    if case == "weighted":
        kw["weightCol"] = "w"
    got = port_spark.LinearSVC(**kw).fit(pdf)
    want = jax_spark.LinearSVC(**kw).fit(jdf)
    assert type(got) is adapter.LinearSVCModel
    assert _rel(got._local.coefficients, want._local.coefficients) \
        <= FIT_RTOL
    assert abs(got._local.intercept - want._local.intercept) <= FIT_RTOL * \
        max(abs(want._local.intercept), 1.0)
    assert got._local.n_iter_ == want._local.n_iter_
    pred = np.asarray([r["prediction"] for r in got.transform(pdf).collect()])
    want_pred = np.asarray(
        [r["prediction"] for r in want.transform(jdf).collect()])
    assert np.array_equal(pred, want_pred)


@pytest.mark.parametrize("case", ["poisson_weight_offset", "gamma", "gaussian"])
def test_glm_front_end_matches_jax(case):
    x, _y, counts, w, off = _design()
    label = counts + 0.5 if case == "gamma" else (
        x[:, 0] + 0.1 * x[:, 1] if case == "gaussian" else counts)
    pdf, jdf = _frames(x, label=label, w=w, off=off)
    kw = {"family": "poisson" if case.startswith("poisson") else case}
    if case == "gamma":
        kw["link"] = "log"
    if case == "poisson_weight_offset":
        kw.update(weightCol="w", offsetCol="off")
    got = port_spark.GeneralizedLinearRegression(**kw).fit(pdf)._local
    want = jax_spark.GeneralizedLinearRegression(**kw).fit(jdf)._local
    assert _rel(got.coefficients, want.coefficients) <= FIT_RTOL
    assert abs(got.intercept - want.intercept) <= FIT_RTOL * max(
        abs(want.intercept), 1.0)
    assert got.num_iterations_ == want.num_iterations_
    assert got.deviance_ == pytest.approx(want.deviance_, rel=FIT_RTOL)
    assert got.weight_sum_ == want.weight_sum_


def test_moments_plane_never_collects_rows(monkeypatch):
    """Every moments-plane front end fits on executor partials: the
    adapter's driver collect never fires."""
    def boom(self, dataset):
        raise AssertionError("driver-collect fired on a plane family")

    monkeypatch.setattr(adapter._AdapterEstimator, "_collect_frame", boom)
    x, y, counts, _w, _o = _design()
    pdf, _jdf = _frames(x, label=y, counts=counts)
    for name in ("StandardScaler", "MinMaxScaler", "MaxAbsScaler",
                 "RobustScaler"):
        assert getattr(port_spark, name)().fit(pdf)._local is not None
    assert port_spark.TruncatedSVD(k=2).fit(pdf)._local.components.shape \
        == (D, 2)
    assert port_spark.LinearSVC(maxIter=3).fit(pdf)._local.n_iter_ >= 1
    glm = port_spark.GeneralizedLinearRegression(
        family="poisson", labelCol="counts", maxIter=3).fit(pdf)
    assert np.isfinite(glm._local.coefficients).all()


def _partition_frame(x, y=None, parts=PARTS):
    """The local engine's contiguous partitions of the rows, one numpy
    batch each (``(x, y)`` tuples with a label)."""
    chunk = -(-x.shape[0] // parts)
    out = []
    for i in range(parts):
        xs = x[i * chunk:(i + 1) * chunk]
        out.append([xs if y is None else (xs, y[i * chunk:(i + 1) * chunk])])
    return fe.PartitionFrame(out)


@pytest.mark.parametrize("name,kw,attrs", [
    ("StandardScaler", {}, ("mean", "std")),
    ("MinMaxScaler", {}, ("original_min", "original_max")),
    ("MaxAbsScaler", {}, ("max_abs",)),
    ("RobustScaler", {}, ("median", "qrange")),
    ("TruncatedSVD", {"k": 3, "dtype": "float64"},
     ("components", "singular_values")),
    ("LinearSVC", {"regParam": 0.01}, ("coefficients", "intercept")),
    ("GeneralizedLinearRegression", {"family": "poisson"},
     ("coefficients", "intercept")),
])
def test_partition_frame_fit_equals_the_local_engine_fit(name, kw, attrs):
    x, y, counts, _w, _o = _design()
    label = counts if name == "GeneralizedLinearRegression" else y
    labelled = name in ("LinearSVC", "GeneralizedLinearRegression")
    pdf, _jdf = _frames(x, label=label)
    got = getattr(port_spark, name)(**kw).fit(
        _partition_frame(x, label if labelled else None))._local
    want = getattr(port_spark, name)(**kw).fit(pdf)._local
    for attr in attrs:
        assert np.array_equal(getattr(got, attr), getattr(want, attr)), attr


def test_partition_frame_shape_of_a_dataframe(monkeypatch):
    monkeypatch.setenv("LOCALSPARK_PARTITION_ID", "9")
    x, y, _c, _w, _o = _design(n=10)
    frame = _partition_frame(x, y, parts=2)
    assert fe._num_partitions(frame) == 2
    first = frame.first()
    assert np.array_equal(first[0], x[0]) and first[1] == y[0]
    features = frame.select("features")
    assert np.array_equal(features.first()[0], x[0])
    assert len(features.first()) == 1
    assert frame.select("features", "label") is frame
    seen = frame.collect_rows(
        lambda batches: [{"pid": fe.os.environ["LOCALSPARK_PARTITION_ID"],
                          "rows": sum(b[0].shape[0] for b in batches)}])
    assert seen == [{"pid": "0", "rows": 5}, {"pid": "1", "rows": 5}]
    assert fe.os.environ["LOCALSPARK_PARTITION_ID"] == "9"
    assert fe.PartitionFrame([[x[:0]]]).first() is None


# -- routing -------------------------------------------------------------------

MOMENTS_NAMES = ("StandardScaler", "MinMaxScaler", "MaxAbsScaler",
                 "RobustScaler", "TruncatedSVD", "LinearSVC",
                 "GeneralizedLinearRegression")


@pytest.mark.parametrize("name", MOMENTS_NAMES + ("NaiveBayes",
                                                  "NaiveBayesModel"))
def test_routing_sends_the_nine_names_to_their_modules(name):
    cls = getattr(port_spark, name)
    module = {"NaiveBayes": estimator, "NaiveBayesModel": adapter}.get(
        name, me)
    assert cls is getattr(module, name)
    assert cls.__module__ == module.__name__
    assert name in port_spark.__all__
    assert name not in port_spark._UNPORTED


@pytest.mark.parametrize("name,item", [
    ("Word2Vec", "7 (their families and front ends)"),
    ("MinHashLSH", "7 (their families and front ends)"),
    ("FPGrowth", "7 (their families and front ends)"),
    ("LDA", "7 (their families and front ends)"),
    ("ALS", "7 (their families and front ends)"),
    ("FMRegressor", "7 (the rest of spark/)"),
    ("PrefixSpan", "7 (the rest of spark/)"),
])
def test_names_left_unported_still_raise_with_their_item(name, item):
    with pytest.raises(AttributeError, match=rf"item {item.split()[0]}"):
        getattr(port_spark, name)
    assert port_spark._UNPORTED[name] == item


# -- GaussianMixture and BisectingKMeans: partials, planes, routing ------------

def _mixture_state(x, k=2, seed=4):
    """A GMM state a few EM steps in: (means, prec, log_det, log_w)."""
    from spark_rapids_ml_tpu_torch.ops import gmm_kernel as pk

    w = np.ones(x.shape[0])
    weights, means, covs = pk.init_params(x, w, k, seed)
    for _ in range(2):
        prec, log_det = pk.precision_cholesky(covs)
        weights, means, covs = pk.m_step(pk.estep_stats_math(
            np, x, w, means, prec, log_det, np.log(weights)), 1e-6)
    prec, log_det = pk.precision_cholesky(covs)
    return means, prec, log_det, np.log(weights)


def _two_blobs(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x[: n // 2] += 6.0
    return x, rng.uniform(0.5, 2.0, size=n)


@pytest.mark.parametrize("form", ["arrow", "arrow_weighted", "numpy"])
def test_gmm_partial_equals_jax(form):
    x, w = _two_blobs()
    state = _mixture_state(x)
    if form == "numpy":
        batches, kw = np.array_split(x, 3), {}
    else:
        batches = _arrow_batches(x, w=w)
        kw = {"weight_col": "w"} if form == "arrow_weighted" else {}
    got = list(pagg.partition_gmm_stats(batches, "features", *state, **kw))
    want = list(jagg.partition_gmm_stats(batches, "features", *state, **kw))
    _assert_rows_equal(got, want)
    k, d = state[0].shape
    for a, b in zip(pagg.combine_gmm_stats(got * 2, k, d),
                    jagg.combine_gmm_stats(want * 2, k, d)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="empty dataset"):
        pagg.combine_gmm_stats([], k, d)


def _hierarchy(x):
    """Two internal nodes: the root routes by the first column's sign, its
    right child splits again along the second column."""
    lo, hi = x[:, 0] < 0, x[:, 0] >= 0
    c_lo, c_hi = x[lo].mean(axis=0), x[hi].mean(axis=0)
    up = hi & (x[:, 1] >= np.median(x[hi, 1]))
    return [{"cl": c_lo, "cr": c_hi, "l": -1, "r": 1},
            {"cl": x[hi & ~up].mean(axis=0), "cr": x[up].mean(axis=0),
             "l": -2, "r": -3}]


@pytest.mark.parametrize("job", ["route", "moments", "moments_weighted",
                                 "lloyd", "lloyd_weighted", "sample"])
def test_bisecting_partials_equal_jax(job):
    x, _y, _c, w, _o = _design()
    x = x - x.mean(axis=0)
    nodes = _hierarchy(x)
    batches = _arrow_batches(x, w=w)
    kw = {"weight_col": "w"} if job.endswith("weighted") else {}
    if job == "route":
        root = [dict(nodes[0], r=-2)]
        for nd in ([], root, nodes):
            assert np.array_equal(pagg.route_rows_bisecting(x, nd),
                                  jagg.route_rows_bisecting(x, nd))
        return
    if job.startswith("moments"):
        args = ("features", nodes, 3)
        name, groups, per = "partition_bisecting_moments", 3, 3
    elif job.startswith("lloyd"):
        leaf = pagg.route_rows_bisecting(x, nodes)
        args = ("features", nodes, 2, x[leaf == 2][:2])
        name, groups, per = "partition_bisecting_lloyd", 2, 1
    else:
        args = ("features", nodes, 1, 17)
        name = "partition_bisecting_sample"
    got = list(getattr(pagg, name)(batches, *args, **kw))
    want = list(getattr(jagg, name)(batches, *args, **kw))
    _assert_rows_equal(got, want)
    if name != "partition_bisecting_sample":
        two = [got[0], list(getattr(pagg, name)(batches[:1], *args, **kw))[0]]
        for a, b in zip(pagg.combine_bisecting_stats(two, groups, D, per),
                        jagg.combine_bisecting_stats(two, groups, D, per)):
            assert np.array_equal(a, b)


def test_gmm_plane_matches_local_em_fixed_point():
    """One plane EM step from a frozen state equals the local E-step on
    every row (tests/test_spark_local_lane.py's fixed-point check)."""
    from spark_rapids_ml_tpu_torch.ops.gmm_kernel import (
        estep_stats_math,
        precision_cholesky,
    )

    rng = np.random.default_rng(5)
    x = rng.normal(size=(120, 3)) + np.array([2.0, 0.0, -1.0])
    pdf, _jdf = _frames(x)
    means = np.array([[1.0, 0.0, 0.0], [3.0, 0.0, -2.0]])
    weights = np.array([0.4, 0.6])
    prec, log_det = precision_cholesky(np.tile(np.eye(3), (2, 1, 1)))

    def job(batches):
        return pagg.partition_gmm_stats(batches, "features", means, prec,
                                        log_det, np.log(weights))

    rows = fe._collect_rows(pdf.select("features"), job,
                            pagg.gmm_stats_arrow_schema,
                            pagg.gmm_stats_spark_ddl())
    plane = pagg.combine_gmm_stats(rows, 2, 3)
    local = estep_stats_math(np, x, np.ones(120), means, prec, log_det,
                             np.log(weights))
    for a, b in zip(plane, local):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


@pytest.mark.parametrize("weighted", [False, True])
def test_gmm_front_end_matches_jax(weighted):
    x, w = _two_blobs(seed=1)
    pdf, jdf = _frames(x, w=w)
    kw = {"k": 2, "seed": 3, "maxIter": 40, "tol": 1e-8}
    if weighted:
        kw["weightCol"] = "w"
    got = port_spark.GaussianMixture(**kw).fit(pdf)
    want = jax_spark.GaussianMixture(**kw).fit(jdf)
    assert type(got) is adapter.GaussianMixtureModel
    for attr in ("means", "weights", "covs"):
        assert _rel(getattr(got._local, attr),
                    getattr(want._local, attr)) <= FIT_RTOL, attr
    assert got._local.num_iterations_ == want._local.num_iterations_
    assert got._local.log_likelihood_ == pytest.approx(
        want._local.log_likelihood_, rel=FIT_RTOL)
    out = got.transform(pdf).collect()
    ref = want.transform(jdf).collect()
    p = np.stack([r["probability"].toArray() for r in out])
    assert _rel(p, np.stack([r["probability"].toArray() for r in ref])) \
        <= 1e-6   # the port's local model serves float32
    assert np.array_equal([r["prediction"] for r in out],
                          [r["prediction"] for r in ref])


@pytest.mark.parametrize("weighted", [False, True])
def test_bisecting_front_end_equals_jax(weighted):
    x, w = _two_blobs(seed=2)
    x[::3] -= 9.0
    pdf, jdf = _frames(x, w=w)
    kw = {"k": 4, "seed": 5, "maxIter": 10}
    if weighted:
        kw["weightCol"] = "w"
    got = port_spark.BisectingKMeans(**kw).fit(pdf)
    want = jax_spark.BisectingKMeans(**kw).fit(jdf)
    assert type(got).__name__ == "BisectingKMeansModel"
    assert type(got).__module__.endswith(".adapter3")
    assert np.array_equal(got._local.cluster_centers,
                          want._local.cluster_centers)
    assert got._local.training_cost_ == want._local.training_cost_
    pred = [r["prediction"] for r in got.transform(pdf).collect()]
    assert pred == [r["prediction"] for r in want.transform(jdf).collect()]


def test_bisecting_plane_on_partitions_matches_the_local_fit():
    """On well-separated blobs the plane (sample-seeded splits) and the
    local host fit reach the same leaves: centres within 1e-9, the cost
    within 1e-9 relative."""
    from spark_rapids_ml_tpu_torch import BisectingKMeans

    rng = np.random.default_rng(6)
    blobs = np.array([[0.0, 0.0, 0.0], [12.0, 0.0, 0.0], [0.0, 12.0, 0.0],
                      [0.0, 0.0, 12.0]])
    x = np.concatenate([c + rng.normal(size=(60, 3)) for c in blobs])
    x = x[rng.permutation(x.shape[0])]
    plane = port_spark.BisectingKMeans(k=4, seed=1).fit(
        _partition_frame(x))._local
    local = BisectingKMeans(k=4, seed=1).setUseXlaDot(False).fit(x)
    order = [int(np.argmin(np.linalg.norm(plane.cluster_centers - c,
                                          axis=1)))
             for c in local.cluster_centers]
    assert sorted(order) == [0, 1, 2, 3]
    np.testing.assert_allclose(plane.cluster_centers[order],
                               local.cluster_centers, rtol=0, atol=1e-9)
    assert plane.training_cost_ == pytest.approx(local.training_cost_,
                                                 rel=1e-9)


@pytest.mark.parametrize("name,kw,attrs", [
    ("GaussianMixture", {"k": 2, "maxIter": 5}, ("means", "covs")),
    ("BisectingKMeans", {"k": 3}, ("cluster_centers", "training_cost_")),
])
def test_clustering_partition_frame_fit_equals_the_local_engine_fit(
        name, kw, attrs):
    x, _w = _two_blobs(seed=3)
    pdf, _jdf = _frames(x)
    got = getattr(port_spark, name)(**kw).fit(_partition_frame(x))._local
    want = getattr(port_spark, name)(**kw).fit(pdf)._local
    for attr in attrs:
        assert np.array_equal(getattr(got, attr), getattr(want, attr)), attr


def test_clustering_planes_never_collect_rows(monkeypatch):
    def boom(self, dataset):
        raise AssertionError("driver-collect fired on a plane family")

    monkeypatch.setattr(adapter._AdapterEstimator, "_collect_frame", boom)
    x, _w = _two_blobs(seed=4)
    pdf, _jdf = _frames(x)
    assert port_spark.GaussianMixture(k=2, maxIter=3).fit(pdf) \
        ._local.means.shape == (2, D)
    assert port_spark.BisectingKMeans(k=2).fit(pdf) \
        ._local.cluster_centers.shape == (2, D)


@pytest.mark.parametrize("name,module", [
    ("GaussianMixture", "moments_estimator"),
    ("BisectingKMeans", "moments_estimator"),
    ("GaussianMixtureModel", "adapter"),
    ("BisectingKMeansModel", "adapter3"),
])
def test_routing_sends_the_clustering_names_to_their_modules(name, module):
    cls = getattr(port_spark, name)
    assert cls.__module__ == f"spark_rapids_ml_tpu_torch.spark.{module}"
    assert cls.__module__.rsplit(".", 1)[-1] == \
        getattr(jax_spark, name).__module__.rsplit(".", 1)[-1]
    assert name in port_spark.__all__
    assert name not in port_spark._UNPORTED
