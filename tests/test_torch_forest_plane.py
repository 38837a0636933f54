"""The forest plane in the port against the JAX package's, on the same
seeded numpy rows.

``spark_rapids_ml_tpu_torch.spark`` (``forest_plane``, the forest partials
of ``device_aggregate``, ``forest_estimator``, the routing of
``__init__``) against the JAX package's ``spark`` modules of the same
names. Bars:

* the host plane (NumPy float64, the same operations in the same order):
  every partial and ``combine_hist_rows`` equal, element for element;
* the device partials (``executorDevice='on'`` under the CPU request: the
  histogram contraction in float64 torch) against the JAX host plane:
  classification equal (sums of integer-weighted counts are exact in any
  order), regression and GBT channels ≤ 1e-12 relative;
* fits at float64 (streamed and through both packages' local-engine front
  ends): feature and threshold arrays equal, leaves ≤ 1e-12. The data is
  free of near-ties (a strong planted signal, ``minInstancesPerNode`` 8 on
  the regression fits), as in ``tests/test_torch_forest.py``: a split
  whose gain another matches within rounding is decided by the order of a
  sum, which the packages take differently.

Every JAX fit here shares one shape (5 features, 32 bins, depth 3), so
the JAX package compiles its split selection once per level and gain.
"""

import time

import numpy as np
import pytest

from spark_rapids_ml_tpu.models import decision_tree as jax_dt
from spark_rapids_ml_tpu.models import gbt as jax_gbt
from spark_rapids_ml_tpu.models import random_forest as jax_rf
from spark_rapids_ml_tpu.obs import devmon as jax_devmon
from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu.spark import forest_plane as jfp
from spark_rapids_ml_tpu.spark import local_engine as jle
import spark_rapids_ml_tpu.spark as jax_spark
import spark_rapids_ml_tpu_torch.spark as port_spark
from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame
from spark_rapids_ml_tpu_torch.models import decision_tree as dt
from spark_rapids_ml_tpu_torch.models import gbt
from spark_rapids_ml_tpu_torch.models import random_forest as rf
from spark_rapids_ml_tpu_torch.obs import devmon, fitmon, metrics
from spark_rapids_ml_tpu_torch.ops.forest_kernel import quantile_bins
from spark_rapids_ml_tpu_torch.spark import adapter
from spark_rapids_ml_tpu_torch.spark import device_aggregate as dev
from spark_rapids_ml_tpu_torch.spark import forest_estimator as fe
from spark_rapids_ml_tpu_torch.spark import forest_plane as fp
from spark_rapids_ml_tpu_torch.spark import local_engine as le

F64_ATOL = 1e-12
DEVICE_RTOL = 1e-12
N, D, BINS, DEPTH = 300, 5, 32, 3


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """The CPU requested, and metrics registries of this test's own in both
    packages (the front ends' ``observed_transform`` and the fits'
    ``observed_fit`` write into them)."""
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    monkeypatch.delenv("SPARK_RAPIDS_ML_TPU_TREE_GROUP_BYTES", raising=False)
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
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y_cls = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(float)
    y_reg = 3.0 * x[:, 0] - 2.0 * x[:, 2] + 0.1 * rng.normal(size=n)
    y_mc = np.digitize(x[:, 0] + x[:, 1], [-0.7, 0.7]).astype(float)
    wt = rng.uniform(0.5, 2.0, size=n)
    return x, y_cls, y_reg, y_mc, wt


def _arrow_batch(x, extra=()):
    """One Arrow batch of VectorUDT structs and scalar columns, the
    mapInArrow wire shape."""
    import pyarrow as pa

    rows = []
    for i, r in enumerate(x):
        row = {"features": {"type": 1, "size": None, "indices": None,
                            "values": r.tolist()}}
        for name, values in extra:
            row[name] = float(values[i])
        rows.append(row)
    return pa.RecordBatch.from_pylist(rows)


def _frames(x, extra=(), n_partitions=3):
    """The same rows as a JAX and a port local DataFrame."""
    def build(module):
        rows = []
        for i, r in enumerate(x):
            row = {"features": module.DenseVector(r)}
            for name, values in extra:
                row[name] = float(values[i])
            rows.append(row)
        return module.LocalSparkSession(n_partitions=n_partitions) \
            .createDataFrame(rows)

    return build(jle), build(le)


def _tree(edges_d, seed=4):
    """A partial tree of depth 3 (7 internal nodes): random features and
    bin thresholds, one pass-through node."""
    rng = np.random.default_rng(seed)
    feature = rng.integers(0, edges_d, size=7).astype(np.int32)
    threshold = rng.integers(1, BINS - 1, size=7).astype(np.int32)
    threshold[5] = BINS
    return feature, threshold


def _specs():
    x, y_cls, y_reg, y_mc, wt = _design()
    _, edges = quantile_bins(x, BINS)
    f0, t0 = _tree(D, 4)
    f1, t1 = _tree(D, 5)
    trees = [{"tree": 0, "feature": f0, "threshold": t0},
             {"tree": 3, "feature": f1, "threshold": t1}]
    forest = {"edges": edges, "n_bins": BINS, "level": 2,
              "subsampling_rate": 0.8, "seed": 11, "classes": None,
              "trees": trees}
    leaf = {k: v for k, v in forest.items() if k not in ("n_bins", "level")}
    leaf["depth"] = 3
    ens_f = np.stack([f0, f1])
    ens_t = np.stack([t0, t1])
    ens_l = np.stack([np.linspace(-1.0, 1.0, 8), np.linspace(0.5, -0.5, 8)])
    gbt_spec = {"edges": edges, "n_bins": BINS, "level": 2, "depth": 3,
                "subsampling_rate": 1.0, "seed": 11, "tree": 2,
                "init": 0.2, "step_size": 0.1, "classification": False,
                "ens_feature": ens_f, "ens_threshold": ens_t,
                "ens_leaf": ens_l, "feature": f1, "threshold": t1}
    return x, y_cls, y_reg, y_mc, wt, forest, leaf, gbt_spec


def _host_cases():
    x, y_cls, y_reg, y_mc, wt, forest, leaf, gspec = _specs()
    halves = lambda y: [(x[:130], y[:130]), (x[130:], y[130:])]  # noqa: E731
    classes2 = np.array([0.0, 1.0])
    classes3 = np.array([0.0, 1.0, 2.0])
    b_cls = _arrow_batch(x, [("label", y_cls), ("wt", wt)])
    b_reg = _arrow_batch(x, [("label", y_reg), ("wt", wt)])
    sample = ("partition_forest_sample",)
    return {
        "sample tuples": (*sample, (halves(y_reg), "f", "l", 7),
                          {"cap": 64}),
        "sample arrow weighted": (*sample, ([b_reg], "features", "label", 7),
                                  {"cap": 512, "weight_col": "wt"}),
        "sample not emitting": (*sample, (halves(y_cls), "f", "l", 7),
                                {"cap": 64, "sample_stride": 3}),
        "forest regression": ("partition_forest_histograms",
                              (halves(y_reg), "f", "l", forest), {}),
        "forest classes": ("partition_forest_histograms",
                           (halves(y_mc), "f", "l",
                            dict(forest, classes=classes3)), {}),
        "forest weighted": ("partition_forest_histograms",
                            ([b_cls], "features", "label",
                             dict(forest, classes=classes2,
                                  weight_col="wt")), {}),
        "forest no bootstrap": ("partition_forest_histograms",
                                (halves(y_reg), "f", "l",
                                 dict(forest, bootstrap=False)), {}),
        "leaves regression": ("partition_forest_leaf_stats",
                              (halves(y_reg), "f", "l", leaf), {}),
        "leaves classes weighted": ("partition_forest_leaf_stats",
                                    ([b_cls], "features", "label",
                                     dict(leaf, classes=classes2,
                                          weight_col="wt")), {}),
        "leaves no bootstrap": ("partition_forest_leaf_stats",
                                (halves(y_mc), "f", "l",
                                 dict(leaf, classes=classes3,
                                      bootstrap=False)), {}),
        "gbt regression": ("partition_gbt_histograms",
                           (halves(y_reg), "f", "l", gspec), {}),
        "gbt logistic subsampled": ("partition_gbt_histograms",
                                    (halves(y_cls), "f", "l",
                                     dict(gspec, classification=True,
                                          subsampling_rate=0.7)), {}),
        "gbt weighted": ("partition_gbt_histograms",
                         ([b_reg], "features", "label",
                          dict(gspec, weight_col="wt")), {}),
        "gbt first round": ("partition_gbt_histograms",
                            (halves(y_reg), "f", "l",
                             dict(gspec, ens_feature=None,
                                  ens_threshold=None, ens_leaf=None)), {}),
        "gbt leaves": ("partition_gbt_leaf_stats",
                       (halves(y_reg), "f", "l", gspec), {}),
        "gbt leaves logistic weighted": ("partition_gbt_leaf_stats",
                                         ([b_cls], "features", "label",
                                          dict(gspec, classification=True,
                                               subsampling_rate=0.6,
                                               weight_col="wt")), {}),
    }


HOST_CASES = _host_cases()


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_partials_equal_jax(case):
    name, args, kwargs = HOST_CASES[case]
    ours = list(getattr(fp, name)(*args, **kwargs))
    ref = list(getattr(jfp, name)(*args, **kwargs))
    assert len(ours) == len(ref) >= 1
    for o, r in zip(ours, ref):
        assert list(o) == list(r)
        for key in r:
            np.testing.assert_array_equal(np.asarray(o[key]),
                                          np.asarray(r[key]), err_msg=key)


def test_host_helpers_equal_jax():
    x, _, _, _, _, forest, _, gspec = _specs()
    binned = fp.apply_bin_edges(x, forest["edges"])
    rng = np.random.default_rng(3)
    node = rng.integers(0, 4, size=N)
    channels = rng.normal(size=(N, 3))
    np.testing.assert_array_equal(
        fp.histogram_channels_np(node, binned, channels, 4, BINS),
        jfp.histogram_channels_np(node, binned, channels, 4, BINS))
    for level in range(4):
        np.testing.assert_array_equal(
            fp.route_to_level_np(binned, gspec["feature"],
                                 gspec["threshold"], level),
            jfp.route_to_level_np(binned, gspec["feature"],
                                  gspec["threshold"], level))
    for args in ((binned, gspec["ens_feature"], gspec["ens_threshold"],
                  gspec["ens_leaf"], 0.3, 0.1, 3),
                 (binned, None, None, None, 0.3, 0.1, 3)):
        np.testing.assert_array_equal(fp._gbt_margin(*args),
                                      jfp._gbt_margin(*args))
    f = rng.normal(size=N) * 30
    y = (f > 0).astype(float)
    for cls in (False, True):
        for o, r in zip(fp._gbt_residual_hess(y, f, cls),
                        jfp._gbt_residual_hess(y, f, cls)):
            np.testing.assert_array_equal(o, r)
    for d in (1, 5, 28, 90, 4096):
        for parts in (1, 3, 8, 200, 5000):
            cap = fp.sample_cap_rows(d, parts)
            assert cap == jfp.sample_cap_rows(d, parts)
            assert fp.sample_partition_stride(cap, d, parts) == \
                jfp.sample_partition_stride(cap, d, parts)
            assert fp.quantile_sample_cap(d, parts) == \
                jfp.quantile_sample_cap(d, parts)
    streams = (fp._tree_weight_stream(0.7, 5, 2, 1, True),
               jfp._tree_weight_stream(0.7, 5, 2, 1, True))
    np.testing.assert_array_equal(fp._draw_weights(streams[0], 0.7, 50),
                                  jfp._draw_weights(streams[1], 0.7, 50))
    for args in ((1.0, 5, 2, 1, False), (0.5, 5, 2, 1, True, False)):
        assert fp._tree_weight_stream(*args) is None
        assert jfp._tree_weight_stream(*args) is None


def test_combine_hist_rows_equals_jax():
    rng = np.random.default_rng(9)
    rows = [{"tree": t, "hist": rng.normal(size=24).tolist()}
            for t in (0, 2, 0, 1, 2)]
    ours = fp.combine_hist_rows(rows, 24)
    ref = jfp.combine_hist_rows(rows, 24)
    assert sorted(ours) == sorted(ref) == [0, 1, 2]
    for t in ref:
        np.testing.assert_array_equal(ours[t], ref[t])
    with pytest.raises(ValueError, match="expected 25"):
        fp.combine_hist_rows(rows, 25)


DEVICE_CASES = {
    "forest regression": ("forest", "forest regression"),
    "forest classes": ("forest", "forest classes"),
    "forest weighted": ("forest", "forest weighted"),
    "forest no bootstrap": ("forest", "forest no bootstrap"),
    "gbt regression": ("gbt", "gbt regression"),
    "gbt logistic subsampled": ("gbt", "gbt logistic subsampled"),
    "gbt weighted": ("gbt", "gbt weighted"),
    "gbt first round": ("gbt", "gbt first round"),
}


@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_device_partials_match_jax_host_plane(case):
    kind, host_case = DEVICE_CASES[case]
    _, args, _ = HOST_CASES[host_case]
    fn = (dev.partition_forest_histograms_device if kind == "forest"
          else dev.partition_gbt_histograms_device)
    ref_fn = (jfp.partition_forest_histograms if kind == "forest"
              else jfp.partition_gbt_histograms)
    ours = list(fn(*args))
    ref = list(ref_fn(*args))
    assert [o["tree"] for o in ours] == [r["tree"] for r in ref]
    # integer-weighted class counts are exact; user weights are not
    exact = (args[3].get("classes") is not None
             and not args[3].get("weight_col"))
    for o, r in zip(ours, ref):
        assert list(o) == ["tree", "hist"]
        got, want = np.asarray(o["hist"]), np.asarray(r["hist"])
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= \
                DEVICE_RTOL * np.abs(want).max()


def test_device_partial_helpers_are_the_host_channels():
    """``forest_batch_host`` builds the host plane's channels in its stream
    order, and one ``group_histograms_device`` call equals the host
    plane's ``histogram_channels_np`` per tree."""
    import torch

    x, _, y_reg, _, _, forest, _, _ = _specs()
    streams = [fp._tree_weight_stream(0.8, 11, t["tree"], 0, True)
               for t in forest["trees"]]
    binned, nodes, channels = dev.forest_batch_host(x, y_reg, None, forest,
                                                    streams)
    h = dev.group_histograms_device(binned, nodes, channels, 4, BINS,
                                    torch.device("cpu"))
    assert h.dtype == torch.float64 and h.shape == (2, 3, 4 * D * BINS)
    for ti in range(2):
        want = jfp.histogram_channels_np(nodes[ti], binned, channels[ti], 4,
                                         BINS)
        np.testing.assert_allclose(h[ti].numpy(), want, rtol=0,
                                   atol=DEVICE_RTOL * np.abs(want).max())
    empty = list(dev.partition_forest_histograms_device(
        [(x[:0], y_reg[:0])], "f", "l", forest))
    assert empty == []


def test_stream_rows_are_the_arrow_round_trip():
    """The stream shim collects the partition functions' row dicts as
    they come; they are the dicts an Arrow round trip gives, key for key
    and float for float, so the streamed fit needs no pyarrow."""
    import pyarrow as pa

    x, y_cls, y_reg, _, _, forest, leaf, gspec = _specs()
    frame = fe._StreamFrame(lambda: iter([(x[:100], y_cls[:100]),
                                          (x[100:], y_cls[100:])]))
    jobs = [(lambda b: fp.partition_forest_sample(b, "f", "l", 3, cap=64),
             fp.sample_arrow_schema),
            (lambda b: fp.partition_forest_histograms(
                b, "f", "l", dict(forest, classes=np.array([0.0, 1.0]))),
             fp.hist_arrow_schema),
            (lambda b: dev.partition_gbt_histograms_device(b, "f", "l",
                                                           gspec),
             fp.hist_arrow_schema)]
    for rows_fn, schema_fn in jobs:
        rows = frame.collect_rows(rows_fn)
        assert rows
        for row in rows:
            trip = pa.RecordBatch.from_pylist([row],
                                              schema=schema_fn()).to_pylist()
            assert list(trip[0]) == list(row)
            assert trip[0] == row
            assert all(type(trip[0][k]) is type(row[k]) for k in row)


def _set(est, **params):
    for name, value in params.items():
        est.set(name, value)
    return est


STREAMED = {
    "rf regressor": (rf.RandomForestRegressor, jax_rf.RandomForestRegressor,
                     "reg", dict(numTrees=4, subsamplingRate=0.8,
                                 minInstancesPerNode=8,
                                 featureSubsetStrategy="onethird")),
    "rf classifier": (rf.RandomForestClassifier,
                      jax_rf.RandomForestClassifier, "cls",
                      dict(numTrees=4, featureSubsetStrategy="auto")),
    "dt classifier": (dt.DecisionTreeClassifier,
                      jax_dt.DecisionTreeClassifier, "cls", {}),
    "dt regressor": (dt.DecisionTreeRegressor, jax_dt.DecisionTreeRegressor,
                     "reg", dict(minInstancesPerNode=8)),
    "gbt regressor": (gbt.GBTRegressor, jax_gbt.GBTRegressor, "reg",
                      dict(maxIter=3, minInstancesPerNode=8)),
    "gbt classifier": (gbt.GBTClassifier, jax_gbt.GBTClassifier, "cls",
                       dict(maxIter=3, subsamplingRate=0.7)),
}


@pytest.mark.parametrize("case", sorted(STREAMED))
def test_streamed_fit_equals_jax_streamed_fit(case):
    port_cls, jax_cls, target, params = STREAMED[case]
    x, y_cls, y_reg, _, _ = _design(seed=7, n=900)
    y = y_cls if target == "cls" else y_reg

    def chunks():
        return ((x[i:i + 250], y[i:i + 250]) for i in range(0, 900, 250))

    params = dict(params, maxDepth=DEPTH, seed=3, dtype="float64")
    ours = _set(port_cls(), **params).fit(chunks)
    ref = _set(jax_cls(), **params).fit(chunks)
    assert type(ours).__name__ == type(ref).__name__
    np.testing.assert_array_equal(ours.ensemble_.feature,
                                  np.asarray(ref.ensemble_.feature))
    np.testing.assert_array_equal(ours.ensemble_.threshold,
                                  np.asarray(ref.ensemble_.threshold))
    np.testing.assert_allclose(ours.ensemble_.leaf_value,
                               np.asarray(ref.ensemble_.leaf_value),
                               rtol=0, atol=F64_ATOL)
    np.testing.assert_allclose(ours.feature_importances_,
                               np.asarray(ref.feature_importances_),
                               rtol=0, atol=F64_ATOL)
    np.testing.assert_array_equal(ours.edges_, np.asarray(ref.edges_))
    assert set(ours.fit_timings_) >= set(ref.fit_timings_)
    col = "probability" if target == "cls" else "prediction"
    np.testing.assert_allclose(
        np.asarray(ours.transform(x[:50]).column(col), dtype=np.float64),
        np.asarray(ref.transform(x[:50]).column(col), dtype=np.float64),
        rtol=0, atol=F64_ATOL)


def test_streamed_gbt_equals_in_memory_fit():
    """subsamplingRate 1.0 makes boosting deterministic and n < the
    sample cap makes the plane's bin edges the in-memory fit's, so the
    streamed fit is the in-memory fit (JAX ``tests/test_gbt.py``'s
    case)."""
    x, _, y_reg, _, _ = _design(seed=8, n=300, d=4)

    def chunks():
        for i in range(0, 300, 64):
            yield x[i:i + 64], y_reg[i:i + 64]

    def est():
        return gbt.GBTRegressor().setMaxIter(6).setMaxDepth(3).setSeed(4) \
            .setDtype("float64")

    mem = est().fit(as_vector_frame(x, "features")
                    .with_column("label", y_reg.tolist()))
    streamed = est().fit(chunks)
    np.testing.assert_array_equal(streamed.ensemble_.feature,
                                  mem.ensemble_.feature)
    np.testing.assert_allclose(streamed.ensemble_.leaf_value,
                               mem.ensemble_.leaf_value, rtol=0, atol=1e-8)
    np.testing.assert_allclose(streamed.init_, mem.init_, rtol=1e-12)


def test_streamed_fits_refuse_weights_and_validation():
    x, _, y_reg, _, _ = _design(n=64)
    for est in (rf.RandomForestRegressor().setWeightCol("w"),
                gbt.GBTRegressor().setWeightCol("w")):
        with pytest.raises(ValueError, match="weightCol"):
            est.fit(lambda: iter([(x, y_reg)]))
    with pytest.raises(ValueError, match="validationIndicatorCol"):
        gbt.GBTRegressor().setValidationIndicatorCol("v") \
            .fit(lambda: iter([(x, y_reg)]))
    with pytest.raises(ValueError, match="0/1 labels"):
        gbt.GBTClassifier().fit(lambda: iter([(x, y_reg)]))
    with pytest.raises(ValueError, match="empty dataset"):
        rf.RandomForestRegressor().fit(lambda: iter([(x[:0], y_reg[:0])]))


# -- the local-engine front ends of both packages ----------------------------

def _same_fit(port_model, jax_model):
    a, b = port_model._local.ensemble_, jax_model._local.ensemble_
    np.testing.assert_array_equal(a.feature, np.asarray(b.feature))
    np.testing.assert_array_equal(a.threshold, np.asarray(b.threshold))
    np.testing.assert_allclose(a.leaf_value, np.asarray(b.leaf_value),
                               rtol=0, atol=F64_ATOL)


def _column(df, name):
    return np.asarray([r[name] for r in df.collect()])


def test_forest_plane_never_collects_rows(monkeypatch):
    """RF/GBT DataFrame fits run on the executor statistics plane — the
    driver-collect path never fires — and grow the JAX front ends'
    trees."""
    def boom(self, dataset):
        raise AssertionError("driver-collect fired on a plane family")

    monkeypatch.setattr(adapter._AdapterEstimator, "_collect_frame", boom)
    x, y_cls, y_reg, _, _ = _design(seed=2, n=240)
    jdf, pdf = _frames(x, [("label", y_cls)])
    params = dict(numTrees=6, maxDepth=DEPTH, seed=1, dtype="float64")
    m = port_spark.RandomForestClassifier(**params).fit(pdf)
    _same_fit(m, jax_spark.RandomForestClassifier(**params).fit(jdf))
    pred = _column(m.transform(pdf), "prediction")
    assert (pred == y_cls).mean() > 0.85

    jdf2, pdf2 = _frames(x, [("label", y_reg)])
    params = dict(maxIter=5, maxDepth=DEPTH, seed=2, dtype="float64",
                  minInstancesPerNode=8)
    g = port_spark.GBTRegressor(**params).fit(pdf2)
    _same_fit(g, jax_spark.GBTRegressor(**params).fit(jdf2))
    assert np.corrcoef(_column(g.transform(pdf2), "prediction"),
                       y_reg)[0, 1] > 0.9


def test_forest_executor_device_matches_host_plane():
    """executorDevice='on' runs the per-partition histogram contraction in
    torch (the CPU requested here); the grown trees equal the host plane's
    and the JAX front end's."""
    x, y_cls, y_reg, _, _ = _design(seed=3)
    jdf, pdf = _frames(x, [("label", y_cls)])
    fits = {}
    for where in ("on", "off"):
        params = dict(numTrees=6, maxDepth=DEPTH, seed=2, dtype="float64",
                      executorDevice=where)
        fits[where] = port_spark.RandomForestClassifier(**params).fit(pdf)
    _same_fit(fits["on"], fits["off"])
    _same_fit(fits["on"], jax_spark.RandomForestClassifier(
        numTrees=6, maxDepth=DEPTH, seed=2, dtype="float64",
        executorDevice="off").fit(jdf))

    jdf2, pdf2 = _frames(x, [("label", y_reg)])
    gfits = {
        where: port_spark.GBTRegressor(
            maxIter=5, maxDepth=DEPTH, seed=3, dtype="float64",
            minInstancesPerNode=8, executorDevice=where).fit(pdf2)
        for where in ("on", "off")}
    _same_fit(gfits["on"], gfits["off"])
    np.testing.assert_allclose(_column(gfits["on"].transform(pdf2),
                                       "prediction"),
                               _column(gfits["off"].transform(pdf2),
                                       "prediction"), rtol=0, atol=1e-12)


def test_gbt_plane_weight_col_matches_local():
    """weightCol on the GBT plane: with subsamplingRate 1.0 boosting is
    deterministic, the sampled bin edges cover every row (n < cap) and the
    weighted histograms are float64 — so the DataFrame fit reproduces the
    local weighted fit, and the JAX front end's plane fit."""
    x, _, y_reg, _, wt = _design(seed=5, n=200)
    jdf, pdf = _frames(x, [("label", y_reg), ("w", wt)])
    params = dict(maxIter=5, maxDepth=DEPTH, seed=5, weightCol="w",
                  dtype="float64", minInstancesPerNode=8)
    plane = port_spark.GBTRegressor(**params).fit(pdf)
    _same_fit(plane, jax_spark.GBTRegressor(**params).fit(jdf))
    frame = as_vector_frame(x, "features").with_column(
        "label", y_reg.tolist()).with_column("w", wt.tolist())
    local = _set(gbt.GBTRegressor(), **params).fit(frame)
    np.testing.assert_array_equal(plane._local.ensemble_.feature,
                                  local.ensemble_.feature)
    np.testing.assert_allclose(plane._local.ensemble_.leaf_value,
                               local.ensemble_.leaf_value, rtol=0, atol=1e-8)


def test_decision_tree_plane_never_collects(monkeypatch):
    """The DecisionTree estimators fit on the forest plane (Spark's
    single tree = RandomForest.run(numTrees=1)): the collect path never
    fires, the fit is deterministic, equals the JAX front end's, and keeps
    the single-tree surface."""
    def boom(self, dataset):
        raise AssertionError("driver-collect fired on a plane family")

    monkeypatch.setattr(adapter._AdapterEstimator, "_collect_frame", boom)
    x, y_cls, _, _, _ = _design(seed=6, n=240)
    jdf, pdf = _frames(x, [("label", y_cls)])
    m1 = port_spark.DecisionTreeClassifier(maxDepth=DEPTH, seed=1,
                                           dtype="float64").fit(pdf)
    m2 = port_spark.DecisionTreeClassifier(maxDepth=DEPTH, seed=1,
                                           dtype="float64").fit(pdf)
    _same_fit(m1, m2)
    _same_fit(m1, jax_spark.DecisionTreeClassifier(
        maxDepth=DEPTH, seed=1, dtype="float64").fit(jdf))
    assert type(m1).__name__ == "DecisionTreeClassifierModel"
    assert (_column(m1.transform(pdf), "prediction") == y_cls).mean() > 0.9
    assert m1._local.depth_ == DEPTH
    assert m1._local.to_debug_string().startswith("If (feature")

    yr = x @ [1.0, -0.5, 0.0, 0.2, 0.0]
    jdfr, pdfr = _frames(x, [("label", yr)])
    mr = port_spark.DecisionTreeRegressor(
        maxDepth=DEPTH, seed=1, dtype="float64",
        minInstancesPerNode=8).fit(pdfr)
    _same_fit(mr, jax_spark.DecisionTreeRegressor(
        maxDepth=DEPTH, seed=1, dtype="float64",
        minInstancesPerNode=8).fit(jdfr))
    assert np.corrcoef(_column(mr.transform(pdfr), "prediction"),
                       yr)[0, 1] > 0.9


def test_forest_plane_fit_persists_both_ways(tmp_path):
    x, y_cls, _, _, _ = _design(seed=9, n=200)
    jdf, pdf = _frames(x, [("label", y_cls)])
    m = port_spark.RandomForestClassifier(numTrees=3, maxDepth=DEPTH,
                                          seed=4).fit(pdf)
    m.save(str(tmp_path / "port"))
    back = port_spark.RandomForestClassificationModel.load(
        str(tmp_path / "port"))
    jax_back = jax_spark.RandomForestClassifierModel.load(
        str(tmp_path / "port"))
    np.testing.assert_array_equal(back._local.ensemble_.feature,
                                  np.asarray(jax_back._local.ensemble_
                                             .feature))
    assert (_column(back.transform(pdf), "prediction")
            == _column(m.transform(pdf), "prediction")).all()
    est = port_spark.GBTClassifier(maxIter=4, stepSize=0.3)
    est.save(str(tmp_path / "est"))
    loaded = port_spark.GBTClassifier.load(str(tmp_path / "est"))
    assert loaded.getMaxIter() == 4 and loaded.getStepSize() == 0.3


def test_forest_plane_in_spawned_executors():
    """Partitions histogram in a real spawned worker process (the executor
    side of the plane, cloudpickled closures and all) and grow the inline
    engine's tree. The one spawned-executor case of this file: a depth-1
    tree is three jobs (sample, level, leaves), each a fresh process pool
    of one worker that imports torch."""
    x, _, y_reg, _, _ = _design(seed=10, n=240)
    rows = [{"features": le.DenseVector(r), "label": float(v)}
            for r, v in zip(x, y_reg)]
    params = dict(maxDepth=1, seed=5, dtype="float64",
                  minInstancesPerNode=8)
    t0 = time.perf_counter()
    spawned = le.LocalSparkSession(
        n_partitions=2, executors="process", max_workers=1,
        executor_env={"SPARK_RAPIDS_ML_TORCH_PLATFORM": "cpu",
                      "OMP_NUM_THREADS": "1"},
    ).createDataFrame(rows)
    m = port_spark.DecisionTreeRegressor(**params).fit(spawned)
    seconds = time.perf_counter() - t0
    inline = port_spark.DecisionTreeRegressor(**params).fit(
        le.LocalSparkSession(n_partitions=2).createDataFrame(rows))
    _same_fit(m, inline)
    assert m._local.ensemble_.threshold[0, 0] < BINS
    assert seconds < 60


# -- the package's routing ----------------------------------------------------

PORTED = {
    **{n: "estimator" for n in port_spark._PYSPARK_CLASSES},
    **{n: "moments_estimator" for n in port_spark._MOMENTS_PLANE_CLASSES},
    **{n: "forest_estimator" for n in port_spark._FOREST_PLANE_CLASSES},
    **{n: "adapter" for n in port_spark._ADAPTER_CLASSES},
    **{n: "adapter2" for n in port_spark._ADAPTER2_CLASSES},
}


@pytest.mark.parametrize("name", sorted(PORTED))
def test_ported_front_ends_resolve(name):
    cls = getattr(port_spark, name)
    assert cls.__module__ == f"spark_rapids_ml_tpu_torch.spark.{PORTED[name]}"
    assert cls.__name__ == name
    assert name in port_spark.__all__
    assert name in jax_spark.__all__


@pytest.mark.parametrize("alias", sorted(port_spark._CANONICAL_ALIASES))
def test_canonical_aliases(alias):
    target = port_spark._CANONICAL_ALIASES[alias]
    if target in port_spark._UNPORTED:
        with pytest.raises(AttributeError, match="queue 1 item 7"):
            getattr(port_spark, alias)
        assert alias not in port_spark.__all__
    else:
        assert getattr(port_spark, alias) is getattr(port_spark, target)
        assert alias in port_spark.__all__


@pytest.mark.parametrize("name", sorted(port_spark._UNPORTED))
def test_unported_front_ends_name_their_item(name):
    item = port_spark._UNPORTED[name]
    with pytest.raises(AttributeError,
                       match=rf"ROADMAP queue 1 item {item.split()[0]}"):
        getattr(port_spark, name)
    assert name not in port_spark.__all__
    assert name in jax_spark.__all__
    assert item.startswith("7 ")


def test_every_jax_front_end_is_routed():
    helpers = {"combine_stats", "finalize_pca_from_stats",
               "partition_gram_stats", "vector_column_to_matrix"}
    assert set(PORTED) | set(port_spark._UNPORTED) \
        | set(port_spark._CANONICAL_ALIASES) == \
        set(jax_spark.__all__) - helpers
    with pytest.raises(AttributeError):
        getattr(port_spark, "NoSuchEstimator")
