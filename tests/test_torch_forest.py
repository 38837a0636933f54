"""The tree family in the port against the JAX package's, on the same numpy
inputs: the operations of ``ops/forest_kernel.py`` one by one, then the
RandomForest and DecisionTree estimators and models.

The JAX suite runs with x64 (tests/conftest.py), so its 'auto' dtype is
float64; the port's is float32, so every comparison names its dtype.

Bars:

* float64: feature and threshold arrays equal element for element; leaf
  values, predictions, probabilities and feature importances within
  1e-12 (absolute; the quantities here are O(1)–O(10));
* float32: the port selects splits on its float64 histogram, so a
  float32 classification tree is the float64 tree (integer class counts
  are exact either way), its leaves rounded once; a float32 regression
  tree sees its labels rounded to float32, and predicts within 1e-5
  relative of the JAX package's float64 fit;
* the data is free of near-ties: a split whose gain another split matches
  to within rounding is decided by the order of a sum, which the two
  packages take differently. Poisson weights of 0 and nodes of a few rows
  make such exact ties (two partitions equal on the weighted rows), so
  the regression fits here keep ``minInstancesPerNode`` ≥ 8 and a strong
  planted signal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import spark_rapids_ml_tpu as jax_pkg
import spark_rapids_ml_tpu_torch as port_pkg
import spark_rapids_ml_tpu.ops.forest_kernel as jax_ops
from spark_rapids_ml_tpu.data.frame import as_vector_frame as jax_frame
from spark_rapids_ml_tpu.models import random_forest as jax_rf
from spark_rapids_ml_tpu.spark.forest_plane import (
    route_to_level_np as jax_route_to_level_np,
)
from spark_rapids_ml_tpu_torch import (
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    RandomForestClassifier,
    RandomForestRegressor,
)
from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame
from spark_rapids_ml_tpu_torch.models import random_forest as rf
from spark_rapids_ml_tpu_torch.ops import forest_kernel as ops
from spark_rapids_ml_tpu_torch.utils import resources

F64_ATOL = 1e-12
F32_REL = 1e-5
N, D, DEPTH, BINS = 1536, 6, 3, 16


@pytest.fixture(scope="module", autouse=True)
def _cpu_requested():
    """The CPU asked for, and no group-size override, for the module's
    fixtures as well as its tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
        mp.delenv("SPARK_RAPIDS_ML_TPU_TREE_GROUP_BYTES", raising=False)
        yield


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _x(seed=0, n=N, d=D):
    return np.random.default_rng(seed).normal(size=(n, d))


def _y_reg(x, seed=1):
    noise = np.random.default_rng(seed).normal(size=x.shape[0])
    return (3.0 * x[:, 0] + 2.0 * np.sin(2.0 * x[:, 1]) + x[:, 2] * x[:, 3]
            + 0.2 * noise)


def _y_cls(x, k=2):
    score = x[:, 0] + x[:, 1] ** 2 - 0.5 * x[:, 2]
    cuts = np.quantile(score, np.linspace(0, 1, k + 1)[1:-1])
    return np.searchsorted(cuts, score).astype(np.float64)


def _same_trees(port_ens, jax_ens):
    np.testing.assert_array_equal(np.asarray(port_ens.feature),
                                  np.asarray(jax_ens.feature))
    np.testing.assert_array_equal(np.asarray(port_ens.threshold),
                                  np.asarray(jax_ens.threshold))


# -- the operations ------------------------------------------------------------

@pytest.fixture(scope="module")
def binned():
    b, _ = jax_ops.quantile_bins(_x(), BINS)
    return b


def test_binning_is_the_jax_packages():
    x = _x(3)
    pb, pe = ops.quantile_bins(x, BINS)
    jb, je = jax_ops.quantile_bins(x, BINS)
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pe, je)
    np.testing.assert_array_equal(ops.apply_bin_edges(_x(4), pe),
                                  jax_ops.apply_bin_edges(_x(4), je))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_channel_histograms_equal_the_jax_contraction(binned, dtype):
    """H = (node one-hot · channels)ᵀ · bin one-hot, over several row
    blocks: float64 within 1e-12 of the JAX contraction, and the float32
    result exactly the float64 one rounded once."""
    rng = np.random.default_rng(2)
    n_nodes = 4
    node = rng.integers(0, n_nodes, size=N)
    channels = rng.normal(size=(N, 3))
    node_oh = np.eye(n_nodes)[node]
    bin_oh = np.asarray(jax_ops._bin_onehot(jnp.asarray(binned), BINS,
                                            jnp.float64))
    want = np.asarray(jax_ops._channel_histograms(
        jnp.asarray(node_oh), jnp.asarray(bin_oh), jnp.asarray(channels)))
    old = ops.ROW_CHUNK
    try:
        ops.ROW_CHUNK = 500  # four blocks, the last one ragged
        got = ops.channel_histograms(_t(node, torch.int64)[None], n_nodes,
                                     _t(binned, torch.int32),
                                     _t(channels)[None], BINS)
        rounded = ops.channel_histograms(
            _t(node, torch.int64)[None], n_nodes, _t(binned, torch.int32),
            _t(channels, dtype)[None], BINS, dtype=dtype)
    finally:
        ops.ROW_CHUNK = old
    assert got.dtype == torch.float64 and got.shape == (1, 3, n_nodes,
                                                        D * BINS)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=F64_ATOL)
    if dtype == torch.float32:
        h32 = ops.channel_histograms(
            _t(node, torch.int64)[None], n_nodes, _t(binned, torch.int32),
            _t(channels, dtype)[None], BINS)
        assert torch.equal(rounded, h32.to(torch.float32))
    else:
        assert torch.equal(rounded, got)


@pytest.mark.parametrize("criterion", ["variance", "gini"])
def test_level_split_equals_the_jax_selection(criterion):
    """A level's split selection on the same histograms: equal features,
    thresholds and kept gains — with masked features, a node too small to
    split under min_leaf (pass-through) and a node of one class (no
    positive gain)."""
    rng = np.random.default_rng(5)
    n_nodes, d, bins = 4, 5, 8
    if criterion == "variance":
        c = rng.integers(0, 6, size=(n_nodes, d, bins)).astype(float)
        s = rng.normal(size=c.shape) * c
        h = np.stack([c, s, s * s / np.maximum(c, 1) + c])
        gain_j, gain_p, cnt = (jax_ops.variance_gain_fn,
                               ops.variance_gain_fn, slice(0, 1))
    else:
        h = rng.integers(0, 5, size=(3, n_nodes, d, bins)).astype(float)
        h[1:, 3] = 0.0  # node 3 holds one class only
        gain_j, gain_p, cnt = (jax_ops.gini_gain_fn, ops.gini_gain_fn,
                               slice(0, 3))
    h[:, 2] = 0.0
    h[0, 2, :, 0] = 1.0  # node 2: one row a feature, no split of 2 rows
    mask = np.array([1.0, 0.0, 1.0, 1.0, 0.0])
    want = jax.jit(jax_ops.level_split, static_argnums=(1, 2, 4, 5))(
        jnp.asarray(h), gain_j, cnt, jnp.asarray(mask), 1, bins)
    got = ops.level_split(_t(h), gain_p, cnt, _t(mask), 1, bins)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1][2]) == bins  # pass-through
    assert set(np.asarray(got[0])) <= {0, 2, 3}


@pytest.fixture(scope="module")
def grown_regression(binned):
    """One regression tree of each package on the same inputs (float64),
    with leaf ids, and the port's float32 tree."""
    x = _x()
    y = _y_reg(x)
    w = np.random.default_rng(7).poisson(1.0, N).astype(np.float64)
    mask = np.ones((DEPTH, D))
    mask[1, 4] = 0.0
    jax_out = jax_ops.grow_tree_regression(
        jnp.asarray(binned), jnp.asarray(y), jnp.asarray(w),
        jnp.asarray(mask), DEPTH, BINS, 8, return_leaf_ids=True)
    port_out = ops.grow_tree_regression(
        _t(binned, torch.int32), _t(y), _t(w), _t(mask), DEPTH, BINS, 8,
        return_leaf_ids=True)
    port32 = ops.grow_tree_regression(
        _t(binned, torch.int32), _t(y, torch.float32),
        _t(w, torch.float32), _t(mask, torch.float32), DEPTH, BINS, 8,
        return_leaf_ids=True)
    return [np.asarray(a) for a in jax_out], port_out, port32


def test_grow_tree_regression_equals_the_jax_grower(grown_regression):
    jax_out, port_out, _ = grown_regression
    jf, jt, jl, jg, jids = jax_out
    pf, pt, pl, pg, pids = port_out
    np.testing.assert_array_equal(pf.numpy(), jf)
    np.testing.assert_array_equal(pt.numpy(), jt)
    np.testing.assert_allclose(pl.numpy(), jl, rtol=0, atol=F64_ATOL)
    np.testing.assert_allclose(pg.numpy(), jg, rtol=1e-12)
    np.testing.assert_array_equal(pids.numpy(), jids)
    assert pf.dtype == torch.int32 and pl.dtype == torch.float64


def test_float32_regression_tree_is_the_float64_tree(grown_regression):
    jax_out, _, port32 = grown_regression
    jf, jt, jl = jax_out[:3]
    pf, pt, pl, pg, pids = port32
    assert pl.dtype == torch.float32 and pg.dtype == torch.float32
    np.testing.assert_array_equal(pf.numpy(), jf)
    np.testing.assert_array_equal(pt.numpy(), jt)
    np.testing.assert_array_equal(pids.numpy(), jax_out[4])
    assert np.abs(pl.numpy() - jl).max() <= F32_REL * np.abs(jl).max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_grow_tree_classification_equals_the_jax_grower(binned, dtype):
    """The JAX grower at float64 on integer-weighted class counts (exact
    in either package): equal trees, leaves and gains at float64; at
    float32 the port's tree is that float64 tree, its leaves and gains
    rounded once (the split selection runs on the float64 histogram)."""
    x = _x()
    y = _y_cls(x, 3)
    oh = np.eye(3)[y.astype(int)]
    w = np.random.default_rng(8).poisson(1.0, N).astype(np.float64)
    mask = np.ones((DEPTH, D))
    mask[0, 0] = 0.0
    jf, jt, jl, jg = [np.asarray(a) for a in jax_ops.grow_tree_classification(
        jnp.asarray(binned), jnp.asarray(oh), jnp.asarray(w),
        jnp.asarray(mask), DEPTH, BINS, 3, 1)]
    pf, pt, pl, pg = ops.grow_tree_classification(
        _t(binned, torch.int32), _t(oh, dtype), _t(w, dtype),
        _t(mask, dtype), DEPTH, BINS, 3, 1)
    np.testing.assert_array_equal(pf.numpy(), jf)
    np.testing.assert_array_equal(pt.numpy(), jt)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    np.testing.assert_array_equal(pl.numpy(), jl.astype(np_dtype))
    np.testing.assert_array_equal(pg.numpy(), jg.astype(np_dtype))
    assert pl.shape == (2 ** DEPTH, 3) and pl.dtype == dtype


def test_batched_growers_grow_each_tree_as_alone(binned):
    """Trees grown as a group of 3 equal the same trees grown one by
    one (features, thresholds; leaves within 1e-12)."""
    x = _x()
    y = _y_reg(x)
    rng = np.random.default_rng(9)
    w = rng.poisson(1.0, (3, N)).astype(np.float64)
    masks = (rng.random((3, DEPTH, D)) < 0.7).astype(np.float64)
    group = ops.grow_trees_regression_batch(
        _t(binned, torch.int32), _t(y), _t(w), _t(masks), DEPTH, BINS, 8)
    for t in range(3):
        alone = ops.grow_tree_regression(
            _t(binned, torch.int32), _t(y), _t(w[t]), _t(masks[t]), DEPTH,
            BINS, 8)
        assert torch.equal(group[0][t], alone[0])
        assert torch.equal(group[1][t], alone[1])
        np.testing.assert_allclose(group[2][t].numpy(), alone[2].numpy(),
                                   rtol=0, atol=F64_ATOL)


def test_collectives_take_contiguous_tensors(binned, monkeypatch):
    """Every all_reduce of a sharded grow gets a contiguous tensor (NCCL
    refuses a strided one; gloo takes it), and its result is used."""
    import torch.distributed as dist

    seen = []

    def fake_all_reduce(t, group=None):
        seen.append(t.is_contiguous())
        t.mul_(2.0)  # a "world" of two identical ranks

    monkeypatch.setattr(dist, "all_reduce", fake_all_reduce)
    x = _x()
    y = _y_cls(x, 3)
    w = np.ones(N)
    mask = np.ones((DEPTH, D))
    args = (_t(binned, torch.int32), _t(np.eye(3)[y.astype(int)]), _t(w),
            _t(mask), DEPTH, BINS, 3, 1)
    alone = ops.grow_tree_classification(*args)
    doubled = ops.grow_tree_classification(*args, group=object())
    assert seen and all(seen)
    for a, b in zip(alone[:3], doubled[:3]):
        assert torch.equal(a, b)  # doubled counts: the same splits, leaves
    assert torch.allclose(doubled[3], 2 * alone[3])


def test_route_apply_and_importances_equal_the_jax_functions(binned):
    rng = np.random.default_rng(11)
    t_count, n_int = 3, 2 ** DEPTH - 1
    feature = rng.integers(0, D, size=(t_count, n_int)).astype(np.int32)
    threshold = rng.integers(0, BINS + 1, size=(t_count, n_int)).astype(
        np.int32)
    leaf = rng.normal(size=(t_count, 2 ** DEPTH, 3))
    gains = np.abs(rng.normal(size=(t_count, n_int)))
    for t in range(t_count):
        want = np.asarray(jax_ops.route_to_leaves(
            jnp.asarray(binned), jnp.asarray(feature[t]),
            jnp.asarray(threshold[t]), DEPTH))
        got = ops.route_to_leaves(_t(binned, torch.int32),
                                  _t(feature[t], torch.int64),
                                  _t(threshold[t], torch.int32), DEPTH)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            ops.route_to_level_np(binned, feature[t], threshold[t], DEPTH),
            jax_route_to_level_np(binned, feature[t], threshold[t], DEPTH))
    want = np.asarray(jax_ops.forest_apply(
        jnp.asarray(binned), jax_ops.TreeEnsemble(
            jnp.asarray(feature), jnp.asarray(threshold), jnp.asarray(leaf)),
        DEPTH))
    got = ops.forest_apply(_t(binned, torch.int32), ops.TreeEnsemble(
        _t(feature, torch.int64), _t(threshold, torch.int32), _t(leaf)),
        DEPTH)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F64_ATOL)
    np.testing.assert_array_equal(
        ops.feature_importances(feature, gains, D),
        jax_ops.feature_importances(feature, gains, D))


# -- the estimators ------------------------------------------------------------

def _frame(pkg_frame, x, y, **cols):
    frame = pkg_frame(x, "features").with_column("label", y.tolist())
    for name, values in cols.items():
        frame = frame.with_column(name, np.asarray(values).tolist())
    return frame


REG_CASES = {
    "all": dict(featureSubsetStrategy="all"),
    "auto": dict(featureSubsetStrategy="auto"),
    "log2": dict(featureSubsetStrategy="log2", subsamplingRate=0.7),
    "count": dict(featureSubsetStrategy=4),
    "fraction": dict(featureSubsetStrategy="0.5"),
}
CLS_CASES = {
    "binary": (2, dict(featureSubsetStrategy="auto")),
    "multiclass": (3, dict(featureSubsetStrategy="all")),
    "weighted": (2, dict(featureSubsetStrategy="sqrt")),
}


def _forest(pkg, classification, dtype="float64", **params):
    cls = pkg.RandomForestClassifier if classification else \
        pkg.RandomForestRegressor
    est = cls().setNumTrees(4).setMaxDepth(DEPTH).setMaxBins(BINS) \
        .setSeed(17).setDtype(dtype)
    if not classification:
        est.setMinInstancesPerNode(8)
    for name, value in params.items():
        est.set(name, value)
    return est


def _weights(seed=21):
    # quarter steps: sums of them are exact, so weighted class counts
    # stay exact in either package
    return np.random.default_rng(seed).integers(1, 9, size=N) / 4.0


@pytest.fixture(scope="module")
def regression_fits():
    """{case: (port model, JAX model)} at float64 on one data set."""
    x = _x()
    y = _y_reg(x)
    out = {}
    for case, params in REG_CASES.items():
        out[case] = (_forest(port_pkg, False, **params).fit(x, y),
                     _forest(jax_pkg, False, **params).fit(x, y))
    return out


@pytest.mark.parametrize("case", list(REG_CASES))
def test_forest_regressor_equals_the_jax_fit(regression_fits, case):
    port, jax_model = regression_fits[case]
    _same_trees(port.ensemble_, jax_model.ensemble_)
    np.testing.assert_allclose(port.ensemble_.leaf_value,
                               np.asarray(jax_model.ensemble_.leaf_value),
                               rtol=0, atol=F64_ATOL)
    np.testing.assert_allclose(port.feature_importances_,
                               jax_model.feature_importances_, rtol=0,
                               atol=F64_ATOL)
    xq = _x(30, n=200)
    got = np.asarray(port.transform(xq).column("prediction"))
    want = np.asarray(jax_model.transform(xq).column("prediction"))
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_ATOL)
    np.testing.assert_array_equal(port.edges_, jax_model.edges_)


@pytest.fixture(scope="module")
def classification_fits():
    x = _x()
    out = {}
    for case, (k, params) in CLS_CASES.items():
        y = _y_cls(x, k)
        if case == "weighted":
            pf = _frame(as_vector_frame, x, y, w=_weights())
            jf = _frame(jax_frame, x, y, w=_weights())
            params = dict(params, weightCol="w")
        else:
            pf = jf = None
        out[case] = (
            _forest(port_pkg, True, **params).fit(pf) if pf is not None
            else _forest(port_pkg, True, **params).fit(x, y),
            _forest(jax_pkg, True, **params).fit(jf) if jf is not None
            else _forest(jax_pkg, True, **params).fit(x, y))
    return out


@pytest.mark.parametrize("case", list(CLS_CASES))
def test_forest_classifier_equals_the_jax_fit(classification_fits, case):
    port, jax_model = classification_fits[case]
    _same_trees(port.ensemble_, jax_model.ensemble_)
    np.testing.assert_allclose(port.ensemble_.leaf_value,
                               np.asarray(jax_model.ensemble_.leaf_value),
                               rtol=0, atol=F64_ATOL)
    np.testing.assert_array_equal(port.classes_, jax_model.classes_)
    np.testing.assert_allclose(port.feature_importances_,
                               jax_model.feature_importances_, rtol=0,
                               atol=F64_ATOL)
    xq = _x(31, n=200)
    np.testing.assert_allclose(port.predict_proba(xq),
                               jax_model.predict_proba(xq), rtol=0,
                               atol=F64_ATOL)
    got, want = port.transform(xq), jax_model.transform(xq)
    np.testing.assert_array_equal(np.asarray(got.column("prediction")),
                                  np.asarray(want.column("prediction")))


def test_float32_classifier_grows_the_float64_trees(classification_fits):
    x = _x()
    port32 = _forest(port_pkg, True, dtype="float32",
                     featureSubsetStrategy="auto").fit(x, _y_cls(x, 2))
    _, jax_model = classification_fits["binary"]
    _same_trees(port32.ensemble_, jax_model.ensemble_)
    assert port32.ensemble_.leaf_value.dtype == np.float32
    np.testing.assert_allclose(port32.ensemble_.leaf_value,
                               np.asarray(jax_model.ensemble_.leaf_value),
                               rtol=0, atol=1e-7)


def test_float32_regressor_predicts_as_the_jax_float64_fit(regression_fits):
    x = _x()
    port32 = _forest(port_pkg, False, dtype="float32",
                     featureSubsetStrategy="auto").fit(x, _y_reg(x))
    _, jax_model = regression_fits["auto"]
    _same_trees(port32.ensemble_, jax_model.ensemble_)
    xq = _x(32, n=200)
    got = np.asarray(port32.transform(xq).column("prediction"))
    want = np.asarray(jax_model.transform(xq).column("prediction"))
    assert np.abs(got - want).max() <= F32_REL * np.abs(want).max()


def test_tree_batching_is_invariant_to_group_size(monkeypatch):
    """The JAX test of the same name through the port: the same ensemble
    whatever the memory-budgeted group size (all 6, 1 through the env
    seam, and the maxMemoryInMB param seam)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 6))
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float64)

    def fit(**params):
        est = RandomForestClassifier().setNumTrees(6).setMaxDepth(3) \
            .setSeed(11).setDtype("float64")
        for name, value in params.items():
            est.set(name, value)
        return est.fit(x, y)

    big = fit()
    monkeypatch.setenv("SPARK_RAPIDS_ML_TPU_TREE_GROUP_BYTES", "1")
    tiny = fit()
    monkeypatch.delenv("SPARK_RAPIDS_ML_TPU_TREE_GROUP_BYTES")
    mid = fit(maxMemoryInMB=1)
    assert (big.trees_per_group_, tiny.trees_per_group_) == (6, 1)
    for other in (mid, tiny):
        _same_trees(other.ensemble_, big.ensemble_)
        np.testing.assert_allclose(other.ensemble_.leaf_value,
                                   big.ensemble_.leaf_value, atol=1e-12)
        np.testing.assert_allclose(other.feature_importances_,
                                   big.feature_importances_, atol=1e-12)


def test_tree_group_budget_reads_the_jax_knobs(monkeypatch):
    est = RandomForestRegressor().setMaxMemoryInMB(3)
    assert resources.tree_group_budget_bytes(est) == 3 * 1024 * 1024
    assert resources.tree_group_budget_bytes() == 64 * 1024 * 1024
    monkeypatch.setenv("SPARK_RAPIDS_ML_TPU_TREE_GROUP_BYTES", "4096")
    assert resources.tree_group_budget_bytes(est) == 4096
    monkeypatch.setenv("SPARK_RAPIDS_ML_TPU_TREE_GROUP_BYTES", "lots")
    with pytest.raises(ValueError, match="positive integer"):
        resources.tree_group_budget_bytes(est)
    # the port's own residents: 8 bytes an element of the channels,
    # weights, routing and a row block's leaf-pass one-hot
    per_tree = 8 * (1000 * (3 + 5) + 1000 * 2 ** 5 * 3)
    assert rf._tree_batch_size(1000, 5, 3, 10 * per_tree, 20) == 10
    assert rf._tree_batch_size(1000, 5, 3, 1, 20) == 1
    assert rf._tree_batch_size(1000, 5, 3, 10 ** 12, 20) == 20


def test_subset_strategy_surface_is_the_jax_packages():
    for d in (1, 2, 7, 28, 90):
        for strategy in ("auto", "all", "sqrt", "onethird", "log2", 1, 3,
                         "2", "0.25", 0.5, "1.0", 1.0):
            for classification in (False, True):
                assert rf._subset_counts(strategy, d, classification) == \
                    jax_rf._subset_counts(strategy, d, classification)
    for bad in (0, -1, "0", "1.5", 1.5, True, "half"):
        assert rf._valid_subset_strategy(bad) == \
            jax_rf._valid_subset_strategy(bad)
        with pytest.raises(ValueError):
            RandomForestRegressor().setFeatureSubsetStrategy(bad)


def test_streamed_tree_fits_are_not_ported_yet():
    x = _x(n=64)
    y = _y_reg(x)
    for est in (RandomForestRegressor(), DecisionTreeClassifier(),
                port_pkg.GBTRegressor()):
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            est.fit(lambda: iter([(x, y)]))
        with pytest.raises(ValueError, match="RE-ITERABLE"):
            est.fit(iter([(x, y)]))


def test_depth_comes_from_the_fitted_ensemble():
    x = _x(n=400)
    y = _y_reg(x)
    model = RandomForestRegressor().setNumTrees(2).setMaxDepth(3) \
        .setDtype("float64").fit(x, y)
    before = np.asarray(model.transform(x).column("prediction"))
    model.setMaxDepth(7)
    after = np.asarray(model.transform(x).column("prediction"))
    np.testing.assert_array_equal(before, after)
    with pytest.raises(ValueError, match="query dim"):
        model.transform(x[:, :3])


# -- DecisionTree ------------------------------------------------------------

@pytest.mark.parametrize("classification", [False, True])
def test_decision_tree_equals_the_jax_tree(classification):
    x = _x()
    y = _y_cls(x, 2) if classification else _y_reg(x)
    name = "DecisionTreeClassifier" if classification else \
        "DecisionTreeRegressor"
    port = getattr(port_pkg, name)(maxDepth=DEPTH, dtype="float64",
                                   minInstancesPerNode=8).fit(x, y)
    jax_model = getattr(jax_pkg, name)(maxDepth=DEPTH, dtype="float64",
                                       minInstancesPerNode=8).fit(x, y)
    _same_trees(port.ensemble_, jax_model.ensemble_)
    np.testing.assert_allclose(port.ensemble_.leaf_value,
                               np.asarray(jax_model.ensemble_.leaf_value),
                               rtol=0, atol=F64_ATOL)
    assert (port.depth_, port.num_nodes_) == (jax_model.depth_,
                                              jax_model.num_nodes_)
    assert port.to_debug_string() == jax_model.to_debug_string()
    assert port.getNumTrees() == 1


def test_decision_tree_pins_are_enforced():
    est = DecisionTreeRegressor()
    for name, value in (("numTrees", 3), ("featureSubsetStrategy", "sqrt"),
                        ("subsamplingRate", 0.5)):
        with pytest.raises(ValueError, match="single-tree contract"):
            est.set(name, value)
    est.set("numTrees", 1)
    assert DecisionTreeClassifier(maxDepth=3).getMaxDepth() == 3
