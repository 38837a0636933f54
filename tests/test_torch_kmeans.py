"""KMeans in the port against the JAX package's, on the same numpy inputs.

The operations of ``ops/kmeans_kernel.py`` one by one, then the models.
The JAX suite runs with x64 (tests/conftest.py), so its 'auto' dtype is
float64; the port's is float32, so every comparison names its dtype.

Bars:

* float64, both packages: distances, labels and ``_cluster_stats`` within
  1e-12 relative; ``lloyd_iterations`` from shared initial centres (with a
  0/1 mask, fractional weights and an empty cluster) within 1e-10 relative
  for centres and cost, with equal ``n_iter`` and ``converged``; the host
  and streamed fits (numpy seeding in both) within 1e-12 (host) and 1e-10
  (the streamed device accumulation);
* bf16 and int8 assignment: labels equal to the JAX package's and to the
  native labels on well-separated blobs;
* seeding: ``jax.random`` cannot be matched draw for draw, so k-means++ is
  held to its properties (a zero-weight row never seeds, a seed gives the
  same centres every time) and the fits to the JAX tests' own bars on
  blobs; float32 device fits within 1e-4 of the float64 JAX fit's centres.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_ml_tpu.ops.kmeans_kernel as jax_ops
from spark_rapids_ml_tpu import KMeans as JaxKMeans
from spark_rapids_ml_tpu import KMeansModel as JaxKMeansModel
from spark_rapids_ml_tpu.data.frame import as_vector_frame as jax_frame
from spark_rapids_ml_tpu_torch import KMeans, KMeansModel
from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame
from spark_rapids_ml_tpu_torch.feature import KMeans as FeatureKMeans
from spark_rapids_ml_tpu_torch.ops import kmeans_kernel as ops

F64_REL = 1e-12
LLOYD_REL = 1e-10
F32_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def make_blobs(rng, n=300, centers=None, scale=0.5):
    centers = centers if centers is not None else np.array(
        [[0.0, 0.0], [10.0, 10.0], [-10.0, 8.0]]
    )
    pts = np.concatenate(
        [c + rng.normal(scale=scale, size=(n // len(centers), centers.shape[1]))
         for c in centers]
    )
    rng.shuffle(pts)
    return pts, centers


def _match_centers(got, want):
    """Order-invariant center comparison: greedy nearest matching."""
    got = np.asarray(got, dtype=np.float64)
    used = set()
    err = 0.0
    for w in want:
        d = np.linalg.norm(got - w, axis=1)
        for i in np.argsort(d):
            if i not in used:
                used.add(i)
                err = max(err, d[i])
                break
    return err


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def _stats_case(seed=0, rows=257, n=7, k=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, n)) * 3.0 + 1.0
    centers = rng.normal(size=(k, n)) * 3.0
    return x, centers


# -- the operations ------------------------------------------------------------

def test_pairwise_sqdist_and_labels_match_jax_at_float64():
    x, centers = _stats_case()
    got = ops._pairwise_sqdist(_t(x), _t(centers)).numpy()
    want = np.asarray(jax_ops._pairwise_sqdist(jnp.asarray(x),
                                               jnp.asarray(centers)))
    assert got.dtype == np.float64
    assert _rel(got, want) <= F64_REL
    np.testing.assert_array_equal(
        ops.assign_clusters(_t(x), _t(centers)).numpy(),
        np.asarray(jax_ops.assign_clusters(jnp.asarray(x),
                                           jnp.asarray(centers))))


@pytest.mark.parametrize("mask_kind", ["none", "binary", "fractional"])
def test_cluster_stats_match_jax_at_float64(mask_kind):
    x, centers = _stats_case(seed=1)
    rng = np.random.default_rng(2)
    valid = {"none": np.ones(len(x)),
             "binary": (rng.random(len(x)) > 0.3).astype(np.float64),
             "fractional": rng.uniform(0.1, 2.0, len(x))}[mask_kind]
    got = ops._cluster_stats(_t(x), _t(centers), _t(valid))
    want = jax_ops._cluster_stats(jnp.asarray(x), jnp.asarray(centers),
                                  jnp.asarray(valid))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) <= F64_REL


def test_float32_distances_are_full_f32_whatever_the_shape():
    """A float32 row's distances are their float64 values rounded once, so
    they do not depend on how many rows arrive with it."""
    x, centers = _stats_case(seed=3, rows=300, n=33)
    x32, c32 = _t(x, torch.float32), _t(centers, torch.float32)
    whole = ops._pairwise_sqdist(x32, c32)
    assert whole.dtype == torch.float32
    for n in (1, 3, 17, 64):
        assert torch.equal(ops._pairwise_sqdist(x32[:n], c32), whole[:n])
    x64 = x32.double()
    c64 = c32.double()
    want = ((x64 * x64).sum(1, keepdim=True) + (c64 * c64).sum(1)[None, :]
            - 2.0 * (x64 @ c64.T)).clamp_min(0).float()
    assert torch.equal(whole, want)


def test_float32_cost_carries_no_centre_norm_bias():
    """Far from the origin (||x||² ≫ d) a float32 expanded form would
    round each centre's ||c||² once for all of its rows; the port's cost
    stays within 1e-6 of the float64 cost of the same centres."""
    rng = np.random.default_rng(16)
    centers = rng.normal(size=(8, 16)) * 100.0
    x = centers[rng.integers(0, 8, 4000)] + rng.normal(size=(4000, 16))
    x32 = _t(x, torch.float32)
    init = _t(centers, torch.float32)
    result = ops.kmeans_fit_kernel(x32, init, max_iter=5)
    c = result.centers.double().numpy()
    x_used = x32.double().numpy()
    d = ((x_used[:, None, :] - c[None, :, :]) ** 2).sum(-1).min(axis=1)
    assert abs(float(result.cost) - d.sum()) <= 1e-6 * d.sum()


def _lloyd_case(mask_kind):
    x, true_centers = make_blobs(np.random.default_rng(4), n=240,
                                 centers=np.array([[0.0, 0.0, 0.0],
                                                   [6.0, 6.0, 0.0],
                                                   [-6.0, 5.0, 3.0]]),
                                 scale=1.5)
    rng = np.random.default_rng(5)
    mask = {"none": None,
            "binary": (rng.random(len(x)) > 0.2).astype(np.float64),
            "fractional": rng.uniform(0.05, 3.0, len(x))}[mask_kind]
    # rows 0-2 as seeds, one centre far from every row: an empty cluster
    init = np.concatenate([x[:3] + 0.5, [[1e3, 1e3, 1e3]]])
    return x, init, mask


@pytest.mark.parametrize("mask_kind", ["none", "binary", "fractional"])
@pytest.mark.parametrize("max_iter,tol", [(0, 1e-4), (1, 1e-4), (2, 0.0),
                                          (50, 1e-4), (50, 0.0)])
def test_lloyd_iterations_match_jax_from_shared_centres(mask_kind, max_iter,
                                                        tol):
    x, init, mask = _lloyd_case(mask_kind)
    got = ops.kmeans_fit_kernel(_t(x), _t(init),
                                mask=None if mask is None else _t(mask),
                                max_iter=max_iter, tol=tol)
    want = jax_ops.kmeans_fit_kernel(
        jnp.asarray(x), jnp.asarray(init),
        mask=None if mask is None else jnp.asarray(mask),
        max_iter=max_iter, tol=tol)
    assert got.centers.dtype == torch.float64
    assert _rel(got.centers.numpy(), np.asarray(want.centers)) <= LLOYD_REL
    assert abs(float(got.cost) - float(want.cost)) <= \
        LLOYD_REL * abs(float(want.cost))
    assert int(got.n_iter) == int(want.n_iter)
    assert bool(got.converged) == bool(want.converged)
    # the empty cluster keeps its centre
    np.testing.assert_array_equal(got.centers.numpy()[3], init[3])
    if max_iter == 0:
        assert int(got.n_iter) == 0
        np.testing.assert_array_equal(got.centers.numpy(), init)


def test_lloyd_reduce_fn_sees_every_statistics_pass():
    x, init, _ = _lloyd_case("none")
    seen = []

    def reduce_fn(stats):
        seen.append(tuple(t.shape for t in stats))
        return stats

    result = ops.lloyd_iterations(_t(x), _t(init), None, 50, 1e-4,
                                  reduce_fn=reduce_fn)
    # one pass per iteration and one for the final cost
    assert len(seen) == int(result.n_iter) + 1
    assert seen[0] == ((4, 3), (4,), ())


def test_update_cluster_stats_folds_like_jax():
    x, centers = _stats_case(seed=6, rows=300, n=5, k=4)
    batches = [(x[:128], None), (x[128:256], None),
               (np.concatenate([x[256:], np.zeros((84, 5))]),
                np.arange(128) < 44)]
    carry = (torch.zeros((4, 5), dtype=torch.float64),
             torch.zeros(4, dtype=torch.int64),
             torch.zeros((), dtype=torch.float64))
    jcarry = (jnp.zeros((4, 5)), jnp.zeros(4, dtype=jnp.int32), jnp.zeros(()))
    for batch, mask in batches:
        carry = ops.update_cluster_stats(
            carry, _t(centers), _t(batch),
            None if mask is None else torch.as_tensor(mask))
        jcarry = jax_ops.update_cluster_stats(
            jcarry, jnp.asarray(centers), jnp.asarray(batch),
            None if mask is None else jnp.asarray(mask))
    sums, counts, cost = carry
    assert counts.dtype == torch.int64 and int(counts.sum()) == 300
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcarry[1]))
    assert _rel(sums.numpy(), np.asarray(jcarry[0])) <= F64_REL
    assert _rel(cost.numpy(), np.asarray(jcarry[2])) <= F64_REL


def _separated(seed=7, rows=400, n=24, k=6, noise=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, n)) * 10.0
    x = centers[rng.integers(0, k, rows)] + noise * rng.normal(size=(rows, n))
    return x, centers


@pytest.mark.parametrize("rows", [1, 5, 17, 100, 400])
def test_reduced_precision_labels_match_jax_on_blobs(rows):
    from spark_rapids_ml_tpu.ops.quantize import (
        quantize_symmetric_host as jax_quantize_host,
    )

    x, centers = _separated()
    x = x[:rows]
    native = ops.assign_clusters(_t(x, torch.float32),
                                 _t(centers, torch.float32)).numpy()
    bf16 = ops._assign_bf16(_t(x, torch.float32),
                            _t(centers).to(torch.bfloat16)).numpy()
    q, scale = jax_quantize_host(centers)
    int8 = ops._assign_int8(
        _t(x, torch.float32), torch.as_tensor(ops.pad_int8_centers(q)),
        torch.tensor(scale), k=centers.shape[0]).numpy()
    jax_bf16 = np.asarray(jax_ops._assign_bf16(
        jnp.asarray(x, dtype=jnp.float32),
        jnp.asarray(centers, dtype=jnp.bfloat16)))
    jax_int8 = np.asarray(jax_ops._assign_int8(
        jnp.asarray(x, dtype=jnp.float32), jnp.asarray(q), scale))
    np.testing.assert_array_equal(bf16, jax_bf16)
    np.testing.assert_array_equal(int8, jax_int8)
    np.testing.assert_array_equal(bf16, native)
    np.testing.assert_array_equal(int8, native)


def test_int8_padding_centre_never_wins():
    """k = 3 pads the quantized centres to 8 columns: a row at the origin
    is nearer the zero padding than every real centre, and must still get
    a real label."""
    centers = np.array([[5.0, 5.0], [-5.0, 5.0], [0.0, -7.0]])
    x = np.zeros((4, 2))
    q = np.clip(np.round(centers / (7.0 / 127)), -127, 127).astype(np.int8)
    qt = torch.as_tensor(ops.pad_int8_centers(q))
    assert tuple(qt.shape) == (8, 8)
    labels = ops._assign_int8(_t(x, torch.float32), qt,
                              torch.tensor(7.0 / 127, dtype=torch.float32),
                              k=3)
    assert labels.max().item() < 3


def test_kmeans_plus_plus_never_seeds_a_zero_weight_row_and_is_seeded():
    rng = np.random.default_rng(8)
    x = np.concatenate([rng.normal(size=(50, 3)), np.full((5, 3), 100.0)])
    w = np.concatenate([np.ones(50), np.zeros(5)])
    for seed in range(20):
        c = ops.kmeans_plus_plus_init(_t(x), 4, seed, mask=_t(w)).numpy()
        assert np.abs(c).max() < 50, seed
    a = ops.kmeans_plus_plus_init(_t(x), 4, 3).numpy()
    b = ops.kmeans_plus_plus_init(_t(x), 4, 3).numpy()
    np.testing.assert_array_equal(a, b)
    # every centre is a data row
    for row in a:
        assert (np.abs(x - row).sum(axis=1) == 0).any()


def test_kmeans_plus_plus_seeds_one_centre_per_separated_blob():
    """D² draws: with in-blob distances ~10⁻³ of the between-blob ones, a
    second draw from a covered blob is a ~10⁻³ event per draw."""
    x, centers = _separated(seed=9, rows=600, k=6, noise=0.3)
    for seed in range(5):
        init = ops.kmeans_plus_plus_init(_t(x, torch.float32), 6, seed)
        labels = ops.assign_clusters(init.double(), _t(centers)).numpy()
        assert sorted(labels.tolist()) == list(range(6)), seed


def test_all_zero_distances_draw_only_valid_rows():
    """Duplicate-heavy data: every valid distance becomes zero after the
    first draw, and a padding row must still never be drawn."""
    x = np.concatenate([np.ones((10, 2)), np.zeros((3, 2))])
    mask = np.concatenate([np.ones(10), np.zeros(3)])
    c = ops.kmeans_plus_plus_init(_t(x), 3, 0, mask=_t(mask)).numpy()
    np.testing.assert_array_equal(c, np.ones((3, 2)))


# -- the models: the JAX package's test_kmeans.py, through both ---------------

def test_kmeans_recovers_blobs():
    x, true_centers = make_blobs(np.random.default_rng(42))
    for est in (KMeans(), JaxKMeans()):
        model = est.setK(3).setSeed(7).fit(x)
        assert _match_centers(model.cluster_centers, true_centers) < 0.2
        assert model.n_iter_ >= 1
        assert model.training_cost_ > 0
    assert isinstance(FeatureKMeans(), KMeans)


def test_float32_device_fit_matches_the_jax_fit_on_blobs():
    x, _ = make_blobs(np.random.default_rng(42))
    got = KMeans().setK(3).setSeed(7).fit(x)
    want = JaxKMeans().setK(3).setSeed(7).fit(x)
    assert got.fit_report_.algo == "kmeans"
    assert _match_centers(got.cluster_centers, want.cluster_centers) < F32_TOL
    assert got.training_cost_ == pytest.approx(want.training_cost_, rel=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_host_fit_equals_jax(weighted):
    rng = np.random.default_rng(10)
    x, _ = make_blobs(rng)
    w = rng.uniform(0.5, 3.0, len(x))
    frames = [as_vector_frame(x, "features"), jax_frame(x, "features")]
    if weighted:
        frames = [f.with_column("w", w.tolist()) for f in frames]
    got, want = (
        est.setK(3).setSeed(11).setUseXlaDot(False).setWeightCol(
            "w" if weighted else "").fit(frame)
        for est, frame in zip((KMeans(), JaxKMeans()), frames))
    assert _rel(got.cluster_centers, want.cluster_centers) <= F64_REL
    assert got.training_cost_ == pytest.approx(want.training_cost_,
                                               rel=F64_REL)
    assert got.n_iter_ == want.n_iter_


@pytest.mark.parametrize("use_xla", [False, True])
def test_streamed_fit_equals_jax(use_xla):
    """Both packages seed a streamed fit with the same numpy reservoir and
    k-means++, so from there the fits are the same computation."""
    x, _ = make_blobs(np.random.default_rng(12), n=3000)

    def factory():
        return (x[i:i + 700] for i in range(0, len(x), 700))

    got = KMeans().setK(3).setSeed(13).setDtype("float64") \
        .setUseXlaDot(use_xla).fit(factory)
    want = JaxKMeans().setK(3).setSeed(13).setUseXlaDot(use_xla).fit(factory)
    bar = LLOYD_REL if use_xla else F64_REL
    assert _rel(got.cluster_centers, want.cluster_centers) <= bar
    assert got.training_cost_ == pytest.approx(want.training_cost_, rel=bar)
    assert got.n_iter_ == want.n_iter_
    assert "seed" in got.fit_timings_


def test_in_memory_input_above_the_threshold_streams(monkeypatch):
    from spark_rapids_ml_tpu_torch.models import kmeans as km_module

    x, true_centers = make_blobs(np.random.default_rng(14), n=600)
    calls = []
    real = km_module.KMeans._fit_streamed

    def spy(self, source, k, timer):
        calls.append(source.batch_rows)
        return real(self, source, k, timer)

    monkeypatch.setattr(km_module.KMeans, "_fit_streamed", spy)
    monkeypatch.setenv("TPUML_STREAM_THRESHOLD_BYTES", "1024")
    model = KMeans().setK(3).setSeed(1).fit(x)
    assert calls
    assert _match_centers(model.cluster_centers, true_centers) < 0.2


def test_kmeans_host_path_agrees_on_blobs():
    x, true_centers = make_blobs(np.random.default_rng(42))
    host = KMeans().setK(3).setSeed(7).setUseXlaDot(False).fit(x)
    assert _match_centers(host.cluster_centers, true_centers) < 0.2


def test_kmeans_vs_sklearn_inertia():
    sklearn_cluster = pytest.importorskip("sklearn.cluster")
    x = np.random.default_rng(42).normal(size=(400, 6))
    ours = KMeans().setK(5).setSeed(3).setMaxIter(100).setTol(1e-8) \
        .setDtype("float64").fit(x)
    sk = sklearn_cluster.KMeans(
        n_clusters=5, n_init=10, random_state=0, tol=1e-8
    ).fit(x)
    assert ours.training_cost_ <= sk.inertia_ * 1.15


def test_kmeans_transform_labels_consistent():
    x, _ = make_blobs(np.random.default_rng(42))
    model = KMeans().setK(3).setSeed(1).fit(x)
    out = model.transform(x)
    labels = np.asarray(out.column("prediction"))
    assert labels.shape == (x.shape[0],)
    assert set(np.unique(labels)) <= {0, 1, 2}
    host_labels = np.asarray(
        model.copy({"useXlaDot": False}).transform(x).column("prediction")
    )
    np.testing.assert_array_equal(labels, host_labels)
    assert model.transform_report_.algo == "kmeans"


def test_kmeans_compute_cost_matches_training():
    x, _ = make_blobs(np.random.default_rng(42))
    model = KMeans().setK(3).setSeed(1).setMaxIter(50).setDtype("float64") \
        .fit(x)
    assert model.compute_cost(x) == pytest.approx(model.training_cost_,
                                                  rel=1e-6)
    # float32: the same bar against the cost of the float32 rows
    model = KMeans().setK(3).setSeed(1).setMaxIter(50).fit(x)
    x32 = x.astype(np.float32).astype(np.float64)
    assert model.compute_cost(x32) == pytest.approx(model.training_cost_,
                                                    rel=1e-6)
    assert model.computeCost(x) == model.compute_cost(x)


def test_kmeans_persistence_roundtrip_and_cross_loading(tmp_path):
    x, _ = make_blobs(np.random.default_rng(42))
    model = KMeans().setK(3).setSeed(1).setMaxIter(30).fit(x)
    path = str(tmp_path / "km")
    model.save(path)
    for loaded in (KMeansModel.load(path), JaxKMeansModel.load(path)):
        np.testing.assert_array_equal(loaded.cluster_centers,
                                      model.cluster_centers)
        assert loaded.getK() == 3 and loaded.getMaxIter() == 30
        assert loaded.training_cost_ == pytest.approx(model.training_cost_)
    a = np.asarray(model.transform(x).column("prediction"))
    b = np.asarray(KMeansModel.load(path).transform(x).column("prediction"))
    np.testing.assert_array_equal(a, b)
    jax_path = str(tmp_path / "jax_km")
    JaxKMeans().setK(3).setSeed(1).fit(x).save(jax_path)
    back = KMeansModel.load(jax_path)
    assert isinstance(back, KMeansModel) and back.getK() == 3
    est_path = str(tmp_path / "est")
    KMeans().setK(4).setTol(0.5).save(est_path)
    est = JaxKMeans.load(est_path)
    assert est.getK() == 4 and est.getTol() == 0.5


def test_kmeans_k_validation():
    with pytest.raises(ValueError, match="rows"):
        KMeans().setK(10).fit(np.ones((3, 2)) * np.arange(3)[:, None])


@pytest.mark.parametrize("use_xla", [True, False])
def test_kmeans_weighted_fixed_point_and_cost(use_xla):
    rng = np.random.default_rng(42)
    centers = np.array([[0.0, 8.0], [8.0, 0.0]])
    x = np.concatenate([c + 0.4 * rng.normal(size=(80, 2)) for c in centers])
    w = rng.uniform(0.5, 3.0, size=len(x))
    frame = as_vector_frame(x, "features").with_column("w", w.tolist())
    model = (
        KMeans().setK(2).setSeed(3).setWeightCol("w").setMaxIter(50)
        .setUseXlaDot(use_xla).setDtype("float64").fit(frame)
    )
    got = np.asarray(model.cluster_centers)
    d = ((x[:, None, :] - got[None, :, :]) ** 2).sum(-1)
    labels = d.argmin(axis=1)
    for j in range(2):
        sel = labels == j
        expect = (x[sel] * w[sel, None]).sum(0) / w[sel].sum()
        np.testing.assert_allclose(got[j], expect, atol=1e-4)
    np.testing.assert_allclose(
        model.training_cost_, (d.min(axis=1) * w).sum(), rtol=1e-4
    )


def test_kmeans_zero_weight_rows_cannot_seed_or_pull():
    rng = np.random.default_rng(42)
    x = np.concatenate([
        0.3 * rng.normal(size=(60, 2)),
        np.array([[50.0, 50.0]] * 5),
    ])
    w = np.concatenate([np.ones(60), np.zeros(5)])
    frame = as_vector_frame(x, "features").with_column("w", w.tolist())
    for seed in range(5):
        model = KMeans().setK(2).setSeed(seed).setWeightCol("w").fit(frame)
        got = np.asarray(model.cluster_centers)
        assert np.linalg.norm(got - np.array([50.0, 50.0]), axis=1).min() > 10


def test_kmeans_weighted_streamed_rejected():
    x = np.random.default_rng(42).normal(size=(50, 3))
    est = KMeans().setK(2).setWeightCol("w")
    with pytest.raises(ValueError, match="weightCol"):
        est.fit(lambda: (x[i:i + 10] for i in range(0, 50, 10)))


def test_kmeans_streamed_needs_a_reiterable_source():
    x = np.random.default_rng(42).normal(size=(50, 3))
    with pytest.raises(ValueError, match="re-iterable"):
        KMeans().setK(2).fit(x[i:i + 10] for i in range(0, 50, 10))


def test_kmeans_weighted_tiny_normalized_weights():
    rng = np.random.default_rng(42)
    centers = np.array([[0.0, 10.0], [10.0, 0.0]])
    x = np.concatenate([c + 0.3 * rng.normal(size=(40, 2)) for c in centers])
    w = np.full(len(x), 1.0 / len(x))
    frame = as_vector_frame(x, "features").with_column("w", w.tolist())
    model = KMeans().setK(2).setSeed(5).setWeightCol("w").fit(frame)
    got = np.sort(np.asarray(model.cluster_centers), axis=0)
    np.testing.assert_allclose(got, np.sort(centers, axis=0), atol=0.5)


# -- serving -------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["native", "bf16", "int8"])
@pytest.mark.parametrize("rows", [1, 13, 64, 100])
def test_serving_program_labels_match_the_jax_program(precision, rows):
    x, centers = _separated(seed=15)
    model = KMeansModel(cluster_centers=centers)
    jax_model = JaxKMeansModel(cluster_centers=centers)
    prog = model.serving_transform_program(precision)
    jax_prog = jax_model.serving_transform_program(precision)
    assert prog.algo == "kmeans" and prog.precision == precision
    batch = x[:rows]
    got = prog.fetch(prog.run(prog.put(batch)))
    want = jax_prog.fetch(jax_prog.run(jax_prog.put(batch)))
    assert got.dtype == np.int32 == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(model.transform(batch).column("prediction")))


def test_serving_stage_is_terminal_and_declines_on_the_host_path():
    x, centers = _separated()
    model = KMeansModel(cluster_centers=centers)
    stage = model.serving_stage()
    assert stage.terminal and stage.algo == "kmeans"
    assert stage.fetch_dtype == np.dtype(np.int32)
    assert model.copy({"useXlaDot": False}).serving_stage() is None
    assert model.copy({"useXlaDot": False}).serving_transform_program() is None
    assert KMeansModel().serving_stage() is None
    with pytest.raises(ValueError, match="precision"):
        model.serving_stage("fp8")
