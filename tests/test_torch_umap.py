"""UMAP in the port against the JAX package's, on the same numpy inputs.

The operations of ``ops/umap_kernel.py`` and the model of
``models/umap.py`` through both packages at float64 (the JAX suite runs
under x64; the port is asked for float64 by name), then the port's fits on
``tests/test_umap.py``'s blobs to that file's structure bars.

Bars. ``fit_ab`` and the edge list are NumPy copies: equal. ρ equal and σ
within 1e3·2⁻³⁰ (a few of the bisection's last steps); the fuzzy graph
within 1e-12; the spectral and PCA inits within 1e-8 after aligning each
column's sign, on a connected graph (the eigenvectors' signs are free).
The optimizers, fed the JAX package's init (spectral for the dense, PCA
for the tiled one): within 1e-12 after one epoch and 1e-9 after five, as
max |Δ| / max |y| (|y| ≈ 14 here). Both packages take the JAX package's
expressions in float64, but XLA and PyTorch sum the force's
rowsum(W)·Y − W·Y in other orders, and that form cancels terms of ~1e5
on these inputs, so each package's force carries ~1e-11 of rounding (the
tiled optimizers differ by 5.3e-12 absolute after one epoch), which the
dynamics amplify about 1000× per epoch (``tests/test_distributed_umap.py``
measured the same growth between two JAX meshes). The inputs are that
file's ``_graph_and_init``. The transform within 1e-10 relative.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import spark_rapids_ml_tpu.ops.umap_kernel as jax_ops
from spark_rapids_ml_tpu import UMAP as JaxUMAP
from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxVectorFrame
from spark_rapids_ml_tpu.models.umap import UMAPModel as JaxUMAPModel
from spark_rapids_ml_tpu.ops.knn_kernel import knn_kernel as jax_knn
from spark_rapids_ml_tpu.parallel.mesh import pad_rows_to_multiple
from spark_rapids_ml_tpu_torch import UMAP, UMAPModel
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
from spark_rapids_ml_tpu_torch.models.umap import knn_without_self
from spark_rapids_ml_tpu_torch.ops import umap_kernel as ops

SIGMA_ATOL = 1e3 * 2.0 ** -30
GRAPH_ATOL = 1e-12
INIT_ATOL = 1e-8
EPOCH1_REL = 1e-12
EPOCH5_REL = 1e-9
TRANSFORM_REL = 1e-10
REPULSION = 0.5          # tests/test_distributed_umap.py's
SEED = 42                # tests/conftest.py's rng, as tests/test_umap.py's


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _aligned(got, want):
    """``got`` with each column's sign flipped to agree with ``want``."""
    got = np.asarray(got)
    return got * np.sign((got * np.asarray(want)).sum(axis=0))[None, :]


def _jax_knn(x, k):
    d, i = jax_knn(jnp.asarray(x), jnp.asarray(x), k + 1)
    return np.asarray(d)[:, 1:], np.asarray(i)[:, 1:]


@functools.lru_cache(maxsize=None)
def _graph_and_init(seed=SEED, n=96, d=6, k=8):
    """tests/test_distributed_umap.py's inputs: the JAX package's kNN,
    memberships, edge list, dense graph and PCA init."""
    rng = np.random.default_rng(seed)
    centers = np.array([np.eye(d)[i] * 8 for i in range(2)])
    y = rng.integers(0, 2, size=n)
    x = rng.normal(size=(n, d)) * 0.4 + centers[y]
    dists, idx = _jax_knn(x, k)
    rho, sigma = jax_ops.smooth_knn_calibration(jnp.asarray(dists))
    mu = np.asarray(jnp.exp(-jnp.maximum(jnp.asarray(dists) - rho[:, None],
                                         0.0) / sigma[:, None]))
    edges = jax_ops.symmetric_edge_list(mu, idx, n)
    p = np.asarray(jax_ops.fuzzy_graph(jnp.asarray(dists), jnp.asarray(idx),
                                       n))
    emb0 = np.asarray(jax_ops.pca_init(jnp.asarray(x), 2))
    return x, y, dists, idx, edges, p, emb0


@functools.lru_cache(maxsize=None)
def _connected(seed=3, n=96, d=6, k=8):
    """One Gaussian cloud of ``_graph_and_init``'s shape (the JAX programs
    compile once): its kNN graph is connected, so the Laplacian's
    eigenvalue 0 is simple and the bottom eigenvectors are unique up to
    sign."""
    x = np.random.default_rng(seed).normal(size=(n, d))
    dists, idx = _jax_knn(x, k)
    return x, dists, idx


# -- the operations -----------------------------------------------------------

@pytest.mark.parametrize("min_dist,spread", [(0.1, 1.0), (0.5, 2.0)])
def test_fit_ab_equal(min_dist, spread):
    assert ops.fit_ab(min_dist, spread) == jax_ops.fit_ab(min_dist, spread)


def test_calibration_rho_equal_sigma_within_steps():
    rng = np.random.default_rng(7)
    d = np.sort(rng.uniform(0.1, 3.0, size=(64, 9)), axis=1)
    d[0] = 1.25                         # all equal: σ ends at the bracket
    d[1] = np.linspace(0.0, 2.0, 9)     # ρ = 0
    jr, js = jax_ops.smooth_knn_calibration(jnp.asarray(d))
    rho, sigma = ops.smooth_knn_calibration(_t(d))
    np.testing.assert_array_equal(rho.numpy(), np.asarray(jr))
    assert np.abs(sigma.numpy() - np.asarray(js)).max() <= SIGMA_ATOL
    # 32 steps from 1e3 stop above the fallback's 2e-8, in both packages
    assert 2e-8 < sigma[0].item() < 1e-6


def test_fuzzy_graph_and_edge_list_match():
    x, _, dists, idx, (ei, ej, ep), p, _ = _graph_and_init()
    got = ops.fuzzy_graph(_t(dists), _t(idx), len(x)).numpy()
    assert np.abs(got - p).max() <= GRAPH_ATOL
    assert np.allclose(got, got.T) and (np.diag(got) == 0).all()
    mu = ops.memberships(_t(dists)).numpy()
    rho, sigma = jax_ops.smooth_knn_calibration(jnp.asarray(dists))
    jmu = np.asarray(jnp.exp(-jnp.maximum(jnp.asarray(dists) - rho[:, None],
                                          0.0) / sigma[:, None]))
    assert np.abs(mu - jmu).max() <= GRAPH_ATOL
    pi, pj, pp = ops.symmetric_edge_list(mu, idx, len(x))
    np.testing.assert_array_equal(pi, ei)
    np.testing.assert_array_equal(pj, ej)
    assert np.abs(pp - ep).max() <= GRAPH_ATOL
    # the edge list is the dense graph's upper triangle
    np.testing.assert_allclose(p[pi, pj], pp, atol=GRAPH_ATOL)
    assert np.count_nonzero(np.triu(p, 1)) == len(pp)


def test_spectral_and_pca_init_match_after_sign_alignment():
    x, dists, idx = _connected()
    p = np.asarray(jax_ops.fuzzy_graph(jnp.asarray(dists), jnp.asarray(idx),
                                       len(x)))
    want = np.asarray(jax_ops.spectral_init(jnp.asarray(p), 2))
    got = ops.spectral_init(_t(p), 2).numpy()
    assert np.abs(_aligned(got, want) - want).max() <= INIT_ATOL
    assert np.abs(got).max() == pytest.approx(10.0)
    want = np.asarray(jax_ops.pca_init(jnp.asarray(x), 2))
    got = ops.pca_init(_t(x), 2).numpy()
    assert np.abs(_aligned(got, want) - want).max() <= INIT_ATOL


@pytest.mark.parametrize("epochs,bar", [(1, EPOCH1_REL), (5, EPOCH5_REL)])
def test_dense_optimizer_matches(epochs, bar):
    p = _graph_and_init()[5]
    a, b = jax_ops.fit_ab(0.1)
    emb0 = np.asarray(jax_ops.spectral_init(jnp.asarray(p), 2))
    want = jax_ops.optimize_embedding(
        jnp.asarray(p), jnp.asarray(emb0), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(1.0), jnp.asarray(REPULSION), epochs)
    got = ops.optimize_embedding(_t(p), _t(emb0), a, b, 1.0, REPULSION,
                                 epochs)
    assert _rel(got.numpy(), want) <= bar


@pytest.mark.parametrize("epochs,bar", [(1, EPOCH1_REL), (5, EPOCH5_REL)])
def test_tiled_optimizer_matches(epochs, bar):
    """JAX's needs n padded to a multiple of the block (96 → 128 at 64);
    the port takes the same padded input and mask, and the unpadded input
    with a ragged last block, to the same answer."""
    x, _, _, _, (ei, ej, ep), _, emb0 = _graph_and_init()
    a, b = jax_ops.fit_ab(0.1)
    n = len(x)
    padded, mask = pad_rows_to_multiple(emb0, 64)
    want = np.asarray(jax_ops.optimize_embedding_blocked(
        jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(ep),
        jnp.asarray(padded), jnp.asarray(mask > 0), jnp.asarray(a),
        jnp.asarray(b), jnp.asarray(1.0), jnp.asarray(REPULSION), epochs,
        64))[:n]
    got = ops.optimize_embedding_blocked(
        ei, ej, _t(ep), _t(padded), _t(mask > 0), a, b, 1.0, REPULSION,
        epochs, 64).numpy()[:n]
    assert _rel(got, want) <= bar
    ragged = ops.optimize_embedding_blocked(
        ei, ej, _t(ep), _t(emb0), None, a, b, 1.0, REPULSION, epochs,
        64).numpy()
    assert _rel(ragged, want) <= bar
    assert _rel(ragged, got) <= 1e-14


def test_segment_sum_equals_a_scatter_add():
    rng = np.random.default_rng(2)
    seg = rng.integers(0, 40, size=700)
    seg[:150] = 7                        # a segment of three levels at width 4
    vals = rng.normal(size=(700, 2))
    ss = ops.SegmentSum(seg, 45, torch.device("cpu"), width=4)
    assert len(ss.levels) == 4
    want = np.zeros((45, 2))
    np.add.at(want, seg, vals)
    np.testing.assert_allclose(ss(_t(vals)).numpy(), want, atol=1e-12)
    # up to the width, each segment sums left to right, as a scatter-add
    wide = ops.SegmentSum(seg[150:], 45, torch.device("cpu"), width=64)
    assert len(wide.levels) == 1
    seq = np.zeros((45, 2))
    for s, v in zip(seg[150:], vals[150:]):
        seq[s] = seq[s] + v
    np.testing.assert_array_equal(wide(_t(vals[150:])).numpy(), seq)
    empty = ops.SegmentSum(np.zeros(0, np.int64), 3, torch.device("cpu"))
    assert empty(torch.zeros((0, 2), dtype=torch.float64)).shape == (3, 2)


def test_duplicate_row_drops_the_column_jax_drops():
    x = _connected()[0].copy()
    x[25] = x[6]                         # row 25's self ties with row 6
    x[31] = x[6]
    jd, ji = _jax_knn(x, 8)
    d, i = knn_without_self(_t(x), _t(x), 8)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(d.numpy(), jd, atol=1e-12)
    # row 25 keeps itself (index 25) and dropped row 6, as lax.top_k orders
    assert 6 not in ji[25] and 25 in ji[25]
    got = ops.fuzzy_graph(d, i, len(x)).numpy()
    want = np.asarray(jax_ops.fuzzy_graph(jnp.asarray(jd), jnp.asarray(ji),
                                          len(x)))
    assert np.abs(got - want).max() <= GRAPH_ATOL


# -- the model ----------------------------------------------------------------

def test_transform_matches_the_jax_placement():
    rng = np.random.default_rng(5)
    items = rng.normal(size=(120, 6))
    emb = rng.normal(size=(120, 2)) * 5
    q = rng.normal(size=(37, 6))
    want = np.asarray(
        JaxUMAPModel(embedding=emb, train_items=items)
        .setNNeighbors(8).setBlockRows(16)
        .transform(JaxVectorFrame({"features": q})).column("embedding"))
    for block in (0, 16):
        got = np.asarray(
            UMAPModel(embedding=emb, train_items=items)
            .setNNeighbors(8).setBlockRows(block).setDtype("float64")
            .transform(VectorFrame({"features": q})).column("embedding"))
        assert _rel(got, want) <= TRANSFORM_REL


def test_tiled_fit_matches_jax_on_a_connected_graph():
    """The whole tiled fit at float64 through both packages, one epoch
    from the fitted state: the query-chunked kNN (48 rows a chunk, the last
    one ragged in the port and padded in JAX), the host edge list, the PCA
    init (signs aligned) and the tiled optimizer. (The dense fit's steps
    are held one by one above; JAX's dense fit costs seconds of eager
    compiles on a device-committed input.)"""
    x = _connected()[0]
    want = (JaxUMAP().setNNeighbors(8).setNEpochs(1).setBlockRows(48)
            .fit(x).embedding_)
    got = (UMAP().setNNeighbors(8).setNEpochs(1).setBlockRows(48)
           .setDtype("float64").fit(x))
    assert _rel(_aligned(got.embedding_, want), want) <= INIT_ATOL
    assert set(got.fit_timings_) == {"densify", "knn", "graph", "init",
                                     "optimize"}


def _blobs(rng, centers, per=60, scale=0.3):
    pts = [rng.normal(loc=c, scale=scale, size=(per, len(c)))
           for c in centers]
    x = np.concatenate(pts)
    y = np.repeat(np.arange(len(centers)), per)
    perm = rng.permutation(len(x))
    return x[perm], y[perm]


def _trustworthiness(x, emb, k=10):
    """tests/test_umap.py's T(k)."""
    n = len(x)
    dx = np.linalg.norm(x[:, None] - x[None, :], axis=2)
    de = np.linalg.norm(emb[:, None] - emb[None, :], axis=2)
    np.fill_diagonal(dx, np.inf)
    np.fill_diagonal(de, np.inf)
    rank_x = np.argsort(np.argsort(dx, axis=1), axis=1)
    knn_e = np.argsort(de, axis=1)[:, :k]
    penalty = sum(np.maximum(rank_x[i, knn_e[i]] - k + 1, 0).sum()
                  for i in range(n))
    return 1.0 - 2.0 / (n * k * (2 * n - 3 * k - 1)) * penalty


def _separated(emb, y, classes):
    cents = np.stack([emb[y == c].mean(0) for c in range(classes)])
    spread = max(emb[y == c].std() for c in range(classes))
    return min(np.linalg.norm(cents[i] - cents[j])
               for i in range(classes) for j in range(i + 1, classes)
               ) > 2.0 * spread


@pytest.mark.parametrize("block,dtype", [(0, "float64"), (48, "float64"),
                                         (48, "float32")])
def test_fit_preserves_cluster_structure(block, dtype):
    """tests/test_umap.py's dense and tiled structure cases, at its dtype
    (float64: 'auto' under x64) and the tiled one also at the port's
    'auto' (float32); 48 rows a block does not divide 180."""
    x, y = _blobs(np.random.default_rng(SEED),
                  [np.r_[np.eye(8)[i] * 8] for i in range(3)])
    model = (UMAP().setNNeighbors(10).setNEpochs(150).setBlockRows(block)
             .setDtype(dtype).fit(x))
    emb = model.embedding_
    assert emb.shape == (len(x), 2) and np.isfinite(emb).all()
    assert _separated(emb, y, 3)
    assert _trustworthiness(x, emb, k=10) > 0.85


def test_dense_float32_fit_keeps_neighbors():
    """The dense fit at float32. Its three blobs are three components of
    the kNN graph, so the Laplacian's eigenvalue 0 is threefold and where
    each blob starts depends on the basis the eigensolver returns for that
    null space (ROADMAP queue 3 items 22 and 23). The float32 basis
    starts two blobs close, and the separation bar (centroid gaps over
    twice the largest spread) then fails, as JAX's own dense fit fails it
    on other seeds. The neighbor bar holds."""
    x, y = _blobs(np.random.default_rng(SEED),
                  [np.r_[np.eye(8)[i] * 8] for i in range(3)])
    emb = UMAP().setNNeighbors(10).setNEpochs(150).fit(x).embedding_
    assert emb.shape == (len(x), 2) and np.isfinite(emb).all()
    assert _trustworthiness(x, emb, k=10) > 0.85


def test_auto_threshold_takes_the_tiled_path():
    x, y = _blobs(np.random.default_rng(SEED),
                  [np.r_[np.eye(6)[i] * 9] for i in range(2)], per=40)
    est = UMAP().setNNeighbors(8).setNEpochs(80)
    est._DENSE_MAX_ROWS = 50
    emb = est.fit(x).embedding_
    assert np.isfinite(emb).all() and emb.shape == (80, 2)
    assert _separated(emb, y, 2)


def test_transform_places_new_points_near_their_cluster():
    x, y = _blobs(np.random.default_rng(SEED), [(0.0,) * 6, (8.0,) * 6],
                  per=50)
    model = UMAP().setNNeighbors(8).setNEpochs(100).fit(x)
    emb = model.embedding_
    q = np.stack([np.full(6, 0.1), np.full(6, 7.9)])
    placed = np.asarray(model.transform(VectorFrame({"features": q}))
                        .column("embedding"))
    c0, c1 = emb[y == 0].mean(0), emb[y == 1].mean(0)
    assert np.linalg.norm(placed[0] - c0) < np.linalg.norm(placed[0] - c1)
    assert np.linalg.norm(placed[1] - c1) < np.linalg.norm(placed[1] - c0)


def test_validation_divergence_and_params(monkeypatch):
    x = np.random.default_rng(0).normal(size=(10, 4))
    with pytest.raises(ValueError, match="nNeighbors"):
        UMAP().setNNeighbors(15).fit(x)
    model = UMAP().setNNeighbors(5).setNEpochs(20).fit(x)
    with pytest.raises(ValueError, match="dim"):
        model.transform(VectorFrame({"features": np.zeros((2, 7))}))
    with pytest.raises(ValueError, match="fit first"):
        UMAPModel().transform(VectorFrame({"features": np.zeros((2, 4))}))
    # a non-finite row never gives an embedding: the eigensolver refuses
    # it (JAX's answers NaN, which the divergence check then refuses)
    bad = x.copy()
    bad[3, 1] = np.nan
    for block in (0, 4):
        with pytest.raises((FloatingPointError, torch.linalg.LinAlgError)):
            UMAP().setNNeighbors(3).setNEpochs(2).setBlockRows(block).fit(bad)
    monkeypatch.setattr(ops, "optimize_embedding",
                        lambda p, emb0, *args: emb0 * float("nan"))
    with pytest.raises(FloatingPointError, match="diverged"):
        UMAP().setNNeighbors(3).setNEpochs(2).fit(x)
    # every param, default and validator as the JAX package's
    port, jax = UMAP(), JaxUMAP()
    names = sorted(port.params())
    assert names == sorted(jax.params())
    for name in names:
        assert port.get_or_default(name) == jax.get_or_default(name), name
    cases = {"nNeighbors": (1, 2.0, 2), "nComponents": (0, 1),
             "minDist": (3.0, -0.1, 0.0), "nEpochs": (0, 1),
             "learningRate": (0.0, 1e-3), "repulsionStrength": (-1.0, 0.0),
             "dtype": ("bfloat16", "float64"), "blockRows": (-1, 0)}
    for name, values in cases.items():
        for value in values:
            outcomes = []
            for est in (UMAP(), JaxUMAP()):
                try:
                    est.set(name, value)
                    outcomes.append(True)
                except (ValueError, TypeError):
                    outcomes.append(False)
            assert outcomes[0] == outcomes[1], (name, value)


def test_estimator_save_load_roundtrip(tmp_path):
    est = (UMAP().setNNeighbors(7).setNComponents(3).setMinDist(0.25)
           .setNEpochs(33).setLearningRate(0.5).setRepulsionStrength(2.0)
           .setBlockRows(64).setDtype("float64"))
    est.save(str(tmp_path / "u"))
    loaded = UMAP.load(str(tmp_path / "u"))
    for name in est.params():
        assert loaded.get_or_default(name) == est.get_or_default(name)
    # the JAX package reads the port's params, and the port the JAX's
    assert JaxUMAP.load(str(tmp_path / "u")).getNEpochs() == 33
    JaxUMAP().setNNeighbors(9).save(str(tmp_path / "j"))
    assert UMAP.load(str(tmp_path / "j")).getNNeighbors() == 9
