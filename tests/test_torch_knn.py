"""NearestNeighbors in the port against the JAX package's, on the same numpy
inputs.

The operations of ``ops/knn_kernel.py`` one by one, then the model: every
case of ``tests/test_nearest_neighbors.py`` through both packages. The JAX
suite runs with x64 (tests/conftest.py), so its 'auto' dtype is float64;
the port's is float32, so every comparison names its dtype.

Bars:

* float64: squared distances within 1e-12 relative of the JAX package's
  (compared squared: the square root magnifies a self match's rounding
  residue), indices equal (the tie order of ``lax.top_k`` is the port's,
  so equal values give equal indices too);
* float32: the port's float32 distances are float64 ones rounded once, so
  they are held to the JAX function at float64 on the same float32 inputs
  (the JAX package's float32 expanded form carries its own cancellation,
  ~ε·|x|² in d², which on the clustered data here is 1.4e-5 relative):
  squared distances within 1e-5 relative, indices equal outside ties;
* the IVF searches are fed the SAME index arrays (the JAX model's index,
  passed as numpy): k-means++ draws from a ``torch.Generator`` in the
  port, so each package's own index differs; on the port's own index the
  JAX tests' contracts hold (recall floors, exactness at nprobe = nlist,
  uint8 codes, the pool guards).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
import spark_rapids_ml_tpu.ops.knn_kernel as jax_ops
from spark_rapids_ml_tpu import NearestNeighbors as JaxNN
from spark_rapids_ml_tpu import NearestNeighborsModel as JaxNNModel
from spark_rapids_ml_tpu_torch import NearestNeighbors, NearestNeighborsModel
from spark_rapids_ml_tpu_torch.models import nearest_neighbors as nn_mod
from spark_rapids_ml_tpu_torch.ops import knn_kernel as ops

F64_REL = 1e-12
F32_REL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _oracle(queries, items, k):
    d2 = (
        (queries * queries).sum(1, keepdims=True)
        - 2.0 * queries @ items.T
        + (items * items).sum(1)[None, :]
    )
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.sqrt(np.maximum(np.take_along_axis(d2, order, 1), 0.0)), order


def _check_against_oracle(dist_, idx, queries, items, k, atol=1e-4):
    od, _ = _oracle(queries, items, k)
    np.testing.assert_allclose(dist_, od, atol=atol)
    d_of_idx = np.linalg.norm(queries[:, None, :] - items[idx], axis=2)
    np.testing.assert_allclose(d_of_idx, od, atol=atol)


def _clustered(rng, n_centers=8, per=80, dim=16, scale=10):
    centers = rng.normal(scale=scale, size=(n_centers, dim))
    return np.concatenate(
        [rng.normal(loc=c, size=(per, dim)) for c in centers]
    ).astype(np.float32)


def _recall(ai, ei, k):
    return np.mean([len(set(ai[i]) & set(ei[i])) / k
                    for i in range(len(ai))])


def _rel_d(got, want):
    """``_rel`` of squared distances: the square root magnifies a self
    match's rounding residue (~1e-13 in d²) past any relative bar."""
    return _rel(np.square(got), np.square(want))


def _f64(*arrays):
    """The same inputs, exactly, as float64 JAX arrays."""
    return [jnp.asarray(np.asarray(a, dtype=np.float64)) for a in arrays]


def _held(got_d, got_i, want_d, want_i, dtype):
    """The bars of the module docstring for ``dtype``."""
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    if dtype == np.float64:
        assert _rel_d(got_d, want_d) <= F64_REL
        np.testing.assert_array_equal(got_i, want_i)
    else:
        assert _rel_d(got_d, want_d) <= F32_REL
        _indices_equal_outside_ties(got_i, want_i, want_d)


def _indices_equal_outside_ties(got_i, want_i, want_d, rel=1e-6):
    """Row by row: equal, or every differing place sits in a run of
    reference distances tied within ``rel``."""
    for g, w, d in zip(got_i, want_i, want_d):
        if np.array_equal(g, w):
            continue
        assert set(g) == set(w) or np.isclose(d[-1], d[-2], rtol=rel), (g, w)
        for j in np.nonzero(g != w)[0]:
            near = np.isclose(d, d[j], rtol=rel, atol=0)
            assert near.sum() > 1, (g, w, d)


# -- the operations --------------------------------------------------------


def test_pairwise_sqdist_matches_jax_at_float64(rng):
    q = rng.normal(size=(9, 7))
    x = rng.normal(size=(31, 7))
    mask = (rng.uniform(size=31) > 0.3).astype(np.float64)
    for m in (None, mask):
        ours = ops.pairwise_sqdist(_t(q), _t(x),
                                   None if m is None else _t(m)).numpy()
        theirs = np.asarray(jax_ops.pairwise_sqdist(
            jnp.asarray(q), jnp.asarray(x),
            None if m is None else jnp.asarray(m)))
        np.testing.assert_array_equal(np.isinf(ours), np.isinf(theirs))
        fin = np.isfinite(theirs)
        assert _rel(ours[fin], theirs[fin]) <= F64_REL


def test_float32_distances_are_rounded_float64_whatever_the_chunk(rng):
    """The TF32-proof cross term: float32 distances are the float64 ones
    rounded once, equal bit for bit under any matmul-precision setting and
    in any chunking of the queries."""
    q = rng.normal(loc=3.0, size=(40, 24)).astype(np.float32)
    x = rng.normal(loc=3.0, size=(300, 24)).astype(np.float32)
    want = ops.pairwise_sqdist(_t(q), _t(x)).to(torch.float32)
    saved = torch.get_float32_matmul_precision()
    try:
        for setting in ("highest", "high", "medium"):
            torch.set_float32_matmul_precision(setting)
            whole = ops.pairwise_sqdist(_t(q, torch.float32),
                                        _t(x, torch.float32))
            assert whole.dtype == torch.float32
            assert torch.equal(whole, want), setting
            parts = torch.cat([ops.pairwise_sqdist(_t(c, torch.float32),
                                                   _t(x, torch.float32))
                               for c in np.array_split(q, [1, 7, 30])])
            assert torch.equal(parts, want), setting
    finally:
        torch.set_float32_matmul_precision(saved)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_knn_kernel_matches_jax(rng, dtype):
    q = rng.normal(size=(23, 12)).astype(dtype)
    x = rng.normal(size=(150, 12)).astype(dtype)
    mask = np.ones(150, dtype=dtype)
    mask[140:] = 0.0
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    d, i = ops.knn_kernel(_t(q, tdt), _t(x, tdt), 6, _t(mask, tdt))
    jq, jx, jmask = _f64(q, x, mask)
    jd, ji = jax_ops.knn_kernel(jq, jx, 6, item_mask=jmask)
    assert d.dtype == tdt and i.dtype == torch.int64
    assert int(i.max()) < 140
    _held(d.numpy(), i.numpy(), jd, ji, dtype)


def test_ties_keep_the_lower_index_first_as_lax_top_k(rng):
    """Duplicated items give exactly tied distances: both packages order
    them by index, and keep the lower indices where a tie straddles the
    k-th place."""
    base = rng.normal(size=(20, 5))
    x = np.concatenate([base, base, base[:7]])          # 47 rows, 3 copies
    q = np.concatenate([base[:6] + 0.01, rng.normal(size=(4, 5))])
    for k in (1, 2, 3, 4, 5):
        d, i = ops.knn_kernel(_t(q), _t(x), k)
        jd, ji = jax_ops.knn_kernel(jnp.asarray(q), jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        assert _rel_d(d.numpy(), jd) <= F64_REL
    # the first rows' nearest is their own triple: indices r, r + 20, r + 40
    _, i = ops.knn_kernel(_t(q), _t(x), 2)
    np.testing.assert_array_equal(i.numpy()[:6, :2],
                                  np.stack([np.arange(6),
                                            np.arange(6) + 20], 1))


def test_smallest_k_equals_a_stable_sort_on_ties():
    d2 = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0, float("inf"), 0.0],
                       [5.0, 5.0, 5.0, 5.0, 5.0, 5.0, 5.0],
                       [float("inf")] * 7])
    for k in range(1, 8):
        vals, pos = ops._smallest_k(d2, k)
        want_v, want_p = torch.sort(d2, dim=1, stable=True)
        assert torch.equal(pos, want_p[:, :k]), k
        assert torch.equal(vals, want_v[:, :k]), k


def test_knn_merge_matches_jax(rng):
    d = rng.integers(0, 6, size=(11, 24)).astype(np.float64)  # many ties
    idx = rng.permutation(11 * 24).reshape(11, 24)
    for k in (1, 5, 24):
        vd, vi = ops.knn_merge(_t(d), torch.as_tensor(idx), k)
        jd, ji = jax_ops.knn_merge(jnp.asarray(d), jnp.asarray(idx), k)
        np.testing.assert_array_equal(vd.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(vi.numpy(), np.asarray(ji))


def test_exact_rerank_matches_jax(rng):
    x = rng.normal(size=(60, 8))
    q = rng.normal(size=(7, 8))
    cand = rng.integers(0, 60, size=(7, 12))
    cand[:, -3:] = -1                                       # padding slots
    vd, vi = ops.exact_rerank(_t(q), _t(x), torch.as_tensor(cand), 5)
    jd, ji = jax_ops.exact_rerank(jnp.asarray(q), jnp.asarray(x),
                                  jnp.asarray(cand), 5)
    assert _rel_d(vd.numpy(), jd) <= F64_REL
    np.testing.assert_array_equal(vi.numpy(), np.asarray(ji))
    assert (vi.numpy() >= 0).all()


def _jax_ivf_arrays(items, algorithm, **params):
    """The JAX model's own index for ``items`` at float64, as numpy."""
    model = JaxNN().setK(5).setAlgorithm(algorithm)
    for name, value in params.items():
        model.set(name, value)
    model = model.fit(items)
    dev = jax.devices()[0]
    if algorithm == "ivfflat":
        index = model._ivf_index(dev, jnp.float64)
    else:
        index = model._ivfpq_index(dev, jnp.float64)
    return [np.asarray(a) for a in index[:-1]] + [index[-1]]


@pytest.mark.parametrize("nprobe", [1, 3, 8])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ivf_search_on_shared_index_arrays_matches_jax(rng, nprobe, dtype):
    items = _clustered(rng).astype(np.float64)
    q = items[rng.choice(len(items), 25, replace=False)] + 0.1
    cent, b_items, b_ids, b_mask, nlist = _jax_ivf_arrays(items, "ivfflat",
                                                          nlist=8)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    vd, vi = ops.ivf_search(_t(q, tdt), _t(cent, tdt), _t(b_items, tdt),
                            torch.tensor(b_ids), _t(b_mask, tdt), 10,
                            nprobe)
    q, cent, b_items = (a.astype(dtype) for a in (q, cent, b_items))
    jd, ji = jax_ops.ivf_search(*_f64(q, cent, b_items), jnp.asarray(b_ids),
                                jnp.asarray(b_mask), 10, nprobe)
    _held(vd.numpy(), vi.numpy(), jd, ji, dtype)


@pytest.mark.parametrize("nprobe", [1, 4])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ivfpq_search_on_shared_index_arrays_matches_jax(rng, nprobe, dtype):
    items = _clustered(rng).astype(np.float64)
    q = items[rng.choice(len(items), 25, replace=False)] + 0.1
    cent, books, codes, b_ids, b_mask, nlist = _jax_ivf_arrays(
        items, "ivfpq", nlist=8, pqM=4, pqBits=5)
    assert codes.dtype == np.uint8
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    vd, vi = ops.ivfpq_search(_t(q, tdt), _t(cent, tdt), _t(books, tdt),
                              torch.tensor(codes), torch.tensor(b_ids),
                              _t(b_mask, tdt), 10, nprobe)
    q, cent, books = (a.astype(dtype) for a in (q, cent, books))
    jd, ji = jax_ops.ivfpq_search(*_f64(q, cent, books), jnp.asarray(codes),
                                  jnp.asarray(b_ids), jnp.asarray(b_mask),
                                  10, nprobe)
    _held(vd.numpy(), vi.numpy(), jd, ji, dtype)


def test_bucket_layout_resolve_pq_m_and_pool_guards_equal_jax(rng):
    assign = rng.integers(0, 9, size=500)
    ours = NearestNeighborsModel._bucket_layout(assign, 11)
    theirs = JaxNNModel._bucket_layout(assign, 11)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    m, jm = NearestNeighborsModel(items=None), JaxNNModel(items=None)
    for dim in (4, 6, 7, 10, 12, 16, 64, 128, 784, 96):
        assert m._resolve_pq_m(dim) == jm._resolve_pq_m(dim)
    for algorithm, k, nprobe, max_size in (("ivfflat", 5, 2, 8),
                                           ("ivfpq", 40, 16, 3),
                                           ("ivfflat", 4, 64, 900)):
        assert m._ivf_pool_check_and_step(algorithm, k, nprobe, max_size) \
            == jm._ivf_pool_check_and_step(algorithm, k, nprobe, max_size)
    for obj in (m, jm):
        with pytest.raises(ValueError, match="candidate pool"):
            obj._ivf_pool_check_and_step("ivfpq", 40, 1, 4)


def test_params_and_defaults_equal_jax():
    ours, theirs = NearestNeighbors(), JaxNN()
    assert ours.param_map_for_metadata() == theirs.param_map_for_metadata()
    for name, bad in (("k", 0), ("algorithm", "hnsw"), ("nlist", -1),
                      ("nprobe", 0), ("pqM", -1), ("pqBits", 9),
                      ("refineRatio", 0.5), ("useXlaDot", 1),
                      ("dtype", "float16")):
        for obj in (ours, theirs):
            with pytest.raises((ValueError, TypeError)):
                obj.set(name, bad)


# -- the cases of tests/test_nearest_neighbors.py, through both packages --


def test_kneighbors_matches_oracle(rng):
    items = rng.normal(size=(500, 24))
    queries = rng.normal(size=(37, 24))
    model = NearestNeighbors().setK(7).fit(items)
    dist_, idx = model.kneighbors(queries)
    assert dist_.shape == (37, 7) and idx.shape == (37, 7)
    _check_against_oracle(dist_, idx, queries, items, 7)
    # float64 through both packages: equal
    d64, i64 = model.setDtype("float64").kneighbors(queries)
    jd, ji = JaxNN().setK(7).fit(items).kneighbors(queries)
    assert _rel_d(d64, jd) <= F64_REL
    np.testing.assert_array_equal(i64, ji)


def test_kneighbors_crosses_query_bucket_boundary(rng):
    items = rng.normal(size=(64, 8))
    queries = rng.normal(size=(nn_mod._QUERY_BUCKET + 13, 8))
    model = NearestNeighbors().setK(3).fit(items)
    dist_, idx = model.kneighbors(queries)
    assert dist_.shape == (nn_mod._QUERY_BUCKET + 13, 3)
    _check_against_oracle(dist_, idx, queries, items, 3)
    jd, ji = JaxNN().setK(3).fit(items.astype(np.float32)).kneighbors(
        queries.astype(np.float32))
    _held(dist_, idx, jd, ji, np.float32)


def test_brute_chunks_bound_the_distance_block(monkeypatch, rng):
    """Past ``DIST_BLOCK_BYTES`` a chunk holds fewer queries; the answer
    does not depend on the chunking."""
    items = rng.normal(size=(200, 6)).astype(np.float32)
    queries = rng.normal(size=(50, 6)).astype(np.float32)
    model = NearestNeighbors().setK(4).fit(items)
    want = model.kneighbors(queries)
    steps = []
    real = NearestNeighborsModel._stream_queries

    def spy(self, q, k, step, *args):
        steps.append(step)
        return real(self, q, k, step, *args)

    monkeypatch.setattr(NearestNeighborsModel, "_stream_queries", spy)
    monkeypatch.setattr(ops, "DIST_BLOCK_BYTES", 8 * 200 * 7)
    got = model.kneighbors(queries)
    assert steps == [7]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_host_and_device_paths_agree(rng):
    items = rng.normal(size=(200, 16))
    queries = rng.normal(size=(29, 16))
    m_dev = NearestNeighbors().setK(5).fit(items)
    m_host = NearestNeighbors().setK(5).setUseXlaDot(False).fit(items)
    d1, _ = m_dev.kneighbors(queries)
    d2, i2 = m_host.kneighbors(queries)
    np.testing.assert_allclose(d1, d2, atol=1e-4)
    jd, ji = JaxNN().setK(5).setUseXlaDot(False).fit(items).kneighbors(
        queries)
    np.testing.assert_array_equal(d2, jd)
    np.testing.assert_array_equal(i2, ji)


def test_k_override_and_validation(rng):
    items = rng.normal(size=(10, 4))
    model = NearestNeighbors().setK(3).fit(items)
    d, i = model.kneighbors(items, k=1)
    assert d.shape == (10, 1)
    np.testing.assert_allclose(d[:, 0], 0.0, atol=1e-5)
    np.testing.assert_array_equal(i[:, 0], np.arange(10))
    with pytest.raises(ValueError, match="k ="):
        model.kneighbors(items, k=11)
    with pytest.raises(ValueError, match="k ="):
        NearestNeighbors().setK(11).fit(items)
    with pytest.raises(ValueError, match="dim"):
        model.kneighbors(np.zeros((2, 5)))
    with pytest.raises(ValueError, match="k ="):
        JaxNN().setK(11).fit(items)


def test_persistence_roundtrip_and_cross_loading(rng, tmp_path):
    items = rng.normal(size=(50, 6))
    model = NearestNeighbors().setK(4).setAlgorithm("ivfflat").fit(items)
    path = str(tmp_path / "knn")
    model.save(path)
    loaded = NearestNeighborsModel.load(path)
    assert loaded.getK() == 4 and loaded.getAlgorithm() == "ivfflat"
    assert loaded.uid == model.uid
    d1, i1 = model.kneighbors(items[:5])
    d2, i2 = loaded.kneighbors(items[:5])
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(i1, i2)
    # port-written loads in JAX, JAX-written in the port
    jax_loaded = JaxNNModel.load(path)
    np.testing.assert_array_equal(jax_loaded.items, model.items)
    assert jax_loaded.getAlgorithm() == "ivfflat"
    jpath = str(tmp_path / "jax_knn")
    JaxNN().setK(3).fit(items).save(jpath)
    back = NearestNeighborsModel.load(jpath)
    np.testing.assert_array_equal(back.items, items)
    assert back.getK() == 3


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    from spark_rapids_ml_tpu_torch.parallel import data_mesh

    mp = pytest.MonkeyPatch()
    mp.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    assert not dist.is_initialized()
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=0, world_size=1)
    try:
        yield data_mesh(1)
    finally:
        dist.destroy_process_group()
        mp.undo()


@pytest.mark.parametrize("n_items,k", [(203, 6), (9, 6)])
def test_distributed_matches_single_device(rng, one_rank_mesh, n_items, k):
    """The two distributed cases (203 rows, uneven; 9 rows, k = 6) on a
    one-rank gloo world; tests/test_torch_parallel_knn.py runs 2 and 4
    ranks. Equal to the JAX function on a one-device mesh at float64."""
    from spark_rapids_ml_tpu.parallel import data_mesh as jax_mesh
    from spark_rapids_ml_tpu.parallel import (
        distributed_kneighbors as jax_dkn,
    )
    from spark_rapids_ml_tpu_torch.parallel import distributed_kneighbors

    items = rng.normal(size=(n_items, 12)).astype(np.float32)
    queries = rng.normal(size=(17, 12)).astype(np.float32)
    d, i = distributed_kneighbors(queries, items, k, one_rank_mesh)
    assert d.shape == (17, k) and int(i.max()) < n_items
    _check_against_oracle(d, i, queries.astype(np.float64),
                          items.astype(np.float64), k, atol=1e-3)
    d64, i64 = distributed_kneighbors(queries, items, k, one_rank_mesh,
                                      dtype=np.float64)
    jd, ji = jax_dkn(queries, items, k, jax_mesh(1), dtype=jnp.float64)
    assert _rel_d(d64, jd) <= F64_REL
    np.testing.assert_array_equal(i64, ji)


def test_ivfflat_high_recall_and_exact_at_full_probe(rng):
    items = _clustered(rng)
    queries = items[rng.choice(len(items), 40, replace=False)]
    exact = NearestNeighbors().setK(10).fit(items)
    ed, ei = exact.kneighbors(queries)
    approx = (NearestNeighbors().setK(10).setAlgorithm("ivfflat")
              .setNlist(8).setNprobe(2).fit(items))
    _, ai = approx.kneighbors(queries)
    assert _recall(ai, ei, 10) > 0.9
    full = (NearestNeighbors().setK(10).setAlgorithm("ivfflat")
            .setNlist(8).setNprobe(8).fit(items))
    fd, fi = full.kneighbors(queries)
    np.testing.assert_allclose(fd, ed, atol=1e-3)
    # exact at full probe: the same float32 distances as brute, so the
    # same indices outside exact ties
    assert _rel_d(fd, ed) <= F32_REL
    _indices_equal_outside_ties(fi, ei, ed)


def test_ivfflat_defaults_and_small_corpus(rng):
    items = rng.normal(size=(30, 4)).astype(np.float32)
    m = NearestNeighbors().setK(3).setAlgorithm("ivfflat").fit(items)
    d, i = m.kneighbors(items[:5])
    assert d.shape == (5, 3)
    np.testing.assert_array_equal(i[:, 0], np.arange(5))
    assert m._resolve_nlist() == JaxNN().setAlgorithm("ivfflat").fit(
        items).setK(3)._resolve_nlist() == 5


def test_ivfpq_recall_on_clustered_data(rng):
    items = _clustered(rng)
    queries = items[rng.choice(len(items), 40, replace=False)]
    _, ei = NearestNeighbors().setK(10).fit(items).kneighbors(queries)

    def recall(nprobe):
        m = (NearestNeighbors().setK(10).setAlgorithm("ivfpq").setNlist(8)
             .setNprobe(nprobe).setPqM(8).setPqBits(6).fit(items))
        d, ai = m.kneighbors(queries)
        assert d.shape == (40, 10) and (ai >= 0).all()
        assert np.all(np.diff(d, axis=1) >= -1e-6)
        return _recall(ai, ei, 10)

    r_full, r_two = recall(8), recall(2)
    assert r_full > 0.7, r_full
    assert r_two > 0.5, r_two
    assert r_full >= r_two - 0.05


def test_ivfpq_auto_pq_m_and_defaults(rng):
    items = rng.normal(size=(60, 12)).astype(np.float32)
    m = NearestNeighbors().setK(5).setAlgorithm("ivfpq").fit(items)
    d, i = m.kneighbors(items[:7])
    assert d.shape == (7, 5) and i.shape == (7, 5)
    assert (i >= 0).all() and (i < 60).all()


def test_ivfpq_auto_pq_m_prefers_wide_subspaces():
    m = NearestNeighborsModel(items=None)
    assert m._resolve_pq_m(64) == 16
    assert m._resolve_pq_m(784) == 196
    assert m._resolve_pq_m(12) == 3
    assert m._resolve_pq_m(10) == 2
    assert m._resolve_pq_m(6) == 3
    assert m._resolve_pq_m(7) == 1


def test_ivfpq_codes_stored_uint8_and_resident_at_n_times_m(rng):
    items = rng.normal(size=(80, 8)).astype(np.float32)
    m = (NearestNeighbors().setK(3).setAlgorithm("ivfpq")
         .setNlist(4).setPqBits(6).fit(items))
    m.kneighbors(items[:2])
    _, books, b_codes, b_ids, _, nlist = m._ivfpq_index_cache[1]
    assert b_codes.dtype == torch.uint8
    m_sub = books.shape[0]
    assert b_codes.shape == (m_sub, nlist, b_ids.shape[1])
    # the real codes are n·M bytes; the rest is the padded layout
    assert int((m._ivfpq_index_cache[1][4] > 0).sum()) * m_sub == 80 * m_sub
    assert b_codes.element_size() == 1


def test_ivfpq_compact_codes_recall_floor_with_rerank(rng):
    centers = rng.normal(scale=6, size=(16, 64))
    items = np.concatenate(
        [rng.normal(loc=c, size=(256, 64)) for c in centers]
    ).astype(np.float32)
    queries = items[rng.choice(len(items), 50, replace=False)]
    _, ei = NearestNeighbors().setK(10).fit(items).kneighbors(queries)
    model = (NearestNeighbors().setK(10).setAlgorithm("ivfpq")
             .setNlist(16).setNprobe(4).setPqM(16).setPqBits(8).fit(items))

    def recall(refine_ratio):
        _, ai = model.setRefineRatio(refine_ratio).kneighbors(queries)
        return _recall(ai, ei, 10)

    r_rerank = recall(4.0)
    assert r_rerank >= 0.8, r_rerank
    assert r_rerank >= recall(0) - 1e-9


def test_ivfpq_pq_m_must_divide_dim(rng):
    items = rng.normal(size=(40, 16)).astype(np.float32)
    m = (NearestNeighbors().setK(3).setAlgorithm("ivfpq").setPqM(5)
         .fit(items))
    with pytest.raises(ValueError, match="must divide"):
        m.kneighbors(items[:2])


@pytest.mark.parametrize("algorithm", ["ivfpq", "ivfflat"])
def test_k_exceeding_candidate_pool_rejected(rng, algorithm):
    items = rng.normal(scale=5, size=(64, 4)).astype(np.float32)
    m = (NearestNeighbors().setK(40).setAlgorithm(algorithm).setNlist(16)
         .setNprobe(1).fit(items))
    with pytest.raises(ValueError, match="candidate pool"):
        m.kneighbors(items[:3])
