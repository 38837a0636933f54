"""DBSCAN in the port against the JAX package's, on the same numpy inputs.

The operations of ``ops/dbscan_kernel.py``, every case of
``tests/test_dbscan.py`` and of ``tests/test_distributed_dbscan.py``
through both packages (the distributed ones on a one-rank gloo world here;
tests/test_torch_parallel_knn.py runs 2 and 4 ranks).

Bars: labels and core masks EQUAL, never close. Labels are exact only
where no pair lies within rounding of ε, since float32 and float64 compare
d² ≤ ε² differently: float64 runs (the port's dtype named; the JAX suite's
'auto' is float64 under x64) must equal the JAX package's on any data.
The JAX files' cases keep their own bars at the port's float32 'auto' too
(no pair of their seeded blobs lies within float32 rounding of ε); beyond
them, float32 is held to float64 and to the JAX package's float32 on
lattice blobs, whose coordinates are multiples of 1/4, so every d² is a
multiple of 1/16, exact in float32, and ε² lies 1/32 away from every
level.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp
import spark_rapids_ml_tpu.ops.dbscan_kernel as jax_ops
from spark_rapids_ml_tpu import DBSCAN as JaxDBSCAN
from spark_rapids_ml_tpu.models.dbscan import _host_dbscan as jax_host
from spark_rapids_ml_tpu_torch import DBSCAN
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
from spark_rapids_ml_tpu_torch.models.dbscan import (
    _host_dbscan,
    _relabel_consecutive,
)
from spark_rapids_ml_tpu_torch.ops import dbscan_kernel as ops


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def _blobs(rng, centers=((0, 0), (10, 10), (20, 0)), per=60, noise=8):
    pts = [rng.normal(loc=c, scale=0.5, size=(per, 2)) for c in centers]
    pts.append(rng.uniform(-5, 25, size=(noise, 2)) + 100.0)
    x = np.concatenate(pts)
    return x[rng.permutation(len(x))]


def _lattice_blobs(rng, n_blobs=4, per=50, dim=3, noise=6):
    """Blobs on the 1/4 lattice: every d² is a multiple of 1/16."""
    centers = np.round(rng.normal(scale=6.0, size=(n_blobs, dim)))
    pts = [c + np.round(4 * rng.normal(scale=0.7, size=(per, dim))) / 4
           for c in centers]
    pts.append(np.round(4 * rng.uniform(-30, 30, size=(noise, dim))) / 4)
    x = np.concatenate(pts)
    return x[rng.permutation(len(x))]


LATTICE_EPS = float(np.sqrt(1.0 + 1 / 32))   # ε² between 1 and 1 + 1/16


def _jax_fit(x, eps, min_pts, **params):
    est = JaxDBSCAN().setEps(eps).setMinPts(min_pts)
    for name, value in params.items():
        est.set(name, value)
    return est.fit(x)


def _same(a, b):
    np.testing.assert_array_equal(a.labels_, b.labels_)
    np.testing.assert_array_equal(a.core_mask_, b.core_mask_)


# -- the operations --------------------------------------------------------


def test_dense_and_blocked_ops_equal_jax_at_float64(rng):
    x = _blobs(rng, per=40, noise=5)
    labels, core = ops.dbscan_labels(torch.as_tensor(x), 1.5, 5)
    jl, jc = jax_ops.dbscan_labels(jnp.asarray(x), jnp.asarray(1.5), 5)
    assert labels.dtype == torch.int32 and core.dtype == torch.bool
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(core.numpy(), np.asarray(jc))
    n = x.shape[0]
    pad = (-n) % 32
    xp = np.concatenate([x, np.zeros((pad, 2))])
    valid = np.arange(n + pad) < n
    bl, bc = ops.dbscan_labels_blocked(torch.as_tensor(xp),
                                       torch.as_tensor(valid), 1.5, 5, 32)
    jbl, jbc = jax_ops.dbscan_labels_blocked(
        jnp.asarray(xp), jnp.asarray(valid), jnp.asarray(1.5), 5, 32)
    np.testing.assert_array_equal(bl.numpy(), np.asarray(jbl))
    np.testing.assert_array_equal(bc.numpy(), np.asarray(jbc))
    np.testing.assert_array_equal(bl.numpy()[:n], labels.numpy())
    assert (bl.numpy()[n:] == -1).all() and not bc.numpy()[n:].any()


def test_float32_ops_equal_jax_and_float64_on_lattice_blobs(rng):
    x = _lattice_blobs(rng)
    want_l, want_c = jax_host(x, LATTICE_EPS, 4)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.float64, jnp.float64)):
        labels, core = ops.dbscan_labels(torch.as_tensor(x, dtype=dtype),
                                         LATTICE_EPS, 4)
        jl, jc = jax_ops.dbscan_labels(jnp.asarray(x, dtype=jdtype),
                                       jnp.asarray(LATTICE_EPS, jdtype), 4)
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(core.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(labels.numpy(), want_l)
        np.testing.assert_array_equal(core.numpy(), want_c)


def test_blocked_rows_must_divide():
    with pytest.raises(ValueError, match="multiple"):
        ops.dbscan_labels_blocked(torch.zeros((10, 2)), torch.ones(10), 1.0,
                                  2, 4)


def test_params_and_defaults_equal_jax():
    ours, theirs = DBSCAN(), JaxDBSCAN()
    assert ours.param_map_for_metadata() == theirs.param_map_for_metadata()
    assert DBSCAN._DENSE_MAX_ROWS == JaxDBSCAN._DENSE_MAX_ROWS
    for name, bad in (("eps", 0.0), ("minPts", 0), ("useXlaDot", "yes"),
                      ("dtype", "half"), ("blockRows", -1)):
        for obj in (ours, theirs):
            with pytest.raises((ValueError, TypeError)):
                obj.set(name, bad)


def test_persistence_of_the_estimator_crosses_packages(tmp_path):
    from spark_rapids_ml_tpu_torch.io.persistence import load_model

    path = str(tmp_path / "dbscan")
    DBSCAN().setEps(0.7).setMinPts(9).setBlockRows(64).save(path)
    for loaded in (DBSCAN.load(path), JaxDBSCAN.load(path), load_model(path)):
        assert (loaded.getEps(), loaded.getMinPts(), loaded.getBlockRows()) \
            == (0.7, 9, 64)
    assert isinstance(load_model(path), DBSCAN)
    jpath = str(tmp_path / "jax_dbscan")
    JaxDBSCAN().setEps(0.3).save(jpath)
    assert DBSCAN.load(jpath).getEps() == 0.3


# -- the cases of tests/test_dbscan.py, through both packages --------------


def test_dbscan_finds_blobs_and_noise(rng):
    x = _blobs(rng)
    model = DBSCAN().setEps(1.5).setMinPts(5).fit(x)
    assert model.n_clusters_ == 3
    assert (model.labels_ == -1).sum() >= 4
    host_labels, host_core = _host_dbscan(x, 1.5, 5)
    np.testing.assert_array_equal(model.labels_,
                                  _relabel_consecutive(host_labels))
    np.testing.assert_array_equal(model.core_mask_, host_core)
    _same(DBSCAN().setEps(1.5).setMinPts(5).setDtype("float64").fit(x),
          _jax_fit(x, 1.5, 5))


def test_dbscan_device_matches_host_path(rng):
    x = _blobs(rng, centers=((0, 0), (6, 6)), per=40, noise=5)
    m_dev = DBSCAN().setEps(1.2).setMinPts(4).fit(x)
    m_host = DBSCAN().setEps(1.2).setMinPts(4).setUseXlaDot(False).fit(x)
    _same(m_dev, m_host)
    _same(m_host, _jax_fit(x, 1.2, 4, useXlaDot=False))


def test_dbscan_matches_sklearn_structure(rng):
    from sklearn.cluster import DBSCAN as SkDBSCAN

    x = _blobs(rng)
    ours = DBSCAN().setEps(1.5).setMinPts(5).fit(x)
    sk = SkDBSCAN(eps=1.5, min_samples=5).fit(x)
    core_sk = np.zeros(len(x), dtype=bool)
    core_sk[sk.core_sample_indices_] = True
    np.testing.assert_array_equal(ours.core_mask_, core_sk)
    ours_core, sk_core = ours.labels_[core_sk], sk.labels_[core_sk]
    for a in np.unique(ours_core):
        assert len(np.unique(sk_core[ours_core == a])) == 1
    for b in np.unique(sk_core):
        assert len(np.unique(ours_core[sk_core == b])) == 1
    assert ((ours.labels_ == -1) == (sk.labels_ == -1)).mean() > 0.95
    _same(ours, _jax_fit(x, 1.5, 5))


def test_dbscan_transform_and_validation(rng):
    x = _blobs(rng, per=30, noise=3)
    model = DBSCAN().setEps(1.5).setMinPts(5).fit(x)
    out = model.transform(VectorFrame({"features": x}))
    got = np.asarray(out.column("prediction"))
    np.testing.assert_array_equal(got, model.labels_)
    with pytest.raises(ValueError, match="fitted"):
        model.transform(VectorFrame({"features": x[:5]}))
    assert model.fit_report_.algo == "dbscan"


def test_dbscan_all_noise_and_single_cluster(rng):
    x = np.arange(10, dtype=np.float64)[:, None] * 100.0
    m = DBSCAN().setEps(0.1).setMinPts(2).fit(x)
    assert m.n_clusters_ == 0 and (m.labels_ == -1).all()
    y = rng.normal(size=(50, 3)) * 0.01
    m2 = DBSCAN().setEps(1.0).setMinPts(3).fit(y)
    assert m2.n_clusters_ == 1 and (m2.labels_ == 0).all()
    _same(m2, _jax_fit(y, 1.0, 3))


def test_dbscan_blocked_matches_dense(rng):
    x = _blobs(rng, per=40, noise=5)
    dense = DBSCAN().setEps(1.5).setMinPts(5).fit(x)
    jax_dense = _jax_fit(x, 1.5, 5)
    for block in (32, 37, len(x)):
        blocked = DBSCAN().setEps(1.5).setMinPts(5).setBlockRows(block).fit(x)
        _same(blocked, dense)
        _same(DBSCAN().setEps(1.5).setMinPts(5).setBlockRows(block)
              .setDtype("float64").fit(x), jax_dense)


def test_dbscan_blocked_selected_automatically_past_dense_envelope(
        rng, monkeypatch):
    x = _blobs(rng, per=40, noise=0)
    est = DBSCAN().setEps(1.5).setMinPts(5)
    assert est.getBlockRows() == 0
    calls = []
    real = ops.dbscan_labels_blocked
    monkeypatch.setattr(ops, "dbscan_labels_blocked",
                        lambda *a, **kw: calls.append(a[4]) or real(*a, **kw))
    est._DENSE_MAX_ROWS = 50
    model = est.fit(x)
    assert calls == [len(x)]  # auto block: min(4096, n)
    _same(model, DBSCAN().setEps(1.5).setMinPts(5).fit(x))


def test_dbscan_tiled_envelope_is_jax_s(monkeypatch, rng):
    assert ops.LABEL_ENVELOPE == 2 ** 24
    monkeypatch.setattr(ops, "LABEL_ENVELOPE", 30)
    with pytest.raises(ValueError, match="2\\^24"):
        DBSCAN().setBlockRows(8).fit(rng.normal(size=(31, 2)))


# -- the cases of tests/test_distributed_dbscan.py ---------------------------


def _dist_blobs(rng, per=40, noise=5):
    centers = np.array([[0, 8], [8, 0], [-8, -8]], dtype=float)
    pts = [c + 0.6 * rng.normal(size=(per, 2)) for c in centers]
    pts.append(rng.uniform(-30, 30, size=(noise, 2)))
    return np.concatenate(pts)


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


def _jax_distributed(x, devices):
    from spark_rapids_ml_tpu.parallel import data_mesh as jax_mesh
    from spark_rapids_ml_tpu.parallel import (
        distributed_dbscan_labels as jax_labels,
    )

    return jax_labels(x, 1.5, 5, jax_mesh(devices), dtype=np.float64)


@pytest.mark.parametrize("per,noise", [(40, 5), (41, 3)])
def test_distributed_matches_single_device(rng, one_rank_mesh, per, noise):
    """(40, 5): the JAX file's first case; (41, 3): its uneven rows."""
    from spark_rapids_ml_tpu_torch.parallel import distributed_dbscan_labels

    x = _dist_blobs(rng, per=per, noise=noise)
    result = distributed_dbscan_labels(x, 1.5, 5, one_rank_mesh,
                                       dtype=np.float64)
    labels, core = result
    assert labels.shape == (len(x),) and core.shape == (len(x),)
    single = DBSCAN().setEps(1.5).setMinPts(5).fit(x)
    np.testing.assert_array_equal(_relabel_consecutive(labels),
                                  single.labels_)
    np.testing.assert_array_equal(core, single.core_mask_)
    jl, jc = _jax_distributed(x, 8)
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_array_equal(core, jc)
    # one rank: no padding, each all_gather moves n float64
    report = result.fit_report_
    payload = report.extra["dbscan_sweep_payload_bytes"]
    assert payload == 8 * len(x)
    assert report.collectives["all_gather"] == {"count": 3,
                                                "bytes": 3 * payload}


def test_distributed_envelope_guard(one_rank_mesh):
    from spark_rapids_ml_tpu.parallel import data_mesh as jax_mesh
    from spark_rapids_ml_tpu.parallel import (
        distributed_dbscan_labels as jax_labels,
    )
    from spark_rapids_ml_tpu_torch.parallel import distributed_dbscan_labels

    x = np.zeros((2 ** 24 + 8, 1), dtype=np.float32)
    with pytest.raises(ValueError, match="2\\^24"):
        distributed_dbscan_labels(x, 1.0, 2, one_rank_mesh)
    with pytest.raises(ValueError, match="2\\^24"):
        jax_labels(x, 1.0, 2, jax_mesh(2))
