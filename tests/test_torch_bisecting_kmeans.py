"""BisectingKMeans in the port against the JAX package's, on the same
seeded numpy inputs.

``models/bisecting_kmeans.py`` against the JAX module of the same name.
Bars:

* the host route (``useXlaDot=False``, every split a numpy Lloyd seeded
  by numpy): centres and ``training_cost_`` bit-equal to the JAX fit at
  float64, weighted, with a fractional ``minDivisibleClusterSize`` and
  with fewer divisible leaves than ``k``;
* the device route (seeded by a ``torch.Generator``, so not draw for
  draw): ``tests/test_bisecting_kmeans.py``'s bars — blobs recovered
  within 0.5, each blob one predicted cluster (> 98 %), the divisibility
  rules, cost falling with k, ``computeCost`` equal to ``training_cost_``
  (1e-6 relative) — at float64 and float32;
* ``transform`` equal to the KMeans model on the same centres.
"""

import numpy as np
import pytest

from spark_rapids_ml_tpu_torch import (
    BisectingKMeans,
    BisectingKMeansModel,
    KMeansModel,
)
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def _blobs(seed=0, sizes=(150, 150, 150, 150), d=3, sep=10.0):
    """tests/test_bisecting_kmeans.py's ``make_blobs``."""
    rng = np.random.default_rng(seed)
    centers = np.zeros((len(sizes), d))
    for i in range(len(sizes)):
        centers[i, i % d] = sep * (1 + i // d)
    xs, labels = [], []
    for i, n in enumerate(sizes):
        xs.append(centers[i] + rng.normal(size=(n, d)))
        labels.extend([i] * n)
    return np.vstack(xs), centers, np.asarray(labels), rng


@pytest.mark.parametrize("case", ["plain", "weighted", "fraction",
                                  "undivisible", "k_past_blobs"])
def test_host_fit_is_bit_equal_to_jax(case):
    from spark_rapids_ml_tpu import BisectingKMeans as JaxBKM
    from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxFrame

    x, _c, _l, rng = _blobs(seed=1)
    kw = {"k": 4, "seed": 2}
    port_data = jax_data = x
    if case == "weighted":
        w = rng.uniform(0.5, 3.0, size=x.shape[0])
        kw["weightCol"] = "w"
        port_data = VectorFrame({"features": list(x), "w": w})
        jax_data = JaxFrame({"features": list(x), "w": w})
    elif case == "fraction":
        x, _c, _l, _rng = _blobs(seed=2, sizes=(200, 10))
        port_data = jax_data = x
        kw.update(k=3, minDivisibleClusterSize=0.4)
    elif case == "undivisible":
        x = np.ones((6, 2))
        port_data = jax_data = x
        kw["k"] = 3
    elif case == "k_past_blobs":
        kw.update(k=7, maxIter=5)
    got = BisectingKMeans(**kw).setUseXlaDot(False).fit(port_data)
    want = JaxBKM(**kw).setUseXlaDot(False).fit(jax_data)
    assert np.array_equal(got.cluster_centers, want.cluster_centers)
    assert got.training_cost_ == want.training_cost_
    pred = got.transform(x).column("prediction")
    assert np.array_equal(np.asarray(pred),
                          np.asarray(want.transform(x).column("prediction")))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_device_fit_recovers_blobs(dtype):
    x, centers, labels, _rng = _blobs()
    model = BisectingKMeans(k=4, seed=1, dtype=dtype).fit(x)
    assert model.cluster_centers.shape == (4, 3)
    for c in centers:
        assert np.min(np.linalg.norm(model.cluster_centers - c,
                                     axis=1)) < 0.5
    pred = np.asarray(model.transform(x).column("prediction"))
    for i in range(4):
        _v, counts = np.unique(pred[labels == i], return_counts=True)
        assert counts.max() / counts.sum() > 0.98
    assert model.computeCost(x) == pytest.approx(model.training_cost_,
                                                 rel=1e-6)


def test_device_divisibility_rules():
    assert BisectingKMeans(k=3).fit(np.ones((4, 2))) \
        .cluster_centers.shape[0] == 1
    x, _c, _l, _rng = _blobs(seed=2, sizes=(200, 10))
    model = BisectingKMeans(k=3, seed=2, minDivisibleClusterSize=0.4).fit(x)
    assert model.cluster_centers.shape[0] == 3
    sizes = np.bincount(np.asarray(model.transform(x).column("prediction"),
                                   dtype=int))
    assert sizes.min() >= 10


def test_device_cost_falls_with_k_and_weights_pull_centres():
    x, _c, _l, _rng = _blobs()
    costs = [BisectingKMeans(k=k, seed=0).fit(x).training_cost_
             for k in (1, 2, 4)]
    assert costs[0] > costs[1] > costs[2]
    x, _c, _l, _rng = _blobs(seed=3, sizes=(100, 100))
    w = np.ones(200)
    w[:100] = 3.0
    model = BisectingKMeans(k=2, seed=3, weightCol="w").fit(
        VectorFrame({"features": list(x), "w": w}))
    pred = np.asarray(model.transform(x).column("prediction"))
    assert len(set(pred[:100])) == 1 and len(set(pred[100:])) == 1
    heavy = model.cluster_centers[pred[0]]
    np.testing.assert_allclose(heavy, x[:100].mean(axis=0), atol=1e-6)


def test_transform_is_the_kmeans_assignment():
    x, _c, _l, _rng = _blobs(seed=4)
    model = BisectingKMeans(k=4, seed=5, predictionCol="leaf").fit(x)
    km = KMeansModel(cluster_centers=model.cluster_centers)
    assert np.array_equal(
        np.asarray(model.transform(x).column("leaf")),
        np.asarray(km.transform(x).column("prediction")))
    with pytest.raises(ValueError, match="fit first"):
        BisectingKMeansModel().transform(x)
