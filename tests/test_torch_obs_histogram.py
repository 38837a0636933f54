"""The port's ``Histogram`` against the JAX registry's: the same seeded
observations give the same exposition text (``_bucket{le=}``, ``_sum``,
``_count``) and the same snapshot, and the history sampler reads a
histogram's ``_count`` / ``_sum`` into the store as the JAX sampler does.
"""

import json

import numpy as np
import pytest

from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu.obs import tsdb as jax_tsdb
from spark_rapids_ml_tpu_torch.obs import metrics, tsdb


def _observations(seed, n=200):
    rng = np.random.default_rng(seed)
    values = rng.lognormal(-3.0, 2.0, size=n)
    # on a bound exactly, and past the last bound
    values[:3] = (0.001, 5.0, 1000.0)
    labels = [{"algo": ("pca", "kmeans")[i % 2]} for i in range(n)]
    return list(zip(values.tolist(), labels))


def _fill(module, seed, buckets=None):
    reg = module.MetricsRegistry()
    kwargs = {} if buckets is None else {"buckets": buckets}
    hist = reg.histogram("sparkml_fit_seconds", "fit wall-clock seconds",
                         ("algo",), **kwargs)
    for value, labels in _observations(seed):
        hist.observe(value, **labels)
    reg.histogram("sparkml_unlabelled_seconds", "").observe(0.2)
    return reg, hist


def test_default_buckets_are_the_jax_buckets():
    assert metrics.DEFAULT_BUCKETS == jax_metrics.DEFAULT_BUCKETS


@pytest.mark.parametrize("buckets", [None, (0.5, 0.1, 2.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_exposition_and_snapshot_equal_the_jax_registry(seed,
                                                                   buckets):
    ours, h_ours = _fill(metrics, seed, buckets)
    theirs, h_theirs = _fill(jax_metrics, seed, buckets)
    assert ours.prometheus_text() == theirs.prometheus_text()
    assert ours.snapshot() == theirs.snapshot()
    json.dumps(ours.snapshot())
    assert h_ours.buckets == h_theirs.buckets
    snap = h_ours.snapshot_child(algo="pca")
    assert snap["count"] == 100 and snap["buckets"]["+Inf"] == 100
    cumulative = list(snap["buckets"].values())
    assert cumulative == sorted(cumulative)
    text = ours.prometheus_text()
    assert "# TYPE sparkml_fit_seconds histogram" in text
    assert 'sparkml_fit_seconds_bucket{algo="pca",le="+Inf"} 100' in text
    assert 'sparkml_unlabelled_seconds_bucket{le="+Inf"} 1' in text
    assert "sparkml_unlabelled_seconds_count 1" in text


def test_histogram_kind_and_label_conflicts_raise():
    reg = metrics.MetricsRegistry()
    reg.histogram("h", "", ("algo",))
    assert reg.histogram("h", "", ("algo",)) is reg.histogram("h", "",
                                                              ("algo",))
    with pytest.raises(ValueError):
        reg.counter("h", "", ("algo",))
    with pytest.raises(ValueError):
        reg.histogram("h", "", ("model",))
    with pytest.raises(ValueError):
        reg.histogram("empty", "", buckets=())


def test_the_sampler_reads_a_histogram_as_the_jax_sampler_does():
    """Two sweeps around more observations: the same ``_count`` and
    ``_sum`` series, recorded as counters, in both stores."""
    packages = ((metrics, tsdb), (jax_metrics, jax_tsdb))
    regs, samplers = [], []
    for metrics_mod, tsdb_mod in packages:
        reg, _ = _fill(metrics_mod, 3)
        regs.append(reg)
        samplers.append(tsdb_mod.MetricsSampler(
            tsdb_mod.TimeSeriesStore(tiers=((1.0, 600.0),)), registry=reg,
            interval_seconds=1.0))
    for sampler in samplers:
        sampler.sample_once(now=1000.0)
    for reg in regs:
        reg.histogram("sparkml_fit_seconds", "", ("algo",)).observe(
            7.5, algo="pca")
    for sampler in samplers:
        sampler.sample_once(now=1001.0)
    for name in ("sparkml_fit_seconds_count", "sparkml_fit_seconds_sum"):
        got = samplers[0].store.range_query(name, window=60.0, now=1001.0)
        want = samplers[1].store.range_query(name, window=60.0, now=1001.0)
        assert got == want
        assert {s["labels"]["algo"] for s in got} == {"pca", "kmeans"}
        assert all(len(s["points"]) == 2 for s in got)
    pca = samplers[0].store.range_query("sparkml_fit_seconds_count",
                                        {"algo": "pca"}, window=60.0,
                                        now=1001.0)
    assert [p[1] for p in pca[0]["points"]] == [100, 101]
    assert samplers[0].store.rate("sparkml_fit_seconds_count",
                                  {"algo": "pca"}, window=60.0,
                                  now=1001.0) == \
        samplers[1].store.rate("sparkml_fit_seconds_count",
                               {"algo": "pca"}, window=60.0, now=1001.0)
