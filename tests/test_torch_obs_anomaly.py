"""The port's ``obs/robust.py`` and ``obs/anomaly.py`` against the JAX
package's.

Robust statistics are equal exactly on seeded series. Each detector kind
judges the same seeded series, recorded into a JAX ``TimeSeriesStore`` and
a port one under one injected clock, into equal ``Finding.as_dict()``
lists: the values are Python floats through the same arithmetic, so the
comparison is ``==``, not a tolerance. The catalog describes itself as the
reference does. Then the JAX file's own cases, run on the port. No sleeps.
"""

import os
import sys

import numpy as np
import pytest

from spark_rapids_ml_tpu.obs import anomaly as jax_anomaly
from spark_rapids_ml_tpu.obs import robust as jax_robust
from spark_rapids_ml_tpu.obs import tsdb as jax_tsdb
from spark_rapids_ml_tpu_torch.obs import anomaly
from spark_rapids_ml_tpu_torch.obs import robust
from spark_rapids_ml_tpu_torch.obs import tsdb
from spark_rapids_ml_tpu_torch.obs.anomaly import (
    DeltaDetector,
    MadSpikeDetector,
    RateOfChangeDetector,
    RatioDetector,
    ThresholdDetector,
    builtin_detectors,
)
from spark_rapids_ml_tpu_torch.obs.tsdb import TimeSeriesStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t


@pytest.fixture
def clock():
    return FakeClock()


@pytest.fixture
def store(clock):
    return TimeSeriesStore(tiers=((1.0, 900.0),), clock=clock)


# -- robust statistics: equal to the reference exactly -----------------------


def _seeded_series(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    kind = seed % 4
    if kind == 0:
        values = rng.normal(10.0, 3.0, size=n)
    elif kind == 1:
        values = rng.exponential(0.02, size=n)
    elif kind == 2:
        values = np.full(n, float(rng.integers(0, 5)))
    else:
        values = rng.integers(-5, 50, size=n).astype(np.float64)
    return [float(v) for v in values]


@pytest.mark.parametrize("seed", range(12))
def test_robust_equals_the_reference(seed):
    values = _seeded_series(seed)
    probe = float(np.random.default_rng(seed + 100).normal(12.0, 8.0))
    assert robust.median(values) == jax_robust.median(values)
    assert robust.mad(values) == jax_robust.mad(values)
    assert robust.mad(values, center=probe) == jax_robust.mad(
        values, center=probe)
    for tolerance in (0.0, 0.15, 0.5):
        assert robust.noise_band(values, tolerance) == \
            jax_robust.noise_band(values, tolerance)
        assert robust.baseline_stats(values, tolerance) == \
            jax_robust.baseline_stats(values, tolerance)
    for value in (probe, values[0], values[-1] + 1.0, values[0] - 1.0):
        assert robust.robust_zscore(value, values) == \
            jax_robust.robust_zscore(value, values)
    assert robust.MAD_CONSISTENCY == jax_robust.MAD_CONSISTENCY
    assert robust.__all__ == jax_robust.__all__


def test_robust_empty_median_raises_like_the_reference():
    with pytest.raises(ValueError, match="empty"):
        robust.median([])
    with pytest.raises(ValueError, match="empty"):
        jax_robust.median([])


def test_robust_matches_perf_sentinel_band():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import perf_sentinel
    finally:
        sys.path.pop(0)
    for values in ([100.0], [100.0, 60.0, 140.0, 80.0, 120.0],
                   [5.0, 5.1, 4.9, 5.0], [0.0, 0.0, 0.0]):
        assert perf_sentinel.noise_band(values, 0.15) == \
            robust.noise_band(values, 0.15)
        assert perf_sentinel._median(values) == robust.median(values)


def test_robust_zscore_basics():
    flat = [10.0, 10.5, 9.5, 10.0, 10.2, 9.8]
    assert abs(robust.robust_zscore(10.0, flat)) < 1.0
    assert robust.robust_zscore(100.0, flat) > 50.0
    # constant baseline: exact match is 0, any excursion is +/- inf
    assert robust.robust_zscore(5.0, [5.0, 5.0, 5.0]) == 0.0
    assert robust.robust_zscore(6.0, [5.0, 5.0, 5.0]) == float("inf")
    assert robust.robust_zscore(4.0, [5.0, 5.0, 5.0]) == float("-inf")
    assert robust.mad([1.0, 1.0, 1.0]) == 0.0


# -- every detector kind: the same findings as the reference -----------------
#
# A scenario is (records, sweep times, detector factory). The factory takes
# an anomaly module, so one call builds the JAX detector and one the port's
# from the same arguments.


def _mad_scenario(rng):
    name = "sparkml_serve_queue_depth"
    records = []
    for model in ("a", "b"):
        base = float(rng.uniform(1.0, 20.0))
        for i in range(60):
            records.append((name, {"model": model},
                            base + float(rng.normal(0.0, 1.5)), "gauge",
                            1000.0 + i))
        step = float(rng.choice([0.0, 3.0, 30.0]))
        for i in range(60, 70):
            records.append((name, {"model": model},
                            base + step + float(rng.normal(0.0, 1.5)),
                            "gauge", 1000.0 + i))

    def make(mod):
        return mod.MadSpikeDetector(
            "qd", name, kind="saturation", baseline_window=300.0,
            spike_window=5.0, z_threshold=4.0, min_relative=0.5,
            min_step=2.0, min_value=4.0, min_points=8)

    return records, [1030.0, 1060.0, 1061.0, 1065.0, 1069.0], make


def _roc_scenario(rng):
    name = "sparkml_serve_request_latency_seconds"
    records = []
    for model in ("a", "b"):
        level = float(rng.uniform(0.002, 0.02))
        jump_at = int(rng.integers(15, 40))
        jump = float(rng.choice([1.0, 1.5, 12.0]))
        for i in range(80):
            value = level * (jump if i >= jump_at else 1.0)
            for q in ("0.5", "0.99"):
                records.append((name, {"model": model, "quantile": q},
                                value * (0.5 if q == "0.5" else 1.0),
                                "gauge", 1000.0 + i))

    def make(mod):
        return mod.RateOfChangeDetector(
            "p99", name, labels={"quantile": "0.99"}, kind="latency",
            severity="serious", lookback=30.0, min_relative=1.0,
            min_step=0.02, min_points=4)

    return records, [1010.0, 1020.0, 1030.0, 1040.0, 1050.0, 1079.0], make


def _threshold_scenario(rng):
    records = []
    for slo in ("serve_availability", "serve_latency"):
        for i in range(0, 60, 5):
            for window in ("5m", "1h"):
                records.append(("sparkml_slo_burn_rate",
                                {"slo": slo, "window": window},
                                float(rng.choice([0.0, 2.0, 14.4, 15.0,
                                                  120.0])),
                                "gauge", 1000.0 + i))

    def make(mod):
        return mod.ThresholdDetector(
            "burn", "sparkml_slo_burn_rate", threshold=14.4,
            labels={"window": "5m"}, kind="slo", severity="critical",
            stale_after=30.0)

    return records, [1020.0, 1055.0, 1080.0, 1200.0], make


def _threshold_below_scenario(rng):
    records = []
    for host in ("h0", "h1", "h2"):
        for i in range(0, 40, 4):
            records.append(("sparkml_fleet_host_up", {"host": host},
                            float(rng.integers(0, 2)), "gauge",
                            1000.0 + i))

    def make(mod):
        return mod.ThresholdDetector(
            "down", "sparkml_fleet_host_up", threshold=0.5,
            direction="<", kind="fleet", severity="critical",
            stale_after=20.0)

    return records, [1010.0, 1036.0, 1050.0], make


def _ratio_scenario(rng):
    name = "sparkml_serve_requests_total"
    records = []
    for model in ("a", "b", "c"):
        ok = err = 0.0
        err_born = int(rng.integers(0, 20))
        for i in range(30):
            ok += float(rng.integers(0, 12))
            err += float(rng.integers(0, 4)) if model != "c" else 0.0
            records.append((name, {"model": model, "outcome": "ok"}, ok,
                            "counter", 1000.0 + i))
            if i >= err_born:
                records.append((name, {"model": model, "outcome": "error"},
                                err, "counter", 1000.0 + i))

    def make(mod):
        return mod.RatioDetector(
            "err", name, select={"outcome": "error"}, threshold=0.05,
            window=10.0, min_total=10.0)

    return records, [1005.0, 1012.0, 1020.0, 1029.0], make


def _delta_scenario(rng):
    name = "sparkml_serve_breaker_transitions_total"
    records = []
    for model in ("a", "b"):
        opens = float(rng.integers(0, 2))
        for i in range(0, 100, 5):
            opens += float(rng.integers(0, 2))
            if model == "b" and i == 50:
                opens = 0.0  # a restart resets the counter
            records.append((name, {"model": model, "state": "open"}, opens,
                            "counter", 1000.0 + i))
            records.append((name, {"model": model, "state": "closed"},
                            opens, "counter", 1000.0 + i))

    def make(mod):
        return mod.DeltaDetector(
            "flap", name, labels={"state": "open"}, min_delta=3.0,
            window=40.0)

    return records, [1020.0, 1045.0, 1060.0, 1095.0], make


SCENARIOS = {
    "mad_spike": _mad_scenario,
    "rate_of_change": _roc_scenario,
    "threshold": _threshold_scenario,
    "threshold_below": _threshold_below_scenario,
    "ratio": _ratio_scenario,
    "delta": _delta_scenario,
}


def _findings(tsdb_mod, anomaly_mod, records, times, make):
    clock = FakeClock(times[-1])
    store = tsdb_mod.TimeSeriesStore(tiers=((1.0, 900.0),), clock=clock)
    for name, labels, value, kind, ts in records:
        store.record(name, labels, value, kind=kind, now=ts)
    detector = make(anomaly_mod)
    return [[f.as_dict() for f in detector.evaluate(store, now)]
            for now in times], detector


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", sorted(SCENARIOS))
def test_detector_findings_equal_the_reference(kind, seed):
    records, times, make = SCENARIOS[kind](
        np.random.default_rng(1000 * seed + len(kind)))
    ours, det = _findings(tsdb, anomaly, records, times, make)
    theirs, jax_det = _findings(jax_tsdb, jax_anomaly, records, times, make)
    assert ours == theirs
    assert det.describe() == jax_det.describe()
    # the seeds must give the comparison something to compare
    if kind in ("rate_of_change", "threshold", "ratio"):
        assert any(ours), f"{kind} seed {seed} found nothing"


def test_every_scenario_fires_somewhere():
    for kind, scenario in sorted(SCENARIOS.items()):
        fired = False
        for seed in range(4):
            records, times, make = scenario(
                np.random.default_rng(1000 * seed + len(kind)))
            fired = fired or any(
                _findings(tsdb, anomaly, records, times, make)[0])
        assert fired, kind


def test_finding_key_and_dict_equal_the_reference():
    args = dict(detector="d", kind="latency", severity="serious",
                metric="m", labels={"model": "a", "quantile": "0.99"},
                value=0.5, baseline=0.1, reason="r")
    ours = anomaly.Finding(**args)
    theirs = jax_anomaly.Finding(**args)
    assert ours.key == theirs.key
    assert ours.as_dict() == theirs.as_dict()
    assert anomaly.SEVERITIES == jax_anomaly.SEVERITIES


@pytest.mark.parametrize("window", [None, "8", "0.5", "-3", "garbage"])
def test_builtin_catalog_describes_itself_as_the_reference(window,
                                                           monkeypatch):
    for env in (anomaly.WINDOW_ENV, jax_anomaly.WINDOW_ENV):
        if window is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, window)
    assert anomaly.WINDOW_ENV == "SPARK_RAPIDS_ML_TORCH_OBS_INCIDENT_WINDOW_S"
    assert anomaly.short_window_seconds() == \
        jax_anomaly.short_window_seconds()
    ours = [d.describe() for d in builtin_detectors()]
    theirs = [d.describe() for d in jax_anomaly.builtin_detectors()]
    assert ours == theirs
    assert len(ours) == 10


def test_catalog_detectors_on_absent_series_find_nothing(store):
    # the four catalog entries over series no port module publishes yet
    absent = {"serve_replica_degraded", "serve_canary_regressed",
              "fit_backend_degraded", "fleet_host_down"}
    store.record("sparkml_serve_queue_depth", {"model": "m"}, 1.0,
                 now=1000.0)
    for det in builtin_detectors(short_window=8.0):
        if det.name in absent:
            assert det.evaluate(store, 1001.0) == []


# -- the JAX file's cases, on the port ---------------------------------------


def _fill(store, name, values, labels=None, start=1000.0, step=1.0):
    for i, v in enumerate(values):
        store.record(name, labels or {"model": "m"}, v,
                     now=start + i * step)
    return start + (len(values) - 1) * step


def _mad_detector(**kw):
    defaults = dict(baseline_window=300.0, spike_window=5.0,
                    z_threshold=4.0, min_relative=0.5, min_step=0.0,
                    min_value=0.0, min_points=8)
    defaults.update(kw)
    return MadSpikeDetector("d", "sparkml_serve_queue_depth", **defaults)


def test_mad_spike_fires_on_step_change(store):
    last = _fill(store, "sparkml_serve_queue_depth",
                 [2.0, 3.0, 2.0, 3.0, 2.0] * 12)  # noisy-ish flat
    store.record("sparkml_serve_queue_depth", {"model": "m"}, 40.0,
                 now=last + 1)
    findings = _mad_detector().evaluate(store, last + 1)
    assert len(findings) == 1
    f = findings[0]
    assert f.labels == {"model": "m"}
    assert f.value == 40.0
    assert f.baseline == pytest.approx(2.0, abs=1.0)
    assert "z" in f.reason


def test_mad_spike_quiet_on_noisy_but_flat_series(store):
    values = [10.0, 50.0, 20.0, 60.0, 15.0, 55.0, 25.0, 45.0] * 8
    last = _fill(store, "sparkml_serve_queue_depth", values)
    store.record("sparkml_serve_queue_depth", {"model": "m"}, 62.0,
                 now=last + 1)
    assert _mad_detector().evaluate(store, last + 1) == []


@pytest.mark.parametrize("base, wiggle, step, min_value", [
    # constant baseline => MAD 0 => infinite z: the step guard decides
    (100.0, 100.5, 200.0, 0.0),
    # an idle queue blipping to 5 is not saturation; 50 is
    (0.0, 5.0, 50.0, 8.0),
])
def test_mad_spike_guards_on_a_flat_baseline(store, base, wiggle, step,
                                             min_value):
    last = _fill(store, "sparkml_serve_queue_depth", [base] * 50)
    det = _mad_detector(min_value=min_value)
    store.record("sparkml_serve_queue_depth", {"model": "m"}, wiggle,
                 now=last + 1)
    assert det.evaluate(store, last + 1) == []
    store.record("sparkml_serve_queue_depth", {"model": "m"}, step,
                 now=last + 2)
    assert len(det.evaluate(store, last + 2)) == 1


def test_mad_spike_needs_min_baseline_points(store):
    last = _fill(store, "sparkml_serve_queue_depth", [1.0] * 4)
    store.record("sparkml_serve_queue_depth", {"model": "m"}, 99.0,
                 now=last + 6)
    assert _mad_detector(min_points=8).evaluate(store, last + 6) == []


def _roc(**kw):
    defaults = dict(lookback=30.0, min_relative=1.0, min_step=0.02,
                    min_points=4)
    defaults.update(kw)
    return RateOfChangeDetector(
        "p99", "sparkml_serve_request_latency_seconds",
        labels={"quantile": "0.99"}, **defaults)


def test_roc_fires_on_jump_then_quiets_on_plateau(store):
    labels = {"model": "m", "quantile": "0.99"}
    name = "sparkml_serve_request_latency_seconds"
    for i in range(20):
        store.record(name, labels, 0.005, now=1000.0 + i)
    for i in range(20, 80):
        store.record(name, labels, 0.2, now=1000.0 + i)
    det = _roc()
    assert len(det.evaluate(store, 1025.0)) == 1
    # the whole lookback at the new level: quiet, which is what resolves
    # an incident on a signal that can never come back down
    assert det.evaluate(store, 1075.0) == []


@pytest.mark.parametrize("quantile, values", [
    # +6 ms drift over the window: below min_step and below 1x relative
    ("0.99", [0.100 + i * 0.0002 for i in range(40)]),
    # a jump on another quantile is not the p99's
    ("0.5", [0.001] * 5 + [1.0] * 5),
])
def test_roc_ignores_drift_and_other_quantiles(store, quantile, values):
    name = "sparkml_serve_request_latency_seconds"
    for i, v in enumerate(values):
        store.record(name, {"model": "m", "quantile": quantile}, v,
                     now=1000.0 + i)
    assert _roc().evaluate(store, 1000.0 + len(values) - 1) == []


def test_threshold_fires_and_skips_stale_series(store):
    det = ThresholdDetector(
        "burn", "sparkml_slo_burn_rate", threshold=14.4,
        labels={"window": "5m"}, stale_after=60.0)
    store.record("sparkml_slo_burn_rate",
                 {"slo": "serve_availability", "window": "5m"},
                 120.0, now=1000.0)
    findings = det.evaluate(store, 1010.0)
    assert len(findings) == 1 and findings[0].value == 120.0
    assert det.evaluate(store, 1200.0) == []
    store.record("sparkml_slo_burn_rate",
                 {"slo": "serve_availability", "window": "5m"},
                 0.2, now=1201.0)
    assert det.evaluate(store, 1202.0) == []


def test_threshold_rejects_a_bad_direction():
    with pytest.raises(ValueError, match="direction"):
        ThresholdDetector("x", "m", threshold=1.0, direction=">=")


def test_ratio_detector_error_fraction_per_model(store):
    name = "sparkml_serve_requests_total"
    for i in range(11):
        store.record(name, {"model": "a", "outcome": "ok"}, i * 10.0,
                     kind="counter", now=1000.0 + i)
        store.record(name, {"model": "a", "outcome": "error"},
                     0.0 if i < 5 else (i - 4) * 5.0,
                     kind="counter", now=1000.0 + i)
        store.record(name, {"model": "b", "outcome": "ok"}, i * 10.0,
                     kind="counter", now=1000.0 + i)
    det = RatioDetector("err", name, select={"outcome": "error"},
                        threshold=0.05, window=60.0, min_total=10.0)
    findings = det.evaluate(store, 1010.0)
    assert len(findings) == 1
    assert findings[0].labels == {"model": "a"}
    assert findings[0].value == pytest.approx(30.0 / 130.0)


def test_ratio_detector_sees_burst_born_error_child(store):
    name = "sparkml_serve_requests_total"
    for i in range(11):
        store.record(name, {"model": "a", "outcome": "ok"}, i * 2.0,
                     kind="counter", now=1000.0 + i)
    store.record(name, {"model": "a", "outcome": "error"}, 3.0,
                 kind="counter", now=1009.0)
    store.record(name, {"model": "a", "outcome": "error"}, 3.0,
                 kind="counter", now=1010.0)
    det = RatioDetector("err", name, select={"outcome": "error"},
                        threshold=0.05, window=60.0, min_total=10.0)
    findings = det.evaluate(store, 1010.0)
    assert len(findings) == 1
    assert findings[0].value == pytest.approx(3.0 / 23.0)


def test_ratio_detector_min_total_floor(store):
    name = "sparkml_serve_requests_total"
    store.record(name, {"model": "a", "outcome": "error"}, 0.0,
                 kind="counter", now=1000.0)
    store.record(name, {"model": "a", "outcome": "error"}, 1.0,
                 kind="counter", now=1001.0)
    det = RatioDetector("err", name, select={"outcome": "error"},
                        threshold=0.05, window=60.0, min_total=10.0)
    assert det.evaluate(store, 1002.0) == []


@pytest.mark.parametrize("first", [0.0, 1.0])
def test_delta_detector_counts_flaps_and_the_birth(store, first):
    # first 0: one open is self-healing, three are a flap; first 1: the
    # first open mints the child already at 1, and still counts
    name = "sparkml_serve_breaker_transitions_total"
    labels = {"model": "m", "state": "open"}
    det = DeltaDetector("flap", name, labels={"state": "open"},
                        min_delta=3.0, window=120.0)
    store.record(name, labels, first, kind="counter", now=1000.0)
    store.record(name, labels, first + 1.0, kind="counter", now=1010.0)
    if first == 0.0:
        assert det.evaluate(store, 1011.0) == []
    store.record(name, labels, first + 2.0, kind="counter", now=1020.0)
    if first == 0.0:
        store.record(name, labels, 3.0, kind="counter", now=1030.0)
    findings = det.evaluate(store, 1031.0)
    assert len(findings) == 1 and findings[0].value == 3.0


def test_builtin_catalog_names_and_env_window(monkeypatch):
    names = {d.name for d in builtin_detectors()}
    assert names == {
        "serve_p99_spike", "serve_queue_depth", "serve_error_rate",
        "device_mem_in_use", "breaker_flap", "slo_fast_burn",
        "serve_replica_degraded", "serve_canary_regressed",
        "fit_backend_degraded", "fleet_host_down",
    }
    monkeypatch.setenv(anomaly.WINDOW_ENV, "8")
    dets = {d.name: d for d in builtin_detectors()}
    assert dets["serve_p99_spike"].query_window == 8.0
    assert dets["serve_error_rate"].query_window == 8.0
    monkeypatch.setenv(anomaly.WINDOW_ENV, "garbage")
    assert {d.name: d for d in builtin_detectors()}[
        "serve_p99_spike"].query_window == 60.0
    for det in builtin_detectors():
        doc = det.describe()
        assert doc["name"] == det.name and doc["metric"] == det.metric
