"""obs.tsdb: the port's history store and sampler against the JAX
package's, on the same record sequences and the same metric updates.

Every case runs once per package; the two readouts (``range_query``,
``rate``, ``delta``, ``rate_points``, ``windowed_increase``,
``history_tail``, ``dropped_series``) must be EQUAL — both are float64
Python arithmetic over the same points — and the JAX test file's
expectations (``tests/test_obs_tsdb.py``) are held on the port's readout.
Clocks are injected: thirty minutes of samples cost no real second. The
concurrency and background-thread cases run on the port alone (their
timing is the machine's)."""

import threading
import time

import numpy as np
import pytest

from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu.obs import tsdb as jax_tsdb
from spark_rapids_ml_tpu_torch.obs import metrics as port_metrics
from spark_rapids_ml_tpu_torch.obs import tsdb as port_tsdb

PACKAGES = (("jax", jax_tsdb, jax_metrics), ("port", port_tsdb,
                                             port_metrics))
TIERS = ((1.0, 10.0), (5.0, 60.0))


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _store(tsdb, clock, **kwargs):
    kwargs.setdefault("tiers", TIERS)
    return tsdb.TimeSeriesStore(clock=clock, **kwargs)


def _both(case):
    """``case(tsdb, metrics)`` on each package: (jax result, port result)."""
    return tuple(case(tsdb, metrics) for _, tsdb, metrics in PACKAGES)


# -- the JAX file's store cases, one function each ---------------------------


def ring_bounded(tsdb, _metrics):
    clock = FakeClock()
    store = _store(tsdb, clock)
    for i in range(30):
        store.record("sparkml_serve_queue_depth", {"model": "m"}, i,
                     now=1000.0 + i)
    clock.t = 1030.0
    return store.range_query("sparkml_serve_queue_depth", window=10.0)


def last_in_bucket(tsdb, _metrics):
    clock = FakeClock()
    store = _store(tsdb, clock)
    for value, ts in ((1.0, 1000.1), (2.0, 1000.5), (3.0, 1000.9)):
        store.record("g", {}, value, now=ts)
    store.record("g", {}, 7.0, now=1001.2)
    clock.t = 1002.0
    return store.range_query("g", window=10.0)


def downsample_tier(tsdb, _metrics):
    clock = FakeClock()
    store = _store(tsdb, clock)
    for i in range(40):
        store.record("g", {"model": "m"}, float(i), now=1000.0 + i)
    clock.t = 1040.0
    return {"fine": store.range_query("g", window=8.0),
            "coarse": store.range_query("g", window=40.0)}


def clock_backwards(tsdb, _metrics):
    clock = FakeClock()
    store = _store(tsdb, clock)
    store.record("g", {}, 1.0, now=1005.0)
    store.record("g", {}, 2.0, now=1001.0)  # stale timestamp: dropped
    clock.t = 1010.0
    return store.range_query("g", window=60.0)


def label_matching(tsdb, _metrics):
    clock = FakeClock()
    store = _store(tsdb, clock)
    store.record("n", {"model": "a"}, 1.0, now=1000.0)
    store.record("n", {"model": "b"}, 2.0, now=1000.0)
    store.record("other", {}, 3.0, now=1000.0)
    clock.t = 1001.0
    return {"all": store.range_query("n", window=10.0),
            "a": store.range_query("n", {"model": "a"}, window=10.0),
            "names": store.series_names(),
            "count": store.series_count()}


def max_series_drops(tsdb, _metrics):
    store = _store(tsdb, FakeClock(), tiers=((1.0, 10.0),), max_series=2)
    dropped = []
    for i, ts in (("1", 1000.0), ("2", 1000.0), ("3", 1000.0),
                  ("3", 1001.0), ("3", 1002.0), ("4", 1002.0)):
        store.record("n", {"i": i}, 1.0, now=ts)
        dropped.append(store.dropped_series())
    return {"count": store.series_count(), "dropped": dropped}


def counter_increase(tsdb, _metrics):
    return [tsdb.counter_increase(points) for points in (
        [[0, 0], [1, 5], [2, 10], [3, 2], [4, 7]], [[0, 3]], [])]


def windowed_increase(tsdb, _metrics):
    clock = FakeClock()
    store = _store(tsdb, clock)
    store.record("c", {"o": "err"}, 3.0, kind="counter", now=1000.0)
    store.record("c", {"o": "err"}, 3.0, kind="counter", now=1001.0)
    clock.t = 1002.0
    young = store.range_query("c", window=60.0)[0]
    store.record("c", {"o": "err"}, 5.0, kind="counter", now=1200.0)
    clock.t = 1201.0
    old = store.range_query("c", window=5.0)[0]
    return {"born": young["born_ts"],
            "plain": tsdb.counter_increase(young["points"]),
            "young": tsdb.windowed_increase(young, 1002.0 - 60.0),
            "old": tsdb.windowed_increase(old, 1201.0 - 5.0),
            "empty": tsdb.windowed_increase(
                {"points": [], "born_ts": None}, 0.0)}


def rate_delta_over_reset(tsdb, _metrics):
    clock = FakeClock()
    store = _store(tsdb, clock)
    for i, v in enumerate([0, 10, 20, 5, 15]):  # reset between 20 and 5
        store.record("c", {"model": "m"}, v, kind="counter", now=1000.0 + i)
    clock.t = 1004.0
    return {"delta": store.delta("c", window=10.0),
            "rate": store.rate("c", window=10.0),
            "rate_points": store.rate_points("c", window=10.0)}


def rate_single_sample(tsdb, _metrics):
    clock = FakeClock()
    store = _store(tsdb, clock)
    store.record("c", {}, 5.0, kind="counter", now=1000.0)
    clock.t = 1001.0
    return {"rate": store.rate("c", window=10.0),
            "delta": store.delta("c", window=10.0)}


def history_tail(tsdb, _metrics):
    clock = FakeClock()
    store = _store(tsdb, clock)
    store.record("sparkml_serve_queue_depth", {"model": "m"}, 2.0,
                 now=1000.0)
    store.record("sparkml_slo_burn_rate", {"slo": "s", "window": "5m"},
                 0.5, now=1000.0)
    store.record("sparkml_http_requests_total", {}, 9.0, now=1000.0)
    clock.t = 1001.0
    return {"default": store.history_tail(window=300.0),
            "capped": store.history_tail(prefixes=("sparkml_",),
                                         window=300.0, max_series=1)}


STORE_CASES = {
    "ring_bounded": ring_bounded,
    "last_in_bucket": last_in_bucket,
    "downsample_tier": downsample_tier,
    "clock_backwards": clock_backwards,
    "label_matching": label_matching,
    "max_series_drops": max_series_drops,
    "counter_increase": counter_increase,
    "windowed_increase": windowed_increase,
    "rate_delta_over_reset": rate_delta_over_reset,
    "rate_single_sample": rate_single_sample,
    "history_tail": history_tail,
}


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_store_case_equals_the_jax_store(case):
    jax_out, port_out = _both(STORE_CASES[case])
    assert port_out == jax_out


def test_store_cases_keep_the_jax_expectations():
    """The JAX test file's assertions, held on the port's readouts."""
    pts = ring_bounded(port_tsdb, None)[0]["points"]
    assert len(pts) <= 11 and pts[-1] == [1029.0, 29.0]
    assert pts[0][0] >= 1019.0
    assert last_in_bucket(port_tsdb, None)[0]["points"] == [
        [1000.0, 3.0], [1001.0, 7.0]]
    tiers = downsample_tier(port_tsdb, None)
    fine = tiers["fine"][0]["points"]
    coarse = tiers["coarse"][0]["points"]
    assert all(b[0] - a[0] == 1.0 for a, b in zip(fine, fine[1:]))
    assert all(b[0] - a[0] == 5.0 for a, b in zip(coarse, coarse[1:]))
    assert coarse[-1][1] == 39.0 and coarse[-2][1] == 34.0
    assert clock_backwards(port_tsdb, None)[0]["points"] == [[1005.0, 1.0]]
    labels = label_matching(port_tsdb, None)
    assert len(labels["all"]) == 2 and labels["a"][0]["labels"] == {
        "model": "a"}
    assert labels["names"] == ["n", "other"] and labels["count"] == 3
    drops = max_series_drops(port_tsdb, None)
    assert drops == {"count": 2, "dropped": [0, 0, 1, 1, 1, 2]}
    assert counter_increase(port_tsdb, None) == [17.0, 0.0, 0.0]
    wi = windowed_increase(port_tsdb, None)
    assert wi == {"born": 1000.0, "plain": 0.0, "young": 3.0, "old": 0.0,
                  "empty": 0.0}
    rd = rate_delta_over_reset(port_tsdb, None)
    assert rd["delta"] == 35.0 and rd["rate"] == pytest.approx(35.0 / 4.0)
    assert [r for _ts, r in rd["rate_points"][0]["points"]] == [
        10.0, 10.0, 5.0, 10.0]
    assert rate_single_sample(port_tsdb, None) == {"rate": 0.0,
                                                   "delta": 0.0}
    tail = history_tail(port_tsdb, None)
    assert "sparkml_serve_queue_depth{model=m}" in tail["default"]
    assert "sparkml_slo_burn_rate{slo=s,window=5m}" in tail["default"]
    assert not any(k.startswith("sparkml_http_") for k in tail["default"])
    assert tail["capped"]["_truncated_series"] == 2


# -- seeded record sequences: resets, clocks going back, tiers, the cap ------

NAMES = ("sparkml_serve_requests_total", "sparkml_serve_queue_depth",
         "sparkml_slo_burn_rate")
LABELS = ({"m": "a"}, {"m": "b"}, {"m": "a", "o": "err"}, {})


def _script(seed: int):
    """A record sequence made from ``seed``: 600 records over ~130 s, each
    (name, labels, value, kind, ts); counters climb and sometimes reset
    to a small value, ts sometimes steps back, and twelve (name, labels)
    pairs compete for a six-series cap."""
    rng = np.random.default_rng(seed)
    ts = 1000.0
    values = {}
    script = []
    for _ in range(600):
        name = NAMES[int(rng.integers(len(NAMES)))]
        labels = LABELS[int(rng.integers(len(LABELS)))]
        kind = "counter" if name.endswith("_total") else "gauge"
        key = (name, tuple(sorted(labels.items())))
        if kind == "counter":
            prev = values.get(key, 0.0)
            if rng.random() < 0.04:
                value = float(rng.integers(0, 3))  # a process restart
            else:
                value = prev + float(rng.integers(0, 5))
        else:
            value = float(rng.normal())
        values[key] = value
        step = float(rng.exponential(0.22))
        if rng.random() < 0.05:
            step = -float(rng.uniform(0.0, 3.0))  # the clock goes back
        ts = round(ts + step, 3)
        script.append((name, dict(labels), value, kind, ts))
    return script, ts


def _readout(tsdb, store, now):
    out = {"names": store.series_names(), "count": store.series_count(),
           "dropped": store.dropped_series()}
    for name in NAMES:
        for window in (3.0, 10.0, 45.0, 200.0):
            for labels in (None, {"m": "a"}, {"o": "err"}):
                key = f"{name}|{window}|{labels}"
                series = store.range_query(name, labels, window, now=now)
                out[key + "|range"] = series
                out[key + "|wi"] = [tsdb.windowed_increase(s, now - window)
                                    for s in series]
                out[key + "|rate"] = store.rate(name, labels, window,
                                                now=now)
                out[key + "|delta"] = store.delta(name, labels, window,
                                                  now=now)
                out[key + "|rate_points"] = store.rate_points(
                    name, labels, window, now=now)
    for prefixes in (("sparkml_serve_",), ("sparkml_",)):
        out[f"tail|{prefixes}"] = store.history_tail(
            prefixes=prefixes, window=60.0, now=now, max_series=4)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_seeded_sequence_equals_the_jax_store(seed):
    script, end = _script(seed)

    def run(tsdb, _metrics):
        store = _store(tsdb, FakeClock(end), max_series=6)
        readouts = []
        for i, (name, labels, value, kind, ts) in enumerate(script):
            store.record(name, labels, value, kind=kind, now=ts)
            if i % 150 == 149:
                readouts.append(_readout(tsdb, store, ts))
        readouts.append(_readout(tsdb, store, end + 0.5))
        return readouts

    jax_out, port_out = _both(run)
    assert port_out == jax_out
    last = port_out[-1]
    # the sequence reached what it was made for: the cap refused six of
    # the twelve series, and the counters reset
    assert last["count"] == 6 and last["dropped"] == 6
    prev, resets = {}, 0
    for name, labels, value, kind, _ts in script:
        key = (name, tuple(sorted(labels.items())))
        resets += kind == "counter" and value < prev.get(key, 0.0)
        prev[key] = value
    assert resets > 0
    assert any(b[4] < a[4] for a, b in zip(script, script[1:]))


# -- env knobs ---------------------------------------------------------------


@pytest.mark.parametrize("raw", ["2x120,30x7200", "garbage", "5x2", "",
                                 "10x3600,1x300"])
def test_default_tiers_parse_as_the_jax_package(monkeypatch, raw):
    monkeypatch.setenv(jax_tsdb.HISTORY_ENV, raw)
    monkeypatch.setenv(port_tsdb.HISTORY_ENV, raw)
    assert port_tsdb.HISTORY_ENV == "SPARK_RAPIDS_ML_TORCH_OBS_HISTORY"
    assert port_tsdb.default_tiers() == jax_tsdb.default_tiers()
    if raw == "2x120,30x7200":
        assert port_tsdb.default_tiers() == ((2.0, 120.0), (30.0, 7200.0))


@pytest.mark.parametrize("raw", ["250", "1", "junk"])
def test_sample_interval_parses_as_the_jax_package(monkeypatch, raw):
    monkeypatch.setenv(jax_tsdb.SAMPLE_MS_ENV, raw)
    monkeypatch.setenv(port_tsdb.SAMPLE_MS_ENV, raw)
    assert port_tsdb.SAMPLE_MS_ENV == "SPARK_RAPIDS_ML_TORCH_OBS_SAMPLE_MS"
    assert (port_tsdb.sample_interval_seconds()
            == jax_tsdb.sample_interval_seconds())


def test_the_sampled_families_are_the_jax_packages():
    assert port_tsdb.DEFAULT_PREFIXES == jax_tsdb.DEFAULT_PREFIXES
    assert port_tsdb.SAMPLE_EXCLUDE == jax_tsdb.SAMPLE_EXCLUDE
    assert port_tsdb.DUMP_PREFIXES == jax_tsdb.DUMP_PREFIXES
    assert port_tsdb._MAX_SERIES == jax_tsdb._MAX_SERIES
    assert port_tsdb.DEFAULT_TIERS == jax_tsdb.DEFAULT_TIERS


# -- the sampler, on a registry of each package fed the same updates ---------


def _families(reg):
    return {
        "requests": reg.counter("sparkml_serve_requests_total", "",
                                ("model", "outcome")),
        "depth": reg.gauge("sparkml_serve_queue_depth", "", ("model",)),
        "latency": reg.summary("sparkml_serve_request_latency_seconds", "",
                               ("model",)),
        "excluded": reg.counter("sparkml_model_requests_total", "",
                                ("model", "outcome")),
        "kept": reg.gauge("sparkml_model_hbm_bytes", "",
                          ("model", "component")),
        "unrelated": reg.counter("unrelated_total", ""),
    }


def _sampler_run(seed):
    """``run(tsdb, metrics)``: 30 injected seconds of seeded metric
    updates, one ``sample_once(now=)`` per second; the store's readout
    without the ``sparkml_obs_`` families (their values are the sweeps'
    own wall-clock cost)."""
    rng = np.random.default_rng(seed)
    updates = [(int(rng.integers(0, 4)), int(rng.integers(0, 9)),
                rng.exponential(0.05, size=int(rng.integers(1, 6))))
               for _ in range(30)]

    def run(tsdb, metrics):
        reg = metrics.MetricsRegistry()
        fam = _families(reg)
        fam["unrelated"].inc(9)
        fam["requests"].inc(0, model="m", outcome="ok")
        fam["requests"].inc(0, model="m", outcome="error")
        fam["excluded"].inc(2, model="m", outcome="ok")
        fam["kept"].set(512, model="m", component="weights")
        clock = FakeClock()
        store = tsdb.TimeSeriesStore(tiers=((1.0, 3600.0),), clock=clock)
        sampler = tsdb.MetricsSampler(store, registry=reg,
                                      interval_seconds=1.0, clock=clock)
        recorded = [sampler.sample_once(now=1000.0)]
        for i, (ok, depth, latencies) in enumerate(updates):
            fam["requests"].inc(ok, model="m", outcome="ok")
            if i % 7 == 3:
                fam["requests"].inc(1, model="m", outcome="error")
            fam["depth"].set(depth, model="m")
            for v in latencies:
                fam["latency"].observe(float(v), model="m")
            recorded.append(sampler.sample_once(now=1001.0 + i))
        clock.t = 1031.0
        names = [n for n in store.series_names()
                 if not n.startswith("sparkml_obs_")]
        return {
            "recorded": recorded,
            "names": names,
            "series": {n: store.range_query(n, window=60.0) for n in names},
            "delta": store.delta("sparkml_serve_requests_total",
                                 {"model": "m"}, window=60.0),
            "registry_total": fam["requests"].value(model="m", outcome="ok")
            + fam["requests"].value(model="m", outcome="error"),
            "sweeps": sampler.sweeps,
        }

    return run


@pytest.mark.parametrize("seed", range(3))
def test_sampler_equals_the_jax_sampler(seed):
    jax_out, port_out = _both(_sampler_run(seed))
    assert port_out == jax_out
    names = port_out["names"]
    # summaries sample one series per quantile + a _count counter; the
    # excluded and unprefixed families are not sampled
    for want in ("sparkml_serve_requests_total", "sparkml_serve_queue_depth",
                 "sparkml_serve_request_latency_seconds",
                 "sparkml_serve_request_latency_seconds_count",
                 "sparkml_model_hbm_bytes"):
        assert want in names
    assert "sparkml_model_requests_total" not in names
    assert "unrelated_total" not in names
    q99 = [s for s in port_out["series"][
        "sparkml_serve_request_latency_seconds"]
        if s["labels"].get("quantile") == "0.99"]
    assert len(q99) == 1 and len(q99[0]["points"]) == 30
    # both children were sampled at 0 first: the history's delta is the
    # registry's whole count
    assert port_out["delta"] == port_out["registry_total"]
    assert port_out["sweeps"] == 31


def test_sampler_publishes_its_own_overhead():
    reg = port_metrics.MetricsRegistry()
    clock = FakeClock()
    store = port_tsdb.TimeSeriesStore(tiers=((1.0, 300.0),), clock=clock)
    sampler = port_tsdb.MetricsSampler(store, registry=reg,
                                       interval_seconds=1.0, clock=clock)
    sampler.sample_once(now=1000.0)
    overhead = reg.counter("sparkml_obs_overhead_seconds_total", "",
                           ("component",))
    assert overhead.value(component="sampler") > 0.0
    assert reg.counter("sparkml_obs_samples_total", "").value() == 0.0
    # the overhead counter is prefix-matched: the next sweep samples it
    assert sampler.sample_once(now=1001.0) > 0
    clock.t = 1002.0
    assert store.range_query("sparkml_obs_overhead_seconds_total",
                             window=10.0)


def test_sampler_collectors_run_and_a_broken_one_is_counted():
    def run(tsdb, metrics):
        reg = metrics.MetricsRegistry()
        clock = FakeClock()
        store = tsdb.TimeSeriesStore(tiers=((1.0, 300.0),), clock=clock)
        sampler = tsdb.MetricsSampler(store, registry=reg,
                                      interval_seconds=1.0, clock=clock)
        calls, hooks = [], []

        def good():
            calls.append(1)

        def broken():
            raise RuntimeError("boom")

        sampler.register_collector(good)
        sampler.register_collector(good)  # idempotent
        sampler.register_collector(broken)
        sampler.register_post_sweep(hooks.append)
        sampler.sample_once(now=1000.0)
        errs = reg.counter("sparkml_obs_collector_errors_total", "",
                           ("collector",))
        first = errs.value(collector="broken")
        sampler.unregister_collector(broken)
        sampler.unregister_post_sweep(hooks.append)
        sampler.sample_once(now=1001.0)
        return {"calls": calls, "hooks": hooks, "first": first,
                "after": errs.value(collector="broken")}

    jax_out, port_out = _both(run)
    assert port_out == jax_out
    assert port_out == {"calls": [1, 1], "hooks": [1000.0], "first": 1.0,
                        "after": 1.0}


def test_sampler_background_thread_runs_and_stops():
    reg = port_metrics.MetricsRegistry()
    reg.gauge("sparkml_serve_queue_depth", "", ("model",)).set(1, model="m")
    sampler = port_tsdb.MetricsSampler(
        port_tsdb.TimeSeriesStore(tiers=((0.01, 10.0),)), registry=reg,
        interval_seconds=0.02)
    swept = threading.Event()
    sampler.register_post_sweep(
        lambda _ts: sampler.sweeps >= 3 and swept.set())
    sampler.start()
    sampler.start()  # idempotent
    try:
        assert swept.wait(30.0)
    finally:
        sampler.stop()
    assert not sampler.running
    sweeps = sampler.sweeps
    assert sweeps >= 3
    assert sampler.sweeps == sweeps  # really stopped: the thread is joined


def test_concurrent_record_and_query_8_threads():
    store = port_tsdb.TimeSeriesStore(tiers=((0.001, 1.0), (0.01, 10.0)))
    stop = threading.Event()
    errors = []
    written = [0] * 4

    def writer(i):
        n = 0
        while not stop.is_set() or n < 200:
            try:
                store.record("c", {"w": str(i)}, n, kind="counter")
                store.record("g", {"w": str(i)}, n % 7)
                n += 1
            except Exception as exc:  # pragma: no cover
                errors.append(exc)
                return
        written[i] = n

    def reader():
        while not stop.is_set():
            try:
                for s in store.range_query("c", window=5.0):
                    pts = s["points"]
                    assert all(a[0] <= b[0] for a, b in zip(pts, pts[1:]))
                store.rate("c", window=5.0)
                store.history_tail(prefixes=("c", "g"), window=5.0)
            except Exception as exc:  # pragma: no cover
                errors.append(exc)
                return

    threads = ([threading.Thread(target=writer, args=(i,)) for i in range(4)]
               + [threading.Thread(target=reader) for _ in range(4)])
    for t in threads:
        t.start()
    time.sleep(0.2)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert min(written) >= 200
    assert store.series_count() == 8  # 4 writers x 2 names


# -- the process-wide sampler -------------------------------------------------


def test_start_sampling_registers_the_device_monitor(monkeypatch):
    """The device monitor's ``sample`` and, beside it, the fit monitor's
    watchdog collector, as the JAX ``start_sampling`` registers them."""
    from spark_rapids_ml_tpu_torch.obs import devmon, fitmon

    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    devmon.reset_device_monitor()
    fitmon.reset_fitmon()
    port_tsdb.reset_tsdb()
    try:
        sampler = port_tsdb.start_sampling(interval_seconds=3600.0)
        assert sampler is port_tsdb.get_sampler() and sampler.running
        assert sampler.interval_seconds == 3600.0
        assert port_tsdb.start_sampling() is sampler  # idempotent
        assert sampler._collectors == [
            devmon.get_device_monitor().sample,
            fitmon.get_fit_monitor().watchdog_collector]
        port_tsdb.stop_sampling()
        assert not sampler.running
        sampler.sample_once()
        series = port_tsdb.get_tsdb().range_query(
            "sparkml_device_mem_bytes_in_use", {"device": "cpu"},
            window=60.0)
        assert series and series[0]["labels"]["source"] == "host_rss"
        # the CPU was asked for: the watchdog's verdict is healthy
        (ok,) = port_tsdb.get_tsdb().range_query(
            "sparkml_fit_backend_ok", {}, window=60.0)
        assert ok["points"][-1][1] == 1.0
    finally:
        port_tsdb.reset_tsdb()
        devmon.reset_device_monitor()
        fitmon.reset_fitmon()
