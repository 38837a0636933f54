"""The port's ``obs/incidents.py`` against the JAX package's, and the JAX
file's lifecycle cases on the port.

The same seeded sequence of findings, under one injected clock, goes
through a JAX ``IncidentManager`` and a port one: the returned openings and
every snapshot are equal, leaving out the evidence paths (each package
writes its bundles under its own dump directory). Then hysteresis, dedup,
cooldown, distinct series, the evidence bundle on disk, the single-flight
capture, escalation from the burn, the engine inside the sampler's sweep, a
broken detector, retention of the ``incident`` kind and the clock-injection
rule — all with injected timestamps and no sleeps.
"""

import json
import os
import sys

import numpy as np
import pytest

from spark_rapids_ml_tpu.obs import anomaly as jax_anomaly
from spark_rapids_ml_tpu.obs import flight as jax_flight
from spark_rapids_ml_tpu.obs import incidents as jax_incidents
from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu.obs import tsdb as jax_tsdb
from spark_rapids_ml_tpu_torch.obs import anomaly, flight, incidents
from spark_rapids_ml_tpu_torch.obs import profiler as profiler_mod
from spark_rapids_ml_tpu_torch.obs import retention, tsdb
from spark_rapids_ml_tpu_torch.obs.anomaly import Finding, ThresholdDetector
from spark_rapids_ml_tpu_torch.obs.incidents import (
    IncidentEngine,
    IncidentManager,
)
from spark_rapids_ml_tpu_torch.obs.metrics import MetricsRegistry
from spark_rapids_ml_tpu_torch.obs.tsdb import MetricsSampler, TimeSeriesStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _finding(detector="det", kind="saturation", severity="warning",
             labels=None, value=50.0, module=anomaly):
    return module.Finding(
        detector=detector, kind=kind, severity=severity,
        metric="sparkml_serve_queue_depth",
        labels=labels if labels is not None else {"model": "m"},
        value=value, baseline=2.0, reason="test finding")


@pytest.fixture
def dump_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(flight.DUMP_DIR_ENV, str(tmp_path / "dumps"))
    monkeypatch.delenv(profiler_mod.PROFILE_DIR_ENV, raising=False)
    return tmp_path / "dumps"


@pytest.fixture
def manager(dump_dir):
    return IncidentManager(open_after=2, resolve_after=3,
                           cooldown_seconds=30.0, capture_seconds=0.0,
                           registry=MetricsRegistry())


# -- the lifecycle equals the reference's -------------------------------------


def _without_evidence(snapshot):
    doc = {k: v for k, v in snapshot.items() if k != "evidence_root"}
    for key in ("open", "recent"):
        doc[key] = [{k: v for k, v in inc.items() if k != "evidence"}
                    for inc in doc[key]]
    return doc


SWEEP_KEYS = [("lat", "latency", {"model": "a"}),
              ("lat", "latency", {"model": "b"}),
              ("qd", "saturation", {"model": "a"}),
              ("err", "errors", {"model": "c", "tenant": "t"})]


def _sweeps(seed, n=60):
    """Per sweep: (now, [(detector, kind, severity, labels, value)], burn)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        fire = rng.random(len(SWEEP_KEYS)) < (0.75 if (i // 12) % 2 == 0
                                               else 0.1)
        findings = [
            (det, kind, str(rng.choice(jax_anomaly.SEVERITIES)),
             dict(labels), float(rng.normal(50.0, 10.0)))
            for (det, kind, labels), on in zip(SWEEP_KEYS, fire) if on]
        burn = float(rng.choice([0.0, 0.5, 2.0, 7.0, 20.0]))
        out.append((1000.0 + 2.0 * i, findings, burn))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_manager_lifecycle_equals_the_reference(seed, tmp_path,
                                                monkeypatch):
    monkeypatch.setenv(flight.DUMP_DIR_ENV, str(tmp_path / "port"))
    monkeypatch.setenv(jax_flight.DUMP_DIR_ENV, str(tmp_path / "jax"))
    knobs = dict(open_after=2, resolve_after=3, cooldown_seconds=9.0,
                 capture_seconds=0.0)
    ours = IncidentManager(registry=MetricsRegistry(), **knobs)
    theirs = jax_incidents.IncidentManager(
        registry=jax_metrics.MetricsRegistry(), **knobs)
    clock = FakeClock()
    stores = (TimeSeriesStore(tiers=((1.0, 600.0),), clock=clock),
              jax_tsdb.TimeSeriesStore(tiers=((1.0, 600.0),), clock=clock))
    opened_any = resolved_any = suppressed_any = False
    for now, findings, burn in _sweeps(seed):
        clock.t = now
        for store in stores:
            store.record("sparkml_slo_burn_rate",
                         {"slo": "serve_availability", "window": "5m"},
                         burn, now=now)
        got = ours.observe(
            [_finding(d, k, s, lab, v) for d, k, s, lab, v in findings],
            now, store=stores[0])
        want = theirs.observe(
            [_finding(d, k, s, lab, v, module=jax_anomaly)
             for d, k, s, lab, v in findings], now, store=stores[1])
        assert [i.id for i in got] == [i.id for i in want]
        assert _without_evidence(ours.snapshot()) == \
            _without_evidence(theirs.snapshot())
        opened_any = opened_any or bool(got)
        resolved_any = resolved_any or ours.resolved_total > 0
        suppressed_any = suppressed_any or ours.suppressed_total > 0
    assert opened_any and resolved_any and suppressed_any
    for name, labelnames in (
            ("sparkml_obs_incidents_total", ("detector", "severity")),
            ("sparkml_obs_incidents_suppressed_total", ("detector",))):
        a = ours._reg().counter(name, "", labelnames)
        b = theirs._reg().counter(name, "", labelnames)
        assert sorted((k, c.value) for k, c in a._samples()) == \
            sorted((k, c.value) for k, c in b._samples())
    assert ours._reg().gauge("sparkml_obs_incidents_open").value() == \
        theirs._reg().gauge("sparkml_obs_incidents_open").value()
    # both bundles hold the record and its trace document
    for inc in ours.snapshot()["recent"] + ours.snapshot()["open"]:
        bundle = inc["evidence"]["dir"]
        assert bundle.startswith(str(tmp_path / "port"))
        assert os.path.isfile(os.path.join(bundle, "incident.json"))
        assert os.path.isfile(os.path.join(bundle, "traces.json"))


def test_incident_dict_and_digest_equal_the_reference(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv(flight.DUMP_DIR_ENV, str(tmp_path / "port"))
    monkeypatch.setenv(jax_flight.DUMP_DIR_ENV, str(tmp_path / "jax"))
    engines = []
    for inc_mod, met_mod, an_mod, ts_mod in (
            (incidents, MetricsRegistry, anomaly, tsdb),
            (jax_incidents, jax_metrics.MetricsRegistry, jax_anomaly,
             jax_tsdb)):
        reg = met_mod()
        store = ts_mod.TimeSeriesStore(tiers=((1.0, 600.0),),
                                       clock=FakeClock())
        engine = inc_mod.IncidentEngine(
            store=store, detectors=[], registry=reg,
            manager=inc_mod.IncidentManager(
                open_after=1, resolve_after=1, cooldown_seconds=0.0,
                capture_seconds=0.0, registry=reg))
        engine.manager.observe(
            [_finding(labels={"model": "a"}, module=an_mod),
             _finding("e", "errors", labels={"model": "b"}, module=an_mod)],
            1000.0)
        engine.manager.observe(
            [_finding("e", "errors", labels={"model": "b"}, module=an_mod)],
            1001.0)
        engines.append(engine)
    ours, theirs = engines
    assert ours.digest() == theirs.digest()
    assert ours.digest(recent_limit=0) == theirs.digest(recent_limit=0)
    assert set(ours.snapshot()) == set(theirs.snapshot())
    assert incidents.enabled() and jax_incidents.enabled()
    assert set(incidents.__all__) == set(jax_incidents.__all__)


@pytest.mark.parametrize("value, expected", [
    (None, True), ("1", True), ("yes", True), ("0", False),
    ("false", False), (" OFF ", False), ("no", False)])
def test_kill_switch_reads_as_the_reference(value, expected, monkeypatch):
    for env in (incidents.ENABLED_ENV, jax_incidents.ENABLED_ENV):
        if value is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, value)
    assert incidents.ENABLED_ENV == "SPARK_RAPIDS_ML_TORCH_OBS_INCIDENTS"
    assert incidents.enabled() is jax_incidents.enabled() is expected


def test_env_knobs_take_the_port_prefix(dump_dir, monkeypatch):
    monkeypatch.setenv(incidents.OPEN_AFTER_ENV, "4")
    monkeypatch.setenv(incidents.RESOLVE_AFTER_ENV, "0")
    monkeypatch.setenv(incidents.COOLDOWN_ENV, "7.5")
    monkeypatch.setenv(incidents.CAPTURE_ENV, "garbage")
    mgr = IncidentManager(registry=MetricsRegistry())
    assert (mgr.open_after, mgr.resolve_after, mgr.cooldown_seconds,
            mgr.capture_seconds) == (4, 1, 7.5, 3.0)
    assert all(env.startswith("SPARK_RAPIDS_ML_TORCH_OBS_INCIDENT")
               for env in (incidents.OPEN_AFTER_ENV,
                           incidents.RESOLVE_AFTER_ENV,
                           incidents.COOLDOWN_ENV, incidents.CAPTURE_ENV))
    assert mgr.evidence_root() == os.path.join(str(dump_dir), "incidents")


# -- the JAX file's lifecycle cases, on the port -------------------------------


def test_hysteresis_needs_consecutive_firing_sweeps(manager):
    assert manager.observe([_finding()], now=1000.0) == []
    # the streak BROKE: one quiet sweep resets it
    assert manager.observe([], now=1001.0) == []
    assert manager.observe([_finding()], now=1002.0) == []
    opened = manager.observe([_finding()], now=1003.0)
    assert len(opened) == 1
    assert opened[0].opened_ts == 1003.0
    assert manager.opened_total == 1


def test_dedup_continued_firing_updates_not_duplicates(manager):
    manager.observe([_finding(value=50.0)], now=1000.0)
    (incident,) = manager.observe([_finding(value=50.0)], now=1001.0)
    for i in range(5):
        assert manager.observe([_finding(value=60.0 + i)],
                               now=1002.0 + i) == []
    assert manager.opened_total == 1
    snap = manager.snapshot()
    assert len(snap["open"]) == 1
    assert snap["open"][0]["id"] == incident.id
    assert snap["open"][0]["updates"] == 5
    assert snap["open"][0]["value"] == 64.0  # latest firing value


def test_resolve_after_quiet_sweeps_and_cooldown_suppression(manager):
    manager.observe([_finding()], now=1000.0)
    (incident,) = manager.observe([_finding()], now=1001.0)
    manager.observe([], now=1002.0)
    manager.observe([], now=1003.0)
    assert len(manager.open_incidents()) == 1
    manager.observe([], now=1004.0)
    assert manager.open_incidents() == []
    (recent,) = manager.recent_incidents()
    assert recent["id"] == incident.id
    assert recent["state"] == "resolved"
    assert recent["resolved_ts"] == 1004.0
    assert manager.resolved_total == 1
    # refire inside the cooldown: suppressed, counted, never opened
    for i in range(6):
        assert manager.observe([_finding()], now=1010.0 + i) == []
    assert manager.suppressed_total > 0
    assert manager._reg().counter(
        "sparkml_obs_incidents_suppressed_total", "", ("detector",),
    ).value(detector="det") == manager.suppressed_total
    # past the cooldown the key can open again (fresh hysteresis)
    manager.observe([_finding()], now=1040.0)
    opened = manager.observe([_finding()], now=1041.0)
    assert len(opened) == 1 and opened[0].id != incident.id


def test_distinct_series_open_distinct_incidents(manager):
    a = _finding(labels={"model": "a"})
    b = _finding(labels={"model": "b"})
    manager.observe([a, b], now=1000.0)
    opened = manager.observe([a, b], now=1001.0)
    assert len(opened) == 2
    assert manager._reg().gauge(
        "sparkml_obs_incidents_open", "").value() == 2.0
    # same detector, same sweep, same millisecond: distinct ids and dirs
    assert opened[0].id != opened[1].id
    assert opened[0].evidence["dir"] != opened[1].evidence["dir"]


def test_evidence_bundle_lands_on_disk(manager, dump_dir):
    store = TimeSeriesStore(tiers=((1.0, 600.0),),
                            clock=FakeClock(1100.0))
    for i in range(30):
        store.record("sparkml_serve_queue_depth", {"model": "m"},
                     float(i), now=1000.0 + i)
    manager.observe([_finding()], now=1029.0, store=store)
    (incident,) = manager.observe([_finding()], now=1030.0, store=store)
    evidence = incident.evidence
    bundle = evidence["dir"]
    assert os.path.isdir(bundle)
    assert str(dump_dir) in bundle
    with open(os.path.join(bundle, "incident.json")) as f:
        doc = json.load(f)
    assert doc["id"] == incident.id
    assert doc["detector"] == "det"
    assert doc["state"] == "open"
    with open(os.path.join(bundle, "history.json")) as f:
        history = json.load(f)
    implicated = history["implicated"]
    assert implicated["metric"] == "sparkml_serve_queue_depth"
    assert implicated["series"] and implicated["series"][0]["points"]
    assert set(history) == {"window_seconds", "implicated", "context"}
    with open(os.path.join(bundle, "traces.json")) as f:
        assert set(json.load(f)) == {"exemplars", "trees"}
    # the breaker section rides in when the serving tier registered it
    if flight.run_dump_section("breaker_events") is not None:
        assert os.path.isfile(evidence["breakers"])
    # the flight dump is a real dump in the same dump dir
    assert evidence["flight_dump"] and os.path.isfile(
        evidence["flight_dump"])
    with open(evidence["flight_dump"]) as f:
        dump_doc = json.load(f)
    assert dump_doc["extra"]["incident_id"] == incident.id
    assert dump_doc["reason"] == "incident:det"
    assert evidence["profile"] == {"skipped": "disabled"}
    # resolve rewrites incident.json with the final state
    for i in range(3):
        manager.observe([], now=1031.0 + i, store=store)
    with open(os.path.join(bundle, "incident.json")) as f:
        assert json.load(f)["state"] == "resolved"


def test_profile_capture_guarded_single_flight(dump_dir, monkeypatch):
    calls = []

    def fake_start(seconds, label="x"):
        calls.append((seconds, label))
        if len(calls) > 1:
            raise profiler_mod.CaptureInFlight("already running")
        return {"id": "cap1", "seconds": seconds}

    monkeypatch.setattr(profiler_mod, "start_capture", fake_start)
    manager = IncidentManager(open_after=1, resolve_after=1,
                              cooldown_seconds=0.0, capture_seconds=2.0,
                              registry=MetricsRegistry())
    latency = _finding(detector="lat", kind="latency",
                       labels={"model": "a"})
    (first,) = manager.observe([latency], now=1000.0)
    assert first.evidence["profile"]["started"]["id"] == "cap1"
    assert calls[0][0] == 2.0 and "incident_lat" in calls[0][1]
    # a second latency incident while the capture runs: skipped, not
    # stacked, and the skip is recorded in the bundle
    other = _finding(detector="lat2", kind="memory", labels={"model": "b"})
    (second,) = manager.observe([latency, other], now=1001.0)
    assert second.evidence["profile"] == {"skipped": "capture_in_flight"}
    # non-latency/memory kinds never trigger a capture
    err = _finding(detector="errs", kind="errors", labels={"model": "c"})
    (third,) = manager.observe([latency, other, err], now=1002.0)
    assert third.evidence["profile"] == {"skipped": "kind_errors"}
    assert len(calls) == 2


def test_profile_capture_error_is_recorded(dump_dir, monkeypatch):
    def broken_start(seconds, label="x"):
        raise RuntimeError("no CUDA device is available")

    monkeypatch.setattr(profiler_mod, "start_capture", broken_start)
    manager = IncidentManager(open_after=1, capture_seconds=1.0,
                              registry=MetricsRegistry())
    (incident,) = manager.observe(
        [_finding(detector="lat", kind="latency")], now=1000.0)
    assert incident.evidence["profile"] == {
        "error": "RuntimeError: no CUDA device is available"}


@pytest.mark.parametrize("burn, detector_severity, expected", [
    (120.0, "warning", "critical"),   # burn >= page_fast 14.4
    (7.0, "warning", "serious"),      # >= page_slow 6.0
    (7.0, "critical", "critical"),    # never de-escalates
    (0.5, "warning", "warning"),      # inside budget: the detector's own
])
def test_severity_escalates_from_live_burn(dump_dir, burn,
                                           detector_severity, expected):
    store = TimeSeriesStore(tiers=((1.0, 600.0),),
                            clock=FakeClock(1000.0))
    store.record("sparkml_slo_burn_rate",
                 {"slo": "serve_availability", "window": "5m"},
                 burn, now=999.0)
    manager = IncidentManager(open_after=1, resolve_after=1,
                              cooldown_seconds=0.0, capture_seconds=0.0,
                              registry=MetricsRegistry())
    (incident,) = manager.observe([_finding(severity=detector_severity)],
                                  now=1000.0, store=store)
    assert incident.severity == expected
    assert manager._reg().counter(
        "sparkml_obs_incidents_total", "", ("detector", "severity"),
    ).value(detector="det", severity=expected) == 1.0


# -- the engine on the sampler: no new thread, cost visible --------------------


def test_engine_runs_inside_sampler_sweep(dump_dir):
    clock = FakeClock(1000.0)
    reg = MetricsRegistry()
    gauge = reg.gauge("sparkml_serve_queue_depth", "", ("model",))
    store = TimeSeriesStore(tiers=((1.0, 600.0),), clock=clock)
    sampler = MetricsSampler(store, registry=reg, interval_seconds=1.0,
                             clock=clock)
    engine = IncidentEngine(
        store=store,
        detectors=[ThresholdDetector(
            "qd", "sparkml_serve_queue_depth", threshold=10.0,
            kind="saturation")],
        manager=IncidentManager(open_after=2, resolve_after=2,
                                cooldown_seconds=0.0,
                                capture_seconds=0.0, registry=reg),
        registry=reg,
    )
    try:
        engine.install(sampler)
        engine.install(sampler)  # idempotent: one sweep per sample
        gauge.set(2, model="m")
        sampler.sample_once(now=1000.0)
        assert engine.sweeps == 1  # detection ran inside the sweep
        gauge.set(99, model="m")
        sampler.sample_once(now=1001.0)
        sampler.sample_once(now=1002.0)
        snap = engine.snapshot()
        assert len(snap["open"]) == 1
        assert snap["open"][0]["detector"] == "qd"
        assert snap["sweeps"] == 3
        assert snap["detectors"] == [engine.detectors[0].describe()]
        # the detector sweep cost is visible in the obs overhead counter
        assert reg.counter(
            "sparkml_obs_overhead_seconds_total", "", ("component",),
        ).value(component="anomaly") > 0.0
        # open incidents ride every flight dump via the registered section
        doc = flight.build_dump("test_incident_section")
        assert doc["incidents"]["open"][0]["detector"] == "qd"
        # recovery resolves through the same sweep path
        gauge.set(1, model="m")
        sampler.sample_once(now=1003.0)
        sampler.sample_once(now=1004.0)
        assert engine.snapshot()["open"] == []
        assert engine.snapshot()["resolved_total"] == 1
    finally:
        engine.uninstall(sampler)
    assert "incidents" not in flight._dump_sections
    sampler.sample_once(now=1005.0)
    assert engine.sweeps == 5  # uninstalled: the sweep no longer detects


def test_broken_detector_counted_never_kills_sweep(dump_dir):
    reg = MetricsRegistry()

    class Broken:
        name = "broken"

        def evaluate(self, store, now):
            raise RuntimeError("boom")

        def describe(self):
            return {"name": self.name}

    store = TimeSeriesStore(tiers=((1.0, 60.0),), clock=FakeClock())
    engine = IncidentEngine(
        store=store,
        detectors=[Broken(), ThresholdDetector(
            "qd", "sparkml_serve_queue_depth", threshold=1.0)],
        manager=IncidentManager(registry=reg, open_after=1,
                                capture_seconds=0.0),
        registry=reg)
    store.record("sparkml_serve_queue_depth", {"model": "m"}, 5.0,
                 now=999.0)
    opened = engine.sweep(now=1000.0)
    assert [i.detector for i in opened] == ["qd"]  # the rest still ran
    assert reg.counter(
        "sparkml_obs_detector_errors_total", "", ("detector",),
    ).value(detector="broken") == 1.0


def test_process_wide_engine_and_reset(dump_dir):
    incidents.reset_incident_engine()
    try:
        engine = incidents.get_incident_engine()
        assert incidents.get_incident_engine() is engine
        assert [d.name for d in engine.detectors] == [
            d.name for d in anomaly.builtin_detectors()]
        sampler = tsdb.get_sampler()
        engine.install(sampler)
        assert engine._post_sweep in sampler._post_hooks
        assert "incidents" in flight._dump_sections
        incidents.reset_incident_engine()
        assert engine._post_sweep not in sampler._post_hooks
        assert "incidents" not in flight._dump_sections
        assert incidents.get_incident_engine() is not engine
    finally:
        incidents.reset_incident_engine()
        tsdb.reset_tsdb()


# -- retention of the incident kind --------------------------------------------


def _mk_file(path, size, mtime):
    path.write_bytes(b"x" * size)
    os.utime(path, (mtime, mtime))


def test_retention_byte_cap_on_incident_directories(tmp_path):
    root = tmp_path / "incidents"
    root.mkdir()
    for i in range(4):
        d = root / f"inc_{i}"
        d.mkdir()
        _mk_file(d / "incident.json", 1000, 1000.0 + i)
        os.utime(d, (1000.0 + i, 1000.0 + i))
    removed = retention.sweep_kind("incident", root=str(root),
                                   dirs=True, keep_count=0,
                                   keep_bytes=2500)
    assert removed == 2
    assert sorted(p.name for p in root.iterdir()) == ["inc_2", "inc_3"]


def test_an_opened_bundle_sweeps_the_incident_kind(dump_dir, monkeypatch):
    monkeypatch.setenv(retention.MAX_COUNT_ENV, "2")
    monkeypatch.setattr(retention, "_last_sweep", {})
    root = dump_dir / "incidents"
    root.mkdir(parents=True)
    for i in range(3):
        d = root / f"inc_old_{i}"
        d.mkdir()
        _mk_file(d / "incident.json", 10, 1000.0 + i)
        os.utime(d, (1000.0 + i, 1000.0 + i))
    assert retention._kind_root("incident") == (str(root), True)
    registry = MetricsRegistry()
    manager = IncidentManager(open_after=1, capture_seconds=0.0,
                              registry=registry)
    (incident,) = manager.observe([_finding()], now=5000.0)
    left = sorted(p.name for p in root.iterdir())
    assert os.path.basename(incident.evidence["dir"]) in left
    assert left == sorted(["inc_old_2", os.path.basename(
        incident.evidence["dir"])])


# -- the clock-injection rule holds the port's clocked modules -----------------


def test_rule8_finds_no_wall_clock_read_in_the_port():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        from check_instrumentation import check_clock_injection
    finally:
        sys.path.pop(0)
    for name in ("tsdb.py", "anomaly.py", "incidents.py"):
        path = os.path.join(REPO, "spark_rapids_ml_tpu_torch", "obs", name)
        assert list(check_clock_injection(path)) == [], path
