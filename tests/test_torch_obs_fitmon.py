"""The port's fit-path monitor (``obs.fitmon``), peak tables
(``utils.platform``) and cost seam (``obs.xprof``), held against the JAX
package's ``obs.fitmon`` on the same fixtures and one injected clock.

The pure roofline and skew functions equal the JAX ones; the same scripted
run gives the same run, step and rollup records and the same
``sparkml_fit_*`` children, but for durations (wall seconds and rows/s,
measured on the host clock); the watchdog's verdict matrix gives the JAX
reasons; a platform mismatch and a wedged canary each open exactly one
``fit_backend_degraded`` incident through the port's sampler, builtin
detector and incident engine, which resolves once the watchdog recovers;
a disabled monitor is inert; the peak override, the CPU's absent peaks and
the H100's table entry; ``debug_fit_doc``'s keys and ``GET /debug/fit``.
Every test takes a metrics registry of its own in both packages (the
defaults are process-wide) and drops the fit-monitor singletons after it.
"""

import http.client
import json
import threading

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.obs import devmon as jax_devmon
from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu_torch import PCAModel
from spark_rapids_ml_tpu_torch.obs import (
    anomaly,
    devmon,
    fitmon,
    flight,
    incidents,
    metrics,
    profiler,
    tsdb,
    xprof,
)
from spark_rapids_ml_tpu_torch.obs.incidents import (
    IncidentEngine,
    IncidentManager,
)
from spark_rapids_ml_tpu_torch.serve import (
    ModelRegistry,
    ServeEngine,
    start_serve_server,
)
from spark_rapids_ml_tpu_torch.utils import platform

PEAK_FLOPS = 1.0e12
PEAK_BW = 1.0e11
H100 = "NVIDIA H100 80GB HBM3"
PACKAGES = {"jax": jax_fitmon, "torch": fitmon}
# the record fields measured on the host clock: they differ run to run
DURATIONS = ("wall_seconds", "rows_per_sec", "canary_seconds")


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t


class FakeDevice:
    def __init__(self, platform="cpu", device_kind="cpu"):
        self.platform = platform
        self.device_kind = device_kind


@pytest.fixture(autouse=True)
def registries(monkeypatch):
    """A fresh registry in each package, the CPU requested, and no
    fit-monitor or device-monitor singleton leaking across tests."""
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    for name in ("SPARK_RAPIDS_ML_TORCH_FITMON_PEAK_FLOPS",
                 "SPARK_RAPIDS_ML_TORCH_FITMON_PEAK_BW",
                 "SPARK_RAPIDS_ML_TORCH_FITMON_EXPECT_PLATFORM"):
        monkeypatch.delenv(name, raising=False)
    regs = {"torch": metrics.MetricsRegistry(),
            "jax": jax_metrics.MetricsRegistry()}
    monkeypatch.setattr(metrics, "_default_registry", regs["torch"])
    monkeypatch.setattr(jax_metrics, "_default_registry", regs["jax"])
    fitmon.reset_fitmon()
    # each package's device monitor binds its counters to the registry
    # current when it is made: drop both on each side of the swap
    devmon.reset_device_monitor()
    jax_devmon.reset_device_monitor()
    yield regs
    fitmon.reset_fitmon()
    devmon.reset_device_monitor()
    jax_devmon.reset_device_monitor()


def _watchdog(mod, **kw):
    kw.setdefault("expected_platform", None)
    kw.setdefault("interval_s", 30.0)
    kw.setdefault("clock", FakeClock())
    kw.setdefault("devices_fn", lambda: [FakeDevice()])
    kw.setdefault("canary_fn", lambda: None)
    return mod.BackendWatchdog(**kw)


def _monitor(mod, clock=None, enabled=True, peaks=(PEAK_FLOPS, PEAK_BW),
             watchdog=None):
    clock = clock if clock is not None else FakeClock()
    return mod.FitMonitor(
        enabled=enabled, clock=clock, peaks_fn=lambda: peaks,
        watchdog=watchdog if watchdog is not None
        else _watchdog(mod, clock=clock))


def _strip(obj):
    """A document without its host-clock durations."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in DURATIONS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


# -- the pure functions -------------------------------------------------------

PURE_CASES = [
    ("step_mfu", (1.0e12, 2.0, PEAK_FLOPS)),
    ("step_mfu", (5.0e11, 1.0, PEAK_FLOPS)),
    ("step_mfu", (None, 2.0, PEAK_FLOPS)),
    ("step_mfu", (1.0e12, None, PEAK_FLOPS)),
    ("step_mfu", (1.0e12, 0.0, PEAK_FLOPS)),
    ("step_mfu", (1.0e12, 2.0, None)),
    ("step_mfu", (0.0, 2.0, PEAK_FLOPS)),
    ("roofline_bound", (1.0e9, 1.0e6, PEAK_FLOPS, PEAK_BW)),
    ("roofline_bound", (1.0e6, 1.0e6, PEAK_FLOPS, PEAK_BW)),
    ("roofline_bound", (10.0, 1.0, PEAK_FLOPS, PEAK_BW)),
    ("roofline_bound", (None, 1.0e6, PEAK_FLOPS, PEAK_BW)),
    ("roofline_bound", (1.0e6, None, PEAK_FLOPS, PEAK_BW)),
    ("roofline_bound", (1.0e6, 1.0e6, None, PEAK_BW)),
    ("roofline_bound", (1.0e6, 1.0e6, PEAK_FLOPS, None)),
    # the H100's ridge (989e12 / 3.35e12 ≈ 295 FLOP/B) against a 262,144 ×
    # 4096 float32 Gram's intensity (≈ 1008 FLOP/B)
    ("roofline_bound", (262144 * 4096 * 4097,
                        262144 * 4096 * 4 + 4096 * 4096 * 4,
                        989e12, 3.35e12)),
    ("detect_stragglers", ({"host0": 0.10, "host1": 0.11, "host2": 0.45},
                           1.5)),
    ("detect_stragglers", ({"a": 1.0, "b": 1.0, "c": 1.5}, 1.5)),
    ("detect_stragglers", ({"a": 1.0, "b": 3.0, "c": 0.5, "d": 2.0}, 1.2)),
    ("detect_stragglers", ({"only": 99.0},)),
    ("detect_stragglers", ({},)),
]


@pytest.mark.parametrize("name,args", PURE_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(PURE_CASES)])
def test_pure_functions_equal_the_jax_ones(name, args):
    ours = getattr(fitmon, name)(*args)
    theirs = getattr(jax_fitmon, name)(*args)
    assert ours == theirs
    if name == "roofline_bound" and args[2] == 989e12:
        assert ours == "compute"


# -- run and step records -----------------------------------------------------


def _scripted(mod):
    """One scripted monitor history on an injected clock; the same calls
    in either package."""
    clock = FakeClock(1000.0)
    monitor = _monitor(mod, clock=clock)
    run = monitor.start_run("distributed_pca", trace_id="tr-1")
    with run.step("gram", rows=4096) as mon:
        run.record_program("gram", 1.0e12, 1.0e8)
        mon.set_device_seconds(2.0)
        mon.note(n_iter=3, cost=0.125, junk="not-a-number")
    clock.t = 1010.0
    with run.step("eigh") as mon:
        mon.set_device_seconds(0.5)
    with pytest.raises(RuntimeError):
        with run.step("lloyd", rows=128) as mon:
            mon.set_device_seconds(0.25)
            raise RuntimeError("kernel blew up")
    run.record_program("outside_a_step", 3.0e9, 1.0e6)
    for _ in range(4):
        run.note_host_step("host0", 0.10)
        run.note_host_step("host1", 0.11)
        run.note_host_step("host2", 0.45)
    run.record_collective("psum", nbytes=1024, count=3, seconds=0.01)
    run.record_collective("psum", nbytes=1024)
    run.note(batches_streamed=4)
    clock.t = 1020.0
    monitor.finish_run(run, report={"k": 3})
    active = monitor.start_run("distributed_kmeans")
    with active.step("lloyd", rows=64) as mon:
        mon.set_device_seconds(0.2)
    monitor.watchdog.check()
    return monitor, run


def _fit_children(reg):
    """Every ``sparkml_fit_*`` child but the host-clock ones."""
    out = {}
    for name, family in reg.snapshot().items():
        if not name.startswith("sparkml_fit_") or name in (
                "sparkml_fit_step_seconds_total",
                "sparkml_fit_rows_per_sec"):
            continue
        out[name] = sorted(
            (tuple(sorted(s["labels"].items())), s.get("value"))
            for s in family["samples"])
    return out


def test_run_and_step_records_equal_the_jax_ones(registries):
    docs = {}
    for pkg, mod in PACKAGES.items():
        monitor, run = _scripted(mod)
        assert run.steps_total == 3 and run.steps_failed == 1
        docs[pkg] = {
            "run": _strip(run.as_dict()),
            "debug": _strip(monitor.debug_doc()),
            "report": _strip(monitor.fit_report()),
            "children": _fit_children(registries[pkg]),
        }
    ours, theirs = docs["torch"], docs["jax"]
    assert ours["run"] == theirs["run"]
    assert ours["debug"] == theirs["debug"]
    assert ours["report"] == theirs["report"]
    assert ours["children"] == theirs["children"]
    # the program cost landed in the first step only (delta attribution),
    # the call outside every step in the run's total only
    gram, eigh, lloyd = ours["run"]["step_table"]
    assert gram["flops"] == 1.0e12 and gram["mfu"] == pytest.approx(0.5)
    assert gram["bound"] == "compute" and eigh["flops"] is None
    assert lloyd["failed"] is True
    assert ours["run"]["flops"] == 1.0e12 + 3.0e9
    assert ours["run"]["stragglers"] == ["host2"]


def test_fit_run_context_and_current_run(monkeypatch):
    monitor = _monitor(fitmon)
    monkeypatch.setattr(fitmon, "_monitor", monitor)
    assert fitmon.current_run() is fitmon._NULL_RUN
    with fitmon.fit_run("distributed_pca") as run:
        assert fitmon.current_run() is run
        # the xprof seam attributes to the current run only
        xprof.record_execution("centered_gram", 2.0e9, 4.0e6)
        with run.step("power_iter", rows=64) as mon:
            mon.set_device_seconds(0.25)
    assert fitmon.current_run() is fitmon._NULL_RUN
    xprof.record_execution("centered_gram", 1.0, 1.0)  # no run: no-op
    (done,) = monitor.recent_runs()
    assert done.algo == "distributed_pca" and not done.active
    assert (done.flops_total, done.bytes_total) == (2.0e9, 4.0e6)


def test_step_publishes_the_same_seconds_to_devmon():
    """The one measured duration feeds fitmon's counter and devmon's
    ``fit:<algo>`` attribution: the planes agree exactly."""
    monitor = _monitor(fitmon)
    run = monitor.start_run("distributed_pca")
    for seconds in (0.125, 0.3, 0.0625):
        with run.step("covariance_eigh", rows=8) as mon:
            mon.set_device_seconds(seconds)
    with run.step("finalize", rows=8):
        pass  # device time defaults to the step's wall
    reg = metrics.get_registry()
    fit_s = reg.counter("sparkml_fit_device_seconds_total", "",
                        ("algo", "step"))
    total = (fit_s.value(algo="distributed_pca", step="covariance_eigh")
             + fit_s.value(algo="distributed_pca", step="finalize"))
    dev = devmon.get_device_monitor()
    batch_s = reg.counter("sparkml_serve_device_batch_seconds_total", "",
                          ("model", "device"))
    assert batch_s.value(model="fit:distributed_pca",
                         device=dev._default_device) == total
    overhead = reg.counter("sparkml_obs_overhead_seconds_total", "",
                           ("component",))
    assert overhead.value(component="fitmon") > 0


# -- the watchdog -------------------------------------------------------------


def _boom():
    raise RuntimeError("dispatch failed")


def _no_backend():
    raise RuntimeError("no CUDA device is available")


WATCHDOG_CASES = {
    "healthy": {},
    "platform_mismatch": {"expected_platform": "cuda"},
    "no_devices": {"devices_fn": lambda: []},
    "backend_error": {"devices_fn": _no_backend},
    "canary_error": {"canary_fn": _boom},
    "canary_wedged": {"canary_timeout_s": 0.01},
}


@pytest.mark.parametrize("case", list(WATCHDOG_CASES))
def test_watchdog_verdicts_equal_the_jax_ones(case, registries):
    verdicts = {}
    for pkg, mod in PACKAGES.items():
        release = threading.Event()
        kw = dict(WATCHDOG_CASES[case])
        if case == "canary_wedged":
            kw["canary_fn"] = lambda: release.wait(5.0)
        wd = _watchdog(mod, **kw)
        try:
            verdicts[pkg] = wd.check(now=1234.0)
        finally:
            release.set()
        gauge = registries[pkg].gauge(mod.BACKEND_OK_METRIC, "", ())
        assert gauge.value() == (1.0 if verdicts[pkg]["ok"] else 0.0)
    ours, theirs = (_strip(verdicts[p]) for p in ("torch", "jax"))
    assert ours == theirs
    assert ours["reason"] == (None if case == "healthy" else case)


def test_default_devices_and_canary_on_the_cpu(monkeypatch):
    """The port's own devices and canary: the CPU when it is asked for
    (healthy, a real canary time), a missing card otherwise (degraded,
    never healthy)."""
    wd = fitmon.BackendWatchdog(expected_platform=None)
    verdict = wd.check()
    assert verdict["ok"] is True and verdict["reason"] is None
    assert (verdict["platform"], verdict["device_kind"],
            verdict["device_count"]) == ("cpu", "cpu", 1)
    assert verdict["canary"] == "ok" and verdict["canary_seconds"] > 0
    assert wd.check(now=1.0)["ok"] is True
    expecting = fitmon.BackendWatchdog(expected_platform="cuda")
    assert expecting.check()["reason"] == "platform_mismatch"
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = wd.check()
    assert missing["ok"] is False and missing["reason"] == "backend_error"
    assert "SPARK_RAPIDS_ML_TORCH_PLATFORM" in missing["error"]
    assert missing["device_count"] == 0 and missing["canary"] == "skipped"


def test_watchdog_cadence_and_collector(monkeypatch):
    clock = FakeClock(1000.0)
    wd = _watchdog(fitmon, clock=clock, interval_s=30.0)
    monitor = _monitor(fitmon, clock=clock, watchdog=wd)
    assert monitor.watchdog_collector()[0]["checked_unix"] == 1000.0
    clock.t = 1010.0  # inside the interval: the cached verdict
    assert monitor.watchdog_collector()[0]["checked_unix"] == 1000.0
    clock.t = 1031.0
    assert monitor.watchdog_collector()[0]["checked_unix"] == 1031.0
    assert wd.checks == 2
    # a profiler start or stop in flight: the sweep skips, as devmon's does
    monkeypatch.setattr(profiler, "torch_transition_pending", lambda: True)
    clock.t = 2000.0
    assert monitor.watchdog_collector() == [] and wd.checks == 2


# -- the incident drills ------------------------------------------------------


def _pipeline(tmp_path, monkeypatch, registry, watchdog):
    """The port's detection path on an injected clock: the fit monitor's
    watchdog collector on a sampler, the builtin ``fit_backend_degraded``
    detector, and the incident engine on the sampler's post-sweep hook."""
    monkeypatch.setenv(flight.DUMP_DIR_ENV, str(tmp_path / "dumps"))
    clock = watchdog._clock
    store = tsdb.TimeSeriesStore(tiers=((1.0, 600.0),), clock=clock)
    sampler = tsdb.MetricsSampler(store, registry=registry,
                                  interval_seconds=1.0, clock=clock)
    monitor = _monitor(fitmon, clock=clock, watchdog=watchdog)
    sampler.register_collector(monitor.watchdog_collector)
    (detector,) = [d for d in anomaly.builtin_detectors()
                   if d.name == fitmon.INCIDENT_NAME]
    engine = IncidentEngine(
        store=store, detectors=[detector],
        manager=IncidentManager(open_after=1, resolve_after=2,
                                cooldown_seconds=0.0, capture_seconds=0.0,
                                registry=registry),
        registry=registry)
    engine.install(sampler)

    def tick():
        before = engine.manager.opened_total
        sampler.sample_once(now=clock.t)
        clock.t += 1.0
        return engine.manager.opened_total - before

    return engine, sampler, tick


@pytest.mark.parametrize("drill", ["platform_mismatch", "canary_wedged"])
def test_drill_opens_exactly_one_auto_resolving_incident(
        drill, tmp_path, monkeypatch, registries):
    release = threading.Event()
    state = {"broken": True}

    def canary():
        if state["broken"]:
            release.wait(5.0)  # a card that stopped answering

    if drill == "platform_mismatch":
        # the real default devices (the CPU, as asked) against a cuda
        # expectation: a fit silently on the CPU
        wd = fitmon.BackendWatchdog(expected_platform="cuda",
                                    interval_s=1.0, clock=FakeClock())
    else:
        wd = fitmon.BackendWatchdog(interval_s=1.0, canary_timeout_s=0.01,
                                    clock=FakeClock(), canary_fn=canary)
    engine, sampler, tick = _pipeline(tmp_path, monkeypatch,
                                      registries["torch"], wd)
    try:
        assert tick() == 1
        (incident,) = engine.manager.open_incidents()
        assert incident["detector"] == fitmon.INCIDENT_NAME
        assert incident["severity"] == "critical"
        assert wd.last_verdict()["reason"] == drill
        for _ in range(3):  # still degraded: the same incident, no dupes
            assert tick() == 0
        assert engine.manager.opened_total == 1
        # recovery: the expectation fixed, the card answering again
        wd.expected_platform = None
        state["broken"] = False
        tick()
        tick()
        assert engine.manager.open_incidents() == []
        (recent,) = engine.manager.recent_incidents()
        assert recent["state"] == "resolved"
        assert engine.manager.resolved_total == 1
    finally:
        release.set()
        engine.uninstall(sampler)


# -- disabled monitor, peaks, /debug/fit --------------------------------------


def test_disabled_monitor_is_inert(monkeypatch):
    monitor = _monitor(fitmon, enabled=False)
    monkeypatch.setattr(fitmon, "_monitor", monitor)
    with fitmon.fit_run("distributed_pca") as run:
        assert run is fitmon._NULL_RUN
        step = run.step("gram", rows=10)
        assert step is fitmon._NULL_STEP
        with step as mon:
            mon.note(cost=1.0)
            mon.set_device_seconds(5.0)
        run.note_host_step("h", 1.0)
        run.record_collective("psum", nbytes=8)
        xprof.record_execution("centered_gram", 1.0e9, 1.0e6)
    assert monitor.active_runs() == [] and monitor.recent_runs() == []
    assert run.summary() == {} and run.as_dict() == {}
    monitor.enabled = True
    live = monitor.start_run("distributed_pca")
    monitor.enabled = False
    assert live.step("gram") is fitmon._NULL_STEP
    assert live.steps_total == 0
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_FITMON", "0")
    assert fitmon.FitMonitor().enabled is False


def test_peaks_override_cpu_absent_and_the_h100_entry(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_FITMON_PEAK_FLOPS", "2.5e13")
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_FITMON_PEAK_BW", "8e11")
    assert fitmon.device_peaks() == (2.5e13, 8.0e11)
    # a malformed override falls through to the table; the CPU is an
    # unlisted kind → absent, never a guess
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_FITMON_PEAK_FLOPS", "fast")
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_FITMON_PEAK_BW")
    assert fitmon.device_peaks() == (None, None)
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_FITMON_PEAK_FLOPS")
    assert fitmon.device_peaks() == (None, None)
    assert platform.device_kind() is None
    assert xprof.peak_flops_per_second() is None
    assert xprof.analytic_mfu(1.0e12, 1.0) is None
    # a card named as the H100 reports: the table's published 700 W peaks
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: H100)
    assert platform.device_kind() == H100
    assert fitmon.device_peaks() == (989e12, 3.35e12)
    assert xprof.peak_flops_per_second() == 989e12
    assert xprof.analytic_mfu(989e12, 2.0) == pytest.approx(0.5)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    assert fitmon.device_peaks() == (None, None)


def test_debug_fit_doc_keys_equal_the_jax_doc(monkeypatch):
    docs = {}
    for pkg, mod in PACKAGES.items():
        monitor, _ = _scripted(mod)
        monkeypatch.setattr(mod, "_monitor", monitor)
        docs[pkg] = mod.debug_fit_doc()
    ours, theirs = docs["torch"], docs["jax"]
    assert set(ours) == set(theirs) == {
        "enabled", "active", "recent", "rollup", "watchdog",
        "straggler_ratio", "peaks"}
    assert set(ours["active"][0]) == set(theirs["active"][0])
    assert set(ours["recent"][0]) == set(theirs["recent"][0])
    assert set(ours["rollup"]["distributed_pca"]) == \
        set(theirs["rollup"]["distributed_pca"])
    assert set(ours["watchdog"]) == set(theirs["watchdog"])
    assert ours["peaks"] == {"flops_per_second": PEAK_FLOPS,
                             "hbm_bytes_per_second": PEAK_BW}


def test_get_debug_fit_serves_the_document(monkeypatch):
    monitor, run = _scripted(fitmon)
    monkeypatch.setattr(fitmon, "_monitor", monitor)
    model = PCAModel.from_numpy(np.eye(6)[:, :2], [0.6, 0.4])
    registry = ModelRegistry()
    registry.register("pca_fit", model)
    engine = ServeEngine(registry, max_batch_rows=16, max_wait_ms=1)
    server = start_serve_server(engine, port=0)
    try:
        conn = http.client.HTTPConnection(
            "127.0.0.1", server.server_address[1], timeout=30)
        try:
            conn.request("GET", "/debug/fit")
            resp = conn.getresponse()
            status, ctype = resp.status, resp.getheader("Content-Type")
            doc = json.loads(resp.read())
        finally:
            conn.close()
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        tsdb.reset_tsdb()
        incidents.reset_incident_engine()
    assert status == 200 and ctype == "application/json"
    assert set(doc) == {"enabled", "active", "recent", "rollup",
                        "watchdog", "straggler_ratio", "peaks"}
    assert doc["recent"][0]["run_id"] == run.run_id
    assert doc["rollup"]["distributed_pca"]["runs"] == 1
    assert doc["active"][0]["algo"] == "distributed_kmeans"
