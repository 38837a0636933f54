"""The port's on-demand profiler (``obs.profiler`` on ``torch.profiler``),
held to the JAX package's capture logic with ``jax_`` renamed ``torch_``:
single-flight, the ``seconds`` clamp and label sanitising, early stop,
the ``obs:profile`` span and counters, the unavailable and wedged
outcomes, and the device monitor skipping a sweep while a profiler start
is in flight. No capture ever drops to CPU-only events on its own.

Only one test starts the REAL ``torch.profiler`` (on the CPU): it checks
that both artifacts land and load, and that a CPU op of a thread that
existed before the capture is in the trace (``profile_all_threads``).
The logic tests fake ``torch.profiler.profile`` with an instant start and
stop, and the JAX side fakes ``jax.profiler`` the way the JAX package's
own tests do; the real ``jax.profiler`` is never started here (it can
stall for ~30 s under a loaded suite). Every test drains with
``profiler.wait(30)``."""

import json
import os
import threading

import pytest
import torch

from spark_rapids_ml_tpu.obs import get_registry as jax_registry
from spark_rapids_ml_tpu.obs import profiler as jax_profiler
from spark_rapids_ml_tpu_torch.obs import devmon, profiler, spans
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry

WAIT = 30.0


class FakeProfile:
    """``torch.profiler.profile`` with an instant start and stop; the
    export writes ``events`` (CPU-only unless a test says otherwise)."""

    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm",
               "ts": 1.0, "dur": 2.0, "pid": 1, "tid": 1}]
    made = []
    start_gate = None  # a threading.Event start() blocks on, when set
    start_error = None

    def __init__(self, activities=None, experimental_config=None, **_):
        self.activities = list(activities or ())
        self.experimental_config = experimental_config
        FakeProfile.made.append(self)

    def start(self):
        if FakeProfile.start_error is not None:
            raise FakeProfile.start_error
        if FakeProfile.start_gate is not None:
            FakeProfile.start_gate.wait(WAIT)

    def stop(self):
        pass

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": FakeProfile.events}, f)


@pytest.fixture
def profile_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    monkeypatch.setenv(profiler.PROFILE_DIR_ENV, str(tmp_path / "port"))
    monkeypatch.setenv(jax_profiler.PROFILE_DIR_ENV, str(tmp_path / "jax"))
    profiler.wait(WAIT)
    yield str(tmp_path / "port")
    profiler.wait(WAIT)
    jax_profiler.wait(WAIT)


@pytest.fixture
def fake_profilers(monkeypatch):
    """Instant profilers in both packages: capture-logic tests must not
    depend on a profiler backend's mood (or the suite's load)."""
    import jax

    monkeypatch.setattr(FakeProfile, "made", [])
    monkeypatch.setattr(FakeProfile, "start_gate", None)
    monkeypatch.setattr(FakeProfile, "start_error", None)
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(jax.profiler, "start_trace", lambda path: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    profiler.wait(WAIT)
    jax_profiler.wait(WAIT)
    yield FakeProfile
    # drain before the fakes are torn down
    if FakeProfile.start_gate is not None:
        FakeProfile.start_gate.set()
    profiler.wait(WAIT)
    jax_profiler.wait(WAIT)


def _outcomes(registry=None):
    reg = registry or get_registry()
    counter = reg.counter("sparkml_obs_profile_captures_total", "",
                          ("outcome",))
    return lambda outcome: counter.value(outcome=outcome)


def _torchify(obj):
    """The JAX document's keys and values with ``jax`` read ``torch``."""
    if isinstance(obj, dict):
        return {_torchify(k): _torchify(v) for k, v in obj.items()}
    if isinstance(obj, str):
        return obj.replace("jax_", "torch_")
    return obj


def test_real_capture_lands_both_traces_with_a_prior_threads_ops(
        profile_dir):
    """The real CPU profiler: the torch trace and the span trace land and
    load, and a CPU op run on a thread that existed before the capture
    (as the batcher's workers do) is in the torch trace."""
    started_before = _outcomes()("started")
    go, done = threading.Event(), threading.Event()

    def worker():
        assert go.wait(WAIT)
        with spans.span("profiler_test_work", rows=8):
            torch.mm(torch.ones(32, 32), torch.ones(32, 32))
        done.set()

    t = threading.Thread(target=worker, name="pre-existing")
    t.start()
    try:
        info = profiler.start_capture(WAIT, label="real")
        assert info["path"].startswith(profile_dir)
        assert info["torch_enabled"] is True
        # the profiler's first start in a process takes seconds: wait for
        # it, so the op lands inside the trace
        assert _until_started()
        go.set()
        assert done.wait(WAIT)
    finally:
        go.set()
        t.join(WAIT)
    result = profiler.stop_capture()
    profiler.wait(WAIT)
    assert result["id"] == info["id"]
    assert result["torch_outcome"] == "ok" and result["torch_trace"]
    names = sorted(os.path.basename(a["path"]) for a in result["artifacts"])
    assert names == sorted([f"spans_{info['id']}.json",
                            f"torch_{info['id']}.json"])
    assert all(a["bytes"] > 0 for a in result["artifacts"])
    doc = json.load(open(result["spans_trace"]))
    assert any(e["name"] == "profiler_test_work" for e in doc["traceEvents"])
    trace = json.load(open(profiler.torch_trace_path(result["path"],
                                                     result["id"])))
    mm = [e for e in trace["traceEvents"]
          if e.get("name", "").startswith("aten::mm")]
    assert any(e.get("tid") == t.native_id for e in mm), \
        "a CPU op of a thread older than the capture is missing"
    assert _outcomes()("started") == started_before + 1
    assert profiler.capture_active() is None


def _until_started():
    import time

    end = time.monotonic() + WAIT
    while time.monotonic() < end:
        active = profiler.capture_active()
        if active is None:
            return False
        if active["torch_trace"]:
            return True
        time.sleep(0.005)
    return False


def test_activities_follow_the_requested_device(profile_dir, fake_profilers,
                                                monkeypatch):
    """[CPU] alone with the CPU requested, and every thread's ops: the
    profiler starts on a helper thread."""
    from torch._C import _profiler as c_profiler
    from torch.profiler import ProfilerActivity

    configs = []
    monkeypatch.setattr(c_profiler, "_ExperimentalConfig",
                        lambda **kw: configs.append(kw) or kw)
    profiler.start_capture(0.05, label="cpu")
    profiler.wait(WAIT)
    (made,) = fake_profilers.made
    assert made.activities == [ProfilerActivity.CPU]
    assert configs == [{"profile_all_threads": True}]
    assert made.experimental_config == {"profile_all_threads": True}


def test_no_card_and_no_cpu_request_raises(profile_dir, fake_profilers,
                                           monkeypatch):
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="SPARK_RAPIDS_ML_TORCH_PLATFORM"):
        profiler.start_capture(0.1)
    assert profiler.capture_active() is None
    assert fake_profilers.made == []


def test_single_flight_second_start_rejected(profile_dir, fake_profilers):
    profiler.start_capture(0.3, label="first")
    with pytest.raises(profiler.CaptureInFlight):
        profiler.start_capture(0.2, label="second")
    profiler.wait(WAIT)
    # after it lands, a new capture is admitted again
    profiler.start_capture(0.1, label="third")
    result = profiler.wait(WAIT)
    assert result["id"].startswith("third")


def test_stop_capture_ends_window_early(profile_dir, fake_profilers):
    profiler.start_capture(60.0, label="early")  # would run a minute
    result = profiler.stop_capture()
    assert result is not None and result["id"].startswith("early")
    assert result["elapsed_seconds"] < 30.0
    assert profiler.capture_active() is None


def test_capture_records_profile_span_and_status(profile_dir,
                                                 fake_profilers):
    profiler.start_capture(0.15, label="spanned")
    result = profiler.wait(WAIT)
    events = [e for e in spans.get_recorder().events()
              if e.name == "obs:profile"
              and e.args.get("capture_id") == result["id"]]
    assert len(events) == 1
    assert events[0].args["torch_outcome"] == "ok"
    assert profiler.last_capture()["id"] == result["id"]


@pytest.mark.parametrize("seconds,label,want_seconds,want_label", [
    (10_000, "../we ird/..", profiler.MAX_SECONDS, "___we_ird___"),
    (0.0, "", 0.05, "ondemand"),
    (-5, "a" * 60, 0.05, "a" * 40),
    (2.5, "ok-label_1", 2.5, "ok-label_1"),
])
def test_seconds_clamped_and_label_sanitized(profile_dir, fake_profilers,
                                             seconds, label, want_seconds,
                                             want_label):
    info = profiler.start_capture(seconds, label=label)
    jax_info = None
    try:
        assert info["seconds"] == want_seconds
        assert "/" not in os.path.basename(info["path"])
        assert os.path.basename(info["path"]).startswith(want_label + "_")
    finally:
        profiler.stop_capture()
    jax_info = jax_profiler.start_capture(seconds, label=label)
    jax_profiler.stop_capture()
    assert jax_info["seconds"] == info["seconds"]
    assert jax_info["id"].split("_")[:-2] == info["id"].split("_")[:-2]


def test_capture_documents_match_jax(profile_dir, fake_profilers):
    """The same capture through both packages: the start info, the
    in-flight view, the result and the counters carry the same keys and
    verdicts, ``jax_`` read ``torch_``."""
    ours_count, theirs_count = _outcomes(), _outcomes(jax_registry())
    before = {o: (ours_count(o), theirs_count(o))
              for o in ("started", "completed")}
    docs = []
    for mod in (profiler, jax_profiler):
        info = mod.start_capture(60.0, label="parity")
        active = mod.capture_active()
        result = mod.stop_capture()
        mod.wait(WAIT)
        docs.append((info, active, result))
    (info, active, result), (jinfo, jactive, jresult) = docs
    assert set(info) == set(_torchify(jinfo))
    assert set(active) == set(_torchify(jactive))
    assert set(result) == set(_torchify(jresult))
    assert result["torch_outcome"] == _torchify(jresult)["torch_outcome"] \
        == "ok"
    assert result["torch_trace"] is jresult["jax_trace"] is True
    assert info["fit_run_id"] is None
    for outcome, (ours0, theirs0) in before.items():
        assert ours_count(outcome) - ours0 == \
            theirs_count(outcome) - theirs0 == 1


def test_capture_inside_a_fit_run_carries_its_run_id(
        profile_dir, fake_profilers, monkeypatch):
    """A capture started while a fit-monitor run is active names that run
    in its documents, as the JAX capture does; outside any run, None."""
    from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
    from spark_rapids_ml_tpu_torch.obs import fitmon

    ids = {}
    for mod, mon in ((profiler, fitmon), (jax_profiler, jax_fitmon)):
        monkeypatch.setattr(mon, "_monitor", mon.FitMonitor(enabled=True))
        with mon.fit_run("distributed_pca") as run:
            info = mod.start_capture(60.0, label="fit")
            active = mod.capture_active()
            result = mod.stop_capture()
            mod.wait(WAIT)
        assert info["fit_run_id"] == active["fit_run_id"] == \
            result["fit_run_id"] == run.run_id
        outside = mod.start_capture(60.0, label="nofit")
        mod.stop_capture()
        mod.wait(WAIT)
        assert outside["fit_run_id"] is None
        ids[mod] = run.run_id
    assert ids[profiler] == ids[jax_profiler] == "fit-1"


def test_unavailable_profiler_outcome_matches_jax(profile_dir,
                                                  fake_profilers,
                                                  monkeypatch):
    import jax

    fake_profilers.start_error = RuntimeError("no profiler here")

    def broken(path):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(jax.profiler, "start_trace", broken)
    ours_count, theirs_count = _outcomes(), _outcomes(jax_registry())
    before = (ours_count("torch_unavailable"),
              theirs_count("jax_unavailable"))
    profiler.start_capture(0.05, label="unavail")
    result = profiler.wait(WAIT)
    jax_profiler.start_capture(0.05, label="unavail")
    jresult = jax_profiler.wait(WAIT)
    assert result["torch_outcome"] == "torch_unavailable"
    assert _torchify(jresult["jax_outcome"]) == result["torch_outcome"]
    assert result["torch_trace"] is jresult["jax_trace"] is False
    # the span trace still lands
    assert result["spans_trace"] and os.path.exists(result["spans_trace"])
    assert (ours_count("torch_unavailable") - before[0]
            == theirs_count("jax_unavailable") - before[1] == 1)


def test_wedged_start_completes_and_later_captures_skip(
        profile_dir, fake_profilers, monkeypatch):
    """A ``start()`` that does not come back within the join grace: the
    capture completes ``torch_wedged`` with span-ring artifacts, the
    next capture skips the torch trace while the helper is stuck, and
    the helper cleans up once released — as the JAX capture does."""
    monkeypatch.setattr(profiler, "_JOIN_GRACE", 0.2)
    gate = threading.Event()
    fake_profilers.start_gate = gate
    wedged_before = _outcomes()("torch_wedged")
    profiler.start_capture(0.05, label="wedge")
    assert profiler.torch_transition_pending()  # start() in flight
    mon = devmon.DeviceMonitor()
    assert mon.sample() == []  # the sweep waits out the transition
    result = profiler.stop_capture()
    assert result["torch_outcome"] == "torch_wedged"
    assert result["torch_trace"] is False
    assert _outcomes()("torch_wedged") == wedged_before + 1
    assert profiler.torch_profiler_busy()
    assert profiler.torch_transition_pending()  # the orphan is stuck
    info = profiler.start_capture(0.05, label="skipped")
    assert info["torch_enabled"] is False
    skipped = profiler.stop_capture()
    assert skipped["torch_outcome"] == "skipped_busy"
    gate.set()
    profiler.wait(WAIT)
    assert not profiler.torch_profiler_busy()
    assert not profiler.torch_transition_pending()
    assert mon.sample() != []


def test_device_monitor_sweeps_through_the_capture_window(
        profile_dir, fake_profilers):
    """Between start() and stop() nothing is in transition: the monitor
    keeps sampling through a long capture."""
    profiler.start_capture(60.0, label="window")
    assert _until_started()
    assert not profiler.torch_transition_pending()
    assert devmon.DeviceMonitor().sample() != []
    profiler.stop_capture()


def test_jax_monitor_skips_the_same_transition(monkeypatch):
    """The JAX monitor's hook, for the record the port follows: a pending
    transition empties the sweep."""
    from spark_rapids_ml_tpu.obs import devmon as jax_devmon

    monkeypatch.setattr(jax_profiler, "jax_transition_pending",
                        lambda: True)
    monkeypatch.setattr(profiler, "torch_transition_pending", lambda: True)
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    assert jax_devmon.DeviceMonitor().sample() == []
    assert devmon.DeviceMonitor().sample() == []


@pytest.mark.parametrize("device_events,outcome", [
    ([], "torch_unavailable"),
    ([{"ph": "X", "cat": "kernel", "name": "gemm", "ts": 3.0, "dur": 1.0}],
     "ok"),
    ([{"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 3.0,
       "dur": 1.0}], "ok"),
])
def test_cuda_capture_is_never_ok_on_cpu_events_alone(
        profile_dir, fake_profilers, monkeypatch, device_events, outcome):
    """With CUDA activities asked for, a trace without one device event
    (CUPTI failed) is ``torch_unavailable`` — no fallback to CPU-only."""
    from torch.profiler import ProfilerActivity

    monkeypatch.setattr(profiler, "_capture_device", lambda: "cuda")
    monkeypatch.setattr(profiler, "_probe_device", lambda: None)
    monkeypatch.setattr(fake_profilers, "events",
                        FakeProfile.events + device_events)
    profiler.start_capture(0.05, label="cuda")
    result = profiler.wait(WAIT)
    (made,) = fake_profilers.made
    assert made.activities == [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    assert result["torch_outcome"] == outcome
    assert result["torch_trace"] is (outcome == "ok")


def test_failed_probe_stops_the_profiler(profile_dir, fake_profilers,
                                         monkeypatch):
    stopped = []
    monkeypatch.setattr(profiler, "_capture_device", lambda: "cuda")

    def probe():
        raise RuntimeError("CUDA error: launch failed")

    monkeypatch.setattr(profiler, "_probe_device", probe)
    monkeypatch.setattr(FakeProfile, "stop", lambda self: stopped.append(1))
    profiler.start_capture(0.05, label="probe")
    result = profiler.wait(WAIT)
    assert result["torch_outcome"] == "torch_unavailable"
    assert stopped == [1]


def test_a_capture_is_swept_by_retention(profile_dir, fake_profilers,
                                         monkeypatch):
    from spark_rapids_ml_tpu_torch.obs import retention

    monkeypatch.setenv(retention.MAX_COUNT_ENV, "2")
    monkeypatch.setattr(retention, "_last_sweep", {})
    ids = []
    for i in range(3):
        profiler.start_capture(0.05, label=f"gc{i}")
        ids.append(profiler.wait(WAIT)["id"])
        monkeypatch.setattr(retention, "_last_sweep", {})
    kept = sorted(os.listdir(profile_dir))
    assert len(kept) == 2 and ids[-1] in kept


def test_overhead_counted_for_the_profiler(profile_dir, fake_profilers):
    counter = get_registry().counter(
        "sparkml_obs_overhead_seconds_total", "", ("component",))
    before = counter.value(component="profiler")
    profiler.start_capture(0.05, label="cost")
    profiler.wait(WAIT)
    assert counter.value(component="profiler") > before


def test_module_names_map_from_jax():
    ours = set(profiler.__all__)
    theirs = {name.replace("jax_", "torch_") for name in jax_profiler.__all__}
    assert theirs <= ours
    assert ours - theirs == {"DEVICE_CATEGORIES", "torch_trace_path"}
    assert profiler.MAX_SECONDS == jax_profiler.MAX_SECONDS
