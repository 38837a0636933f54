"""The port's flight recorder (``obs.flight``), held to the JAX package's:
dump contents, the watchdog firing on a stalled block and not within its
budget, exception dumps, the dump counter, the cross-thread open-span
table, the dump's key set (the JAX one less ``compile_log_tail``), and the batcher's wedge writing exactly one
``budget_exceeded:serve_worker:<model>`` dump.

Every dump goes to a ``tmp_path`` through each package's dump-dir env.
The tests synchronise on events and on the dump files appearing, never on
fixed sleeps."""

import glob
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.obs import flight as jax_flight
from spark_rapids_ml_tpu.obs import span as jax_span
from spark_rapids_ml_tpu.obs import tracectx as jax_tracectx
from spark_rapids_ml_tpu_torch import obs
from spark_rapids_ml_tpu_torch.obs import devmon, flight, tracectx, tsdb
from spark_rapids_ml_tpu_torch.obs import report as report_mod
from spark_rapids_ml_tpu_torch.serve import breaker
from spark_rapids_ml_tpu_torch.serve.batching import (
    MicroBatcher,
    WorkerCrashed,
)

WAIT = 30.0
# the JAX dump's section that the port leaves out (xprof: it compiles
# nothing)
UNPORTED_DUMP_KEYS = {"compile_log_tail"}


@pytest.fixture
def dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    monkeypatch.setenv(flight.DUMP_DIR_ENV, str(tmp_path / "port"))
    monkeypatch.setenv(jax_flight.DUMP_DIR_ENV, str(tmp_path / "jax"))
    return tmp_path / "port"


def _dump_files(directory):
    return sorted(glob.glob(os.path.join(str(directory),
                                         "flightdump_*.json")))


def _until(predicate, timeout=WAIT):
    end = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > end:
            raise AssertionError("condition not reached")
        time.sleep(0.005)


def _wait_for_dumps(directory, n=1):
    _until(lambda: len(_dump_files(directory)) >= n)
    return _dump_files(directory)


def test_dump_contents(dumps):
    with obs.span("flight_open_span"):
        path = flight.dump("unit_test", extra={"marker": 42})
    assert path and os.path.exists(path)
    assert os.path.dirname(path) == str(dumps)
    doc = json.load(open(path))
    assert doc["reason"] == "unit_test"
    assert doc["extra"]["marker"] == 42
    assert doc["pid"] == os.getpid()
    # all-thread stacks, including this one
    assert any("test_dump_contents" in "".join(stack)
               for stack in doc["thread_stacks"].values())
    # the span open at dump time is visible
    assert any(s["name"] == "flight_open_span" for s in doc["open_spans"])
    assert isinstance(doc["span_ring_tail"], list)
    assert isinstance(doc["metrics"], dict)
    # the port's knobs and the CUDA stack's env, not the JAX package's
    assert doc["env"]["SPARK_RAPIDS_ML_TORCH_PLATFORM"] == "cpu"
    assert not any(k.startswith(("JAX_", "XLA_", "SPARK_RAPIDS_ML_TPU_"))
                   for k in doc["env"])


def test_dump_dir_defaults_apart_from_the_jax_package(monkeypatch):
    monkeypatch.delenv(flight.DUMP_DIR_ENV, raising=False)
    monkeypatch.delenv(jax_flight.DUMP_DIR_ENV, raising=False)
    assert flight.dump_dir() != jax_flight.dump_dir()
    assert os.path.dirname(flight.dump_dir()) == \
        os.path.dirname(jax_flight.dump_dir())


def test_watchdog_fires_on_stalled_block(dumps):
    """A stalled block produces a dump naming it, with its info."""
    with obs.deadline("stalled_phase_test", budget_seconds=0.15,
                      what="unit test"):
        _wait_for_dumps(dumps)
    (path,) = _dump_files(dumps)
    doc = json.load(open(path))
    assert doc["reason"] == "budget_exceeded:stalled_phase_test"
    assert doc["extra"]["budget_info"]["what"] == "unit test"
    assert doc["extra"]["label"] == "stalled_phase_test"


def test_watchdog_does_not_fire_within_budget(dumps):
    """A block that ends inside its budget is disarmed: a later stalled
    block's dump, which lands past the first budget, is the only one."""
    with obs.deadline("fast_phase_test", budget_seconds=0.3):
        pass
    with obs.deadline("stalled_after_test", budget_seconds=0.6):
        _wait_for_dumps(dumps)
    (path,) = _dump_files(dumps)
    assert json.load(open(path))["reason"] == \
        "budget_exceeded:stalled_after_test"


def test_a_deadline_armed_while_the_watchdog_dumps_still_fires(dumps):
    """The watchdog's lost wakeup: a deadline armed while the thread runs
    an expired one's hook and dump (outside its lock, so the arm's notify
    reaches no waiter) must still fire. The JAX package's watchdog,
    whose wait is computed before the dumps, waits past it."""
    watchdog = flight.Watchdog()
    in_hook, release, fired = (threading.Event(), threading.Event(),
                               threading.Event())

    def hold():
        in_hook.set()
        release.wait(WAIT)

    watchdog.arm("first_expired_test", 0.0, on_expire=hold)
    assert in_hook.wait(WAIT)
    watchdog.arm("armed_meanwhile_test", 0.05, on_expire=fired.set)
    release.set()
    assert fired.wait(WAIT)
    reasons = {json.load(open(p))["reason"]
               for p in _wait_for_dumps(dumps, 2)}
    assert reasons == {"budget_exceeded:first_expired_test",
                       "budget_exceeded:armed_meanwhile_test"}


def test_hard_exception_dumps_fast_validation_does_not(dumps):
    with pytest.raises(OSError):
        with obs.deadline("hard_error_test", budget_seconds=30.0):
            raise OSError("device gone")
    files = _dump_files(dumps)
    assert len(files) == 1
    doc = json.load(open(files[0]))
    assert doc["reason"] == "unhandled_exception:hard_error_test"
    assert "device gone" in doc["extra"]["error"]
    with pytest.raises(ValueError):
        with obs.deadline("validation_error_test", budget_seconds=30.0):
            raise ValueError("k must be set")
    assert len(_dump_files(dumps)) == 1


@pytest.mark.parametrize("exc,elapsed", [
    (OSError("gone"), 0.0),
    (TimeoutError("late"), 0.0),
    (MemoryError(), 0.0),
    (ConnectionError("reset"), 0.0),
    (ValueError("bad k"), 0.0),
    (KeyError("ghost"), 0.0),
    (ValueError("bad k"), 6.0),
    (RuntimeError("plain"), 0.0),
])
def test_should_dump_exception_matches_jax(exc, elapsed):
    assert flight._should_dump_exception(exc, elapsed) == \
        jax_flight._should_dump_exception(exc, elapsed)


@pytest.mark.parametrize("exc,expected", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (RuntimeError("shape mismatch"), False),
    (TypeError("CUDA error in a message of the wrong type"), False),
])
def test_cuda_failures_are_hard_errors(exc, expected):
    """Where the JAX recorder matches ``XlaRuntimeError`` by name, the
    port matches the CUDA runtime's failures."""
    assert flight._should_dump_exception(exc, 0.0) is expected


def test_accelerator_error_is_a_hard_error():
    cls = getattr(torch, "AcceleratorError", None)
    if cls is None:
        pytest.skip("this torch has no AcceleratorError")
    assert flight._should_dump_exception(cls("launch failed"), 0.0)


def test_dump_counts_in_metrics(dumps):
    counter = obs.get_registry().counter(
        "sparkml_flight_dumps_total", "flight-recorder dumps", ("reason",))
    before = counter.value(reason="metrics_probe")
    flight.dump("metrics_probe:extra_detail")
    assert counter.value(reason="metrics_probe") == before + 1


def test_dump_never_raises_into_its_caller(tmp_path, monkeypatch):
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    monkeypatch.setenv(flight.DUMP_DIR_ENV, str(blocker / "dumps"))
    assert flight.dump("unwritable") is None


def test_active_spans_cross_thread_visibility():
    ready, release = threading.Event(), threading.Event()

    def worker():
        with obs.span("cross_thread_span"):
            ready.set()
            release.wait(timeout=WAIT)

    t = threading.Thread(target=worker)
    t.start()
    try:
        assert ready.wait(WAIT)
        names = [s["name"] for s in obs.active_spans()]
        assert "cross_thread_span" in names
        (entry,) = [s for s in obs.active_spans()
                    if s["name"] == "cross_thread_span"]
        assert entry["tid"] == t.ident and entry["elapsed_seconds"] >= 0
    finally:
        release.set()
        t.join(WAIT)
    assert not t.is_alive()
    assert "cross_thread_span" not in [s["name"] for s in obs.active_spans()]


def test_build_dump_keys_are_the_jax_keys_less_two(dumps):
    """The same registered section in both recorders: the port's document
    has exactly the JAX keys, less the compile log it cannot fill, and its
    ``device_health_cached`` is the fit reports' cached verdict."""
    for mod in (flight, jax_flight):
        mod.register_dump_section("parity_section", lambda: {"x": 1})
    try:
        ours = flight.build_dump("parity", extra={"k": 1})
        theirs = jax_flight.build_dump("parity", extra={"k": 1})
    finally:
        for mod in (flight, jax_flight):
            mod.unregister_dump_section("parity_section")
    own_sections = set(flight._dump_sections)
    jax_sections = set(jax_flight._dump_sections)
    assert ours["parity_section"] == theirs["parity_section"] == {"x": 1}
    assert set(ours) - own_sections == \
        set(theirs) - jax_sections - UNPORTED_DUMP_KEYS
    assert UNPORTED_DUMP_KEYS <= set(theirs)
    assert not UNPORTED_DUMP_KEYS & set(ours)
    assert ours["device_health_cached"] == report_mod._health_cache
    # the port's serving sections, registered where JAX registers them
    assert "breaker_events" in own_sections
    assert flight.run_dump_section("parity_section") is None


def test_open_spans_and_active_traces_match_jax(dumps):
    """Driven alike (one open span, one in-flight request of the same
    identity), both dumps name the same span and the same request."""
    trace_id, span_id = tracectx.new_trace_id(), tracectx.new_span_id()
    ours_ctx = tracectx.TraceContext(trace_id, span_id)
    jax_ctx = jax_tracectx.TraceContext(trace_id, span_id)
    with obs.span("flight:parity", trace_id=trace_id), \
            jax_span("flight:parity", trace_id=trace_id), \
            tracectx.inflight_request(ours_ctx, model="pca", rows=3), \
            jax_tracectx.inflight_request(jax_ctx, model="pca", rows=3):
        ours = flight.build_dump("parity")
        theirs = jax_flight.build_dump("parity")

    def spans_of(doc):
        return [(s["name"], s["trace_id"]) for s in doc["open_spans"]
                if s["trace_id"] == trace_id]

    def requests_of(doc):
        return [{k: v for k, v in r.items() if k != "elapsed_seconds"}
                for r in doc["active_traces"] if r["trace_id"] == trace_id]

    assert spans_of(ours) == spans_of(theirs) == [("flight:parity",
                                                   trace_id)]
    assert requests_of(ours) == requests_of(theirs)
    assert len(requests_of(ours)) == 1


def test_breaker_section_carries_events_and_live_states(dumps):
    clock = [0.0]
    b = breaker.CircuitBreaker("flight_brk", failure_threshold=1,
                               clock=lambda: clock[0])
    b.record_failure(error="RuntimeError: boom")
    section = flight.run_dump_section("breaker_events")
    assert any(e["model"] == "flight_brk" and e["to_state"] == "open"
               for e in section["events"])
    assert any(s["model"] == "flight_brk" and s["state"] == "open"
               for s in section["states"])


@pytest.mark.parametrize("value", [None, "0.5", "0", "-3", "bogus"])
def test_transform_budget_matches_jax(monkeypatch, value):
    for env in (flight.TRANSFORM_BUDGET_ENV,
                jax_flight.TRANSFORM_BUDGET_ENV):
        if value is None:
            monkeypatch.delenv(env, raising=False)
        else:
            monkeypatch.setenv(env, value)
    assert flight.transform_budget_seconds() == \
        jax_flight.transform_budget_seconds()
    assert flight.fit_budget_seconds() == jax_flight.fit_budget_seconds()


def test_batcher_budget_defaults_to_the_transform_budget(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    monkeypatch.delenv(flight.TRANSFORM_BUDGET_ENV, raising=False)
    b = MicroBatcher(lambda m: m, name="budget_default")
    try:
        assert b.worker_budget_s == 120.0
    finally:
        b.close(timeout=5)
    monkeypatch.setenv(flight.TRANSFORM_BUDGET_ENV, "7.5")
    b = MicroBatcher(lambda m: m, name="budget_env")
    try:
        assert b.worker_budget_s == 7.5
    finally:
        b.close(timeout=5)


@pytest.fixture
def sampling(dumps):
    """The history sampler, which registers the metrics_history section;
    stopped and dropped after."""
    tsdb.reset_tsdb()
    devmon.reset_device_monitor()
    tsdb.start_sampling(interval_seconds=60.0)
    tsdb.get_sampler().sample_once()
    yield
    tsdb.reset_tsdb()
    devmon.reset_device_monitor()


def test_wedged_batcher_writes_exactly_one_dump(dumps, sampling):
    """A port batcher whose program blocks on an event past its 0.2 s
    budget fails its window fast and writes one wedge dump, which holds
    the breakers' events and the metrics history."""
    release = threading.Event()
    entered = threading.Event()

    def blocked(matrix):
        entered.set()
        release.wait(WAIT)
        return matrix

    name = "flight_wedge"
    b = MicroBatcher(blocked, name=name, max_wait_ms=0,
                     worker_budget_s=0.2)
    try:
        t0 = time.monotonic()
        with pytest.raises(WorkerCrashed, match="wedged"):
            b.submit(np.ones((3, 2))).wait(WAIT)
        assert time.monotonic() - t0 < 1.5
        assert entered.is_set()
        (path,) = _wait_for_dumps(dumps)
    finally:
        release.set()
        b.close(timeout=5)
    # the stuck call returned and the batcher closed: still one dump
    (again,) = _dump_files(dumps)
    assert again == path
    doc = json.load(open(path))
    assert doc["reason"] == f"budget_exceeded:serve_worker:{name}"
    assert doc["extra"]["label"] == f"serve_worker:{name}"
    assert doc["extra"]["budget_info"] == {"model": name, "requests": 1,
                                           "rows": 3}
    assert doc["extra"]["overdue_at_utc"].endswith("Z")
    assert set(doc["breaker_events"]) == {"events", "states"}
    assert isinstance(doc["metrics_history"], dict)
    assert any(k.startswith("sparkml_device_mem_")
               for k in doc["metrics_history"])
    assert any(f"sparkml-watchdog-{name}" in label
               for label in doc["thread_stacks"])
