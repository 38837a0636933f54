"""The port's structured logging (``obs.logging``) and artifact retention
(``obs.retention``), held to the JAX package's: one JSON object per line
whose fields equal the JAX logger's for the same call (the timestamp
aside), the level gate, trace-id stamping, the per-(level, logger) token
bucket and its counters, the flight dump's notice going through it, and
the retention sweeper's count and byte caps, oldest first, on identical
directory trees."""

import io
import json
import os

import pytest

from spark_rapids_ml_tpu.obs import get_registry as jax_registry
from spark_rapids_ml_tpu.obs import logging as jax_logging
from spark_rapids_ml_tpu.obs import retention as jax_retention
from spark_rapids_ml_tpu.obs import tracectx as jax_tracectx
from spark_rapids_ml_tpu_torch.obs import flight, retention, tracectx
from spark_rapids_ml_tpu_torch.obs.logging import (
    BURST_ENV,
    LEVEL_ENV,
    RATE_ENV,
    StructuredLogger,
    get_logger,
)
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _lines(stream):
    return [json.loads(line) for line in
            stream.getvalue().splitlines() if line.strip()]


@pytest.fixture
def both_envs(monkeypatch):
    """Set one knob in both packages' spellings."""
    def setenv(port_name, value):
        monkeypatch.setenv(port_name, value)
        monkeypatch.setenv(
            port_name.replace("SPARK_RAPIDS_ML_TORCH_", "SPARK_RAPIDS_ML_TPU_"),
            value)
    return setenv


def test_env_knobs_are_the_ports():
    assert (LEVEL_ENV, RATE_ENV, BURST_ENV) == tuple(
        name.replace("SPARK_RAPIDS_ML_TPU_", "SPARK_RAPIDS_ML_TORCH_")
        for name in (jax_logging.LEVEL_ENV, jax_logging.RATE_ENV,
                     jax_logging.BURST_ENV))
    assert retention.MAX_COUNT_ENV == jax_retention.MAX_COUNT_ENV.replace(
        "SPARK_RAPIDS_ML_TPU_", "SPARK_RAPIDS_ML_TORCH_")
    assert retention.MAX_MB_ENV == jax_retention.MAX_MB_ENV.replace(
        "SPARK_RAPIDS_ML_TPU_", "SPARK_RAPIDS_ML_TORCH_")


def test_log_line_is_one_json_object_with_fields():
    stream = io.StringIO()
    log = StructuredLogger("test.module", stream=stream)
    log.info("model registered", model="pca", version=3)
    (rec,) = _lines(stream)
    assert rec["level"] == "info"
    assert rec["logger"] == "test.module"
    assert rec["message"] == "model registered"
    assert rec["model"] == "pca" and rec["version"] == 3
    assert rec["ts"].endswith("Z") and "T" in rec["ts"]


def test_level_gate_from_env(monkeypatch):
    stream = io.StringIO()
    log = StructuredLogger("gated", stream=stream)
    monkeypatch.setenv(LEVEL_ENV, "warning")
    log.info("dropped")
    log.debug("dropped")
    log.warning("kept")
    log.error("kept too")
    assert [r["level"] for r in _lines(stream)] == ["warning", "error"]
    monkeypatch.setenv(LEVEL_ENV, "debug")
    log.debug("now visible")
    assert _lines(stream)[-1]["message"] == "now visible"


def test_trace_id_stamped_from_active_context():
    stream = io.StringIO()
    log = StructuredLogger("traced", stream=stream)
    ctx = tracectx.new_context()
    with tracectx.activate(ctx):
        log.info("inside request")
    log.info("outside request")
    inside, outside = _lines(stream)
    assert inside["trace_id"] == ctx.trace_id
    assert "trace_id" not in outside


def test_non_serializable_fields_degrade_to_str():
    stream = io.StringIO()
    log = StructuredLogger("weird", stream=stream)
    log.info("odd payload", payload=object())
    (rec,) = _lines(stream)
    assert "object object at" in rec["payload"]


def test_logger_never_raises_on_broken_stream():
    class Broken:
        def write(self, _):
            raise OSError("disk full")

    log = StructuredLogger("broken", stream=Broken())
    log.error("this must not raise")


def test_get_logger_is_cached_per_name():
    assert get_logger("same") is get_logger("same")
    assert get_logger("same") is not get_logger("other")


def test_log_lines_counted_in_the_ports_registry():
    counter = get_registry().counter(
        "sparkml_log_lines_total", "", ("level",))
    theirs = jax_registry().counter("sparkml_log_lines_total", "",
                                    ("level",))
    before, jax_before = (counter.value(level="warning"),
                          theirs.value(level="warning"))
    StructuredLogger("counted", stream=io.StringIO()).warning("one")
    assert counter.value(level="warning") == before + 1
    assert theirs.value(level="warning") == jax_before


LOG_CALLS = {
    "info_fields": ("info", "model registered",
                    {"model": "pca", "version": 3}),
    "warning_nested": ("warning", "slow batch",
                       {"rows": [1, 2], "info": {"k": 1.5}}),
    "error_plain": ("error", "flight dump written", {}),
    "debug_gated": ("debug", "hidden at info", {"x": 1}),
    "unknown_level": ("loud", "falls back to info", {"k": "v"}),
    "reserved_field": ("info", "reserved keys are not overwritten",
                       {"logger": "other", "trace_id": "caller's"}),
    "non_serializable": ("info", "odd", {"payload": 7j}),
}


@pytest.mark.parametrize("case", sorted(LOG_CALLS))
@pytest.mark.parametrize("traced", [False, True])
def test_log_line_equals_the_jax_line(case, traced):
    """The same call through both loggers writes the same JSON object,
    the timestamp aside (with the same trace activated in both)."""
    level, message, fields = LOG_CALLS[case]
    streams = io.StringIO(), io.StringIO()
    ours = StructuredLogger("parity", stream=streams[0])
    theirs = jax_logging.StructuredLogger("parity", stream=streams[1])
    trace_id, span_id = tracectx.new_trace_id(), tracectx.new_span_id()
    with tracectx.activate(tracectx.TraceContext(trace_id, span_id)
                           if traced else None), \
            jax_tracectx.activate(jax_tracectx.TraceContext(
                trace_id, span_id) if traced else None):
        ours.log(level, message, **fields)
        theirs.log(level, message, **fields)
    got, want = _lines(streams[0]), _lines(streams[1])
    for rec in got + want:
        rec.pop("ts")
    assert got == want
    assert len(got) == (0 if level == "debug" else 1)
    if traced and got:
        assert got[0]["trace_id"] == trace_id


def test_log_token_bucket_suppresses_and_recovers(monkeypatch):
    monkeypatch.setenv(RATE_ENV, "1")
    monkeypatch.setenv(BURST_ENV, "5")
    clock = FakeClock(0.0)
    stream = io.StringIO()
    log = StructuredLogger("stormy", stream=stream, clock=clock)
    suppressed = get_registry().counter(
        "sparkml_log_suppressed_total", "", ("level", "logger"))
    before = suppressed.value(level="error", logger="stormy")
    for i in range(12):
        log.error("incident storm", i=i)
    assert len(_lines(stream)) == 5  # the burst
    assert suppressed.value(level="error", logger="stormy") == before + 7
    # refill: 3 seconds at 1 line/s admits more, and the first line
    # after the dry spell names the gap
    clock.t = 3.0
    log.error("after the storm")
    lines = _lines(stream)
    assert len(lines) == 6
    assert lines[-1]["suppressed_lines"] == 7
    # levels are independent buckets: info was never throttled here
    log.info("unrelated")
    assert _lines(stream)[-1]["message"] == "unrelated"


def test_log_rate_limit_disabled_with_nonpositive_rate(monkeypatch):
    monkeypatch.setenv(RATE_ENV, "0")
    stream = io.StringIO()
    log = StructuredLogger("free", stream=stream, clock=FakeClock())
    for _ in range(100):
        log.error("flood")
    assert len(_lines(stream)) == 100


@pytest.mark.parametrize("rate,burst", [("1", "5"), ("2.5", "3"),
                                        ("0.5", "1")])
def test_token_bucket_storm_equals_the_jax_one(both_envs, rate, burst):
    """A scripted storm on injected clocks: the same lines pass both
    buckets, with the same ``suppressed_lines`` gaps."""
    both_envs(RATE_ENV, rate)
    both_envs(BURST_ENV, burst)
    clocks = FakeClock(), FakeClock()
    streams = io.StringIO(), io.StringIO()
    ours = StructuredLogger("storm", stream=streams[0], clock=clocks[0])
    theirs = jax_logging.StructuredLogger("storm", stream=streams[1],
                                          clock=clocks[1])
    for step in range(40):
        for clock in clocks:
            clock.t = 0.13 * step + (2.0 if step > 25 else 0.0)
        for log in (ours, theirs):
            log.error("storm", step=step)
            if step % 7 == 0:
                log.info("aside", step=step)
    got, want = _lines(streams[0]), _lines(streams[1])
    for rec in got + want:
        rec.pop("ts")
    assert got == want
    assert 0 < len(got) < 40 + 6


def test_flight_dump_notice_is_structured(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(flight.DUMP_DIR_ENV, str(tmp_path))
    path = flight.dump("logging_test")
    assert path is not None
    err = capsys.readouterr().err
    recs = [json.loads(line) for line in err.splitlines()
            if line.strip().startswith("{")]
    notice = [r for r in recs if r.get("message") == "flight dump written"]
    assert notice and notice[0]["reason"] == "logging_test"
    assert notice[0]["path"] == path
    assert notice[0]["logger"] == "obs.flight"
    assert notice[0]["level"] == "error"


# -- retention GC -------------------------------------------------------------


def _mk_file(path, size, mtime):
    path.write_bytes(b"x" * size)
    os.utime(path, (mtime, mtime))


def test_retention_count_cap_oldest_first(tmp_path):
    root = tmp_path / "dumps"
    root.mkdir()
    for i in range(6):
        _mk_file(root / f"flightdump_r_{i}.json", 10, 1000.0 + i)
    (root / "unrelated.txt").write_text("never touched")
    (root / "flightdump_half.json.tmp").write_text("mid-rename")
    counter = get_registry().counter(
        "sparkml_obs_artifacts_gc_total", "", ("kind",))
    before = counter.value(kind="flight")
    removed = retention.sweep_kind("flight", root=str(root), dirs=False,
                                   keep_count=3, keep_bytes=0)
    assert removed == 3
    left = sorted(p.name for p in root.iterdir())
    assert "flightdump_r_5.json" in left  # newest kept
    assert "flightdump_r_0.json" not in left  # oldest gone
    assert "unrelated.txt" in left and "flightdump_half.json.tmp" in left
    assert counter.value(kind="flight") == before + 3


def test_retention_byte_cap_on_directories(tmp_path):
    root = tmp_path / "profiles"
    root.mkdir()
    for i in range(4):
        d = root / f"cap_{i}"
        d.mkdir()
        _mk_file(d / "torch_trace.json", 1000, 1000.0 + i)
        os.utime(d, (1000.0 + i, 1000.0 + i))
    removed = retention.sweep_kind("profile", root=str(root),
                                   dirs=True, keep_count=0,
                                   keep_bytes=2500)
    assert removed == 2
    assert sorted(p.name for p in root.iterdir()) == ["cap_2", "cap_3"]


def test_retention_always_keeps_newest_artifact(tmp_path):
    root = tmp_path / "dumps"
    root.mkdir()
    _mk_file(root / "flightdump_only.json", 10_000, 1000.0)
    removed = retention.sweep_kind("flight", root=str(root), dirs=False,
                                   keep_count=1, keep_bytes=1)
    assert removed == 0  # the artifact just written always survives


def test_retention_writer_hook_throttles(tmp_path, monkeypatch):
    monkeypatch.setenv(flight.DUMP_DIR_ENV, str(tmp_path / "dumps"))
    monkeypatch.setenv(retention.MAX_COUNT_ENV, "2")
    monkeypatch.setattr(retention, "_last_sweep", {})
    (tmp_path / "dumps").mkdir()
    for i in range(5):
        _mk_file(tmp_path / "dumps" / f"flightdump_{i}.json", 10,
                 1000.0 + i)
    assert retention.maybe_gc("flight", force=True) == 3
    _mk_file(tmp_path / "dumps" / "flightdump_9.json", 10, 1009.0)
    # inside the min interval the scan is skipped (a dump storm shares
    # one sweep); force overrides
    assert retention.maybe_gc("flight") == 0
    assert retention.maybe_gc("flight", force=True) == 1


def test_retention_kinds_root_under_the_dump_dir(tmp_path, monkeypatch):
    from spark_rapids_ml_tpu_torch.obs import profiler

    monkeypatch.setenv(flight.DUMP_DIR_ENV, str(tmp_path))
    monkeypatch.delenv(profiler.PROFILE_DIR_ENV, raising=False)
    assert retention._kind_root("flight") == (str(tmp_path), False)
    assert retention._kind_root("profile") == (
        os.path.join(str(tmp_path), "profiles"), True)
    assert retention._kind_root("incident") == (
        os.path.join(str(tmp_path), "incidents"), True)
    assert retention.KINDS == ("flight", "profile", "incident")
    monkeypatch.setattr(retention, "_last_sweep", {})
    assert retention.gc_all(force=True) == {
        "flight": 0, "profile": 0, "incident": 0}


def _tree(root, dirs, sizes):
    root.mkdir()
    for i, size in enumerate(sizes):
        mtime = 2000.0 + 3 * i
        if dirs:
            d = root / f"cap_{i}"
            d.mkdir()
            _mk_file(d / "a.json", size, mtime)
            _mk_file(d / "b.json", size // 2, mtime)
            os.utime(d, (mtime, mtime))
        else:
            _mk_file(root / f"flightdump_{i}.json", size, mtime)
    if not dirs:
        (root / "flightdump_x.json.tmp").write_text("partial")
        (root / "notes.txt").write_text("other")


@pytest.mark.parametrize("dirs", [False, True])
@pytest.mark.parametrize("keep_count,keep_bytes", [
    (3, 0), (0, 5000), (4, 2500), (1, 1), (10, 10**9), (0, 0),
])
def test_retention_sweep_equals_the_jax_sweep(tmp_path, dirs, keep_count,
                                              keep_bytes):
    """Identical trees through both sweepers: the same number removed and
    the same artifacts left."""
    sizes = [700, 1500, 300, 2200, 900, 1200]
    left = []
    for name, mod in (("port", retention), ("jax", jax_retention)):
        root = tmp_path / name
        _tree(root, dirs, sizes)
        removed = mod.sweep_kind("flight" if not dirs else "profile",
                                 root=str(root), dirs=dirs,
                                 keep_count=keep_count,
                                 keep_bytes=keep_bytes)
        left.append((removed, sorted(p.name for p in root.iterdir())))
    assert left[0] == left[1]
