"""Per-fit reports (``obs.report``), the device-memory watermark
(``obs.memory``) and the health probe (``utils.health``), held against the
JAX package's on the same seeded data.

The PCA ``fit_report_`` of both packages on one input: the same
``as_dict()`` keys, rows, features, ``bytes_processed`` and phase keys,
JSON-safe. Then the decorators themselves: ``attach_report`` on a tuple, a
NamedTuple and an ndarray, ``last_fit_report``, the metrics side effects,
trace export under ``SPARK_RAPIDS_ML_TORCH_TRACE_DIR``,
``fit_instrumentation`` on a plain function (and on a ``DeviceMesh`` of a
one-rank gloo world), and report assembly that raises. The CPU cases of
the watermark and the probe keep the JAX keys; fake CUDA readings stand in
for the card, whose own cases are in ``tests/test_torch_gpu.py``.
"""

import glob
import json
import subprocess
from typing import NamedTuple

import numpy as np
import pytest
import torch
import torch.distributed as dist

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu.obs import memory as jax_memory
from spark_rapids_ml_tpu.obs import report as jax_report
from spark_rapids_ml_tpu.parallel.mesh import mesh_shape as jax_mesh_shape
from spark_rapids_ml_tpu.utils import health as jax_health
from spark_rapids_ml_tpu_torch import PCA
from spark_rapids_ml_tpu_torch.obs import memory, metrics, report
from spark_rapids_ml_tpu_torch.obs.report import (
    FitReport,
    attach_report,
    current_fit,
    fit_instrumentation,
    last_fit_report,
)
from spark_rapids_ml_tpu_torch.parallel import mesh as mesh_mod
from spark_rapids_ml_tpu_torch.utils import health


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


@pytest.fixture
def fresh_registry(monkeypatch):
    """A metrics registry of this test's own (the default is process-wide)."""
    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_default_registry", reg)
    return reg


def _value(reg, name, **labels):
    family = reg.snapshot().get(name, {"samples": []})
    for sample in family["samples"]:
        if sample["labels"] == labels:
            return sample.get("value", sample.get("count"))
    return None


# -- the PCA report against the JAX package's -------------------------------

FITS = {
    "device": {},
    "host": {"useXlaDot": False, "useXlaSvd": False},
    "device_cov_host_solve": {"useXlaSvd": False},
}


@pytest.mark.parametrize("fit", list(FITS))
def test_pca_fit_report_matches_the_jax_report(rng, fit):
    x = rng.normal(size=(300, 10)) * (1.0 + np.arange(10)) ** -0.5
    reports = []
    for cls in (JaxPCA, PCA):
        est = cls().setK(3).setDtype("float64")
        for name, value in FITS[fit].items():
            est.set(name, value)
        model = est.fit(x)
        rep = model.fit_report_
        assert rep.algo == "pca"
        # phases absorb fit_timings_, which stays populated
        assert model.fit_timings_
        assert set(rep.phases) == set(model.fit_timings_) | {"total"}
        reports.append(rep)
    theirs, ours = reports
    assert isinstance(ours, FitReport)
    doc = json.loads(json.dumps(ours.as_dict()))
    assert set(doc) == set(theirs.as_dict())
    for key in ("rows", "features", "bytes_processed"):
        assert getattr(ours, key) == getattr(theirs, key)
    assert (ours.rows, ours.features, ours.bytes_processed) == \
        (300, 10, x.nbytes)
    assert set(ours.phases) == set(theirs.phases)
    assert ours.phases["total"] > 0
    assert ours.device_platform == theirs.device_platform == "cpu"
    assert ours.device_count == 1 and ours.healthy is True
    assert set(ours.health) == set(theirs.health)
    assert ours.memory["source"] == theirs.memory["source"] == "host_rss"
    assert set(ours.memory) == set(theirs.memory)
    assert ours.memory["per_device"] == [{"device": "cpu"}]
    assert ours.peak_device_bytes == ours.memory["host_peak_rss_bytes"]
    # nothing compiles; the analytic FLOPs are the Gram's, rows·n·(n+1)
    # (none where the host computes the covariance), and without a card's
    # peak there is no MFU
    assert (ours.compiles, ours.recompiles, ours.compile_seconds) == \
        (0, 0, 0.0)
    gram_flops = None if fit == "host" else 300 * 10 * 11
    assert ours.analytic_flops == gram_flops and ours.analytic_mfu is None
    assert ours.collectives == {} and ours.mesh_shape is None


def test_streamed_fit_reports_no_array_stats(rng):
    """A factory of chunks has no shape: rows and bytes stay unset in both
    packages, and the phases are still the fit's timings plus total."""
    chunks = [rng.normal(size=(64, 6)) for _ in range(3)]
    reports = []
    for cls in (JaxPCA, PCA):
        model = cls().setK(2).setDtype("float64").fit(lambda: iter(chunks))
        reports.append(model.fit_report_)
        assert set(model.fit_report_.phases) == \
            set(model.fit_timings_) | {"total"}
    theirs, ours = reports
    assert ours.rows is theirs.rows is None
    assert ours.bytes_processed is theirs.bytes_processed is None
    assert set(ours.phases) == set(theirs.phases)


def test_last_fit_report_and_metrics_side_effects(rng, fresh_registry):
    x = rng.normal(size=(40, 5))
    model = PCA().setK(2).fit(x)
    rep = model.fit_report_
    assert last_fit_report("pca") is rep and last_fit_report() is rep
    reg = fresh_registry
    assert _value(reg, "sparkml_fits_total", algo="pca") == 1
    assert _value(reg, "sparkml_fit_seconds", algo="pca") == 1
    assert _value(reg, "sparkml_rows_processed_total", algo="pca") == 40
    assert _value(reg, "sparkml_bytes_processed_total",
                  algo="pca") == x.nbytes
    assert _value(reg, "sparkml_device_count", platform="cpu") == 1
    assert _value(reg, "sparkml_host_peak_rss_bytes") == \
        rep.memory["host_peak_rss_bytes"]
    text = reg.prometheus_text()
    assert 'sparkml_fit_seconds_bucket{algo="pca",le="+Inf"} 1' in text
    PCA().setK(2).fit(x)
    assert _value(reg, "sparkml_fits_total", algo="pca") == 2


def test_trace_export_writes_the_fit_timeline(rng, tmp_path, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_TRACE_DIR", str(tmp_path))
    model = PCA().setK(2).fit(rng.normal(size=(32, 4)))
    files = glob.glob(str(tmp_path / "trace_pca_*.json"))
    assert len(files) == 1 and model.fit_report_.trace_id in files[0]
    events = json.loads(open(files[0]).read())["traceEvents"]
    assert events
    for ev in events:
        assert ev["ph"] == "X" and "ts" in ev and "dur" in ev
        assert isinstance(ev["pid"], int)
    assert [e for e in events if e["name"] == "fit:pca"]


def test_no_trace_file_without_the_env(rng, tmp_path, monkeypatch):
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    PCA().setK(2).fit(rng.normal(size=(32, 4)))
    assert not list(tmp_path.iterdir())


# -- attach_report -------------------------------------------------------------


class _Pair(NamedTuple):
    first: np.ndarray
    second: str


@pytest.mark.parametrize("kind", ["tuple", "namedtuple", "ndarray", "object"])
def test_attach_report_matches_the_jax_wrapping(kind):
    def make():
        return {"tuple": lambda: (np.arange(3), "second"),
                "namedtuple": lambda: _Pair(np.arange(3), "second"),
                "ndarray": lambda: np.arange(4.0),
                "object": lambda: type("Result", (), {})()}[kind]()

    ours = attach_report(make(), "ours")
    theirs = jax_report.attach_report(make(), "theirs")
    assert ours.fit_report_ == "ours" and theirs.fit_report_ == "theirs"
    assert type(ours).__name__ == type(theirs).__name__
    if kind == "ndarray":
        assert isinstance(ours, np.ndarray) and ours.sum() == 6.0
    elif kind != "object":
        a, b = ours
        assert list(a) == [0, 1, 2] and b == "second"
        assert isinstance(ours, tuple)
    if kind == "namedtuple":
        assert isinstance(ours, _Pair) and ours._fields == _Pair._fields
        assert ours.second == "second"


def test_attach_report_returns_what_cannot_carry_it():
    assert attach_report(7, "r") == 7
    assert attach_report(None, "r") is None


# -- fit_instrumentation -------------------------------------------------------


class _Fitted(NamedTuple):
    components: np.ndarray
    n_iter: int


def _plain_fit(package_report):
    """The same plain function, decorated by either package: records a
    collective, an iteration count and a phase, returns a NamedTuple."""

    @package_report.fit_instrumentation("plain_fit")
    def fit(x, y, k=2):
        ctx = package_report.current_fit()
        with ctx.phase("gram"):
            g = x.T @ x
        ctx.record_collective("all_reduce", shape=g.shape, dtype=g.dtype,
                              count=2)
        ctx.set_iterations(5)
        ctx.note(solver="eigh")
        return _Fitted(np.linalg.eigh(g)[1][:, :k], 5)

    return fit


def test_fit_instrumentation_on_a_plain_function(rng, fresh_registry):
    x = rng.normal(size=(50, 4))
    y = rng.normal(size=(50,))
    theirs = _plain_fit(jax_report)(x, y)
    ours = _plain_fit(report)(x, y)
    assert isinstance(ours, _Fitted) and ours.n_iter == 5
    np.testing.assert_array_equal(ours.components, theirs.components)
    a, b = ours.fit_report_, theirs.fit_report_
    assert set(a.as_dict()) == set(b.as_dict())
    for key in ("algo", "rows", "features", "bytes_processed", "n_iter",
                "collectives", "extra"):
        assert getattr(a, key) == getattr(b, key), key
    assert a.bytes_processed == x.nbytes + y.nbytes
    assert a.collectives == {"all_reduce": {"count": 2, "bytes": 2 * 4 * 4 * 8}}
    assert a.total_collective_calls() == 2
    assert a.total_collective_bytes() == 256
    assert set(a.phases) == set(b.phases) == {"gram", "total"}
    assert _value(fresh_registry, "sparkml_collective_calls_total",
                  algo="plain_fit", kind="all_reduce") == 2
    assert _plain_fit(report).__obs_instrumented__ == "plain_fit"
    # outside a fit the context is a no-op
    current_fit().record_collective("all_reduce", nbytes=8)
    with current_fit().phase("x"):
        pass


def test_a_raising_report_assembly_still_returns_the_result(rng, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("telemetry broke")

    monkeypatch.setattr(report, "_build_report", boom)
    x = rng.normal(size=(30, 4))
    model = PCA().setK(2).fit(x)
    assert model.pc.shape == (4, 2)
    assert getattr(model, "fit_report_", None) is None
    assert model.fit_timings_
    out = _plain_fit(report)(x, x[:, 0])
    assert isinstance(out, _Fitted) and not hasattr(out, "fit_report_")


def test_a_raising_fit_propagates_and_reports_nothing(rng):
    before = last_fit_report("pca")
    with pytest.raises(ValueError, match="k = 9"):
        PCA().setK(9).fit(rng.normal(size=(20, 4)))
    assert last_fit_report("pca") is before


def test_mesh_fields_from_a_one_rank_gloo_world(rng, tmp_path):
    """A ``DeviceMesh`` argument fills the mesh fields, as a JAX ``Mesh``
    does; ``mesh_shape`` has the JAX summary's keys."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = mesh_mod.data_mesh()
        summary = mesh_mod.mesh_shape(mesh)
        assert summary == {"axes": ("data",), "shape": (1,), "devices": 1,
                           "platform": "cpu"}

        class _JaxLike:  # the JAX summary's keys, from a stand-in mesh
            axis_names = ("data",)
            devices = np.array([type("D", (), {"platform": "cpu"})()])

        assert set(summary) == set(jax_mesh_shape(_JaxLike()))

        @fit_instrumentation("mesh_fit")
        def mesh_fit(x, mesh):
            return x.sum(0)

        x = rng.normal(size=(16, 3))
        rep = mesh_fit(x, mesh=mesh).fit_report_
        assert rep.mesh_shape == (1,) and rep.mesh_axes == ("data",)
        assert rep.device_platform == "cpu" and rep.device_count == 1
        assert json.loads(json.dumps(rep.as_dict()))["mesh_shape"] == [1]
        assert mesh_fit(x, mesh).fit_report_.mesh_axes == ("data",)
    finally:
        dist.destroy_process_group()


# -- memory watermarks ---------------------------------------------------------


def test_memory_watermarks_on_the_cpu_have_the_jax_keys():
    ours = memory.memory_watermarks()
    theirs = jax_memory.memory_watermarks()
    assert set(ours) == set(theirs)
    assert ours["source"] == theirs["source"] == "host_rss"
    assert ours["per_device"] == [{"device": "cpu"}]
    assert all(set(e) == {"device"} for e in theirs["per_device"])
    assert ours["peak_bytes"] == ours["host_peak_rss_bytes"] > 0
    assert memory.peak_bytes_in_use(torch.device("cpu")) is None


def test_memory_watermarks_without_a_card_or_a_request(monkeypatch):
    """No card and no CPU request: no device is listed (and none is
    reported healthy), the host RSS peak still is."""
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wm = memory.memory_watermarks()
    assert wm["per_device"] == [] and wm["source"] == "host_rss"


class _JaxDevice:
    """A PJRT-like device for the JAX reader: ``memory_stats()``."""

    def __init__(self, name, stats):
        self.name, self.stats = name, stats

    def memory_stats(self):
        return self.stats

    def __str__(self):
        return self.name


FAKE = {"cuda:0": {"bytes_in_use": 1 << 20, "peak_bytes_in_use": 5 << 20,
                   "bytes_limit": 80 << 30},
        "cuda:1": {"bytes_in_use": 2 << 20, "peak_bytes_in_use": 7 << 20,
                   "bytes_limit": 80 << 30}}


def test_memory_watermarks_on_fake_cards_equal_the_jax_reading(
        monkeypatch, fresh_registry):
    """The allocator's readings (faked) give the JAX reader's snapshot of
    the same PJRT readings, with ``cuda`` where it says ``pjrt``; the
    gauges carry them."""
    monkeypatch.setattr(memory, "device_memory_stats",
                        lambda d: dict(FAKE[str(d)]))
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    ours = memory.memory_watermarks(devices)
    theirs = jax_memory.memory_watermarks(
        [_JaxDevice(name, stats) for name, stats in FAKE.items()])
    assert ours["source"] == "cuda" and theirs["source"] == "pjrt"
    assert {k: v for k, v in ours.items() if k != "source"} == \
        {k: v for k, v in theirs.items() if k != "source"}
    assert ours["peak_bytes"] == 7 << 20
    assert memory.peak_bytes_in_use(devices[0]) == 5 << 20
    memory.record_memory_metrics(ours)
    assert _value(fresh_registry, "sparkml_device_peak_bytes",
                  device="cuda:1") == 7 << 20
    assert _value(fresh_registry, "sparkml_host_peak_rss_bytes") == \
        ours["host_peak_rss_bytes"]


def test_record_memory_metrics_never_raises(monkeypatch, fresh_registry):
    memory.record_memory_metrics({"per_device": [{"device": "cuda:0",
                                                  "peak_bytes_in_use": 3}],
                                  "host_peak_rss_bytes": None})
    assert _value(fresh_registry, "sparkml_device_peak_bytes",
                  device="cuda:0") == 3
    memory.record_memory_metrics({"per_device": None})  # malformed: no raise


# -- the health probe ----------------------------------------------------------


def test_check_devices_on_the_cpu():
    ours = health.check_devices()
    theirs = jax_health.check_devices()
    assert set(ours.__dict__) == set(theirs.__dict__)
    assert ours.healthy and ours.error is None
    assert (ours.platform, ours.device_count, ours.devices) == \
        ("cpu", 1, ["cpu"])
    assert theirs.healthy and theirs.platform == "cpu"
    assert health.check_devices(probe_all=False).devices == ["cpu"]


def test_check_devices_without_a_card_or_a_request_is_unhealthy(monkeypatch):
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    verdict = health.check_devices()
    assert verdict.healthy is False
    assert verdict.platform == "unknown" and verdict.device_count == 0
    assert "no CUDA device" in verdict.error
    assert verdict.devices == []


def test_check_devices_catches_a_wrong_probe_result(monkeypatch):
    monkeypatch.setattr(torch, "ones", lambda *a, **k: torch.zeros(8, 8))
    verdict = health.check_devices()
    assert verdict.healthy is False and "bad probe result" in verdict.error


def test_check_devices_subprocess_on_the_cpu():
    verdict = health.check_devices_subprocess(timeout_seconds=120)
    assert verdict.healthy, verdict.error
    assert (verdict.platform, verdict.devices) == ("cpu", ["cpu"])


def test_check_devices_subprocess_timeout_verdict(monkeypatch):
    def fake_run(*args, **kwargs):
        raise subprocess.TimeoutExpired(cmd="probe",
                                        timeout=kwargs.get("timeout", 0.0))

    monkeypatch.setattr(subprocess, "run", fake_run)
    verdict = health.check_devices_subprocess(timeout_seconds=0.25)
    assert verdict.healthy is False and verdict.device_count == 0
    assert "exceeded 0.25s" in verdict.error


def test_check_devices_subprocess_crash_verdict(monkeypatch):
    class FakeProc:
        returncode = 3
        stdout = ""
        stderr = "boom: the device fell over"

    monkeypatch.setattr(subprocess, "run", lambda *a, **k: FakeProc())
    verdict = health.check_devices_subprocess(timeout_seconds=5)
    assert verdict.healthy is False
    assert "rc=3" in verdict.error and "device fell over" in verdict.error


def test_the_report_caches_one_probe_per_process(monkeypatch):
    monkeypatch.setattr(report, "_health_cache", None)
    calls = []
    real = health.check_devices

    def counted():
        calls.append(1)
        return real()

    monkeypatch.setattr(health, "check_devices", counted)
    first = report._health_once()
    assert report._health_once() is first and len(calls) == 1
    assert first["healthy"] is True and first["platform"] == "cpu"
