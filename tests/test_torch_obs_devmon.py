"""obs.devmon and obs.memory: the port's device monitor against the JAX
package's, on the same readings.

CUDA devices are faked here (no card): ``torch.cuda.memory_stats`` and
``get_device_properties`` are patched, and the JAX monitor reads fake
devices whose ``memory_stats()`` report the same numbers under PJRT's
keys. The CPU device reads the process RSS in both packages. The last
cases serve batches on a CPU engine and hold the attributed batch seconds
to the batcher's own busy counter."""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.obs import get_registry as jax_registry
from spark_rapids_ml_tpu.obs import memory as jax_memory
from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu.obs import tsdb as jax_tsdb
from spark_rapids_ml_tpu.obs.devmon import DeviceMonitor as JaxDeviceMonitor
from spark_rapids_ml_tpu_torch import PCAModel
from spark_rapids_ml_tpu_torch.obs import devmon
from spark_rapids_ml_tpu_torch.obs import memory
from spark_rapids_ml_tpu_torch.obs import metrics
from spark_rapids_ml_tpu_torch.obs import tsdb
from spark_rapids_ml_tpu_torch.obs.devmon import DeviceMonitor
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
from spark_rapids_ml_tpu_torch.serve import ModelRegistry, ServeEngine
from spark_rapids_ml_tpu_torch.utils.resources import PLATFORM_ENV

WAIT = 30.0
GAUGES = ("sparkml_device_mem_bytes_in_use", "sparkml_device_mem_bytes_limit",
          "sparkml_device_mem_peak_bytes")


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv(PLATFORM_ENV, "cpu")
    devmon.reset_device_monitor()
    memory._total_memory.cache_clear()
    yield
    devmon.reset_device_monitor()
    memory._total_memory.cache_clear()


def _gauge(reg, name, **labels):
    return reg.gauge(name, "", ("device", "source")).value(**labels)


# -- fake CUDA devices, the same numbers as the JAX test's fake devices ------


class _FakeJaxDevice:
    def __init__(self, i):
        self.i = i

    def memory_stats(self):
        return {"bytes_in_use": 100 + self.i,
                "peak_bytes_in_use": 200 + self.i, "bytes_limit": 1000}

    def __str__(self):
        return f"cuda:{self.i}"


class _Props:
    total_memory = 1000


@pytest.fixture
def fake_cuda(monkeypatch):
    """Two fake CUDA devices behind the allocator's counters; any driver
    call or sync a sample must not make fails the test. Both packages'
    metrics registries are the test's own: the fake devices' memory
    gauges must not stay in the process-wide registries, where a later
    history sweep would record them."""
    monkeypatch.setattr(metrics, "_default_registry",
                        metrics.MetricsRegistry())
    monkeypatch.setattr(jax_metrics, "_default_registry",
                        jax_metrics.MetricsRegistry())
    props_calls = []

    def memory_stats(index):
        return {"allocated_bytes.all.current": 100 + index,
                "allocated_bytes.all.peak": 200 + index,
                "allocated_bytes.all.freed": 7}

    def get_device_properties(index):
        props_calls.append(index)
        return _Props()

    def forbidden(*_args, **_kwargs):
        raise AssertionError("a sample made a driver call")

    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        get_device_properties)
    monkeypatch.setattr(torch.cuda, "mem_get_info", forbidden)
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    return [torch.device("cuda", 0), torch.device("cuda", 1)], props_calls


def test_cuda_memory_stats_map_to_pjrt_keys(fake_cuda):
    devices, props_calls = fake_cuda
    for i, device in enumerate(devices):
        got = memory.device_memory_stats(device)
        assert got == _FakeJaxDevice(i).memory_stats()
        assert got == jax_memory.device_memory_stats(_FakeJaxDevice(i))
    memory.device_memory_stats(devices[0])
    assert props_calls == [0, 1]  # total_memory is read once per device


def test_cpu_device_has_no_device_stats():
    import jax

    assert memory.device_memory_stats(torch.device("cpu")) is None
    assert jax_memory.device_memory_stats(jax.devices("cpu")[0]) is None


def test_sample_cuda_path_equals_the_jax_pjrt_path(fake_cuda):
    devices, _ = fake_cuda
    port = DeviceMonitor(devices_fn=lambda: devices)
    ref = JaxDeviceMonitor(
        devices_fn=lambda: [_FakeJaxDevice(0), _FakeJaxDevice(1)])
    got, want = port.sample(), ref.sample()
    assert [e["source"] for e in got] == ["cuda", "cuda"]
    assert [dict(e, source="pjrt") for e in got] == want
    for entry in got:
        label = entry["device"]
        for name in GAUGES:
            assert (_gauge(get_registry(), name, device=label,
                           source="cuda")
                    == _gauge(jax_registry(), name, device=label,
                              source="pjrt"))
        assert port.memory_pressure(label) == ref.memory_pressure(label)
        assert port.memory_pressure(label) == pytest.approx(
            entry["bytes_in_use"] / 1000)
    assert _gauge(get_registry(), "sparkml_device_mem_bytes_in_use",
                  device="cuda:1", source="cuda") == 101
    assert port.default_device_label() == "cuda:0"


def test_sample_on_the_cpu_reports_host_rss():
    import jax

    mon = DeviceMonitor()
    out = mon.sample()
    ref = JaxDeviceMonitor().sample()
    assert len(ref) == len(jax.devices())
    assert [e["device"] for e in out] == ["cpu"]
    entry = out[0]
    # the same entry shape as the JAX package's CPU devices, visibly
    # host-sourced: a host number is never mistaken for a device number
    assert {e["source"] for e in ref} == {entry["source"]} == {"host_rss"}
    assert set(entry) == set(ref[0])
    assert entry["bytes_in_use"] > 0 and entry["peak_bytes_in_use"] > 0
    assert _gauge(get_registry(), "sparkml_device_mem_bytes_in_use",
                  device="cpu", source="host_rss") == entry["bytes_in_use"]
    assert mon.last_sample("cpu") == entry
    assert mon.memory_pressure("cpu") is None  # host RSS is no verdict
    assert mon.memory_pressure("cuda:0") is None  # never sampled
    overhead = get_registry().counter(
        "sparkml_obs_overhead_seconds_total", "", ("component",))
    assert overhead.value(component="devmon") > 0.0


def test_host_rss_readers_read_what_the_jax_readers_read():
    # the same /proc and getrusage reads: within what this process
    # allocates between the two calls
    assert abs(memory.host_peak_rss_bytes()
               - jax_memory.host_peak_rss_bytes()) < 64 << 20
    assert abs(memory.host_current_rss_bytes()
               - jax_memory.host_current_rss_bytes()) < 64 << 20


def test_without_a_card_or_a_cpu_request_the_monitor_raises(monkeypatch):
    monkeypatch.delenv(PLATFORM_ENV)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=PLATFORM_ENV):
        DeviceMonitor()
    with pytest.raises(RuntimeError, match=PLATFORM_ENV):
        devmon.get_device_monitor()
    with pytest.raises(RuntimeError, match=PLATFORM_ENV):
        tsdb.start_sampling()
    assert devmon._monitor is None


def test_a_monitor_whose_devices_fail_does_not_construct():
    def broken():
        raise RuntimeError("no devices")

    with pytest.raises(RuntimeError, match="no devices"):
        DeviceMonitor(devices_fn=broken)


# -- batch-time attribution ---------------------------------------------------


def test_note_batch_attributes_device_time_as_the_jax_monitor():
    # microseconds: below the JAX cost ledger's reconcile floor, so the
    # children this leaves in the JAX registry weigh in no JAX test
    port, ref = DeviceMonitor(), JaxDeviceMonitor()
    for mon in (port, ref):
        mon.note_batch("devmon_port_model", 2.5e-6)
        mon.note_batch("devmon_port_model", 7.5e-6, device="dev:7")
        mon.note_batch("devmon_port_model", -1.0, device="dev:7")
    for reg, default in ((get_registry(), "cpu"),
                         (jax_registry(), ref.default_device_label())):
        seconds = reg.counter("sparkml_serve_device_batch_seconds_total",
                              "", ("model", "device"))
        batches = reg.counter("sparkml_serve_device_batches_total", "",
                              ("model", "device"))
        assert seconds.value(model="devmon_port_model",
                             device=default) == 2.5e-6
        assert seconds.value(model="devmon_port_model",
                             device="dev:7") == 7.5e-6
        assert batches.value(model="devmon_port_model", device="dev:7") == 2.0


@pytest.mark.parametrize("seconds", ["abc", None, object()])
def test_note_batch_never_raises(seconds):
    mon = DeviceMonitor()
    mon.note_batch("devmon_never_raises", seconds)
    JaxDeviceMonitor().note_batch("devmon_never_raises", seconds)
    assert get_registry().counter(
        "sparkml_serve_device_batches_total", "", ("model", "device")
    ).value(model="devmon_never_raises", device="cpu") == 0.0


def test_occupancy_reads_from_history(monkeypatch):
    stores = []
    for module in (jax_tsdb, tsdb):
        store = module.TimeSeriesStore(tiers=((1.0, 300.0),),
                                       clock=lambda: 1010.0)
        # 1 s of device time per 1 s of wall clock = occupancy 1.0 on d0,
        # half that on d1 from the 5th second
        for i in range(10):
            store.record("sparkml_serve_device_batch_seconds_total",
                         {"model": "m", "device": "d0"}, float(i),
                         kind="counter", now=1000.0 + i)
            if i >= 5:
                store.record("sparkml_serve_device_batch_seconds_total",
                             {"model": "m", "device": "d1"}, i * 0.5,
                             kind="counter", now=1000.0 + i)
        monkeypatch.setattr(module, "_store", store)
        stores.append(store)
    got = DeviceMonitor().occupancy(window=60.0)
    assert got == JaxDeviceMonitor(devices_fn=lambda: []).occupancy(
        window=60.0)
    assert got == {"d0": 1.0, "d1": 0.5}


class _Double:
    """A model without a serving program: the blocking path."""

    def transform(self, x):
        return np.asarray(x) * 2.0


def _counter_value(name, **labels):
    family = get_registry().counter(name, "", tuple(labels))
    return family.value(**labels)


@pytest.mark.parametrize("program", [True, False],
                         ids=["pipelined", "blocking"])
def test_batcher_attributes_its_busy_time_through_devmon(rng, program):
    """Served batches land their union busy time in
    ``sparkml_serve_device_batch_seconds_total{device="cpu"}``, equal to
    the batcher's own ``sparkml_serve_device_busy_seconds_total``."""
    name = f"devmon_wired_{'pipelined' if program else 'blocking'}"
    x = rng.normal(size=(64, 6))
    if program:
        model = PCAModel.from_numpy(
            np.linalg.qr(rng.normal(size=(6, 3)))[0], [0.5, 0.3, 0.2]
        ).setDtype("float64")
    else:
        model = _Double()
    registry = ModelRegistry()
    registry.register(name, model)
    engine = ServeEngine(registry, max_batch_rows=16, max_wait_ms=1,
                         pipeline_depth=2 if program else 1)
    try:
        for i in range(6):
            engine.predict(name, x[i * 8:(i + 1) * 8 + i], timeout=WAIT)
        batcher = engine._batchers[(name, 1)]
        assert (batcher.async_spec is not None) == program
        assert batcher.device_label == ("cpu" if program else None)
    finally:
        engine.shutdown()
    busy = _counter_value("sparkml_serve_device_busy_seconds_total",
                          model=name)
    attributed = _counter_value("sparkml_serve_device_batch_seconds_total",
                                model=name, device="cpu")
    assert busy > 0.0 and attributed == busy
    assert _counter_value("sparkml_serve_device_batches_total", model=name,
                          device="cpu") == _counter_value(
        "sparkml_serve_batches_total", model=name)
