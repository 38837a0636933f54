"""Per-device monitor: memory gauges + batch-time attribution.

The port's copy of the JAX package's ``obs/devmon.py``, with the same
metric names, labels and help text, over the port's devices: every
visible ``cuda:i``, or ``[cpu]`` when the CPU was asked for
(``SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu``, ``utils/resources.py``). With
neither, constructing the monitor raises, as every entry point does: an
empty device list would hide a missing card.

* ``sample()`` — per-device in-use / limit / peak gauges
  (``sparkml_device_mem_bytes_in_use{device,source}`` etc.). A CUDA
  device reads the caching allocator's counters (``obs.memory``;
  ``source="cuda"``, host-side reads, no driver call and no sync); the
  CPU device reports the process RSS (``source="host_rss"``), so a host
  number is never mistaken for a device number. Registered as a sampler
  collector by ``obs.tsdb.start_sampling``, so every gauge gets history.
* ``note_batch(model, seconds, device)`` — batch-time attribution, wired
  from ``serve/batching.py``: each completed batch's union busy time
  lands in ``sparkml_serve_device_batch_seconds_total{model,device}``
  (+ a batches counter), so per-device occupancy is
  ``rate(batch_seconds)`` out of the history store — ``occupancy(window)``
  computes exactly that. Never raises into the batcher: attribution is
  telemetry, not control flow.

A sweep is skipped while ``torch.profiler`` starts or stops
(``_profiler_transition_pending``, ``obs.profiler``), as the JAX monitor
skips one around ``jax.profiler``; the gauges keep updating through the
capture window itself.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import torch

from spark_rapids_ml_tpu_torch.obs import memory as memory_mod
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
from spark_rapids_ml_tpu_torch.utils.resources import local_devices

SOURCE_DEVICE = "cuda"
SOURCE_HOST = "host_rss"


def _profiler_transition_pending() -> bool:
    try:
        from spark_rapids_ml_tpu_torch.obs import profiler

        return profiler.torch_transition_pending()
    except Exception:
        return False


class DeviceMonitor:
    """One process-wide monitor over the local devices."""

    def __init__(self, devices_fn=local_devices):
        self._devices_fn = devices_fn
        # resolved once here: no card and no CPU request raises now
        self._default_device = str(devices_fn()[0])
        self._lock = threading.Lock()
        # last sample() reading per device label, for readers that must
        # not re-poll the device on a request path
        self._last_sample: Dict[str, Dict[str, Any]] = {}
        reg = get_registry()
        self._m_in_use = reg.gauge(
            "sparkml_device_mem_bytes_in_use",
            "per-device bytes in use (PJRT memory_stats; host RSS on "
            "backends without device stats)", ("device", "source"),
        )
        self._m_limit = reg.gauge(
            "sparkml_device_mem_bytes_limit",
            "per-device memory limit (PJRT memory_stats)",
            ("device", "source"),
        )
        self._m_peak = reg.gauge(
            "sparkml_device_mem_peak_bytes",
            "per-device peak bytes in use (PJRT high-watermark; host RSS "
            "peak on backends without device stats)", ("device", "source"),
        )
        self._m_batch_seconds = reg.counter(
            "sparkml_serve_device_batch_seconds_total",
            "device wall-clock attributed to coalesced serve batches — "
            "rate() of this series is per-device occupancy",
            ("model", "device"),
        )
        self._m_batches = reg.counter(
            "sparkml_serve_device_batches_total",
            "coalesced serve batches attributed per device",
            ("model", "device"),
        )
        self._m_overhead = reg.counter(
            "sparkml_obs_overhead_seconds_total",
            "wall-clock the observability layer spends watching "
            "(sampler sweeps, device monitor, profiler bookkeeping)",
            ("component",),
        )

    # -- memory gauges -----------------------------------------------------

    def sample(self) -> List[Dict[str, Any]]:
        """Publish every device's memory gauges; returns what was read.

        One entry per device: the allocator's counters for a CUDA device,
        the process RSS (tagged ``host_rss``) for the CPU."""
        t0 = time.perf_counter()
        out: List[Dict[str, Any]] = []
        if _profiler_transition_pending():
            # skip this sweep only while a profiler start()/stop() is in
            # flight — gauges keep updating through the capture window
            # itself (a long capture must not hide the very memory ramp
            # the operator is profiling)
            return out
        rss: Optional[int] = None
        peak_rss: Optional[int] = None
        for device in self._devices_fn():
            label = str(device)
            stats = memory_mod.device_memory_stats(device)
            if stats is not None:
                in_use = int(stats["bytes_in_use"])
                peak = int(stats["peak_bytes_in_use"])
                limit = int(stats["bytes_limit"])
                entry: Dict[str, Any] = {
                    "device": label, "source": SOURCE_DEVICE,
                    "bytes_in_use": in_use, "peak_bytes_in_use": peak,
                    "bytes_limit": limit,
                }
                self._m_in_use.set(in_use, device=label, source=SOURCE_DEVICE)
                self._m_peak.set(peak, device=label, source=SOURCE_DEVICE)
                self._m_limit.set(limit, device=label, source=SOURCE_DEVICE)
            else:
                # in_use is CURRENT RSS (it goes down on free, so a spike
                # and a leak look different in the history), peak the
                # lifetime watermark; ru_maxrss only where /proc is
                # unavailable (then in_use IS the watermark)
                if rss is None:
                    peak_rss = memory_mod.host_peak_rss_bytes() or 0
                    rss = memory_mod.host_current_rss_bytes() or peak_rss
                entry = {
                    "device": label, "source": SOURCE_HOST,
                    "bytes_in_use": rss, "peak_bytes_in_use": peak_rss,
                }
                self._m_in_use.set(rss, device=label, source=SOURCE_HOST)
                self._m_peak.set(peak_rss, device=label, source=SOURCE_HOST)
            out.append(entry)
        with self._lock:
            for entry in out:
                self._last_sample[entry["device"]] = entry
        self._m_overhead.inc(time.perf_counter() - t0, component="devmon")
        return out

    def last_sample(self, device: str) -> Optional[Dict[str, Any]]:
        """The most recent ``sample()`` reading for one device label
        (None before any sweep has run)."""
        with self._lock:
            return self._last_sample.get(device)

    def memory_pressure(self, device: str) -> Optional[float]:
        """in-use / limit for one device from the last sample, or None
        when unknowable — no sample yet, no limit, or the reading is host
        RSS (a process-wide number is not a per-device verdict)."""
        entry = self.last_sample(device)
        if entry is None or entry.get("source") != SOURCE_DEVICE:
            return None
        limit = entry.get("bytes_limit")
        if not limit:
            return None
        return float(entry.get("bytes_in_use", 0)) / float(limit)

    # -- batch-time attribution --------------------------------------------

    def default_device_label(self) -> str:
        """The label a batch without an explicit device attributes to:
        the first of the port's devices."""
        return self._default_device

    def note_batch(self, model: str, seconds: float,
                   device: Optional[str] = None) -> None:
        """Attribute one coalesced batch's device time. NEVER raises —
        this is called from the batcher's hot path."""
        try:
            label = device or self._default_device
            self._m_batch_seconds.inc(max(float(seconds), 0.0),
                                      model=model, device=label)
            self._m_batches.inc(model=model, device=label)
        except Exception:
            pass  # attribution must never fail a batch

    def occupancy(self, window: float = 60.0) -> Dict[str, float]:
        """Per-device busy fraction over the trailing window, computed
        as ``rate(sparkml_serve_device_batch_seconds_total)`` from the
        history store (empty dict before any sampling)."""
        from spark_rapids_ml_tpu_torch.obs import tsdb

        out: Dict[str, float] = {}
        for series in tsdb.get_tsdb().rate_points(
            "sparkml_serve_device_batch_seconds_total", window=window,
        ):
            device = series["labels"].get("device", "unknown")
            points = series["points"]
            if not points:
                continue
            mean = sum(v for _ts, v in points) / len(points)
            out[device] = out.get(device, 0.0) + mean
        return out


_monitor: Optional[DeviceMonitor] = None
_monitor_lock = threading.Lock()


def get_device_monitor() -> DeviceMonitor:
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            _monitor = DeviceMonitor()
        return _monitor


def reset_device_monitor() -> None:
    """Drop the cached monitor (tests that reset the registry)."""
    global _monitor
    with _monitor_lock:
        _monitor = None


__all__ = [
    "DeviceMonitor",
    "get_device_monitor",
    "reset_device_monitor",
]
