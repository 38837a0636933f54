"""Device-memory readings and watermarks.

The port's copy of the JAX package's ``obs/memory.py``: the readers the
device monitor (``obs.devmon``) samples, and the watermark snapshot every
fit report embeds (``memory_watermarks``, exported as gauges by
``record_memory_metrics``). A CUDA device reports the caching allocator's counters
(``torch.cuda.memory_stats``) under PJRT's key names, so a reader of the
JAX package's gauges reads the port's the same way:

* ``bytes_in_use``      = ``allocated_bytes.all.current``
* ``peak_bytes_in_use`` = ``allocated_bytes.all.peak``
* ``bytes_limit``       = the device's ``total_memory`` (read once, cached)

The allocator's counters are host-side reads: no driver call, no
synchronisation, no context created on a device that has none. That is
why a sample never calls ``torch.cuda.mem_get_info`` or
``torch.cuda.synchronize`` — a sweep runs every second beside live
batches. The CPU device has no device statistics (``None``, as PJRT's CPU
backend), and the monitor reports the process RSS for it instead, tagged
``host_rss`` so a host number is never mistaken for a device number.

The allocator keeps ``allocated_bytes.all.peak`` as a true high-watermark
since the process started (or since ``torch.cuda.reset_peak_memory_stats``),
so an end-of-fit read IS the watermark: no sampling thread is needed. Where
the JAX package's watermark says ``"source": "pjrt"``, the port's says
``"cuda"``.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch

from spark_rapids_ml_tpu_torch.utils.resources import local_devices


@functools.lru_cache(maxsize=None)
def _total_memory(index: int) -> int:
    return int(torch.cuda.get_device_properties(index).total_memory)


def device_memory_stats(device) -> Optional[Dict[str, Any]]:
    """One device's memory in PJRT's keys, or None for a device without
    statistics (the CPU) or a read that fails (telemetry must not break
    the sweep that reads it)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else 0
    try:
        stats = torch.cuda.memory_stats(index)
        return {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": _total_memory(index),
        }
    except (RuntimeError, AssertionError):
        return None


def host_peak_rss_bytes() -> Optional[int]:
    """Process-lifetime RSS high-watermark (ru_maxrss is KiB on Linux,
    bytes on macOS)."""
    try:
        import resource
        import sys

        scale = 1 if sys.platform == "darwin" else 1024
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * scale
    except Exception:
        return None


def host_current_rss_bytes() -> Optional[int]:
    """CURRENT process RSS (``/proc/self/statm`` resident pages × page
    size) — unlike ``ru_maxrss`` this goes DOWN when memory is freed, so
    a gauge fed from it shows a trend, not a high-watermark. None where
    /proc is unavailable (macOS)."""
    try:
        import resource

        with open("/proc/self/statm") as f:
            resident_pages = int(f.read().split()[1])
        return resident_pages * resource.getpagesize()
    except Exception:
        return None


def peak_bytes_in_use(device) -> Optional[int]:
    """One device's peak bytes in use, or None without statistics."""
    stats = device_memory_stats(device)
    if stats is None:
        return None
    peak = int(stats.get("peak_bytes_in_use",
                         stats.get("bytes_in_use", 0)))
    return peak or None


def memory_watermarks(devices=None) -> Dict[str, Any]:
    """The uniform watermark snapshot every report embeds.

    Returns ``{"source": "cuda"|"host_rss"|"none", "peak_bytes": int|None,
    "host_peak_rss_bytes": int|None, "per_device": [...]}`` —
    ``peak_bytes`` is the highest per-device allocator watermark when any
    device has statistics, else the host RSS peak (so a CPU run still
    carries a concrete number, visibly host-sourced).
    """
    if devices is None:
        try:
            devices = local_devices()
        except (RuntimeError, ValueError):  # no device: the host RSS alone
            devices = []
    per_device: List[Dict[str, Any]] = []
    device_peaks = []
    for d in devices:
        stats = device_memory_stats(d)
        entry: Dict[str, Any] = {"device": str(d)}
        if stats is not None:
            peak = int(stats.get("peak_bytes_in_use",
                                 stats.get("bytes_in_use", 0)))
            entry["peak_bytes_in_use"] = peak
            entry["bytes_in_use"] = int(stats.get("bytes_in_use", 0))
            if "bytes_limit" in stats:
                entry["bytes_limit"] = int(stats["bytes_limit"])
            device_peaks.append(peak)
        per_device.append(entry)
    rss = host_peak_rss_bytes()
    if device_peaks:
        source = "cuda"
        peak: Optional[int] = max(device_peaks)
    elif rss is not None:
        source = "host_rss"
        peak = rss
    else:
        source = "none"
        peak = None
    return {
        "source": source,
        "peak_bytes": peak,
        "host_peak_rss_bytes": rss,
        "per_device": per_device,
    }


def record_memory_metrics(watermarks: Optional[Dict[str, Any]] = None
                          ) -> None:
    """Export a watermark snapshot into the process metrics registry
    (``sparkml_device_peak_bytes{device=}`` + the host RSS gauge)."""
    try:
        from spark_rapids_ml_tpu_torch.obs.metrics import get_registry

        wm = watermarks if watermarks is not None else memory_watermarks()
        reg = get_registry()
        for entry in wm.get("per_device", ()):
            if "peak_bytes_in_use" in entry:
                reg.gauge(
                    "sparkml_device_peak_bytes",
                    "per-device peak bytes in use (allocator watermark)",
                    ("device",),
                ).set(entry["peak_bytes_in_use"], device=entry["device"])
        if wm.get("host_peak_rss_bytes") is not None:
            reg.gauge(
                "sparkml_host_peak_rss_bytes",
                "process RSS high-watermark",
            ).set(wm["host_peak_rss_bytes"])
    except Exception:
        pass  # telemetry must never break the caller


__all__ = [
    "device_memory_stats",
    "host_current_rss_bytes",
    "host_peak_rss_bytes",
    "memory_watermarks",
    "peak_bytes_in_use",
    "record_memory_metrics",
]
