"""Device-memory readings for the device monitor (``obs.devmon``).

The port's cut of the JAX package's ``obs/memory.py``: the readers the
monitor samples. A CUDA device reports the caching allocator's counters
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
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch


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


__all__ = [
    "device_memory_stats",
    "host_current_rss_bytes",
    "host_peak_rss_bytes",
]
