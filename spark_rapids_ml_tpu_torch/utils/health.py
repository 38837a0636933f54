"""Device health checks at task start.

Counterpart of the JAX package's ``utils/health.py``. The reference's
failure posture is "let a CUDA error kill the task and let Spark
reschedule" (``rapidsml_jni.cu:115,189,356-358``). Here an explicit probe
runs a tiny op on each visible card (an 8 × 8 ones tensor summed, which
must read 64) and returns a structured verdict instead of raising, so a
broken device fails fast with a diagnosis instead of hanging a fit.

The platform is ``"cuda"`` and devices are named ``cuda:i``; with the CPU
asked for (``SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu``) it is ``"cpu"``. With
no card and no such request the verdict is unhealthy: the CPU is never
reported healthy in the card's place.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from spark_rapids_ml_tpu_torch.utils.resources import local_devices


@dataclass
class DeviceHealth:
    healthy: bool
    platform: str
    device_count: int
    probe_seconds: float
    error: Optional[str] = None
    devices: List[str] = field(default_factory=list)


def check_devices(probe_all: bool = True) -> DeviceHealth:
    """Probe the port's devices (every one, or the first); returns a
    verdict instead of raising.

    No timeout here: CUDA initialisation itself can block on a broken
    device, and an in-process deadline cannot preempt it — callers that
    need a hard bound use ``check_devices_subprocess``.
    """
    t0 = time.perf_counter()
    try:
        devices = local_devices()
        names = []
        for d in devices if probe_all else devices[:1]:
            out = torch.ones((8, 8), device=d).sum()
            if float(out) != 64.0:
                raise RuntimeError(f"bad probe result on {d}: {out}")
            names.append(str(d))
        return DeviceHealth(
            healthy=True,
            platform=devices[0].type,
            device_count=len(devices),
            probe_seconds=time.perf_counter() - t0,
            devices=names,
        )
    except Exception as e:  # noqa: BLE001 - health checks report, not raise
        return DeviceHealth(
            healthy=False,
            platform="unknown",
            device_count=0,
            probe_seconds=time.perf_counter() - t0,
            error=f"{type(e).__name__}: {e}",
        )


def check_devices_subprocess(timeout_seconds: float = 90.0) -> DeviceHealth:
    """Health probe with a hard wall-clock bound: runs in a child process
    (which inherits the environment, the platform request included) so a
    hanging CUDA initialisation cannot wedge the caller."""
    import json
    import os
    import subprocess
    import sys

    # The child's stdout is a parsed protocol (last line = the verdict
    # JSON), written directly — not print, not a logger.
    code = (
        "import json, sys\n"
        "from spark_rapids_ml_tpu_torch.utils.health import check_devices\n"
        "h = check_devices()\n"
        "sys.stdout.write(json.dumps(h.__dict__) + chr(10))\n"
    )
    # the child imports the package from wherever this process found it
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True,
            text=True,
            timeout=timeout_seconds,
            env=env,
        )
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        if proc.returncode == 0 and line.startswith("{"):
            return DeviceHealth(**json.loads(line))
        return DeviceHealth(
            healthy=False,
            platform="unknown",
            device_count=0,
            probe_seconds=time.perf_counter() - t0,
            error=f"probe exited rc={proc.returncode}: {proc.stderr[-300:]}",
        )
    except subprocess.TimeoutExpired:
        return DeviceHealth(
            healthy=False,
            platform="unknown",
            device_count=0,
            probe_seconds=time.perf_counter() - t0,
            error=f"device probe exceeded {timeout_seconds}s (CUDA initialisation hung?)",
        )
