"""Guarded on-demand device profiling: ``POST /debug/profile`` backend.

The port's copy of the JAX package's ``obs/profiler.py``, on
``torch.profiler``. The hot-path latency work needs device-timeline
evidence ("where did the batch's 4 ms go?") that metrics cannot give.
This module turns one HTTP request into a bounded capture:

* ``start_capture(seconds)`` runs a ``torch.profiler.profile`` into the
  profile dir (``SPARK_RAPIDS_ML_TORCH_OBS_PROFILE_DIR``, default
  ``<dump_dir>/profiles``) — **single-flight** (a second start while
  one is running raises ``CaptureInFlight``), auto-stopped after
  ``seconds`` (clamped to ``MAX_SECONDS``), and exported as
  ``torch_<id>.json`` (Chrome trace). On the card it records
  ``[CPU, CUDA]`` activities (CUPTI: kernels, memcpys, memsets); only
  with the CPU requested (``SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu``) is it
  ``[CPU]`` alone, and with neither it raises, as every entry point
  does. There is **no fallback**: a capture that asked for CUDA and got
  no device event (CUPTI failed, or the probe kernel the helper
  launches after ``start()`` went unrecorded) is ``torch_unavailable``,
  never ``ok`` on CPU events alone;
* the profiler starts with ``profile_all_threads=True``: a profiler
  started on a helper thread otherwise records no CPU op of any other
  thread, and the batcher's workers exist before any capture starts;
* ``start()`` and ``stop()`` run on their **own helper thread with a
  bounded join**: the first ``start()`` in a process initialises
  Kineto (seconds), and an ops endpoint must never inherit a stall.
  A capture whose helper misses the join grace completes anyway
  (``outcome="torch_wedged"``); the helper cleans up after itself when
  the profiler unblocks (start → sees the stop event → stop → exit),
  and while it is still draining, new captures skip the torch trace
  (``torch_enabled=false``) instead of stacking a second ``start()``
  behind it. Every capture still lands a loadable artifact, because
* every capture ALSO exports the span-ring as a Chrome-trace JSON into
  the same directory (loadable in Perfetto / ``chrome://tracing``)
  regardless of the native profiler's mood;
* the capture itself is observable: an ``obs:profile`` span covering
  the window, ``sparkml_obs_profile_captures_total{outcome}`` counts
  (``started`` / ``completed`` / ``torch_unavailable`` /
  ``torch_wedged``), and the bookkeeping cost lands in
  ``sparkml_obs_overhead_seconds_total{component="profiler"}``.

``fit_run_id`` names the fit-monitor run (``obs.fitmon``) active when the
capture started, None outside any monitored fit.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from spark_rapids_ml_tpu_torch.obs import flight
from spark_rapids_ml_tpu_torch.obs.logging import get_logger
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
from spark_rapids_ml_tpu_torch.utils.resources import (
    PLATFORM_ENV,
    cpu_requested,
)

PROFILE_DIR_ENV = "SPARK_RAPIDS_ML_TORCH_OBS_PROFILE_DIR"
MAX_SECONDS = 300.0
_DEFAULT_SECONDS = 5.0
# How long past the capture window the torch helper thread gets to come
# back before the profiler is declared wedged.
_JOIN_GRACE = 2.0
# Chrome-trace categories of device activity (CUPTI)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

_log = get_logger("obs.profiler")


class CaptureInFlight(RuntimeError):
    """A profile capture is already running — captures are single-flight
    (two overlapping profiler sessions would corrupt the trace, and a
    scrape loop must not be able to stack profiler overhead)."""


def profile_dir() -> str:
    return (os.environ.get(PROFILE_DIR_ENV)
            or os.path.join(flight.dump_dir(), "profiles"))


def _captures_counter():
    return get_registry().counter(
        "sparkml_obs_profile_captures_total",
        "on-demand profiler captures by outcome", ("outcome",),
    )


def _overhead_counter():
    return get_registry().counter(
        "sparkml_obs_overhead_seconds_total",
        "wall-clock the observability layer spends watching "
        "(sampler sweeps, device monitor, profiler bookkeeping)",
        ("component",),
    )


class _Capture:
    __slots__ = ("id", "path", "seconds", "t0_perf", "started_unix",
                 "stop_event", "thread", "torch_thread", "torch_started",
                 "torch_result", "device", "fit_run_id")

    def __init__(self, cid: str, path: str, seconds: float, device: str):
        self.id = cid
        self.path = path
        self.seconds = seconds
        self.t0_perf = time.perf_counter()
        self.started_unix = time.time()
        self.stop_event = threading.Event()
        self.thread: Optional[threading.Thread] = None
        self.torch_thread: Optional[threading.Thread] = None
        self.torch_started = threading.Event()
        self.torch_result: Optional[str] = None
        # "cuda" ([CPU, CUDA] activities) or "cpu" ([CPU] only)
        self.device = device
        # the JAX key, kept: the port has no fit monitor yet
        self.fit_run_id: Optional[str] = None


_lock = threading.Lock()
_active: Optional[_Capture] = None
_last: Optional[Dict[str, Any]] = None
# The most recent torch helper thread. While it is still alive (wedged in
# start/stop), new captures skip the torch trace — two overlapping
# profiler sessions would corrupt the trace — and re-arm automatically
# once it drains and cleans up after itself.
_torch_helper: Optional[threading.Thread] = None


def torch_profiler_busy() -> bool:
    """A previous capture's torch helper is still wedged in the profiler
    (new captures serve span-ring artifacts until it drains)."""
    with _lock:
        helper = _torch_helper
    return helper is not None and helper.is_alive()


def torch_transition_pending() -> bool:
    """True only while a profiler ``start()``/``stop()`` call is actually
    in flight. The window between them — trace running, helper parked in
    its ``stop_event`` wait — is NOT a transition: allocator reads are
    safe then, so a long capture must not blind the device monitor for
    its whole duration."""
    with _lock:
        cap = _active
        helper = _torch_helper
    cap_thread = cap.torch_thread if cap is not None else None
    if cap_thread is not None and cap_thread.is_alive():
        if not cap.torch_started.is_set():
            return True  # start() in flight
        if cap.torch_result is None and (
                cap.stop_event.is_set()
                or time.perf_counter() - cap.t0_perf >= cap.seconds):
            return True  # stop() in flight (or about to be)
    if (helper is not None and helper is not cap_thread
            and helper.is_alive()):
        # an orphaned helper from an earlier capture is by definition
        # stuck inside start/stop
        return True
    return False


def reset_torch_profiler_state() -> None:
    """Forget the tracked helper thread (tests)."""
    global _torch_helper
    with _lock:
        _torch_helper = None


def capture_active() -> Optional[Dict[str, Any]]:
    """The in-flight capture's info, or None."""
    with _lock:
        cap = _active
    if cap is None:
        return None
    return {
        "id": cap.id,
        "path": cap.path,
        "seconds": cap.seconds,
        "elapsed_seconds": time.perf_counter() - cap.t0_perf,
        "torch_trace": cap.torch_started.is_set(),
        "fit_run_id": cap.fit_run_id,
    }


def last_capture() -> Optional[Dict[str, Any]]:
    """The most recent completed capture's result document."""
    with _lock:
        return dict(_last) if _last else None


def start_capture(seconds: float = _DEFAULT_SECONDS,
                  label: str = "ondemand") -> Dict[str, Any]:
    """Begin a single-flight capture; auto-stops after ``seconds``.

    Returns the capture info immediately (a worker thread finishes it);
    raises ``CaptureInFlight`` when one is already running, and
    ``RuntimeError`` with no CUDA device and no CPU request. ``seconds``
    is clamped to ``(0, MAX_SECONDS]`` — an unbounded capture armed over
    HTTP would be a denial-of-service knob pointed at the dump disk."""
    global _active, _torch_helper
    device = _capture_device()
    seconds = min(max(float(seconds), 0.05), MAX_SECONDS)
    safe_label = "".join(
        c if (c.isalnum() or c in "-_") else "_" for c in str(label)
    )[:40] or "ondemand"
    cid = f"{safe_label}_{int(time.time() * 1000)}_{os.getpid()}"
    path = os.path.join(profile_dir(), cid)
    with _lock:
        if _active is not None:
            raise CaptureInFlight(
                f"profile capture {_active.id!r} is already running "
                f"({_active.seconds:g}s window) — retry after it lands"
            )
        cap = _Capture(cid, path, seconds, device)
        _active = cap
        torch_enabled = (_torch_helper is None
                         or not _torch_helper.is_alive())
    try:
        from spark_rapids_ml_tpu_torch.obs import fitmon

        cap.fit_run_id = fitmon.get_fit_monitor().latest_active_run_id()
    except Exception:
        cap.fit_run_id = None
    try:
        os.makedirs(path, exist_ok=True)
        from spark_rapids_ml_tpu_torch.obs import tracectx

        if torch_enabled:
            # start AND stop live on one helper thread: if start()
            # wedges, a later unwedge sees the stop event already set
            # and cleans up after itself; the capture path never waits
            # on it past the join grace.
            cap.torch_thread = tracectx.traced_thread(
                _torch_worker, name=f"sparkml-profile-torch-{cid}",
                daemon=True, fresh=True, args=(cap,),
            )
            cap.torch_thread.start()
            with _lock:
                _torch_helper = cap.torch_thread
        cap.thread = tracectx.traced_thread(
            _run_capture, name=f"sparkml-profile-{cid}", daemon=True,
            fresh=True, args=(cap,),
        )
        cap.thread.start()
    except Exception:
        # A failed start (unwritable dir, thread spawn failure) must
        # not brick the endpoint: release the single-flight slot and
        # end any helper that already launched, then surface the error.
        cap.stop_event.set()
        with _lock:
            if _active is cap:
                _active = None
        _captures_counter().inc(outcome="start_failed")
        raise
    _captures_counter().inc(outcome="started")
    _log.info("profile capture started", capture_id=cid, path=path,
              seconds=seconds, torch_enabled=torch_enabled)
    return {
        "id": cid,
        "path": path,
        "seconds": seconds,
        "torch_enabled": torch_enabled,
        "fit_run_id": cap.fit_run_id,
    }


def stop_capture() -> Optional[Dict[str, Any]]:
    """End the in-flight capture early (no-op when none is running);
    blocks until its artifacts are written and returns the result."""
    with _lock:
        cap = _active
    if cap is None:
        return last_capture()
    cap.stop_event.set()
    thread = cap.thread
    if thread is not None:
        thread.join(timeout=10.0)
    return last_capture()


def wait(timeout: Optional[float] = None) -> Optional[Dict[str, Any]]:
    """Block until the in-flight capture (if any) lands AND its torch
    helper thread drains; returns the last capture result. Call before
    process exit in tests/short-lived tools — an abandoned helper stuck
    inside the profiler C++ at interpreter teardown can crash it."""
    with _lock:
        cap = _active
        helper = _torch_helper
    if cap is not None and cap.thread is not None:
        cap.thread.join(timeout=timeout)
    if helper is not None and helper.is_alive():
        helper.join(timeout=timeout)
    return last_capture()


def _capture_device() -> str:
    """The device a capture records: the CPU when it was requested, else
    the card; raises with neither — a capture never picks the CPU by
    itself."""
    if cpu_requested():
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; set "
            f"{PLATFORM_ENV}=cpu to profile on the CPU explicitly"
        )
    return "cuda"


def torch_trace_path(cap_path: str, cid: str) -> str:
    return os.path.join(cap_path, f"torch_{cid}.json")


def _probe_device() -> None:
    """One tiny kernel on a stream of the helper's own, waited for on
    that stream alone: a working CUPTI session records at least this
    device event, so a CUDA capture with none has no device timeline."""
    import torch

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        torch.zeros(1, device="cuda").add_(1.0)
    stream.synchronize()


def _has_device_events(path: str) -> bool:
    with open(path) as f:
        doc = json.load(f)
    return any(ev.get("cat") in DEVICE_CATEGORIES
               for ev in doc.get("traceEvents", ()))


def _torch_worker(cap: _Capture) -> None:
    """start() → wait out the window → stop() → export, all on one
    thread. Any step may block on a busy profiler; the capture worker
    only ever joins this thread with a bounded timeout."""
    prof = None
    try:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if cap.device == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(
            activities=activities,
            # a profiler started on this helper records no other
            # thread's CPU ops without it
            experimental_config=_ExperimentalConfig(profile_all_threads=True),
        )
        prof.start()
        if cap.device == "cuda":
            _probe_device()
    except Exception as exc:
        if prof is not None:
            try:
                prof.stop()  # started, then the probe failed
            except Exception:
                pass
        cap.torch_result = "unavailable"
        _log.warning("torch profiler unavailable; span-ring capture only",
                     error=f"{type(exc).__name__}: {exc}")
        return
    cap.torch_started.set()
    cap.stop_event.wait(cap.seconds)
    try:
        prof.stop()
        path = torch_trace_path(cap.path, cap.id)
        prof.export_chrome_trace(path)
        device_seen = cap.device != "cuda" or _has_device_events(path)
    except Exception as exc:
        cap.torch_result = "stop_failed"
        _log.warning("torch profiler stop/export failed",
                     error=f"{type(exc).__name__}: {exc}")
        return
    if not device_seen:
        # CUDA was asked for and nothing of the device was recorded:
        # never an "ok" on CPU events alone
        cap.torch_result = "unavailable"
        _log.warning("torch profiler recorded no device activity "
                     "(CUPTI unavailable?)", capture_id=cap.id)
        return
    cap.torch_result = "ok"


def _run_capture(cap: _Capture) -> None:
    cap.stop_event.wait(cap.seconds)
    torch_outcome = "skipped_busy"
    if cap.torch_thread is not None:
        cap.stop_event.set()  # early-stop: release the helper's wait
        cap.torch_thread.join(timeout=_JOIN_GRACE)
        if cap.torch_thread.is_alive():
            # start() (or stop()) has not come back. The capture
            # completes with span-ring artifacts; the helper cleans up
            # when the profiler unblocks, and until then new captures
            # skip the torch trace instead of stacking behind it.
            torch_outcome = "torch_wedged"
            _captures_counter().inc(outcome="torch_wedged")
            _log.warning(
                "torch profiler wedged (start/stop did not return "
                "within the join grace); capture lands span-ring only",
                capture_id=cap.id)
        elif cap.torch_result == "unavailable":
            torch_outcome = "torch_unavailable"
            _captures_counter().inc(outcome="torch_unavailable")
        else:
            # a helper that died without a verdict landed no trace
            torch_outcome = cap.torch_result or "stop_failed"
    _finish(cap, torch_outcome)


def _artifacts(path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for root, _dirs, files in os.walk(path):
        for fname in sorted(files):
            fpath = os.path.join(root, fname)
            try:
                size = os.path.getsize(fpath)
            except OSError:
                continue
            out.append({"path": fpath, "bytes": size})
    return out


def _finish(cap: _Capture, torch_outcome: str) -> None:
    global _active, _last
    t_finish = time.perf_counter()
    # The span-ring view of the same window: always written, so every
    # capture yields at least one loadable (Perfetto/chrome://tracing)
    # artifact even without a native profiler backend.
    spans_path: Optional[str] = os.path.join(
        cap.path, f"spans_{cap.id}.json")
    try:
        from spark_rapids_ml_tpu_torch.obs import spans as spans_mod

        spans_mod.get_recorder().export_chrome_trace(spans_path)
    except Exception as exc:
        _log.warning("span-ring export failed",
                     error=f"{type(exc).__name__}: {exc}")
        spans_path = None
    t1 = time.perf_counter()
    try:
        from spark_rapids_ml_tpu_torch.obs import spans as spans_mod

        spans_mod.record_event(
            "obs:profile", cap.t0_perf, t1,
            capture_id=cap.id, seconds=cap.seconds,
            torch_outcome=torch_outcome,
        )
    except Exception:
        pass
    result = {
        "id": cap.id,
        "path": cap.path,
        "seconds": cap.seconds,
        "elapsed_seconds": t1 - cap.t0_perf,
        # honest only on "ok": a failed/wedged stop typically never
        # exported, so there is no loadable torch artifact
        "torch_trace": torch_outcome == "ok",
        "torch_outcome": torch_outcome,
        "spans_trace": spans_path,
        "artifacts": _artifacts(cap.path),
        "finished_unix": time.time(),
        "fit_run_id": cap.fit_run_id,
    }
    with _lock:
        _last = result
        _active = None
    _captures_counter().inc(outcome="completed")
    try:
        from spark_rapids_ml_tpu_torch.obs import retention

        retention.maybe_gc("profile")
    except Exception:
        pass  # GC is best-effort; the capture already landed
    try:
        _overhead_counter().inc(time.perf_counter() - t_finish,
                                component="profiler")
    except Exception:
        pass
    _log.info("profile capture completed", capture_id=cap.id,
              path=cap.path, artifacts=len(result["artifacts"]),
              torch_outcome=torch_outcome)


__all__ = [
    "CaptureInFlight",
    "MAX_SECONDS",
    "PROFILE_DIR_ENV",
    "DEVICE_CATEGORIES",
    "capture_active",
    "last_capture",
    "profile_dir",
    "reset_torch_profiler_state",
    "start_capture",
    "stop_capture",
    "torch_profiler_busy",
    "torch_trace_path",
    "torch_transition_pending",
    "wait",
]
