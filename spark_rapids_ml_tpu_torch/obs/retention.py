"""Retention sweeper for on-disk observability artifacts.

The port's copy of the JAX package's ``obs/retention.py``. Three writers
land artifacts under ``SPARK_RAPIDS_ML_TORCH_DUMP_DIR``: flight dumps
(``flightdump_*.json`` files), profile captures (``profiles/<id>/``
directories) and incident evidence bundles (``incidents/<id>/``
directories). Unswept they accumulate unboundedly — an incident storm
(the exact situation that produces the most artifacts) could fill the
disk and take the serving tier down with its own diagnostics.

``maybe_gc(kind)`` is the shared hook every writer calls after landing
an artifact: per artifact kind it enforces a **count cap** and a **byte
cap** (env-tunable), deleting **oldest first** until both hold. Every
removal is counted in ``sparkml_obs_artifacts_gc_total{kind}`` — GC is
itself observable, never silent. A per-kind minimum sweep interval
keeps a dump storm from paying a directory scan per dump.

Knobs:

* ``SPARK_RAPIDS_ML_TORCH_OBS_ARTIFACT_MAX_COUNT`` — newest N artifacts
  kept per kind (default 200; <= 0 disables the count cap);
* ``SPARK_RAPIDS_ML_TORCH_OBS_ARTIFACT_MAX_MB`` — byte budget per kind
  (default 512 MB; <= 0 disables the byte cap).

The sweeper never raises into a writer: a GC failure mid-incident is
worse than a full disk tomorrow.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

MAX_COUNT_ENV = "SPARK_RAPIDS_ML_TORCH_OBS_ARTIFACT_MAX_COUNT"
MAX_MB_ENV = "SPARK_RAPIDS_ML_TORCH_OBS_ARTIFACT_MAX_MB"
KINDS = ("flight", "profile", "incident")

_DEFAULT_MAX_COUNT = 200
_DEFAULT_MAX_MB = 512.0
# a storm of writers shares one scan per kind per interval
_MIN_SWEEP_INTERVAL_S = 20.0

_last_sweep: Dict[str, float] = {}
_lock = threading.Lock()


def max_count() -> int:
    try:
        return int(float(os.environ.get(MAX_COUNT_ENV,
                                        _DEFAULT_MAX_COUNT)))
    except ValueError:
        return _DEFAULT_MAX_COUNT


def max_bytes() -> float:
    try:
        mb = float(os.environ.get(MAX_MB_ENV, _DEFAULT_MAX_MB))
    except ValueError:
        mb = _DEFAULT_MAX_MB
    return mb * 1024 * 1024


def _kind_root(kind: str) -> Tuple[Optional[str], bool]:
    """(root directory, entries-are-directories) for one artifact
    kind. Function-level imports: flight/profiler/incidents all call
    into this module, and a module-level import back at them would
    cycle."""
    if kind == "flight":
        from spark_rapids_ml_tpu_torch.obs import flight

        return flight.dump_dir(), False
    if kind == "profile":
        from spark_rapids_ml_tpu_torch.obs import profiler

        return profiler.profile_dir(), True
    if kind == "incident":
        from spark_rapids_ml_tpu_torch.obs import incidents

        return incidents.incidents_dir(), True
    return None, False


def _entry_size(path: str, is_dir: bool) -> int:
    if not is_dir:
        try:
            return os.path.getsize(path)
        except OSError:
            return 0
    total = 0
    for root, _dirs, files in os.walk(path):
        for fname in files:
            try:
                total += os.path.getsize(os.path.join(root, fname))
            except OSError:
                continue
    return total


def _list_entries(root: str, dirs: bool) -> List[Dict[str, Any]]:
    """Artifacts under ``root`` as ``{path, mtime, bytes}``, oldest
    first. Files mode keeps only ``flightdump_*.json`` (never touch a
    ``.tmp`` mid-rename or anything another subsystem parked there);
    dirs mode takes every subdirectory."""
    entries: List[Dict[str, Any]] = []
    try:
        names = os.listdir(root)
    except OSError:
        return entries
    for name in names:
        path = os.path.join(root, name)
        is_dir = os.path.isdir(path)
        if dirs != is_dir:
            continue
        if not dirs and not (name.startswith("flightdump_")
                             and name.endswith(".json")):
            continue
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            continue
        entries.append({
            "path": path,
            "mtime": mtime,
            "bytes": _entry_size(path, is_dir),
        })
    entries.sort(key=lambda e: e["mtime"])
    return entries


def _remove(path: str, is_dir: bool) -> bool:
    try:
        if is_dir:
            shutil.rmtree(path, ignore_errors=True)
            return not os.path.exists(path)
        os.remove(path)
        return True
    except OSError:
        return False


def _count_removed(kind: str, n: int) -> None:
    if n <= 0:
        return
    try:
        from spark_rapids_ml_tpu_torch.obs.metrics import get_registry

        get_registry().counter(
            "sparkml_obs_artifacts_gc_total",
            "on-disk observability artifacts removed by the retention "
            "sweeper (oldest-first past the count/byte caps)",
            ("kind",),
        ).inc(n, kind=kind)
    except Exception:
        pass  # GC accounting must never raise into a writer


def sweep_kind(kind: str,
               *,
               root: Optional[str] = None,
               dirs: Optional[bool] = None,
               keep_count: Optional[int] = None,
               keep_bytes: Optional[float] = None) -> int:
    """Enforce the caps for one kind NOW; returns how many artifacts
    were removed. The explicit-parameter form is what tests drive."""
    default_root, default_dirs = _kind_root(kind)
    root = root if root is not None else default_root
    dirs = dirs if dirs is not None else default_dirs
    if not root or not os.path.isdir(root):
        return 0
    cap_count = keep_count if keep_count is not None else max_count()
    cap_bytes = keep_bytes if keep_bytes is not None else max_bytes()
    entries = _list_entries(root, dirs)
    total_bytes = sum(e["bytes"] for e in entries)
    removed = 0
    # the artifact just written is the newest — the caps always leave
    # at least it in place
    while entries[:-1] and (
        (cap_count > 0 and len(entries) > cap_count)
        or (cap_bytes > 0 and total_bytes > cap_bytes)
    ):
        victim = entries.pop(0)
        if _remove(victim["path"], dirs):
            removed += 1
            total_bytes -= victim["bytes"]
        else:
            total_bytes -= victim["bytes"]  # unremovable: stop retrying
    _count_removed(kind, removed)
    return removed


def maybe_gc(kind: str, force: bool = False) -> int:
    """The writer-side hook: sweep ``kind`` unless one ran within the
    last ``_MIN_SWEEP_INTERVAL_S`` (a dump storm shares one scan).
    Never raises."""
    try:
        now = time.monotonic()
        with _lock:
            last = _last_sweep.get(kind, 0.0)
            if not force and now - last < _MIN_SWEEP_INTERVAL_S:
                return 0
            _last_sweep[kind] = now
        return sweep_kind(kind)
    except Exception:
        return 0


def gc_all(force: bool = False) -> Dict[str, int]:
    """Sweep every kind (ops tooling / tests)."""
    return {kind: maybe_gc(kind, force=force) for kind in KINDS}


__all__ = [
    "KINDS",
    "MAX_COUNT_ENV",
    "MAX_MB_ENV",
    "gc_all",
    "max_bytes",
    "max_count",
    "maybe_gc",
    "sweep_kind",
]
