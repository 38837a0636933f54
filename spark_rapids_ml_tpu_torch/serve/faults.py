"""Injectable fault plane: make the serving tier fail on purpose.

The port's copy of the JAX package's ``serve/faults.py``, cut to the faults
the port's engine and batcher absorb: the breaker / retry / fallback
machinery of ``serve/`` is only trustworthy if the failures it exists to
absorb can be produced on demand.

* **programmatic API** — ``fault_plane().inject(model="pca", kind="raise",
  count=5)`` arms a fault; ``clear()`` disarms everything; ``active()``
  lists what is armed (``GET /debug/slo`` reports it, so a chaos drill is
  auditable from the surface it attacks). Tests drive the whole matrix
  in-process.
* **deterministic targeting** — each spec matches a model name (or
  ``*``), fires from call index ``start``, at most ``count`` times
  (None = forever). Call indices are counted per model per site, so a
  test that says "fail calls 3..5 on model A" reproduces exactly, run
  after run. At most ONE fault fires per call: the first-armed matching
  spec wins.

Fault kinds:

* ``raise``   — the device backend errors: ``InjectedBackendError``
  (classified as a backend fault by the engine → breaker food);
* ``nan``     — the transform "succeeds" but its output is corrupted
  with NaNs (the silent poison the NaN guard exists for);
* ``latency`` — the call completes but ``seconds`` (default 0.05)
  slower: SLO latency-burn and incident-drill food;
* ``crash_worker`` — the batcher's worker thread dies
  (``InjectedWorkerCrash``, a ``BaseException`` so nothing on the batch
  path accidentally swallows it) — exercises worker supervision.

Injection sites: the engine consults ``begin_call(model)`` around every
coalesced transform (raise/nan/latency), the batcher consults
``worker_fault(model)`` in its worker loop (crash_worker). Every fired
fault counts in ``sparkml_serve_faults_injected_total{model,kind}``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from spark_rapids_ml_tpu_torch.obs.metrics import get_registry

KINDS = ("raise", "nan", "latency", "crash_worker")

# Transform-site kinds vs worker-loop kinds: one call index per site so
# "fail call 3" means the 3rd *transform*, not the 3rd loop iteration.
_TRANSFORM_KINDS = frozenset({"raise", "nan", "latency"})

_DEFAULT_SECONDS = {"latency": 0.05}


class InjectedBackendError(RuntimeError):
    """An injected device-backend failure — the engine classifies it
    exactly like a real device error (retryable, breaker-counted)."""


class InjectedWorkerCrash(BaseException):
    """Kills a batcher worker thread. Deliberately a ``BaseException``:
    the batch-execution path catches ``Exception`` to survive batch
    failures, and a worker *crash* must not be absorbed by it."""


class FaultSpec:
    """One armed fault: which model, what kind, from which call index, how
    many times, and (``latency``) how many seconds it adds."""

    __slots__ = ("model", "kind", "count", "start", "seconds", "fired")

    def __init__(self, model: str = "*", kind: str = "raise", *,
                 count: Optional[int] = 1, start: int = 0,
                 seconds: Optional[float] = None):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (one of {KINDS})")
        self.model = model
        self.kind = kind
        self.count = None if count is None else int(count)
        self.start = int(start)
        self.seconds = (float(seconds) if seconds is not None
                        else _DEFAULT_SECONDS.get(kind, 0.0))
        self.fired = 0

    def matches(self, model: str, index: int) -> bool:
        if self.model not in ("*", model) or index < self.start:
            return False
        return self.count is None or self.fired < self.count

    def as_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model,
            "kind": self.kind,
            "count": self.count,
            "start": self.start,
            "seconds": self.seconds,
            "fired": self.fired,
        }


class FaultPlane:
    """The process-wide registry of armed faults.

    Thread-safe: the engine/batcher consult it on every call; tests
    arm/disarm from other threads.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: List[FaultSpec] = []
        self._calls: Dict[str, int] = {}          # transform-site index
        self._worker_calls: Dict[str, int] = {}   # worker-loop index
        self._m_injected = get_registry().counter(
            "sparkml_serve_faults_injected_total",
            "faults fired by the injection plane", ("model", "kind"),
        )

    # -- arming ------------------------------------------------------------

    def inject(self, model: str = "*", kind: str = "raise", *,
               count: Optional[int] = 1, start: int = 0,
               seconds: Optional[float] = None) -> FaultSpec:
        """Arm one fault; returns the live spec (its ``fired`` counter
        updates as the fault fires)."""
        spec = FaultSpec(model, kind, count=count, start=start,
                         seconds=seconds)
        with self._lock:
            self._specs.append(spec)
        return spec

    def clear(self) -> None:
        """Disarm every fault and reset the deterministic call counters
        (the next experiment starts from call index 0)."""
        with self._lock:
            self._specs = []
            self._calls.clear()
            self._worker_calls.clear()

    def active(self) -> List[Dict[str, Any]]:
        """Every armed spec as a dict (``GET /debug/slo``'s ``faults``)."""
        with self._lock:
            return [s.as_dict() for s in self._specs]

    # -- firing ------------------------------------------------------------

    def _next(self, counters: Dict[str, int], model: str,
              kinds) -> Optional[FaultSpec]:
        with self._lock:
            index = counters.get(model, 0)
            counters[model] = index + 1
            for spec in self._specs:
                if spec.kind in kinds and spec.matches(model, index):
                    spec.fired += 1
                    break
            else:
                return None
        self._m_injected.inc(model=model, kind=spec.kind)
        return spec

    def begin_call(self, model: str) -> Optional[FaultSpec]:
        """Advance ``model``'s transform-site call index and return the
        fault (if any) that fires on this call. The caller applies it:
        ``apply_pre`` before the model call, ``corrupt`` on the output
        for ``nan``."""
        return self._next(self._calls, model, _TRANSFORM_KINDS)

    def worker_fault(self, model: str) -> Optional[FaultSpec]:
        """The worker-loop site: a matched ``crash_worker`` spec (the
        batcher raises ``InjectedWorkerCrash`` for it)."""
        return self._next(self._worker_calls, model, ("crash_worker",))


def apply_pre(spec: FaultSpec) -> None:
    """Apply a fired fault's before-the-model-call effect."""
    if spec.kind == "raise":
        raise InjectedBackendError(
            f"injected backend fault on {spec.model!r} "
            f"(fired {spec.fired}/{spec.count or 'inf'})"
        )
    if spec.kind == "latency":
        time.sleep(spec.seconds)


def corrupt(spec: FaultSpec, out):
    """Apply a fired ``nan`` fault to a transform output: the first row
    becomes NaN (float outputs) — the silent-poison corruption the
    NaN guard must catch."""
    import numpy as np

    if spec.kind != "nan":
        return out
    out = np.array(out, dtype=np.float64, copy=True)
    if out.size:
        out.reshape(out.shape[0], -1)[0, :] = np.nan
    return out


_plane: Optional[FaultPlane] = None
_plane_lock = threading.Lock()


def fault_plane() -> FaultPlane:
    """The process singleton."""
    global _plane
    with _plane_lock:
        if _plane is None:
            _plane = FaultPlane()
        return _plane


def reset_fault_plane() -> None:
    """Drop the singleton (tests: a fresh plane with fresh counters)."""
    global _plane
    with _plane_lock:
        _plane = None


__all__ = [
    "FaultPlane",
    "FaultSpec",
    "InjectedBackendError",
    "InjectedWorkerCrash",
    "KINDS",
    "apply_pre",
    "corrupt",
    "fault_plane",
    "reset_fault_plane",
]
