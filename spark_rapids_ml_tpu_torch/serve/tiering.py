"""Model tiering: the hot/cold lifecycle plane for many models under a
device-memory budget.

The port's copy of the JAX package's ``serve/tiering.py``: the same
states, gauge codes, events, counters, eviction policy and documents, on
an injectable clock. The cost ledger (``obs.accounting``) ranks resident
models coldest-first by ``resident_bytes * (age + 1) / (ewma_rps + 1)``;
this controller moves the coldest registered models OFF the card until
the host's accounted bytes fit its budget, and brings a model back on
its first request.

Lifecycle (per registered model, driven on the controller cadence with
an injectable clock — tests run hours of policy in zero wall time):

    ACTIVE ──deactivate──▶ DEACTIVATING ──▶ COLD
      ▲                                       │
      └────── REACTIVATING ◀───first hit──────┘

* **COLD transition** (``ServeEngine.deactivate``): each of the model's
  batchers drains through its own worker (queued work is never dropped)
  and is dropped with its serving program, so the staged weights leave
  the card (back to PyTorch's caching allocator, which keeps the block
  for the next allocation in this process) and the accounted residency.
  The registry entry and its ``warmed_buckets`` survive: a cold model
  costs registry metadata, not device memory.

* **REACTIVATION** rides admission: ``AdmissionController.bind_tiering``
  installs ``ensure_active``, so the FIRST request to a COLD model
  blocks (after quota and shed — an already-shed request never triggers
  a replay) while ``ServeEngine.reactivate`` restages the weights and
  warms the bucket ladder by executing it (the port compiles nothing, so
  there is no executable cache to replay from), then serves. Concurrent
  first hits share one replay; the others count as ``gate_wait``. The
  first-hit latency lands in
  ``sparkml_serve_tiering_first_hit_seconds{model}``.

* **Eviction policy**: a per-host byte budget
  (``SPARK_RAPIDS_ML_TORCH_TIERING_HBM_BUDGET``) enforced by weighted LRU
  over the ledger's ``cold_report()`` — the SAME ranking
  ``GET /debug/costs`` serves — skipping pinned models and anything
  inside the flap floor (a model oscillating around the traffic
  threshold cannot thrash through the lifecycle faster than
  ``FLAP_FLOOR``).

* **Observability**: every tier transition increments
  ``sparkml_serve_tiering_total{event}`` and files a
  ``serve:tiering:*`` span event; the per-model state rides the
  ``sparkml_serve_tiering_state{model}`` gauge (3 ACTIVE /
  2 REACTIVATING / 1 DEACTIVATING / 0 COLD); ``snapshot()`` serves
  ``GET /debug/tiering`` and the ``tiering`` section of ``/debug/slo``.

Not ported yet: the JAX controller's per-model autoscale envelopes (they
wait for autoscale) and its executable-cache protection (the port has
no executable cache); ``snapshot()`` carries no ``envelopes`` section.

Env knobs (all ``SPARK_RAPIDS_ML_TORCH_TIERING_*``; constructor args
win):

* ``..._HBM_BUDGET``       (0)     — per-host resident-byte budget the
  eviction loop enforces (0 = unlimited: lifecycle + gate stay live,
  nothing is ever evicted for budget);
* ``..._INTERVAL_MS``      (1000)  — controller cadence;
* ``..._FLAP_FLOOR_MS``    (10000) — minimum time since a model's last
  transition before it may deactivate again (the thrash floor);
* ``..._ENABLED``          (1)     — 0 renders the controller inert:
  no ticks act, the admission gate passes through.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from spark_rapids_ml_tpu_torch.obs import spans as spans_mod
from spark_rapids_ml_tpu_torch.obs import tracectx
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry

ENV_PREFIX = "SPARK_RAPIDS_ML_TORCH_TIERING_"

ACTIVE = "active"
DEACTIVATING = "deactivating"
COLD = "cold"
REACTIVATING = "reactivating"

# gauge encoding for sparkml_serve_tiering_state{model}
STATE_CODES = {COLD: 0, DEACTIVATING: 1, REACTIVATING: 2, ACTIVE: 3}


def _env_number(name: str, default: float) -> float:
    try:
        return float(os.environ.get(ENV_PREFIX + name, default))
    except ValueError:
        return default


def _env_flag(name: str, default: bool) -> bool:
    raw = os.environ.get(ENV_PREFIX + name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off", "")


class TieringController:
    """Hot/cold lifecycle control over one ``ServeEngine`` (see module
    doc). Clock-injectable and drivable step-by-step
    (``evaluate_once``) so tests exercise the whole policy with zero
    sleeps; ``start()`` runs the same tick on a traced daemon thread."""

    def __init__(
        self,
        engine,
        *,
        hbm_budget_bytes: Optional[int] = None,
        interval_s: Optional[float] = None,
        flap_floor_s: Optional[float] = None,
        enabled: Optional[bool] = None,
        pins: Tuple[str, ...] = (),
        clock: Callable[[], float] = time.monotonic,
    ):
        self._engine = engine
        self._clock = clock
        self.enabled = bool(
            enabled if enabled is not None else _env_flag("ENABLED", True))
        self.hbm_budget_bytes = max(int(
            hbm_budget_bytes if hbm_budget_bytes is not None
            else _env_number("HBM_BUDGET", 0)), 0)
        self.interval_s = float(
            interval_s if interval_s is not None
            else _env_number("INTERVAL_MS", 1000.0) / 1000.0)
        self.flap_floor_s = float(
            flap_floor_s if flap_floor_s is not None
            else _env_number("FLAP_FLOOR_MS", 10000.0) / 1000.0)
        self._ledger = engine._ledger
        self._lock = threading.Lock()
        # one lock per model serializes its transitions: the first
        # request to a COLD model blocks on this while ONE reactivation
        # replay runs (concurrent cold hits share the same replay), and
        # the controller's deactivation can never interleave with it
        self._model_locks: Dict[str, threading.Lock] = {}
        self._states: Dict[str, str] = {}
        self._last_change: Dict[str, float] = {}
        self._pinned = set(str(p) for p in pins)
        self._history: collections.deque = collections.deque(maxlen=64)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = get_registry()
        self._m_events = reg.counter(
            "sparkml_serve_tiering_total",
            "tiering lifecycle events (deactivate / cold_hit / "
            "reactivate / skip_pinned / skip_flap / gate_wait / "
            "failures)", ("event",),
        )
        self._m_state = reg.gauge(
            "sparkml_serve_tiering_state",
            "per-model tier state (3 active / 2 reactivating / "
            "1 deactivating / 0 cold)", ("model",),
        )
        self._m_first_hit = reg.summary(
            "sparkml_serve_tiering_first_hit_seconds",
            "cold-model first-hit latency: the admission-blocked "
            "reactivation (weights restaged, bucket ladder warmed)",
            ("model",),
        )
        self._m_errors = reg.counter(
            "sparkml_serve_errors_total",
            "serving errors by type: batch failures (exception class), "
            "worker crashes/wedges, breaker rejections",
            ("model", "error"),
        )
        for event in ("deactivate", "cold_hit", "reactivate"):
            self._m_events.inc(0, event=event)
        self._sync_registry()

    # -- plumbing ----------------------------------------------------------

    def _model_lock(self, name: str) -> threading.Lock:
        with self._lock:
            lock = self._model_locks.get(name)
            if lock is None:
                lock = threading.Lock()
                self._model_locks[name] = lock
            return lock

    def _event(self, event: str, model: str, t0: float,
               **attrs) -> None:
        """Every lifecycle decision lands in the tiering counter AND the
        ``serve:tiering`` span ring with its model and outcome."""
        self._m_events.inc(event=event)
        try:
            spans_mod.record_event(
                f"serve:tiering:{event}", t0, time.perf_counter(),
                model=model, **attrs)
        except Exception:  # noqa: BLE001 - telemetry must not break
            self._m_errors.inc(model=model, error="tiering_audit")

    def _set_state(self, name: str, state: str) -> None:
        with self._lock:
            self._states[name] = state
        self._m_state.set(STATE_CODES[state], model=name)

    def state(self, name: str) -> str:
        """The model's current tier state (unknown models read ACTIVE:
        the registry is the membership authority, not this map)."""
        with self._lock:
            return self._states.get(name, ACTIVE)

    def states(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._states)

    # -- pins --------------------------------------------------------------

    def pin(self, name: str) -> None:
        """Exempt one model from budget eviction (the latency-critical
        override). Counted + recorded like any other lifecycle
        decision."""
        t0 = time.perf_counter()
        with self._lock:
            self._pinned.add(name)
        self._event("pin", name, t0)

    def unpin(self, name: str) -> None:
        t0 = time.perf_counter()
        with self._lock:
            self._pinned.discard(name)
        self._event("unpin", name, t0)

    def pinned(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._pinned))

    # -- the admission gate ------------------------------------------------

    def ensure_active(self, name: str) -> None:
        """The admission-side reactivation gate
        (``AdmissionController.bind_tiering``): returns immediately for
        ACTIVE/unknown models; for a COLD one, blocks on the model's
        transition lock while ONE reactivation runs, then returns with
        the model serving. Raises only if the reactivation itself fails
        (the request then fails like any backend error — never a silent
        404)."""
        if not self.enabled:
            return
        state = self._states.get(name)
        if state is None or state == ACTIVE:
            return
        t0 = time.perf_counter()
        with self._model_lock(name):
            if self._states.get(name, ACTIVE) == ACTIVE:
                # another request won the race: this one just waited
                # out the replay and can proceed straight to serving
                self._event("gate_wait", name, t0)
                return
            self._reactivate(name)

    # -- transitions -------------------------------------------------------

    def _deactivate(self, name: str, row: Dict[str, Any]) -> bool:
        """ACTIVE → DEACTIVATING → COLD for one model (the budget
        loop's actuation). Drains and drops its batchers and staged
        weights, keeps the registry entry."""
        t0 = time.perf_counter()
        with self._model_lock(name):
            if self._states.get(name, ACTIVE) != ACTIVE:
                return False
            self._set_state(name, DEACTIVATING)
            try:
                dropped = self._engine.deactivate(name)
            except Exception as exc:  # noqa: BLE001 - tick must survive
                self._m_errors.inc(model=name, error="deactivate")
                self._set_state(name, ACTIVE)
                self._event("deactivate_failed", name, t0,
                            error=type(exc).__name__)
                return False
            self._set_state(name, COLD)
            now = self._clock()
            with self._lock:
                self._last_change[name] = now
        self._event(
            "deactivate", name, t0,
            resident_bytes=int(row.get("resident_bytes", 0)),
            cold_score=round(float(row.get("cold_score", 0.0)), 3),
            versions=",".join(dropped))
        self._note_history("deactivate", name,
                           resident_bytes=int(row.get("resident_bytes",
                                                      0)))
        return True

    def _reactivate(self, name: str) -> None:
        """COLD → REACTIVATING → ACTIVE. Caller holds the model lock.
        The engine restages the weights and warms the bucket ladder."""
        t0 = time.perf_counter()
        self._set_state(name, REACTIVATING)
        self._event("cold_hit", name, t0)
        try:
            report = self._engine.reactivate(name)
        except Exception as exc:
            self._set_state(name, COLD)
            self._m_errors.inc(model=name, error="reactivate")
            self._event("reactivate_failed", name, t0,
                        error=type(exc).__name__)
            raise
        self._set_state(name, ACTIVE)
        now = self._clock()
        with self._lock:
            self._last_change[name] = now
        elapsed = time.perf_counter() - t0
        self._m_first_hit.observe(elapsed, model=name)
        self._event("reactivate", name, t0,
                    seconds=round(elapsed, 6),
                    buckets=len(report.get("buckets", ())))
        self._note_history("reactivate", name,
                           seconds=round(elapsed, 6))

    def _note_history(self, event: str, model: str, **extra) -> None:
        with self._lock:
            self._history.append({
                "at": self._clock(), "event": event, "model": model,
                **extra,
            })

    # -- the control tick --------------------------------------------------

    def evaluate_once(self) -> List[Dict[str, Any]]:
        """One control tick (bounded: one ledger ranking read, at most
        one pass over it): adopt registry changes, then enforce the byte
        budget coldest-first with pin + flap-floor overrides. Returns
        the deactivation actions taken. Inert when disabled."""
        if not self.enabled:
            return []
        t0 = time.perf_counter()
        now = self._clock()
        self._sync_registry()
        actions: List[Dict[str, Any]] = []
        if self.hbm_budget_bytes > 0:
            known = set(self._registry_names())
            report = self._ledger.cold_report()
            total = sum(int(r.get("resident_bytes", 0)) for r in report)
            for row in report:
                if total <= self.hbm_budget_bytes:
                    break
                name = str(row.get("model", ""))
                if name not in known or self.state(name) != ACTIVE:
                    continue
                if name in self.pinned():
                    self._event("skip_pinned", name, t0)
                    continue
                with self._lock:
                    last = self._last_change.get(name)
                if last is not None and now - last < self.flap_floor_s:
                    self._event("skip_flap", name, t0,
                                held=round(now - last, 3))
                    continue
                if self._deactivate(name, row):
                    total -= int(row.get("resident_bytes", 0))
                    actions.append({
                        "model": name,
                        "resident_bytes": int(
                            row.get("resident_bytes", 0)),
                        "cold_score": row.get("cold_score"),
                    })
        return actions

    def _registry_names(self) -> List[str]:
        try:
            return list(self._engine.registry.names())
        except Exception:  # noqa: BLE001 - tick must survive
            self._m_errors.inc(model="(tiering)", error="registry_read")
            return []

    def _sync_registry(self) -> None:
        """Adopt registry membership: new models enter ACTIVE, models
        deregistered behind our back drop out of the state map (their
        gauge parks at COLD — deregistration IS maximally cold)."""
        names = set(self._registry_names())
        with self._lock:
            tracked = set(self._states)
        for name in names - tracked:
            self._set_state(name, ACTIVE)
        for name in tracked - names:
            with self._lock:
                self._states.pop(name, None)
                self._last_change.pop(name, None)
            self._m_state.set(STATE_CODES[COLD], model=name)

    # -- the background loop -----------------------------------------------

    def start(self) -> None:
        """Run the control tick on a traced daemon thread at
        ``interval_s`` cadence until ``stop()``."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("tiering controller already running")
        self._stop.clear()

        def _loop():
            while not self._stop.is_set():
                try:
                    self.evaluate_once()
                except Exception:  # noqa: BLE001 - loop must survive
                    # visible, never silent: a dead controller is a
                    # frozen residency picture under a moving mix
                    self._m_errors.inc(model="(tiering)",
                                       error="controller")
                self._stop.wait(self.interval_s)

        self._thread = tracectx.traced_thread(
            _loop, name="sparkml-tiering", daemon=True, fresh=True)
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout)

    @property
    def running(self) -> bool:
        return bool(self._thread is not None
                    and self._thread.is_alive())

    # -- introspection -----------------------------------------------------

    def lifecycle_history(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._history)

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /debug/tiering`` payload. The ``cold_report`` here
        is the ledger's OWN ranking — the same source of truth
        ``GET /debug/costs`` serves."""
        report = self._ledger.cold_report()
        with self._lock:
            states = dict(self._states)
            pinned = sorted(self._pinned)
            history = list(self._history)[-16:]
        counts: Dict[str, int] = {s: 0 for s in STATE_CODES}
        for state in states.values():
            counts[state] = counts.get(state, 0) + 1
        return {
            "enabled": self.enabled,
            "running": self.running,
            "hbm_budget_bytes": self.hbm_budget_bytes,
            "resident_bytes": sum(int(r.get("resident_bytes", 0))
                                  for r in report),
            "flap_floor_s": self.flap_floor_s,
            "interval_s": self.interval_s,
            "states": states,
            "state_counts": counts,
            "pinned": pinned,
            "cold_report": report,
            "history": history,
        }


__all__ = [
    "TieringController",
    "ENV_PREFIX",
    "ACTIVE",
    "DEACTIVATING",
    "COLD",
    "REACTIVATING",
    "STATE_CODES",
]
