"""Per-model resource accounting: the cost-attribution ledger.

The port's copy of the JAX package's ``obs/accounting.py``: the same
``ResourceLedger``, metric families, label sets, components and
documents; the knobs carry the port's prefix. A meter that attributes
every resource a served model consumes to that model — device-memory
residency, device-seconds, traffic. It is read-side only: it makes no
placement or eviction decision; ``serve.tiering`` reads its
``cold_report()``.

What is metered, and at which seam:

* **Device-memory residency** — ``sparkml_model_hbm_bytes{model,
  component}``. Charged when the engine builds a model version's
  batcher from a ``ServingProgram`` (``weight_bytes``, the bytes of the
  tensors ``models/_serving.py`` staged on the card), under three
  components:

  - ``weights``   — staged weights of live (serving) programs;
  - ``reserve``   — staged weights of retired replicas that are kept for
    a cheap revival (``retire_replica`` / ``revive_replica``; the port's
    engine has no replica sets yet, so nothing moves there today);
  - ``executables`` — serialized-executable bytes attributed during a
    compile-attribution window. The port compiles nothing and has no
    executable cache, so this component is never charged.

  ``release_memory`` (the engine's ``evict`` and ``deactivate``) frees
  what was charged.

* **Device time** — ``sparkml_model_device_seconds_total{model}``,
  noted at the ``MicroBatcher`` completion seam, the same call that
  feeds ``obs.devmon``, with the same number. So the ledger can be
  *checked, not trusted*: ``reconcile()`` compares its per-model totals
  against devmon's ``sparkml_serve_device_batch_seconds_total`` and
  publishes a drift ratio and a verdict counter; a drift shows a lost
  seam.

* **Compile cost** — ``compile_attribution(model, version)`` wraps the
  engine's warm and build sections, reentrant, the OUTERMOST window
  charging once. In the JAX package the window charges the deltas of
  XLA's compile statistics and of the executable cache. The port has
  neither (it compiles nothing ahead of a call, and builds its CUDA
  kernels with ``nvcc``, a different quantity that the JAX package does
  not meter), so every window charges zero compile seconds, compiles
  and cache events; the window is kept, lock-free, so the engine's seams
  keep the JAX shape and the mutation count.

* **Traffic vitals** — rows, requests by outcome, last-hit age and a
  decaying-average request rate (``ewma_rps``: on each request the
  accumulator decays by ``exp(-dt/tau)`` then adds the row count; the
  published rate is ``acc/tau``). Per-(tenant, priority) rollups are
  kept in the ledger's documents only — never as metric labels — so
  request cardinality cannot leak into the metrics surface.

Every ``sparkml_model_*`` series carries a model label bounded by
``resolve_model``: the first ``MODEL_MAX`` distinct names get their own
label, later ones collapse into ``(overflow)``. Every ledger mutation
increments ``sparkml_model_ledger_mutations_total{model,op}``. Only the
low-cardinality families read over time (HBM bytes, device-seconds,
``ewma_rps``, reconcile drift) earn history rings; the rest stay on
``/metrics`` and in ``/debug/costs`` (``obs.tsdb.SAMPLE_EXCLUDE``).

Knobs (env):

* ``SPARK_RAPIDS_ML_TORCH_OBS_ACCOUNTING`` — ``0`` disables the ledger
  (every mutation becomes a cheap guard-and-return; default on).
* ``SPARK_RAPIDS_ML_TORCH_OBS_MODEL_MAX`` — distinct model labels before
  ``(overflow)`` (default 64).
* ``SPARK_RAPIDS_ML_TORCH_OBS_ACCOUNTING_TAU`` — EWMA time constant for
  ``ewma_rps``, seconds (default 60).
* ``SPARK_RAPIDS_ML_TORCH_OBS_RECONCILE_TOL`` — relative drift between
  ledger and devmon device-seconds tolerated per model (default 0.05).
* ``SPARK_RAPIDS_ML_TORCH_OBS_RECONCILE_MIN_SECONDS`` — models with less
  devmon busy-time than this are skipped by reconciliation (default
  0.05 s).

Surfaces: ``GET /debug/costs`` (``costs_document()`` — per-model
rollups, per-replica breakdown, the ranked cold-model report and the
reconciliation verdict) and the history sampler (``publish()`` is
registered as a collector by ``start_serve_server``, so the time-derived
gauges refresh every sweep and earn history).
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from spark_rapids_ml_tpu_torch.obs.fitmon import FIT_MODEL_PREFIX
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry

ACCOUNTING_ENV = "SPARK_RAPIDS_ML_TORCH_OBS_ACCOUNTING"
MODEL_MAX_ENV = "SPARK_RAPIDS_ML_TORCH_OBS_MODEL_MAX"
TAU_ENV = "SPARK_RAPIDS_ML_TORCH_OBS_ACCOUNTING_TAU"
RECONCILE_TOL_ENV = "SPARK_RAPIDS_ML_TORCH_OBS_RECONCILE_TOL"
RECONCILE_MIN_ENV = "SPARK_RAPIDS_ML_TORCH_OBS_RECONCILE_MIN_SECONDS"

OVERFLOW_MODEL = "(overflow)"
DEFAULT_MODEL_MAX = 64
DEFAULT_TAU_SECONDS = 60.0
DEFAULT_RECONCILE_TOL = 0.05
DEFAULT_RECONCILE_MIN_SECONDS = 0.05

# HBM residency components (the only values the component label takes).
COMPONENT_WEIGHTS = "weights"
COMPONENT_RESERVE = "reserve"
COMPONENT_EXECUTABLES = "executables"

# per-(tenant, priority) rollups kept in the snapshot; bounded so a
# hostile tenant mix cannot grow the ledger without bound (tenant ids
# reaching here are already TENANT_MAX-bounded by serve.admission, this
# is defense in depth)
_MAX_TENANT_ROWS = 128


def _env_flag(name: str, default: bool = True) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off", "")


def _env_float(name: str, default: float) -> float:
    try:
        value = float(os.environ.get(name, "").strip() or default)
    except (TypeError, ValueError):
        return default
    return value if value > 0 else default


def _env_int(name: str, default: int) -> int:
    try:
        value = int(os.environ.get(name, "").strip() or default)
    except (TypeError, ValueError):
        return default
    return value if value > 0 else default


class _ModelVitals:
    """Traffic + cost accumulators for one resolved model label."""

    __slots__ = ("rows", "requests", "device_seconds", "compile_seconds",
                 "compiles", "aot_hit", "aot_miss", "signatures",
                 "last_hit", "ewma_acc", "ewma_ts", "tenants")

    def __init__(self):
        self.rows = 0
        self.requests: Dict[str, int] = {}
        self.device_seconds = 0.0
        self.compile_seconds = 0.0
        self.compiles = 0
        self.aot_hit = 0
        self.aot_miss = 0
        self.signatures = 0
        self.last_hit: Optional[float] = None   # ledger-clock timestamp
        self.ewma_acc = 0.0
        self.ewma_ts: Optional[float] = None
        # (tenant, priority) -> {"rows": n, "requests": n}
        self.tenants: Dict[Tuple[str, str], Dict[str, int]] = {}


class ResourceLedger:
    """Process-wide per-model resource ledger (see module docstring).

    Thread-safe; the hot-path entry points (``note_request``,
    ``note_batch_seconds``) never raise — accounting is telemetry, not
    control flow. Memory mutations (charge/release/retire/revive) DO
    raise on caller bugs (negative bytes, unknown component): those run
    on the engine's build/scale paths where a silent mis-charge would
    corrupt the very numbers the tiering controller will trust.
    """

    def __init__(self, clock=time.monotonic,
                 enabled: Optional[bool] = None):
        self._clock = clock
        self.enabled = (_env_flag(ACCOUNTING_ENV, True)
                        if enabled is None else bool(enabled))
        self.model_max = _env_int(MODEL_MAX_ENV, DEFAULT_MODEL_MAX)
        self.tau = _env_float(TAU_ENV, DEFAULT_TAU_SECONDS)
        self.reconcile_tol = _env_float(
            RECONCILE_TOL_ENV, DEFAULT_RECONCILE_TOL)
        self.reconcile_min_seconds = _env_float(
            RECONCILE_MIN_ENV, DEFAULT_RECONCILE_MIN_SECONDS)
        self._lock = threading.RLock()
        # (model, version, replica, component) -> bytes
        self._mem: Dict[Tuple[str, str, str, str], int] = {}
        self._vitals: Dict[str, _ModelVitals] = {}
        self._known_models: set = set()
        # compile-attribution window depth, per thread (outermost counts)
        self._attr_local = threading.local()
        self._declare_metrics()

    def _declare_metrics(self) -> None:
        reg = get_registry()
        self._m_rows = reg.counter(
            "sparkml_model_rows_total",
            "rows served per model", ("model",))
        self._m_requests = reg.counter(
            "sparkml_model_requests_total",
            "requests per model by outcome", ("model", "outcome"))
        self._m_device_seconds = reg.counter(
            "sparkml_model_device_seconds_total",
            "device wall-clock attributed per model at the batcher "
            "completion seam (reconciled against devmon)", ("model",))
        self._m_compile_seconds = reg.counter(
            "sparkml_model_compile_seconds_total",
            "compile wall-clock attributed per model during warm/build "
            "windows", ("model",))
        self._m_compiles = reg.counter(
            "sparkml_model_compiles_total",
            "compilations attributed per model", ("model",))
        self._m_aot = reg.counter(
            "sparkml_model_aot_cache_total",
            "AOT executable-cache events attributed per model",
            ("model", "event"))
        self._m_mutations = reg.counter(
            "sparkml_model_ledger_mutations_total",
            "ledger mutations by operation (audit trail: every "
            "charge/release/retire/revive/note lands here)",
            ("model", "op"))
        self._m_reconcile_checks = reg.counter(
            "sparkml_model_reconcile_checks_total",
            "ledger-vs-devmon reconciliation verdicts", ("verdict",))
        self._m_hbm = reg.gauge(
            "sparkml_model_hbm_bytes",
            "accounted HBM residency per model by component "
            "(weights=live replicas, reserve=reaped-but-retained "
            "programs, executables=serialized AOT entries)",
            ("model", "component"))
        self._m_ewma = reg.gauge(
            "sparkml_model_ewma_rps",
            "decaying-average rows/second per model (tau="
            "SPARK_RAPIDS_ML_TORCH_OBS_ACCOUNTING_TAU)", ("model",))
        self._m_age = reg.gauge(
            "sparkml_model_last_hit_age_seconds",
            "seconds since a model last served a request "
            "(-1 = never hit)", ("model",))
        self._m_drift = reg.gauge(
            "sparkml_model_reconcile_drift_ratio",
            "relative drift between ledger and devmon device-seconds "
            "per model", ("model",))

    # -- model-label cardinality guard -------------------------------------

    def resolve_model(self, name: str) -> str:
        """Bound the model label: the first ``model_max`` distinct names
        keep their own label, later ones collapse to ``(overflow)``.
        Mirrors ``serve.admission``'s tenant guard."""
        name = str(name) if name else "(unknown)"
        with self._lock:
            if name in self._known_models:
                return name
            if len(self._known_models) < self.model_max:
                self._known_models.add(name)
                return name
            return OVERFLOW_MODEL

    def _vitals_for(self, label: str) -> _ModelVitals:
        # caller holds self._lock
        vitals = self._vitals.get(label)
        if vitals is None:
            vitals = self._vitals[label] = _ModelVitals()
        return vitals

    # -- HBM residency ------------------------------------------------------

    def charge_memory(self, model: str, version: Any, replica: str,
                      component: str, nbytes: int) -> None:
        """Account ``nbytes`` of device residency to one replica of
        ``model@version``. Re-charging the same key overwrites (a
        rebuilt replica re-states its footprint, it does not stack)."""
        if not self.enabled:
            return
        if component not in (COMPONENT_WEIGHTS, COMPONENT_RESERVE,
                             COMPONENT_EXECUTABLES):
            raise ValueError(f"unknown residency component {component!r}")
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError("residency bytes cannot be negative")
        label = self.resolve_model(model)
        key = (label, str(version), str(replica), component)
        with self._lock:
            self._mem[key] = nbytes
            self._publish_hbm_locked(label)
        self._m_mutations.inc(model=label, op="charge")

    def release_memory(self, model: str, version: Any = None,
                       replica: Optional[str] = None,
                       component: Optional[str] = None) -> int:
        """Drop accounted residency; None fields are wildcards (release
        every version / replica / component of the model). Returns the
        bytes released. This is the eviction path — reap uses
        ``retire_replica`` instead, which keeps the bytes visible under
        ``reserve``."""
        if not self.enabled:
            return 0
        label = self.resolve_model(model)
        version_s = None if version is None else str(version)
        replica_s = None if replica is None else str(replica)
        released = 0
        with self._lock:
            for key in [k for k in self._mem if k[0] == label]:
                if version_s is not None and key[1] != version_s:
                    continue
                if replica_s is not None and key[2] != replica_s:
                    continue
                if component is not None and key[3] != component:
                    continue
                released += self._mem.pop(key)
            self._publish_hbm_locked(label)
        self._m_mutations.inc(model=label, op="release")
        return released

    def retire_replica(self, model: str, version: Any,
                       replica: str) -> int:
        """Move one reaped replica's ``weights`` bytes to ``reserve``:
        the engine retains the staged program for cheap revival, so the
        bytes are still device-resident — they just stop counting as
        live serving capacity. Returns the bytes moved. Idempotent."""
        if not self.enabled:
            return 0
        label = self.resolve_model(model)
        src = (label, str(version), str(replica), COMPONENT_WEIGHTS)
        dst = (label, str(version), str(replica), COMPONENT_RESERVE)
        with self._lock:
            moved = self._mem.pop(src, 0)
            if moved:
                self._mem[dst] = self._mem.get(dst, 0) + moved
            self._publish_hbm_locked(label)
        self._m_mutations.inc(model=label, op="retire")
        return moved

    def revive_replica(self, model: str, version: Any,
                       replica: str) -> int:
        """Reverse of ``retire_replica``: a scale-up revived the reaped
        replica, its bytes count as live ``weights`` again. Idempotent
        (a replica that was never reaped moves nothing)."""
        if not self.enabled:
            return 0
        label = self.resolve_model(model)
        src = (label, str(version), str(replica), COMPONENT_RESERVE)
        dst = (label, str(version), str(replica), COMPONENT_WEIGHTS)
        with self._lock:
            moved = self._mem.pop(src, 0)
            if moved:
                self._mem[dst] = self._mem.get(dst, 0) + moved
            self._publish_hbm_locked(label)
        self._m_mutations.inc(model=label, op="revive")
        return moved

    def _publish_hbm_locked(self, label: str) -> None:
        # caller holds self._lock; restate the model's per-component
        # gauge from the map (gauges are absolute, not deltas)
        totals = {COMPONENT_WEIGHTS: 0, COMPONENT_RESERVE: 0,
                  COMPONENT_EXECUTABLES: 0}
        for key, nbytes in self._mem.items():
            if key[0] == label:
                totals[key[3]] += nbytes
        for component, nbytes in totals.items():
            self._m_hbm.set(nbytes, model=label, component=component)

    def memory_bytes(self, model: Optional[str] = None,
                     component: Optional[str] = None) -> Dict[str, int]:
        """Accounted resident bytes per model (summed over versions,
        replicas and — unless ``component`` is given — components).
        The per-model number predictive autoscaling / tiering reads."""
        out: Dict[str, int] = {}
        with self._lock:
            for key, nbytes in self._mem.items():
                if model is not None and key[0] != model:
                    continue
                if component is not None and key[3] != component:
                    continue
                out[key[0]] = out.get(key[0], 0) + nbytes
        return out

    # -- traffic vitals (hot path — never raises) ---------------------------

    def note_request(self, model: str, version: Any, tenant: str,
                     priority: str, rows: int, outcome: str) -> None:
        """Record one request's vitals. Called from the serve hot path:
        guards first, never raises."""
        if not self.enabled:
            return
        try:
            label = self.resolve_model(model)
            rows = max(int(rows), 0)
            now = self._clock()
            with self._lock:
                vitals = self._vitals_for(label)
                vitals.requests[outcome] = (
                    vitals.requests.get(outcome, 0) + 1)
                if outcome == "ok":
                    vitals.rows += rows
                    # decaying rate accumulator: decay by the elapsed
                    # gap, then add this request's rows
                    if vitals.ewma_ts is not None:
                        dt = max(now - vitals.ewma_ts, 0.0)
                        vitals.ewma_acc *= math.exp(-dt / self.tau)
                    vitals.ewma_acc += rows
                    vitals.ewma_ts = now
                    vitals.last_hit = now
                tkey = (str(tenant), str(priority))
                trow = vitals.tenants.get(tkey)
                if trow is None and len(vitals.tenants) < _MAX_TENANT_ROWS:
                    trow = vitals.tenants[tkey] = {"rows": 0,
                                                   "requests": 0}
                if trow is not None:
                    trow["requests"] += 1
                    if outcome == "ok":
                        trow["rows"] += rows
            self._m_requests.inc(model=label, outcome=outcome)
            if outcome == "ok" and rows:
                self._m_rows.inc(rows, model=label)
            self._m_mutations.inc(model=label, op="note_request")
        except Exception:
            pass  # vitals must never fail a request

    def note_batch_seconds(self, model: str, seconds: float,
                           device: Optional[str] = None) -> None:
        """Attribute one coalesced batch's device time to the model.
        Same seam (and same never-raises contract) as
        ``devmon.note_batch`` — reconcile() checks the two agree."""
        if not self.enabled:
            return
        try:
            label = self.resolve_model(model)
            seconds = max(float(seconds), 0.0)
            with self._lock:
                self._vitals_for(label).device_seconds += seconds
            self._m_device_seconds.inc(seconds, model=label)
            self._m_mutations.inc(model=label, op="note_batch")
        except Exception:
            pass  # attribution must never fail a batch

    # -- compile / cache attribution ---------------------------------------

    @contextlib.contextmanager
    def compile_attribution(self, model: str, version: Any):
        """A compile-attribution window for ``model@version``. Reentrant
        per thread: only the OUTERMOST window counts (warmup wrapping the
        batcher build must not count twice). The JAX window charges the
        compile and executable-cache deltas inside it and so serializes
        windows across threads; the port has no such totals (see the
        module docstring), so its window charges only the model's vitals
        entry and the ``compile_attribution`` mutation, and takes no
        lock: concurrent cold models warm in parallel."""
        if not self.enabled:
            yield
            return
        depth = getattr(self._attr_local, "depth", 0)
        self._attr_local.depth = depth + 1
        try:
            yield
        finally:
            self._attr_local.depth = depth
            if depth == 0:
                try:
                    label = self.resolve_model(model)
                    with self._lock:
                        self._vitals_for(label)
                    self._m_mutations.inc(model=label,
                                          op="compile_attribution")
                except Exception:
                    pass  # attribution is telemetry

    # -- reconciliation (checked, not trusted) ------------------------------

    def reconcile(self) -> Dict[str, Any]:
        """Compare the ledger's per-model device-seconds against what
        devmon measured at the same seam
        (``sparkml_serve_device_batch_seconds_total``). Publishes a
        per-model drift-ratio gauge and a verdict counter; returns the
        full comparison. Models below ``reconcile_min_seconds`` of
        devmon busy-time are skipped (ratios over microseconds are
        noise, not evidence). Device time the fit monitor attributes to
        ``fit:<algo>`` is a fit's, not a served model's, so it is left
        out: the JAX ledger counts it as ``(overflow)`` and reads a fit
        run in a serving process as drift."""
        devmon_by_model: Dict[str, float] = {}
        try:
            family = get_registry().counter(
                "sparkml_serve_device_batch_seconds_total",
                "device wall-clock attributed to coalesced serve "
                "batches — rate() of this series is per-device "
                "occupancy", ("model", "device"))
            for key, child in family._samples():
                labels = family._label_dict(key)
                raw = labels.get("model", "(unknown)")
                if raw.startswith(FIT_MODEL_PREFIX):
                    continue
                with self._lock:
                    label = (raw if raw in self._known_models
                             else OVERFLOW_MODEL)
                with child.lock:
                    value = child.value
                devmon_by_model[label] = (
                    devmon_by_model.get(label, 0.0) + value)
        except Exception:
            pass
        with self._lock:
            ledger_by_model = {label: vitals.device_seconds
                               for label, vitals in self._vitals.items()
                               if vitals.device_seconds > 0}
        models: Dict[str, Any] = {}
        worst = 0.0
        checked = 0
        for label in sorted(set(devmon_by_model) | set(ledger_by_model)):
            devmon_s = devmon_by_model.get(label, 0.0)
            ledger_s = ledger_by_model.get(label, 0.0)
            if max(devmon_s, ledger_s) < self.reconcile_min_seconds:
                models[label] = {"ledger_seconds": ledger_s,
                                 "devmon_seconds": devmon_s,
                                 "skipped": True}
                continue
            drift = (abs(ledger_s - devmon_s)
                     / max(devmon_s, ledger_s, 1e-9))
            self._m_drift.set(drift, model=label)
            models[label] = {"ledger_seconds": ledger_s,
                             "devmon_seconds": devmon_s,
                             "drift_ratio": drift}
            worst = max(worst, drift)
            checked += 1
        verdict = "ok" if worst <= self.reconcile_tol else "drift"
        self._m_reconcile_checks.inc(verdict=verdict)
        self._m_mutations.inc(model="(all)", op="reconcile")
        return {"verdict": verdict, "worst_drift_ratio": worst,
                "tolerance": self.reconcile_tol,
                "models_checked": checked, "models": models}

    # -- surfaces -----------------------------------------------------------

    def publish(self) -> None:
        """Refresh the time-derived gauges (last-hit age, EWMA decay).
        Registered as a TSDB sampler collector so every sweep both
        updates the gauges and records their history."""
        if not self.enabled:
            return
        now = self._clock()
        with self._lock:
            for label, vitals in self._vitals.items():
                self._m_ewma.set(self._ewma_rps_locked(vitals, now),
                                 model=label)
                age = (-1.0 if vitals.last_hit is None
                       else max(now - vitals.last_hit, 0.0))
                self._m_age.set(age, model=label)

    def _ewma_rps_locked(self, vitals: _ModelVitals, now: float) -> float:
        if vitals.ewma_ts is None:
            return 0.0
        dt = max(now - vitals.ewma_ts, 0.0)
        return (vitals.ewma_acc * math.exp(-dt / self.tau)) / self.tau

    def costs_document(self) -> Dict[str, Any]:
        """The ``/debug/costs`` payload: per-model rollups, per-replica
        residency breakdown, the ranked cold-model report (the exact
        input a tiering controller evicts by), and the reconciliation
        verdict."""
        models = self._model_rollups()
        cold = self._cold_report(models)
        return {"models": models, "cold_report": cold,
                "reconcile": self.reconcile()}

    def cold_report(self) -> List[Dict[str, Any]]:
        """The ranked cold-model report alone — the ONE source of truth
        the tiering controller's eviction scorer reads, identical row
        for row to ``costs_document()["cold_report"]`` (and therefore to
        ``GET /debug/costs``)."""
        return self._cold_report(self._model_rollups())

    def _model_rollups(self) -> Dict[str, Any]:
        """Per-model rollups (residency components, replicas, traffic
        vitals) shared by ``costs_document`` and ``cold_report``."""
        now = self._clock()
        with self._lock:
            labels = sorted(set(self._vitals)
                            | {key[0] for key in self._mem})
            models: Dict[str, Any] = {}
            for label in labels:
                vitals = self._vitals.get(label) or _ModelVitals()
                components = {COMPONENT_WEIGHTS: 0, COMPONENT_RESERVE: 0,
                              COMPONENT_EXECUTABLES: 0}
                replicas: Dict[str, Dict[str, int]] = {}
                for key, nbytes in self._mem.items():
                    if key[0] != label:
                        continue
                    components[key[3]] += nbytes
                    rep = replicas.setdefault(
                        f"{key[2]}@v{key[1]}", {})
                    rep[key[3]] = rep.get(key[3], 0) + nbytes
                models[label] = {
                    "hbm_bytes": components,
                    "hbm_total_bytes": sum(components.values()),
                    "replicas": replicas,
                    "device_seconds": vitals.device_seconds,
                    "rows": vitals.rows,
                    "requests": dict(vitals.requests),
                    "compile_seconds": vitals.compile_seconds,
                    "compiles": vitals.compiles,
                    "aot_cache": {"hit": vitals.aot_hit,
                                  "miss": vitals.aot_miss},
                    "ewma_rps": self._ewma_rps_locked(vitals, now),
                    "last_hit_age_seconds": (
                        -1.0 if vitals.last_hit is None
                        else max(now - vitals.last_hit, 0.0)),
                    "tenants": {
                        f"{tenant}|{priority}": dict(row)
                        for (tenant, priority), row
                        in sorted(vitals.tenants.items())},
                }
        return models

    @staticmethod
    def _cold_report(models: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Rank resident models coldest-first: cost held on device vs
        traffic served. ``cold_score = resident_bytes * (age + 1) /
        (ewma_rps + 1)`` — a model holding HBM while serving nothing
        sorts to the top; a hot model sorts to the bottom."""
        report = []
        for label, doc in models.items():
            resident = doc["hbm_total_bytes"]
            if resident <= 0:
                continue
            age = doc["last_hit_age_seconds"]
            age = 1e6 if age < 0 else age  # never-hit is maximally cold
            rps = doc["ewma_rps"]
            report.append({
                "model": label,
                "resident_bytes": resident,
                "ewma_rps": rps,
                "last_hit_age_seconds": doc["last_hit_age_seconds"],
                "cold_score": resident * (age + 1.0) / (rps + 1.0),
            })
        report.sort(key=lambda row: row["cold_score"], reverse=True)
        return report

    def snapshot(self) -> Dict[str, Any]:
        """Cheap introspection for tests / debug dumps."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "model_max": self.model_max,
                "known_models": sorted(self._known_models),
                "memory": {" ".join(key): nbytes
                           for key, nbytes in sorted(self._mem.items())},
            }


_ledger: Optional[ResourceLedger] = None
_ledger_lock = threading.Lock()


def get_ledger() -> ResourceLedger:
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            _ledger = ResourceLedger()
        return _ledger


def reset_ledger() -> None:
    """Drop the cached ledger (tests that reset the registry)."""
    global _ledger
    with _ledger_lock:
        _ledger = None


__all__ = [
    "ResourceLedger",
    "get_ledger",
    "reset_ledger",
    "OVERFLOW_MODEL",
    "COMPONENT_WEIGHTS",
    "COMPONENT_RESERVE",
    "COMPONENT_EXECUTABLES",
]
