"""Auto-incident engine: detectors → open/update/resolve lifecycle →
evidence bundles captured while the anomaly is still happening.

The port's copy of the JAX package's ``obs/incidents.py``, whole.
``obs.anomaly`` notices; this module remembers and diagnoses. An
``IncidentEngine`` runs the detector catalog once per metrics-sampler
sweep (``install()`` hooks ``MetricsSampler.register_post_sweep`` — no
new thread, and the sweep cost lands in
``sparkml_obs_overhead_seconds_total{component="anomaly"}``), feeding an
``IncidentManager`` that applies the alerting hygiene a paging system
needs:

* **hysteresis** — a detector must fire ``open_after`` consecutive
  sweeps to open (one noisy sample never pages) and stay quiet
  ``resolve_after`` consecutive sweeps to resolve (a flapping signal
  never storms the log);
* **dedup** — one open incident per (detector, series); continued
  firing updates it (``updates`` count, latest value) instead of
  opening siblings;
* **cooldown** — a just-resolved key cannot reopen for
  ``cooldown_seconds`` (counted in
  ``sparkml_obs_incidents_suppressed_total``, never silent);
* **severity from burn rate** — the detector's own severity is
  escalated by the live 5-minute SLO burn gauge through the same
  SRE-workbook ladder the alert policies use
  (``obs.slo.severity_for_burn``).

Opening an incident assembles an **evidence bundle** on disk
(``<dump_dir>/incidents/<id>/``) while the metrics still show the
lead-up:

* ``incident.json`` — the record itself (rewritten at resolve);
* ``history.json`` — last-5-minutes of the implicated series plus the
  standard serve/SLO/device/host context tail;
* ``traces.json`` — slowest-request trace-id exemplars from the
  latency summaries, each assembled into a full span tree (the span
  ring's newest request traces when no exemplar resolves);
* ``breakers.json`` — circuit-breaker transition ring + live states
  (via the flight recorder's registered dump section — no obs → serve
  import);
* a **flight dump** (stacks, open spans, in-flight requests, metrics);
* for latency/memory incidents, a **guarded profile capture**
  (``obs.profiler.start_capture``, a ``torch.profiler`` trace —
  single-flight; skipped, and recorded as skipped, when one is already
  running).

Operator surface: ``GET /debug/incidents`` (``serve.server``),
``sparkml_obs_incidents_total{detector,severity}``,
``sparkml_obs_incidents_open``, and a structured ERROR log line per
open — the pointer to the bundle survives any UI.

Knobs: ``SPARK_RAPIDS_ML_TORCH_OBS_INCIDENTS`` (kill switch, default
on), ``SPARK_RAPIDS_ML_TORCH_OBS_INCIDENT_{OPEN_AFTER,RESOLVE_AFTER,
COOLDOWN_S,CAPTURE_S}`` and ``..._INCIDENT_WINDOW_S`` (``obs.anomaly``).

All timestamps flow from the caller's ``now`` (the sampler's injectable
clock): this module never reads the wall clock directly (the JAX
package's ``check_instrumentation`` rule 8 holds this file too), so
tests drive the whole open→update→resolve lifecycle with zero real
sleeps.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from spark_rapids_ml_tpu_torch.obs import anomaly as anomaly_mod
from spark_rapids_ml_tpu_torch.obs import flight
from spark_rapids_ml_tpu_torch.obs import metrics as metrics_mod
from spark_rapids_ml_tpu_torch.obs import profiler as profiler_mod
from spark_rapids_ml_tpu_torch.obs import spans as spans_mod
from spark_rapids_ml_tpu_torch.obs import tsdb as tsdb_mod
from spark_rapids_ml_tpu_torch.obs.logging import _env_float, get_logger
from spark_rapids_ml_tpu_torch.obs.slo import severity_for_burn

# one guarded-eval helper for the whole obs layer, not a copy per module
_safe = flight._safe

ENABLED_ENV = "SPARK_RAPIDS_ML_TORCH_OBS_INCIDENTS"
OPEN_AFTER_ENV = "SPARK_RAPIDS_ML_TORCH_OBS_INCIDENT_OPEN_AFTER"
RESOLVE_AFTER_ENV = "SPARK_RAPIDS_ML_TORCH_OBS_INCIDENT_RESOLVE_AFTER"
COOLDOWN_ENV = "SPARK_RAPIDS_ML_TORCH_OBS_INCIDENT_COOLDOWN_S"
CAPTURE_ENV = "SPARK_RAPIDS_ML_TORCH_OBS_INCIDENT_CAPTURE_S"

_DEFAULT_OPEN_AFTER = 2
_DEFAULT_RESOLVE_AFTER = 5
_DEFAULT_COOLDOWN_S = 60.0
_DEFAULT_CAPTURE_S = 3.0
_HISTORY_WINDOW_S = 300.0
_RECENT_LIMIT = 32
_MAX_TRACE_TREES = 3
# Summaries whose slowest-trace exemplars seed the bundle's trace trees.
_EXEMPLAR_FAMILIES = (
    "sparkml_serve_request_latency_seconds",
    "sparkml_http_request_latency_seconds",
)
_SEVERITY_RANK = {s: i for i, s in enumerate(anomaly_mod.SEVERITIES)}

_log = get_logger("obs.incidents")


def enabled() -> bool:
    """The auto-incident engine's kill switch (default on)."""
    return os.environ.get(ENABLED_ENV, "1").strip().lower() not in (
        "0", "false", "off", "no")


def incidents_dir() -> str:
    return os.path.join(flight.dump_dir(), "incidents")


def _safe_id_part(text: str) -> str:
    return "".join(c if (c.isalnum() or c in "-_") else "_"
                   for c in str(text))[:60]


class Incident:
    """One detected anomaly's lifecycle: open → update* → resolve."""

    __slots__ = ("id", "detector", "kind", "severity", "metric",
                 "labels", "state", "opened_ts", "updated_ts",
                 "resolved_ts", "value", "baseline", "reason",
                 "updates", "quiet_sweeps", "evidence")

    def __init__(self, incident_id: str, finding: anomaly_mod.Finding,
                 severity: str, now: float):
        self.id = incident_id
        self.detector = finding.detector
        self.kind = finding.kind
        self.severity = severity
        self.metric = finding.metric
        self.labels = dict(finding.labels)
        self.state = "open"
        self.opened_ts = now
        self.updated_ts = now
        self.resolved_ts: Optional[float] = None
        self.value = finding.value
        self.baseline = finding.baseline
        self.reason = finding.reason
        self.updates = 0
        self.quiet_sweeps = 0
        self.evidence: Dict[str, Any] = {}

    def as_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "detector": self.detector,
            "kind": self.kind,
            "severity": self.severity,
            "metric": self.metric,
            "labels": dict(self.labels),
            "state": self.state,
            "opened_ts": self.opened_ts,
            "updated_ts": self.updated_ts,
            "resolved_ts": self.resolved_ts,
            "duration_seconds": (
                (self.resolved_ts if self.resolved_ts is not None
                 else self.updated_ts) - self.opened_ts
            ),
            "value": self.value,
            "baseline": self.baseline,
            "reason": self.reason,
            "updates": self.updates,
            "evidence": dict(self.evidence),
        }


class IncidentManager:
    """Hysteresis, dedup, cooldown, and evidence capture over findings.

    ``observe(findings, now, store)`` is the one entry point, called
    once per detector sweep with THAT sweep's findings and timestamp —
    the manager itself never reads a clock.
    """

    def __init__(
        self,
        *,
        open_after: Optional[int] = None,
        resolve_after: Optional[int] = None,
        cooldown_seconds: Optional[float] = None,
        capture_seconds: Optional[float] = None,
        evidence_root: Optional[str] = None,
        history_window: float = _HISTORY_WINDOW_S,
        recent_limit: int = _RECENT_LIMIT,
        registry: Optional[metrics_mod.MetricsRegistry] = None,
    ):
        self.open_after = max(int(
            open_after if open_after is not None
            else _env_float(OPEN_AFTER_ENV, _DEFAULT_OPEN_AFTER)), 1)
        self.resolve_after = max(int(
            resolve_after if resolve_after is not None
            else _env_float(RESOLVE_AFTER_ENV, _DEFAULT_RESOLVE_AFTER)),
            1)
        self.cooldown_seconds = float(
            cooldown_seconds if cooldown_seconds is not None
            else _env_float(COOLDOWN_ENV, _DEFAULT_COOLDOWN_S))
        self.capture_seconds = float(
            capture_seconds if capture_seconds is not None
            else _env_float(CAPTURE_ENV, _DEFAULT_CAPTURE_S))
        self._evidence_root = evidence_root
        self.history_window = float(history_window)
        self.recent_limit = int(recent_limit)
        self._registry = registry
        self._lock = threading.Lock()
        self._open: Dict[Tuple, Incident] = {}
        self._streaks: Dict[Tuple, int] = {}
        self._last_resolved: Dict[Tuple, float] = {}
        self._recent: List[Incident] = []
        self.opened_total = 0
        self.resolved_total = 0
        self.suppressed_total = 0

    def _reg(self) -> metrics_mod.MetricsRegistry:
        return (self._registry if self._registry is not None
                else metrics_mod.get_registry())

    def evidence_root(self) -> str:
        return self._evidence_root or incidents_dir()

    # -- the sweep entry point ---------------------------------------------

    def observe(self, findings: List[anomaly_mod.Finding], now: float,
                store: Optional[tsdb_mod.TimeSeriesStore] = None,
                ) -> List[Incident]:
        """Apply one sweep's findings; returns incidents OPENED by it.

        State transitions happen under the lock; evidence capture and
        logging happen AFTER it releases — the flight dump an open
        triggers runs every registered dump section, including this
        manager's own, and bundle I/O must never block a
        ``/debug/incidents`` poll.
        """
        by_key: Dict[Tuple, anomaly_mod.Finding] = {}
        for finding in findings:
            by_key[finding.key] = finding
        opened: List[Incident] = []
        resolved: List[Incident] = []
        with self._lock:
            # keys that went quiet lose their pending open streak
            for key in [k for k in self._streaks if k not in by_key]:
                del self._streaks[key]
            for key, finding in by_key.items():
                incident = self._open.get(key)
                if incident is not None:
                    incident.updated_ts = now
                    incident.value = finding.value
                    incident.reason = finding.reason
                    incident.updates += 1
                    incident.quiet_sweeps = 0
                    continue
                resolved_at = self._last_resolved.get(key)
                if (resolved_at is not None
                        and now - resolved_at < self.cooldown_seconds):
                    self._streaks.pop(key, None)
                    self.suppressed_total += 1
                    self._count_suppressed(finding.detector)
                    continue
                streak = self._streaks.get(key, 0) + 1
                if streak < self.open_after:
                    self._streaks[key] = streak
                    continue
                self._streaks.pop(key, None)
                severity = self._effective_severity(finding, now, store)
                self.opened_total += 1
                # the sequence number keeps ids (and so evidence dirs)
                # unique when one detector opens on TWO series in the
                # same sweep — same detector, same millisecond
                incident = Incident(
                    f"inc_{_safe_id_part(finding.detector)}"
                    f"_{int(now * 1000)}_{self.opened_total}",
                    finding, severity, now,
                )
                self._open[key] = incident
                opened.append(incident)
            # open incidents not re-asserted this sweep edge toward
            # resolution
            for key, incident in list(self._open.items()):
                if key in by_key:
                    continue
                incident.quiet_sweeps += 1
                if incident.quiet_sweeps >= self.resolve_after:
                    incident.state = "resolved"
                    incident.resolved_ts = now
                    del self._open[key]
                    self._last_resolved[key] = now
                    self.resolved_total += 1
                    self._recent.append(incident)
                    del self._recent[:-self.recent_limit]
                    resolved.append(incident)
            self._publish_open_gauge()
        for incident in opened:
            self._finish_open(incident, now, store)
        for incident in resolved:
            _write_incident_json(incident)
            _log.info(
                "incident resolved", incident_id=incident.id,
                detector=incident.detector,
                duration_seconds=now - incident.opened_ts,
                updates=incident.updates,
            )
        return opened

    # -- lifecycle internals (outside the lock) -----------------------------

    def _finish_open(self, incident: Incident, now: float,
                     store) -> None:
        try:
            self._reg().counter(
                "sparkml_obs_incidents_total",
                "auto-detected incidents opened, by detector and "
                "severity", ("detector", "severity"),
            ).inc(detector=incident.detector,
                  severity=incident.severity)
        except Exception:
            pass  # incident accounting must never kill the sweep
        _capture_evidence(incident, now, store, self)
        # ERROR: the pointer to the evidence bundle must survive any
        # production log-level threshold, exactly like a flight dump.
        _log.error(
            "incident opened", incident_id=incident.id,
            detector=incident.detector, severity=incident.severity,
            kind=incident.kind, labels=incident.labels,
            value=incident.value, baseline=incident.baseline,
            reason=incident.reason,
            evidence=incident.evidence.get("dir"),
        )

    def _effective_severity(self, finding: anomaly_mod.Finding,
                            now: float, store) -> str:
        """The detector's severity, escalated by the live 5m SLO burn
        (the SRE ladder: burn ≥ 14.4 pages critical no matter which
        detector noticed first)."""
        severity = finding.severity
        if store is None:
            return severity
        try:
            burn = 0.0
            for series in store.range_query(
                    "sparkml_slo_burn_rate", {"window": "5m"},
                    120.0, now=now):
                if series["points"]:
                    burn = max(burn, series["points"][-1][1])
            escalated = severity_for_burn(burn)
            if (escalated is not None
                    and _SEVERITY_RANK.get(escalated, 0)
                    > _SEVERITY_RANK.get(severity, 0)):
                return escalated
        except Exception:
            pass  # severity escalation is best-effort
        return severity

    def _count_suppressed(self, detector: str) -> None:
        try:
            self._reg().counter(
                "sparkml_obs_incidents_suppressed_total",
                "incident opens suppressed by the post-resolve "
                "cooldown, by detector", ("detector",),
            ).inc(detector=detector)
        except Exception:
            pass

    def _publish_open_gauge(self) -> None:
        try:
            self._reg().gauge(
                "sparkml_obs_incidents_open",
                "currently-open auto-detected incidents",
            ).set(float(len(self._open)))
        except Exception:
            pass

    # -- introspection ------------------------------------------------------

    def open_incidents(self) -> List[Dict[str, Any]]:
        with self._lock:
            incidents = sorted(self._open.values(),
                               key=lambda i: i.opened_ts, reverse=True)
            return [i.as_dict() for i in incidents]

    def recent_incidents(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [i.as_dict() for i in reversed(self._recent)]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            open_ = sorted(self._open.values(),
                           key=lambda i: i.opened_ts, reverse=True)
            return {
                "open": [i.as_dict() for i in open_],
                "recent": [i.as_dict() for i in reversed(self._recent)],
                "opened_total": self.opened_total,
                "resolved_total": self.resolved_total,
                "suppressed_total": self.suppressed_total,
                "open_after": self.open_after,
                "resolve_after": self.resolve_after,
                "cooldown_seconds": self.cooldown_seconds,
                "evidence_root": self.evidence_root(),
            }


# -- evidence assembly --------------------------------------------------------


def _write_json(path: str, doc: Any) -> Optional[str]:
    """Atomic JSON write (tmp + rename, like flight dumps); returns the
    path or None — a failed artifact never kills the sweep."""
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, default=str)
        os.replace(tmp, path)
        return path
    except Exception:
        return None


def _write_incident_json(incident: Incident) -> None:
    directory = incident.evidence.get("dir")
    if not directory:
        return
    _write_json(os.path.join(directory, "incident.json"),
                incident.as_dict())


def _history_doc(incident: Incident, now: float, store,
                 window: float) -> Dict[str, Any]:
    return {
        "window_seconds": window,
        "implicated": {
            "metric": incident.metric,
            "labels": dict(incident.labels),
            "series": store.range_query(
                incident.metric, incident.labels or None, window,
                now=now),
        },
        "context": store.history_tail(
            prefixes=("sparkml_serve_", "sparkml_slo_",
                      "sparkml_device_", "sparkml_host_"),
            window=window, now=now),
    }


def _exemplar_trace_ids(registry: metrics_mod.MetricsRegistry,
                        limit: int) -> List[Dict[str, Any]]:
    """Slowest-request exemplars (value + trace id) from the latency
    summaries, slowest first across families."""
    exemplars: List[Dict[str, Any]] = []
    for family in registry.families():
        if family.name not in _EXEMPLAR_FAMILIES:
            continue
        if not isinstance(family, metrics_mod.Summary):
            continue
        for key, child in family._samples():
            with child.lock:
                ring = list(child.exemplars)
            labels = family._label_dict(key)
            for value, trace_id, unix_ts in ring:
                exemplars.append({
                    "metric": family.name, "labels": labels,
                    "value": value, "trace_id": trace_id,
                    "unix_ts": unix_ts,
                })
    exemplars.sort(key=lambda e: e["value"], reverse=True)
    return exemplars[:max(limit, 1)]


def _traces_doc(registry: metrics_mod.MetricsRegistry) -> Dict[str, Any]:
    exemplars = _safe(
        lambda: _exemplar_trace_ids(registry, _MAX_TRACE_TREES * 2), [])
    trees: List[Dict[str, Any]] = []
    seen: set = set()
    for ex in exemplars:
        tid = ex["trace_id"]
        if tid in seen:
            continue
        seen.add(tid)
        tree = _safe(lambda t=tid: spans_mod.assemble_trace(t))
        if tree and tree.get("span_count"):
            trees.append(tree)
        if len(trees) >= _MAX_TRACE_TREES:
            break
    if not trees:
        # no exemplars yet (cold process): fall back to the most recent
        # request traces in the span ring
        for summary in _safe(
                lambda: spans_mod.recent_traces(
                    _MAX_TRACE_TREES,
                    name_prefix=("serve:http", "serve:request")), []):
            tree = _safe(lambda s=summary: spans_mod.assemble_trace(
                s["trace_id"]))
            if tree and tree.get("span_count"):
                trees.append(tree)
    return {"exemplars": exemplars, "trees": trees}


def _maybe_profile(incident: Incident,
                   capture_seconds: float) -> Dict[str, Any]:
    """A guarded capture for latency/memory incidents: single-flight by
    construction — a second incident while one capture runs records
    ``skipped`` instead of stacking profiler overhead on a sick
    process."""
    if capture_seconds <= 0:
        return {"skipped": "disabled"}
    if incident.kind not in ("latency", "memory"):
        return {"skipped": f"kind_{incident.kind}"}
    try:
        info = profiler_mod.start_capture(
            capture_seconds, label=f"incident_{incident.detector}")
        return {"started": info}
    except profiler_mod.CaptureInFlight:
        return {"skipped": "capture_in_flight"}
    except Exception as exc:  # noqa: BLE001 - evidence is best-effort
        return {"error": f"{type(exc).__name__}: {exc}"}


def _capture_evidence(incident: Incident, now: float, store,
                      manager: IncidentManager) -> None:
    """Assemble the on-disk bundle. Every artifact is independently
    guarded: a full disk loses evidence, never the incident (errors are
    themselves recorded in the bundle index)."""
    evidence: Dict[str, Any] = {}
    try:
        directory = os.path.join(manager.evidence_root(), incident.id)
        os.makedirs(directory, exist_ok=True)
        evidence["dir"] = directory
    except Exception as exc:  # noqa: BLE001 - recorded, not raised
        incident.evidence = {
            "error": f"evidence dir failed: "
                     f"{type(exc).__name__}: {exc}",
        }
        return
    if store is not None:
        evidence["history"] = _write_json(
            os.path.join(directory, "history.json"),
            _safe(lambda: _history_doc(incident, now, store,
                                       manager.history_window), {}),
        )
    evidence["traces"] = _write_json(
        os.path.join(directory, "traces.json"),
        _safe(lambda: _traces_doc(manager._reg()), {}),
    )
    breakers = flight.run_dump_section("breaker_events")
    if breakers is not None:
        evidence["breakers"] = _write_json(
            os.path.join(directory, "breakers.json"), breakers)
    evidence["flight_dump"] = _safe(lambda: flight.dump(
        f"incident:{incident.detector}",
        extra={
            "incident_id": incident.id,
            "detector": incident.detector,
            "labels": dict(incident.labels),
            "reason": incident.reason,
        },
    ))
    evidence["profile"] = _maybe_profile(incident,
                                         manager.capture_seconds)
    incident.evidence = evidence
    _write_incident_json(incident)
    # incident bundles share the artifact GC with flight dumps and
    # profile captures — an incident storm must not fill the disk
    from spark_rapids_ml_tpu_torch.obs import retention

    _safe(lambda: retention.maybe_gc("incident"))


# -- the engine ---------------------------------------------------------------


class IncidentEngine:
    """Detector sweep + incident manager, hooked into the sampler.

    ``sweep(now)`` evaluates every detector against the store and feeds
    the manager; ``install(sampler)`` registers it as a post-sweep hook
    so detection runs on the EXISTING sampler thread at the sampling
    cadence, right after fresh samples land. The sweep's wall-clock
    cost is visible in
    ``sparkml_obs_overhead_seconds_total{component="anomaly"}``.
    """

    def __init__(
        self,
        store: Optional[tsdb_mod.TimeSeriesStore] = None,
        detectors: Optional[List[anomaly_mod.Detector]] = None,
        manager: Optional[IncidentManager] = None,
        registry: Optional[metrics_mod.MetricsRegistry] = None,
    ):
        self._store = store
        self.detectors: List[anomaly_mod.Detector] = (
            list(detectors) if detectors is not None
            else anomaly_mod.builtin_detectors()
        )
        self.manager = manager if manager is not None else (
            IncidentManager(registry=registry))
        self._registry = registry
        self._sweeps = 0
        # flat-0 gauge so dashboards see the series before the first
        # incident, not an absent metric
        self.manager._publish_open_gauge()

    def _reg(self) -> metrics_mod.MetricsRegistry:
        return (self._registry if self._registry is not None
                else metrics_mod.get_registry())

    def store(self) -> tsdb_mod.TimeSeriesStore:
        return (self._store if self._store is not None
                else tsdb_mod.get_tsdb())

    @property
    def sweeps(self) -> int:
        return self._sweeps

    def sweep(self, now: Optional[float] = None) -> List[Incident]:
        """One detection pass; returns incidents opened by it."""
        t0 = time.perf_counter()
        store = self.store()
        ts = store.clock() if now is None else now
        findings: List[anomaly_mod.Finding] = []
        for detector in self.detectors:
            try:
                findings.extend(detector.evaluate(store, ts))
            except Exception:
                self._count_detector_error(detector)
        opened = self.manager.observe(findings, ts, store=store)
        self._sweeps += 1
        try:
            self._reg().counter(
                "sparkml_obs_overhead_seconds_total",
                "wall-clock the observability layer spends watching "
                "(sampler sweeps, device monitor, profiler "
                "bookkeeping)", ("component",),
            ).inc(time.perf_counter() - t0, component="anomaly")
        except Exception:
            pass  # overhead accounting must never break detection
        return opened

    def install(self, sampler: tsdb_mod.MetricsSampler) -> None:
        """Run detection after every sampler sweep (idempotent — bound
        methods of one engine compare equal, so re-installing on server
        restarts never doubles the cadence). The INSTALLED engine also
        owns the ``incidents`` flight-dump section — registering it
        here, not in the constructor, keeps a hand-built side engine
        (examples, tests) from silently replacing the live server's
        section and from being pinned forever by the registry's strong
        reference."""
        sampler.register_post_sweep(self._post_sweep)
        flight.register_dump_section("incidents", self._dump_section)

    def uninstall(self, sampler: tsdb_mod.MetricsSampler) -> None:
        sampler.unregister_post_sweep(self._post_sweep)
        flight.unregister_dump_section("incidents")

    def _post_sweep(self, ts: float) -> None:
        self.sweep(now=ts)

    def _count_detector_error(self, detector) -> None:
        try:
            self._reg().counter(
                "sparkml_obs_detector_errors_total",
                "anomaly detectors that raised during a sweep",
                ("detector",),
            ).inc(detector=getattr(detector, "name", "detector"))
        except Exception:
            pass

    def _dump_section(self) -> Dict[str, Any]:
        # every flight dump names the incidents that were already open
        # when it was taken — a wedge diagnostic starts from them
        return {
            "open": self.manager.open_incidents(),
            "opened_total": self.manager.opened_total,
            "resolved_total": self.manager.resolved_total,
        }

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /debug/incidents`` document."""
        doc = self.manager.snapshot()
        doc["sweeps"] = self._sweeps
        doc["detectors"] = [d.describe() for d in self.detectors]
        return doc

    def digest(self, recent_limit: int = 8) -> Dict[str, Any]:
        """Compact open/recent digests for a fleet export: lifecycle
        fields only, no evidence bundles — an export is a poll payload,
        not an archive."""
        fields = ("id", "detector", "kind", "severity", "metric",
                  "labels", "state", "opened_ts", "resolved_ts",
                  "value", "reason")
        snap = self.manager.snapshot()
        return {
            "open": [{k: inc.get(k) for k in fields}
                     for inc in snap["open"]],
            "recent": [{k: inc.get(k) for k in fields}
                       for inc in snap["recent"][:max(recent_limit, 0)]],
            "opened_total": snap["opened_total"],
            "resolved_total": snap["resolved_total"],
        }


# -- the process-wide engine --------------------------------------------------

_lock = threading.Lock()
_engine: Optional[IncidentEngine] = None


def get_incident_engine() -> IncidentEngine:
    """The process-wide engine ``serve.server`` installs on the
    sampler."""
    global _engine
    with _lock:
        if _engine is None:
            _engine = IncidentEngine()
        return _engine


def reset_incident_engine() -> None:
    """Drop the process-wide engine (tests). Unhooks it from the
    current sampler and the flight-dump section."""
    global _engine
    with _lock:
        engine = _engine
        _engine = None
    if engine is not None:
        _safe(lambda: engine.uninstall(tsdb_mod.get_sampler()))
        flight.unregister_dump_section("incidents")


__all__ = [
    "CAPTURE_ENV",
    "COOLDOWN_ENV",
    "ENABLED_ENV",
    "Incident",
    "IncidentEngine",
    "IncidentManager",
    "OPEN_AFTER_ENV",
    "RESOLVE_AFTER_ENV",
    "enabled",
    "get_incident_engine",
    "incidents_dir",
    "reset_incident_engine",
]
