"""Online anomaly detectors over the embedded time-series store.

The port's copy of the JAX package's ``obs/anomaly.py``, whole. The
history store (``obs.tsdb``) remembers five minutes of every serving
metric; this module is the noticing: a registry of small detectors
evaluated against ``TimeSeriesStore.range_query`` once per sampler sweep
(``obs.incidents`` wires them in — no new thread, the cost lands in
``sparkml_obs_overhead_seconds_total{component="anomaly"}``).

Detector family (each evaluates PER CHILD SERIES, so a finding names
the implicated labels — "p99 spiked" arrives as "p99 spiked for
model=pca_embedder"):

* ``MadSpikeDetector`` — the latest sample vs a robust MAD baseline of
  the series' own trailing window (``obs.robust``). Right for true
  gauges that recover (queue depth, device memory in use): noisy-but-flat
  series widen their own band and stay quiet; a step change fires.
* ``RateOfChangeDetector`` — the increase across a trailing lookback.
  Right for cumulative-sketch signals like the sampled p99 quantile
  series, which only ever *converge* after an incident (a sketch never
  forgets its slow observations): the detector fires on the jump and
  goes quiet once the tail stabilizes.
* ``ThresholdDetector`` — latest sample vs a fixed bound (SLO fast-burn
  gauge > 14.4, the page_fast factor).
* ``RatioDetector`` — windowed delta of a labeled counter child over
  the windowed delta of all its siblings (error fraction of
  ``sparkml_serve_requests_total``), with a min-traffic floor so one
  failure among three requests cannot read as a 33% outage.
* ``DeltaDetector`` — reset-aware counter increase over a window
  (breaker FLAPS: ≥ 3 opens).

``builtin_detectors()`` is the reference's catalog, all ten entries:
serve p99, queue depth, error rate, device memory in use, breaker flaps,
SLO fast-burn, and four threshold detectors over series that no module
of the port publishes yet. On an absent series a detector finds
nothing, so each stays silent until its publisher is ported
(``ROADMAP.md`` queue 1):

* ``serve_replica_degraded`` reads ``sparkml_serve_replica_state``
  (placement, item 9);
* ``serve_canary_regressed`` reads ``sparkml_serve_canary_regressed``
  (rollout, item 2);
* ``fit_backend_degraded`` reads ``sparkml_fit_backend_ok`` (fitmon,
  item 1.4);
* ``fleet_host_down`` reads ``sparkml_fleet_host_up`` (federation,
  item 1.5).

Short windows scale with ``SPARK_RAPIDS_ML_TORCH_OBS_INCIDENT_WINDOW_S``
(default 60) so a drill can compress the whole detect→resolve loop.

Everything here is pure arithmetic over ``(timestamp, value)`` points
plus the caller-provided ``now`` — no wall-clock reads (the JAX
package's ``scripts/check_instrumentation.py`` rule 8 holds this file
too), so tests drive hours of detection through an injected clock with
zero sleeps.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from spark_rapids_ml_tpu_torch.obs import tsdb as tsdb_mod
from spark_rapids_ml_tpu_torch.obs.robust import (
    baseline_stats,
    robust_zscore,
)

WINDOW_ENV = "SPARK_RAPIDS_ML_TORCH_OBS_INCIDENT_WINDOW_S"
_DEFAULT_WINDOW_S = 60.0

# Severity ladder shared with obs.incidents (burn-rate escalation).
SEVERITIES = ("info", "warning", "serious", "critical")


def short_window_seconds() -> float:
    """The catalog's short window (spike/lookback/error-rate horizon)
    from ``SPARK_RAPIDS_ML_TORCH_OBS_INCIDENT_WINDOW_S``."""
    try:
        w = float(os.environ.get(WINDOW_ENV, _DEFAULT_WINDOW_S))
    except ValueError:
        return _DEFAULT_WINDOW_S
    return w if w > 0 else _DEFAULT_WINDOW_S


@dataclass(frozen=True)
class Finding:
    """One detector firing on one series, for one sweep."""

    detector: str
    kind: str  # latency | saturation | errors | memory | breaker | slo
    severity: str
    metric: str
    labels: Dict[str, Any] = field(default_factory=dict)
    value: float = 0.0
    baseline: Optional[float] = None
    reason: str = ""

    @property
    def key(self) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
        """The dedup identity: one incident per (detector, series)."""
        return (self.detector,
                tuple(sorted((str(k), str(v))
                             for k, v in self.labels.items())))

    def as_dict(self) -> Dict[str, Any]:
        return {
            "detector": self.detector,
            "kind": self.kind,
            "severity": self.severity,
            "metric": self.metric,
            "labels": dict(self.labels),
            "value": self.value,
            "baseline": self.baseline,
            "reason": self.reason,
        }


class Detector:
    """Base detector: named, typed, evaluated per matching child series.

    Subclasses implement ``_judge(points, now)`` → ``(value, baseline,
    reason) | None`` over ONE series' ascending ``[ts, value]`` points.
    """

    #: how wide a history slice the detector needs per evaluation
    query_window: float = 300.0

    def __init__(self, name: str, metric: str, *,
                 labels: Optional[Dict[str, str]] = None,
                 kind: str = "anomaly", severity: str = "warning"):
        self.name = name
        self.metric = metric
        self.labels = dict(labels or {})
        self.kind = kind
        self.severity = severity

    def describe(self) -> Dict[str, Any]:
        """Catalog entry for ``/debug/incidents`` and the README."""
        return {
            "name": self.name,
            "metric": self.metric,
            "labels": dict(self.labels),
            "kind": self.kind,
            "severity": self.severity,
            "type": type(self).__name__,
        }

    def evaluate(self, store: tsdb_mod.TimeSeriesStore,
                 now: float) -> List[Finding]:
        findings: List[Finding] = []
        for series in store.range_query(self.metric, self.labels or None,
                                        self.query_window, now=now):
            points = series["points"]
            if not points:
                continue
            verdict = self._judge(points, now, series)
            if verdict is None:
                continue
            value, baseline, reason = verdict
            findings.append(Finding(
                detector=self.name, kind=self.kind,
                severity=self.severity, metric=self.metric,
                labels=dict(series["labels"]), value=value,
                baseline=baseline, reason=reason,
            ))
        return findings

    def _judge(self, points: Sequence[Sequence[float]], now: float,
               series: Optional[Dict[str, Any]] = None):
        raise NotImplementedError


class MadSpikeDetector(Detector):
    """Latest sample vs the MAD noise band of its own trailing baseline.

    The baseline is every point older than ``spike_window``; the value
    is the newest point. Fires when ALL of:

    * the robust z-score exceeds ``z_threshold`` (a noisy-but-flat
      series has a wide MAD and stays quiet);
    * the step clears ``min_relative·|median| + min_step`` (a constant
      baseline has MAD 0 and an infinite z — the absolute guard keeps a
      0.1% wiggle off a flat line from paging);
    * the value is at least ``min_value`` (an empty queue going 0 → 3
      is not saturation).
    """

    def __init__(self, name: str, metric: str, *,
                 labels: Optional[Dict[str, str]] = None,
                 kind: str = "anomaly", severity: str = "warning",
                 baseline_window: float = 300.0,
                 spike_window: float = 15.0,
                 z_threshold: float = 4.0,
                 min_relative: float = 0.5,
                 min_step: float = 0.0,
                 min_value: float = 0.0,
                 min_points: int = 8):
        super().__init__(name, metric, labels=labels, kind=kind,
                         severity=severity)
        self.query_window = float(baseline_window)
        self.spike_window = float(spike_window)
        self.z_threshold = float(z_threshold)
        self.min_relative = float(min_relative)
        self.min_step = float(min_step)
        self.min_value = float(min_value)
        self.min_points = int(min_points)

    def describe(self) -> Dict[str, Any]:
        doc = super().describe()
        doc.update(baseline_window=self.query_window,
                   spike_window=self.spike_window,
                   z_threshold=self.z_threshold,
                   min_relative=self.min_relative,
                   min_step=self.min_step, min_value=self.min_value)
        return doc

    def _judge(self, points, now, series=None):
        cutoff = now - self.spike_window
        baseline = [v for ts, v in points if ts <= cutoff]
        if len(baseline) < self.min_points:
            return None
        value = points[-1][1]
        if value < self.min_value:
            return None
        stats = baseline_stats(baseline)
        med = stats["median"]
        step = value - med
        if step < self.min_relative * abs(med) + self.min_step:
            return None
        z = robust_zscore(value, baseline)
        if z < self.z_threshold:
            return None
        return value, med, (
            f"{self.metric} at {value:g} vs robust baseline median "
            f"{med:g} (MAD {stats['mad']:g}, z {z:g} >= "
            f"{self.z_threshold:g} over {len(baseline)} samples)"
        )


class RateOfChangeDetector(Detector):
    """Increase across a trailing lookback window.

    Fires while the newest sample sits ``min_step`` AND
    ``min_relative×`` above the oldest sample in the lookback — i.e.
    while the jump is still inside the window. Once the series
    plateaus (the step ages out), the detector goes quiet, which is
    what resolves an incident on a cumulative-sketch signal whose
    level can never return to baseline.
    """

    def __init__(self, name: str, metric: str, *,
                 labels: Optional[Dict[str, str]] = None,
                 kind: str = "anomaly", severity: str = "warning",
                 lookback: float = 60.0,
                 min_relative: float = 1.0,
                 min_step: float = 0.0,
                 min_points: int = 4):
        super().__init__(name, metric, labels=labels, kind=kind,
                         severity=severity)
        self.query_window = float(lookback)
        self.min_relative = float(min_relative)
        self.min_step = float(min_step)
        self.min_points = int(min_points)

    def describe(self) -> Dict[str, Any]:
        doc = super().describe()
        doc.update(lookback=self.query_window,
                   min_relative=self.min_relative,
                   min_step=self.min_step)
        return doc

    def _judge(self, points, now, series=None):
        if len(points) < self.min_points:
            return None
        old = points[0][1]
        value = points[-1][1]
        increase = value - old
        if increase < self.min_step:
            return None
        if old > 0 and increase < self.min_relative * abs(old):
            return None
        return value, old, (
            f"{self.metric} rose {increase:g} (from {old:g} to "
            f"{value:g}) inside the {self.query_window:g}s lookback"
        )


class ThresholdDetector(Detector):
    """Latest sample vs a fixed bound (direction ``\">\"`` or
    ``\"<\"``). A series with no sample newer than ``stale_after`` is
    skipped — a gauge nobody updates is absence of signal, not an
    anomaly."""

    def __init__(self, name: str, metric: str, *,
                 threshold: float,
                 labels: Optional[Dict[str, str]] = None,
                 direction: str = ">",
                 kind: str = "anomaly", severity: str = "warning",
                 stale_after: float = 120.0):
        if direction not in (">", "<"):
            raise ValueError(f"direction must be '>' or '<', "
                             f"got {direction!r}")
        super().__init__(name, metric, labels=labels, kind=kind,
                         severity=severity)
        self.threshold = float(threshold)
        self.direction = direction
        self.query_window = float(stale_after)

    def describe(self) -> Dict[str, Any]:
        doc = super().describe()
        doc.update(threshold=self.threshold, direction=self.direction)
        return doc

    def _judge(self, points, now, series=None):
        ts, value = points[-1]
        if now - ts > self.query_window:
            return None
        fired = (value > self.threshold if self.direction == ">"
                 else value < self.threshold)
        if not fired:
            return None
        return value, self.threshold, (
            f"{self.metric} at {value:g} {self.direction} threshold "
            f"{self.threshold:g}"
        )


class RatioDetector(Detector):
    """Windowed delta of one labeled child over the delta of ALL
    children sharing the remaining labels (error fraction of a
    requests-by-outcome counter). Fires per group — the finding's
    labels are the group labels (e.g. ``model=...``), never the
    selector's."""

    def __init__(self, name: str, metric: str, *,
                 select: Dict[str, str],
                 threshold: float,
                 window: float = 60.0,
                 min_total: float = 10.0,
                 kind: str = "errors", severity: str = "serious"):
        super().__init__(name, metric, labels=None, kind=kind,
                         severity=severity)
        self.select = dict(select)
        self.threshold = float(threshold)
        self.query_window = float(window)
        self.min_total = float(min_total)

    def describe(self) -> Dict[str, Any]:
        doc = super().describe()
        doc.update(select=dict(self.select), threshold=self.threshold,
                   window=self.query_window, min_total=self.min_total)
        return doc

    def evaluate(self, store, now):
        groups: Dict[Tuple[Tuple[str, str], ...],
                     List[float]] = {}  # key -> [selected, total]
        select_keys = set(self.select)
        for series in store.range_query(self.metric, None,
                                        self.query_window, now=now):
            labels = dict(series["labels"])
            group = tuple(sorted(
                (k, str(v)) for k, v in labels.items()
                if k not in select_keys
            ))
            # birth-aware: the first error of a storm usually MINTS the
            # outcome="error" child between two samples — its first
            # sampled value must count as increase or the detector is
            # blind to exactly the burst it watches for
            inc = tsdb_mod.windowed_increase(
                series, now - self.query_window)
            bucket = groups.setdefault(group, [0.0, 0.0])
            if all(str(labels.get(k)) == str(v)
                   for k, v in self.select.items()):
                bucket[0] += inc
            bucket[1] += inc
        findings: List[Finding] = []
        for group, (selected, total) in sorted(groups.items()):
            if total < self.min_total:
                continue
            ratio = selected / total
            if ratio <= self.threshold:
                continue
            sel = ",".join(f"{k}={v}" for k, v in self.select.items())
            findings.append(Finding(
                detector=self.name, kind=self.kind,
                severity=self.severity, metric=self.metric,
                labels=dict(group), value=ratio,
                baseline=self.threshold,
                reason=(
                    f"{sel} fraction of {self.metric} is "
                    f"{ratio:.1%} ({selected:g}/{total:g}) over "
                    f"{self.query_window:g}s, above "
                    f"{self.threshold:.1%}"
                ),
            ))
        return findings

    def _judge(self, points, now, series=None):  # pragma: no cover - unused
        raise NotImplementedError("RatioDetector overrides evaluate")


class DeltaDetector(Detector):
    """Reset-aware counter increase over a window ≥ ``min_delta``
    (breaker-flap counting)."""

    def __init__(self, name: str, metric: str, *,
                 min_delta: float,
                 labels: Optional[Dict[str, str]] = None,
                 window: float = 300.0,
                 kind: str = "breaker", severity: str = "serious"):
        super().__init__(name, metric, labels=labels, kind=kind,
                         severity=severity)
        self.min_delta = float(min_delta)
        self.query_window = float(window)

    def describe(self) -> Dict[str, Any]:
        doc = super().describe()
        doc.update(min_delta=self.min_delta, window=self.query_window)
        return doc

    def _judge(self, points, now, series=None):
        # birth-aware like RatioDetector: the first breaker open mints
        # the state="open" child — its first sampled value is a real
        # transition, not ring history that aged out
        delta = (tsdb_mod.windowed_increase(series,
                                            now - self.query_window)
                 if series is not None
                 else tsdb_mod.counter_increase(points))
        if delta < self.min_delta:
            return None
        return delta, self.min_delta, (
            f"{self.metric} increased {delta:g} times in "
            f"{self.query_window:g}s (flap threshold "
            f"{self.min_delta:g})"
        )


def builtin_detectors(
        short_window: Optional[float] = None) -> List[Detector]:
    """The shipped catalog over the serving tier's key series.

    ``short_window`` (default ``SPARK_RAPIDS_ML_TORCH_OBS_INCIDENT_
    WINDOW_S``, 60 s) scales the fast horizons — spike windows,
    p99 lookback, the error-rate window — so drills can compress the
    whole loop; baselines stay at the TSDB's 5-minute tier.
    """
    w = float(short_window if short_window is not None
              else short_window_seconds())
    return [
        # p99 rides the cumulative latency sketch: watch for jumps,
        # resolve on plateau (the level itself can never come back).
        RateOfChangeDetector(
            "serve_p99_spike",
            "sparkml_serve_request_latency_seconds",
            labels={"quantile": "0.99"},
            kind="latency", severity="serious",
            lookback=w, min_relative=1.0, min_step=0.02,
        ),
        MadSpikeDetector(
            "serve_queue_depth",
            "sparkml_serve_queue_depth",
            kind="saturation", severity="warning",
            baseline_window=max(5 * w, 300.0), spike_window=w / 4.0,
            z_threshold=4.0, min_relative=0.5, min_step=4.0,
            min_value=8.0,
        ),
        RatioDetector(
            "serve_error_rate",
            "sparkml_serve_requests_total",
            select={"outcome": "error"},
            threshold=0.05, window=w, min_total=10.0,
            kind="errors", severity="serious",
        ),
        MadSpikeDetector(
            "device_mem_in_use",
            "sparkml_device_mem_bytes_in_use",
            kind="memory", severity="warning",
            baseline_window=max(5 * w, 300.0), spike_window=w / 4.0,
            z_threshold=4.0, min_relative=0.25,
            min_step=16 * 1024 * 1024, min_value=64 * 1024 * 1024,
        ),
        DeltaDetector(
            "breaker_flap",
            "sparkml_serve_breaker_transitions_total",
            labels={"state": "open"},
            min_delta=3.0, window=max(6 * w, 120.0),
            kind="breaker", severity="serious",
        ),
        # page_fast factor from the SRE-workbook ladder; the gauge is
        # republished every sweep by the engine's sampler collector.
        ThresholdDetector(
            "slo_fast_burn",
            "sparkml_slo_burn_rate",
            labels={"window": "5m"},
            threshold=14.4, direction=">",
            kind="slo", severity="critical",
            stale_after=max(2 * w, 120.0),
        ),
        # The replica tier (placement, not ported yet): 0 serving, 1 draining,
        # 2 dead — any replica above 0 means a device left the
        # placement set and its traffic is shedding onto siblings. The
        # incident auto-resolves when the half-open probe re-enters the
        # replica (the gauge drops back to 0).
        ThresholdDetector(
            "serve_replica_degraded",
            "sparkml_serve_replica_state",
            threshold=0.5, direction=">",
            kind="replica", severity="serious",
            stale_after=max(2 * w, 120.0),
        ),
        # The rollout tier (not ported yet): the canary controller
        # raises this gauge to 1 when an experiment auto-rolls back —
        # the series labels {model, candidate} NAME the regressed
        # candidate version, so the incident (and its evidence bundle)
        # carries exactly which version burned the canary. The
        # controller clears the gauge after ROLLOUT_REGRESSED_HOLD_S,
        # which is what lets the incident auto-resolve.
        ThresholdDetector(
            "serve_canary_regressed",
            "sparkml_serve_canary_regressed",
            threshold=0.5, direction=">",
            kind="rollout", severity="critical",
            stale_after=max(2 * w, 120.0),
        ),
        # The fit-path backend watchdog (obs.fitmon): the
        # gauge drops to 0 when the resolved platform silently differs
        # from the configured expectation or the canary dispatch wedges —
        # a fit that fell back to the CPU and nobody noticed. The
        # unlabeled gauge is a single series, so the dedup key yields
        # exactly ONE incident, auto-resolving when the watchdog's next
        # check publishes 1 again.
        ThresholdDetector(
            "fit_backend_degraded",
            "sparkml_fit_backend_ok",
            threshold=0.5, direction="<",
            kind="backend", severity="critical",
            stale_after=max(2 * w, 120.0),
        ),
        # Fleet federation (not ported yet): the aggregator holds
        # sparkml_fleet_host_up{host} at 1 while a peer's export
        # endpoint answers within the staleness grace and drops it to 0
        # when the peer goes silent. Per-host labels make the dedup key
        # per-host, so a dead peer is exactly ONE incident that
        # auto-resolves when the (respawned) peer answers again under
        # the SAME fleet host identity.
        ThresholdDetector(
            "fleet_host_down",
            "sparkml_fleet_host_up",
            threshold=0.5, direction="<",
            kind="fleet", severity="critical",
            stale_after=max(2 * w, 120.0),
        ),
    ]


__all__ = [
    "DeltaDetector",
    "Detector",
    "Finding",
    "MadSpikeDetector",
    "RateOfChangeDetector",
    "RatioDetector",
    "SEVERITIES",
    "ThresholdDetector",
    "WINDOW_ENV",
    "builtin_detectors",
    "short_window_seconds",
]
