"""SLO objectives and multi-window burn-rate alerting for the serving tier.

The port's copy of the JAX package's ``obs/slo.py``, clock for clock, so
the same injected clock and request stream give the same burn rates in
both packages.

The metrics registry answers "what is the p99 right now"; this module
answers the operator question on top of it: *is the service meeting its
objective, and should anyone be paged?* — the Google SRE workbook's
multi-window multi-burn-rate method, applied to the serve/ request stream:

* ``SLO`` — one declarative objective: **availability** (fraction of
  requests that succeed) or **latency** (fraction of requests faster than
  a threshold), with a target like 99.9% over a rolling budget window.
  Every served request is ``record()``-ed good/bad; counts land in a
  time-bucketed ring (``WindowedCounts``) so any trailing window's error
  rate is O(buckets) to read and memory stays bounded.
* **burn rate** — error-rate ÷ error-budget for a trailing window: burn 1
  means exactly spending the budget, burn 14.4 means the 30-day budget is
  gone in 2 days. Alert policies pair a long window (is it sustained?)
  with a short one (is it still happening?), both of which must exceed
  the factor to fire:

  - ``page_fast``: 5 m AND 1 h above **14.4**;
  - ``page_slow``: 30 m AND 6 h above **6.0**.

  A short latency spike therefore flips ``page_fast`` while the 6 h
  window stays quiet, and a recovered outage stops paging as soon as the
  short window clears — exactly the workbook semantics.
* ``SloSet`` — the engine-facing bundle: ``record_request(ok, latency)``
  feeds every objective, ``snapshot()`` is the document
  ``ServeEngine.slo_snapshot`` returns, ``publish()`` mirrors burn rates /
  budget remaining / firing alerts into the metrics registry
  (``sparkml_slo_*`` gauges) so the Prometheus surface carries the
  verdict too.

Wall-clock is injectable everywhere (``clock=``): tests drive hours of
traffic through a fake clock with zero real sleeps. ``ServeEngine`` wires
``default_slos()`` in by default; knobs:

* ``SPARK_RAPIDS_ML_TORCH_SLO_AVAILABILITY_TARGET`` (default ``0.999``;
  ``0`` disables the availability objective);
* ``SPARK_RAPIDS_ML_TORCH_SLO_LATENCY_TARGET`` (default ``0.99``; ``0``
  disables the latency objective);
* ``SPARK_RAPIDS_ML_TORCH_SLO_LATENCY_THRESHOLD_MS`` (default ``250``);
* ``SPARK_RAPIDS_ML_TORCH_SLO_WINDOW_HOURS`` — the budget-remaining window
  (default ``6``, the longest alert window).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

ENV_PREFIX = "SPARK_RAPIDS_ML_TORCH_SLO_"

# The SRE-workbook two-policy ladder. Both windows of a policy must burn
# above the factor: the long window proves it is sustained, the short one
# proves it is still happening (so recovered incidents stop paging).
BURN_POLICIES: Tuple[Dict[str, Any], ...] = (
    {"severity": "page_fast", "factor": 14.4,
     "short_seconds": 300.0, "long_seconds": 3600.0},
    {"severity": "page_slow", "factor": 6.0,
     "short_seconds": 1800.0, "long_seconds": 21600.0},
)

_WINDOW_LABELS = {300.0: "5m", 1800.0: "30m", 3600.0: "1h", 21600.0: "6h"}


def _window_label(seconds: float) -> str:
    label = _WINDOW_LABELS.get(float(seconds))
    if label:
        return label
    if seconds % 3600 == 0:
        return f"{int(seconds // 3600)}h"
    if seconds % 60 == 0:
        return f"{int(seconds // 60)}m"
    return f"{int(seconds)}s"


class WindowedCounts:
    """Good/total event counts in fixed time buckets over a bounded
    horizon — any trailing window's counts in O(window/bucket) with
    O(horizon/bucket) memory, regardless of traffic volume."""

    def __init__(
        self,
        horizon_seconds: float = 6 * 3600.0 + 1800.0,
        bucket_seconds: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if bucket_seconds <= 0:
            raise ValueError("bucket_seconds must be > 0")
        self.bucket_seconds = float(bucket_seconds)
        self.horizon_seconds = float(horizon_seconds)
        self.clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[int, List[float]] = {}  # idx -> [good, total]

    def _prune(self, now: float) -> None:
        cap = int(self.horizon_seconds / self.bucket_seconds) + 2
        if len(self._buckets) <= cap:
            return
        floor = int((now - self.horizon_seconds) // self.bucket_seconds)
        self._buckets = {
            idx: counts for idx, counts in self._buckets.items()
            if idx >= floor
        }

    def record(self, good: bool, n: int = 1,
               now: Optional[float] = None) -> None:
        now = self.clock() if now is None else now
        idx = int(now // self.bucket_seconds)
        with self._lock:
            bucket = self._buckets.get(idx)
            if bucket is None:
                bucket = [0.0, 0.0]
                self._buckets[idx] = bucket
                self._prune(now)
            if good:
                bucket[0] += n
            bucket[1] += n

    def counts(self, window_seconds: float,
               now: Optional[float] = None) -> Tuple[float, float]:
        """(good, total) over the trailing window ending at ``now``.

        The boundary bucket is INCLUDED (the effective window rounds up
        to a whole bucket) — for alerting, slightly over-counting old
        badness is the conservative direction."""
        now = self.clock() if now is None else now
        floor = int((now - window_seconds) // self.bucket_seconds)
        ceil = int(now // self.bucket_seconds)
        good = total = 0.0
        with self._lock:
            for idx, (g, t) in self._buckets.items():
                if floor <= idx <= ceil:
                    good += g
                    total += t
        return good, total


class SLO:
    """One declarative objective over the serving request stream."""

    def __init__(
        self,
        name: str,
        target: float = 0.999,
        kind: str = "availability",
        latency_threshold_seconds: Optional[float] = None,
        window_seconds: float = 6 * 3600.0,
        bucket_seconds: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
        policies: Sequence[Dict[str, Any]] = BURN_POLICIES,
    ):
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        if kind not in ("availability", "latency"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if kind == "latency" and not latency_threshold_seconds:
            raise ValueError("latency SLO needs latency_threshold_seconds")
        self.name = name
        self.target = float(target)
        self.kind = kind
        self.latency_threshold_seconds = (
            float(latency_threshold_seconds)
            if latency_threshold_seconds else None
        )
        self.window_seconds = float(window_seconds)
        self.clock = clock
        self.policies = tuple(dict(p) for p in policies)
        horizon = max(
            [self.window_seconds]
            + [p["long_seconds"] for p in self.policies]
        ) + 2 * bucket_seconds
        self._counts = WindowedCounts(
            horizon_seconds=horizon, bucket_seconds=bucket_seconds,
            clock=clock,
        )

    @property
    def error_budget(self) -> float:
        return 1.0 - self.target

    def is_good(self, ok: bool,
                latency_seconds: Optional[float] = None) -> bool:
        if not ok:
            return False
        if self.kind == "latency":
            return (latency_seconds is not None
                    and latency_seconds <= self.latency_threshold_seconds)
        return True

    def record(self, ok: bool, latency_seconds: Optional[float] = None,
               n: int = 1, now: Optional[float] = None) -> None:
        self._counts.record(self.is_good(ok, latency_seconds), n=n, now=now)

    def _rate(self, good: float, total: float) -> float:
        """Error-rate ÷ error budget from window counts (0.0 with no
        traffic: an idle service burns nothing). THE burn arithmetic —
        ``burn_rate`` and ``SloSet.fast_burn_rate`` both go through it,
        so the breaker trip signal can never diverge from alerting."""
        if total <= 0:
            return 0.0
        return ((total - good) / total) / self.error_budget

    def burn_rate(self, window_seconds: float,
                  now: Optional[float] = None) -> float:
        """Error-rate over the window ÷ error budget."""
        good, total = self._counts.counts(window_seconds, now=now)
        return self._rate(good, total)

    def burn_rates(self, now: Optional[float] = None
                   ) -> Dict[str, float]:
        windows = sorted({
            w for p in self.policies
            for w in (p["short_seconds"], p["long_seconds"])
        })
        return {
            _window_label(w): self.burn_rate(w, now=now) for w in windows
        }

    def budget_remaining(self, now: Optional[float] = None) -> float:
        """Fraction of the error budget left over ``window_seconds``
        (1.0 = untouched, 0.0 = spent, negative = blown)."""
        return 1.0 - self.burn_rate(self.window_seconds, now=now)

    def firing(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Alert dicts for every policy whose BOTH windows burn above its
        factor — multi-window AND semantics."""
        now = self.clock() if now is None else now
        alerts = []
        for policy in self.policies:
            short = self.burn_rate(policy["short_seconds"], now=now)
            long_ = self.burn_rate(policy["long_seconds"], now=now)
            if short > policy["factor"] and long_ > policy["factor"]:
                alerts.append({
                    "slo": self.name,
                    "severity": policy["severity"],
                    "factor": policy["factor"],
                    "short_window": _window_label(policy["short_seconds"]),
                    "short_burn_rate": short,
                    "long_window": _window_label(policy["long_seconds"]),
                    "long_burn_rate": long_,
                })
        return alerts

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = self.clock() if now is None else now
        good, total = self._counts.counts(self.window_seconds, now=now)
        objective = (
            f"{self.target:.6g} of requests succeed"
            if self.kind == "availability" else
            f"{self.target:.6g} of requests faster than "
            f"{self.latency_threshold_seconds * 1000:g} ms"
        )
        return {
            "name": self.name,
            "kind": self.kind,
            "target": self.target,
            "objective": objective,
            "latency_threshold_seconds": self.latency_threshold_seconds,
            "window": _window_label(self.window_seconds),
            "window_good": good,
            "window_total": total,
            "burn_rates": self.burn_rates(now=now),
            "budget_remaining": self.budget_remaining(now=now),
            "alerts": self.firing(now=now),
        }


class SloSet:
    """The engine-facing bundle of objectives sharing one request feed."""

    def __init__(self, slos: Sequence[SLO] = (),
                 clock: Callable[[], float] = time.monotonic):
        self.slos: List[SLO] = list(slos)
        self.clock = clock

    def __iter__(self):
        return iter(self.slos)

    def __len__(self):
        return len(self.slos)

    def get(self, name: str) -> Optional[SLO]:
        for slo in self.slos:
            if slo.name == name:
                return slo
        return None

    def record_request(self, ok: bool,
                       latency_seconds: Optional[float] = None,
                       n: int = 1, now: Optional[float] = None) -> None:
        for slo in self.slos:
            slo.record(ok, latency_seconds, n=n, now=now)

    def firing(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        alerts: List[Dict[str, Any]] = []
        for slo in self.slos:
            alerts.extend(slo.firing(now=now))
        return alerts

    def fast_burn_rate(self, window_seconds: float = 300.0,
                       min_total: float = 20.0,
                       now: Optional[float] = None) -> float:
        """The worst short-window burn rate across the set — the
        serving tier's circuit-breaker trip signal.

        ``min_total`` guards the low-traffic pathology: with 2 requests
        in the window, one failure reads as burn 500 and a naive trip
        wire would open the breaker on a single blip. Below the floor
        this reports 0.0 (the consecutive-failure threshold still
        protects low-traffic models)."""
        worst = 0.0
        for slo in self.slos:
            t = slo.clock() if now is None else now
            good, total = slo._counts.counts(window_seconds, now=t)
            if total < min_total:
                continue
            # one window scan per SLO (this runs on the failure path,
            # during exactly the bursts it exists for); the arithmetic
            # is burn_rate's own, shared via _rate
            worst = max(worst, slo._rate(good, total))
        return worst

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = self.clock() if now is None else now
        slos = [slo.snapshot(now=now) for slo in self.slos]
        return {
            "slos": slos,
            "alerts": [a for s in slos for a in s["alerts"]],
        }

    def publish(self, registry=None,
                now: Optional[float] = None) -> Dict[str, Any]:
        """Evaluate AND mirror the verdict into the metrics registry, so
        ``/metrics`` scrapes carry burn rates, budget remaining, and
        firing alerts as ``sparkml_slo_*`` gauges. Returns the snapshot."""
        if registry is None:
            from spark_rapids_ml_tpu_torch.obs.metrics import get_registry

            registry = get_registry()
        snap = self.snapshot(now=now)
        burn = registry.gauge(
            "sparkml_slo_burn_rate",
            "SLO error-budget burn rate per trailing window "
            "(1.0 = spending exactly the budget)", ("slo", "window"),
        )
        budget = registry.gauge(
            "sparkml_slo_budget_remaining",
            "fraction of the SLO error budget remaining over the budget "
            "window (1 untouched, 0 spent, negative blown)", ("slo",),
        )
        alert = registry.gauge(
            "sparkml_slo_alert_firing",
            "1 when the multi-window burn-rate alert fires", ("slo",
                                                              "severity"),
        )
        for slo_snap in snap["slos"]:
            name = slo_snap["name"]
            for window, rate in slo_snap["burn_rates"].items():
                burn.set(rate, slo=name, window=window)
            budget.set(slo_snap["budget_remaining"], slo=name)
            firing = {a["severity"] for a in slo_snap["alerts"]}
            for policy in BURN_POLICIES:
                alert.set(
                    1.0 if policy["severity"] in firing else 0.0,
                    slo=name, severity=policy["severity"],
                )
        return snap


def severity_for_burn(burn_rate: float) -> Optional[str]:
    """Incident severity implied by a short-window burn rate, on the
    same SRE-workbook ladder the alert policies page with: the
    page_fast factor (14.4) is critical, page_slow (6.0) serious, any
    budget overspend (>= 1.0) a warning, and an idle/healthy service
    (None) implies nothing. ``obs.incidents`` escalates every opening
    incident through this, so "severity" means the same thing on a
    page and on an incident record."""
    if burn_rate >= BURN_POLICIES[0]["factor"]:
        return "critical"
    if burn_rate >= BURN_POLICIES[1]["factor"]:
        return "serious"
    if burn_rate >= 1.0:
        return "warning"
    return None


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(ENV_PREFIX + name, default))
    except ValueError:
        return default


def default_slos(clock: Callable[[], float] = time.monotonic) -> SloSet:
    """The serving tier's default objectives from ``SPARK_RAPIDS_ML_TORCH_
    SLO_*`` env knobs (a target of 0 disables that objective)."""
    window_seconds = _env_float("WINDOW_HOURS", 6.0) * 3600.0
    slos: List[SLO] = []
    availability_target = _env_float("AVAILABILITY_TARGET", 0.999)
    if 0.0 < availability_target < 1.0:
        slos.append(SLO(
            "serve_availability", target=availability_target,
            kind="availability", window_seconds=window_seconds, clock=clock,
        ))
    latency_target = _env_float("LATENCY_TARGET", 0.99)
    threshold_ms = _env_float("LATENCY_THRESHOLD_MS", 250.0)
    if 0.0 < latency_target < 1.0 and threshold_ms > 0:
        slos.append(SLO(
            "serve_latency", target=latency_target, kind="latency",
            latency_threshold_seconds=threshold_ms / 1000.0,
            window_seconds=window_seconds, clock=clock,
        ))
    return SloSet(slos, clock=clock)


__all__ = [
    "BURN_POLICIES",
    "ENV_PREFIX",
    "SLO",
    "SloSet",
    "WindowedCounts",
    "default_slos",
    "severity_for_burn",
]
