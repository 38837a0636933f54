"""Multi-tenant admission control and SLO-burn-adaptive load shedding.

The port's copy of the JAX package's ``serve/admission.py``, decision for
decision: the same clock and request stream give the same verdicts,
levels and counters in both packages. The layer between the HTTP front
end and the per-model micro-batchers that decides, per request, *whether
the service should even try*. Every request carries a **tenant id** and a
**priority class** (``interactive`` vs ``batch`` — header/payload with env
defaults); the controller:

* runs the tenant through its **token-bucket quota** (rows/sec rate +
  burst, ``SPARK_RAPIDS_ML_TORCH_SERVE_TENANT_*`` or constructor config).
  Exceeding the quota does NOT reject by itself — the request is tagged
  ``over_quota``, which demotes its weighted-fair share
  (``serve.scheduler``) and puts it first in line for shedding;
* consults the **shed controller**: a small hysteresis state machine
  over the live overload signals the engine already computes — the SLO
  fast-burn rate (``obs.slo.SloSet.fast_burn_rate``), the batchers'
  queue-wait estimate, and queue-depth fraction. Under pressure it
  escalates through shed levels instead of the old fixed
  ``max_queue_depth`` cliff:

  - **level 0** — admit everything;
  - **level 1** (queue pressure) — shed *over-quota batch* work;
  - **level 2** (queue pressure AND fast SLO burn) — shed *all
    over-quota* work, interactive included.

  **In-quota traffic is never shed by the controller** (any priority):
  quotas are the provisioned capacity, so shedding only the over-quota
  excess keeps the engine work-conserving — during a 2× overload soak
  total throughput stays near single-tenant capacity while the greedy
  tenant's excess absorbs all the shedding. That is the fairness
  contract. (The bounded queue's ``QueueFull``
  remains the last-resort backstop for everyone.)

* serves a **pre-parse fast path** (``fast_shed``): at any shed level,
  a batch-priority request from a tenant whose bucket is already dry is
  rejected from its HEADERS alone — before the server pays the JSON
  body parse. Under a reject storm the cost of saying no is what
  determines whether saying no helps; the fast path makes a shed
  cheaper than a serve, so shedding actually frees capacity instead of
  re-spending it on rejections.

A shed is an **orderly rejection**, not a backend failure: ``ShedLoad``
is never retried, never feeds the circuit breaker (overload must
not read as device failure), maps to HTTP 503 with a
``Retry-After`` derived from the live queue-wait estimate, and every
decision is **attributable**. Sheds DO burn the SLO availability budget
(the established overload stance: a 503 is user-visible unavailability,
exactly like ``QueueFull``/``DeadlineExpired`` — the budget is honest
even when the rejection is policy). A deliberate consequence: once
level 1 is shedding a meaningful fraction of traffic, the shed-driven
fast burn plus sustained pressure escalates to level 2 — under
*sustained* overload the controller converges on shedding ALL
over-quota excess, which is the intended end state; the level
distinction matters at the onset, and de-escalation is governed by
pressure clearing, not by the (5-minute-window) burn decaying: counted in
``sparkml_serve_admission_total{tenant,decision}`` /
``sparkml_serve_shed_total{tenant,reason}`` and filed as a
``serve:admission`` audit span into the request's trace tree: every
decision path here counts, and sheds and over-quota tags file a span.

Tenant-label cardinality is bounded: at most ``TENANT_MAX`` (default 64)
distinct tenant ids are tracked; beyond that, new ids collapse into the
``(overflow)`` tenant for both quota and metrics (a scanner spraying
random tenant headers cannot mint unbounded metric children or
scheduler flows).

Env knobs (``SPARK_RAPIDS_ML_TORCH_SERVE_`` prefix, constructor args win;
the names and defaults are the JAX package's):

* ``..._TENANT_DEFAULT``   (default ``default``) — tenant id for
  requests that carry none;
* ``..._TENANT_RATE``      (default 0 = unlimited) — default quota,
  rows/sec, for tenants without an explicit entry;
* ``..._TENANT_BURST``     (default 4× rate) — default bucket depth;
* ``..._TENANT_QUOTAS``    — per-tenant overrides,
  ``"name:rate[:burst],name2:rate"`` (rate 0 = unlimited);
* ``..._TENANT_WEIGHTS``   — fair-share weights, ``"name:4,name2:1"``;
* ``..._TENANT_MAX``       (default 64) — distinct tenants tracked;
* ``..._PRIORITY_DEFAULT`` (default ``interactive``);
* ``..._SHED``             (default 1; 0 disables adaptive shedding);
* ``..._SHED_BURN``       (default 14.4) — fast-burn rate that arms
  level 2 (the SRE-workbook page_fast factor);
* ``..._SHED_QUEUE_WAIT_MS`` (default 250) — queue-wait estimate that
  counts as pressure;
* ``..._SHED_DEPTH_FRAC``  (default 0.5) — queue-depth fraction that
  counts as pressure;
* ``..._SHED_HOLD_MS``     (default 2000) — how long signals must stay
  healthy before the controller de-escalates (hysteresis);
* ``..._SHED_RETRY_AFTER_MAX_S`` (default 30) — Retry-After clamp.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from spark_rapids_ml_tpu_torch.obs import spans as spans_mod
from spark_rapids_ml_tpu_torch.obs import tracectx
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry

ENV_PREFIX = "SPARK_RAPIDS_ML_TORCH_SERVE_"

INTERACTIVE = "interactive"
BATCH = "batch"
PRIORITIES = (INTERACTIVE, BATCH)

OVERFLOW_TENANT = "(overflow)"


class ShedLoad(RuntimeError):
    """The adaptive load-shedding controller rejected this request —
    an orderly overload rejection, NOT a backend failure: never retried,
    never breaker food (overload must not read as device failure),
    distinct ``error="load_shed"`` label in
    ``sparkml_serve_errors_total``. ``retry_after`` (seconds) is derived
    from the live queue-wait estimate and becomes the HTTP
    ``Retry-After`` header."""

    def __init__(self, message: str, retry_after: float = 1.0,
                 reason: str = "shed", tenant: str = "default"):
        super().__init__(message)
        self.retry_after = float(retry_after)
        self.reason = reason
        self.tenant = tenant


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(ENV_PREFIX + name, default))
    except ValueError:
        return default


def retry_after_cap() -> float:
    """The operator's ``Retry-After`` clamp (seconds) — every overload
    rejection path shares it, so a preemption 503 can never advise a
    longer backoff than an admission 503 from the same server."""
    return max(_env_float("SHED_RETRY_AFTER_MAX_S", 30.0), 1.0)


def _env_str(name: str, default: str) -> str:
    return os.environ.get(ENV_PREFIX + name, default).strip() or default


def parse_tenant_quotas(raw: str) -> Dict[str, Tuple[float, float]]:
    """``"a:1000:2000,b:50"`` → ``{"a": (1000.0, 2000.0),
    "b": (50.0, 200.0)}`` (burst defaults to 4× rate). Malformed entries
    are skipped — a typo must never arm a quota the operator did not
    ask for."""
    out: Dict[str, Tuple[float, float]] = {}
    for entry in raw.replace(";", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2 or not parts[0]:
            continue
        try:
            rate = float(parts[1])
            burst = float(parts[2]) if len(parts) > 2 else 4.0 * rate
        except ValueError:
            continue
        out[parts[0]] = (rate, burst)
    return out


def parse_tenant_weights(raw: str) -> Dict[str, float]:
    """``"a:4,b:1"`` → ``{"a": 4.0, "b": 1.0}``; malformed entries
    skipped."""
    out: Dict[str, float] = {}
    for entry in raw.replace(";", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) != 2 or not parts[0]:
            continue
        try:
            weight = float(parts[1])
        except ValueError:
            continue
        if weight > 0:
            out[parts[0]] = weight
    return out


class TokenBucket:
    """A rows/sec token bucket with an injectable clock.

    ``take(n)`` consumes ``n`` tokens and returns True when the tenant
    is within quota; when the bucket cannot cover ``n`` it consumes
    NOTHING and returns False — the request still runs (tagged
    over-quota), so a misbehaving tenant cannot drive its own bucket
    into unbounded debt and then starve itself forever once it behaves
    again."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else 4.0 * rate)
        if self.burst <= 0:
            self.burst = max(self.rate, 1.0)
        self.clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = threading.Lock()

    @property
    def unlimited(self) -> bool:
        return self.rate <= 0

    def _refill(self, now: float) -> None:
        elapsed = max(now - self._last, 0.0)
        self._last = now
        self._tokens = min(self.burst, self._tokens + elapsed * self.rate)

    def take(self, n: float) -> bool:
        if self.unlimited:
            return True
        with self._lock:
            self._refill(self.clock())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def tokens(self) -> float:
        if self.unlimited:
            return float("inf")
        with self._lock:
            self._refill(self.clock())
            return self._tokens


class ShedController:
    """Hysteresis state machine over the live overload signals.

    ``note_signals(burn, queue_wait_s, depth_frac)`` feeds it (the
    engine refreshes through ``maybe_refresh`` at a bounded cadence so
    the hot path never pays a full SLO window scan per request);
    ``level()`` is the current shed level, escalated immediately under
    pressure and de-escalated only after ``hold_seconds`` of healthy
    signals — flapping load cannot flap the policy."""

    def __init__(
        self,
        *,
        enabled: Optional[bool] = None,
        burn_threshold: Optional[float] = None,
        queue_wait_target_s: Optional[float] = None,
        depth_frac_target: Optional[float] = None,
        hold_seconds: Optional[float] = None,
        refresh_seconds: float = 0.25,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.enabled = bool(
            enabled if enabled is not None
            else _env_float("SHED", 1.0) > 0)
        self.burn_threshold = float(
            burn_threshold if burn_threshold is not None
            else _env_float("SHED_BURN", 14.4))
        self.queue_wait_target_s = float(
            queue_wait_target_s if queue_wait_target_s is not None
            else _env_float("SHED_QUEUE_WAIT_MS", 250.0) / 1000.0)
        self.depth_frac_target = float(
            depth_frac_target if depth_frac_target is not None
            else _env_float("SHED_DEPTH_FRAC", 0.5))
        self.hold_seconds = float(
            hold_seconds if hold_seconds is not None
            else _env_float("SHED_HOLD_MS", 2000.0) / 1000.0)
        self.refresh_seconds = float(refresh_seconds)
        self.clock = clock
        self._lock = threading.Lock()
        self._level = 0
        self._healthy_since: Optional[float] = None
        self._last_refresh: Optional[float] = None
        self._signals = {"burn": 0.0, "queue_wait_s": 0.0,
                         "depth_frac": 0.0}
        self._m_level = get_registry().gauge(
            "sparkml_serve_shed_level",
            "adaptive load-shedding level (0 = admit all, 1 = shed "
            "over-quota batch, 2 = shed ALL over-quota work; in-quota "
            "traffic is never controller-shed)",
        )
        self._m_level.set(0)

    def maybe_refresh(self, signals_fn: Callable[[], Dict[str, float]]
                      ) -> None:
        """Refresh the signals through ``signals_fn`` at most once per
        ``refresh_seconds`` — the hot path amortizes the SLO window
        scans instead of paying them per request."""
        if not self.enabled:
            return
        now = self.clock()
        with self._lock:
            if (self._last_refresh is not None
                    and now - self._last_refresh < self.refresh_seconds):
                return
            self._last_refresh = now
        try:
            signals = signals_fn()
        except Exception:
            get_registry().counter(
                "sparkml_serve_errors_total",
                "serving errors by type: batch failures (exception "
                "class), worker crashes/wedges, breaker rejections",
                ("model", "error"),
            ).inc(model="(engine)", error="shed_signals")
            return
        self.note_signals(
            burn=float(signals.get("burn", 0.0)),
            queue_wait_s=float(signals.get("queue_wait_s", 0.0)),
            depth_frac=float(signals.get("depth_frac", 0.0)),
            now=now,
        )

    def note_signals(self, *, burn: float, queue_wait_s: float,
                     depth_frac: float,
                     now: Optional[float] = None) -> int:
        """Feed one signal sample; returns the (possibly new) level.
        Escalation is immediate; de-escalation waits ``hold_seconds``
        of target-below-current so one healthy sample in the middle of
        an overload cannot drop the shield."""
        now = self.clock() if now is None else now
        pressure = (queue_wait_s > self.queue_wait_target_s
                    or depth_frac >= self.depth_frac_target)
        burning = (self.burn_threshold > 0
                   and burn >= self.burn_threshold)
        target = 0
        if pressure:
            target = 2 if burning else 1
        with self._lock:
            self._signals = {"burn": burn, "queue_wait_s": queue_wait_s,
                             "depth_frac": depth_frac}
            if target >= self._level:
                if target > self._level:
                    self._level = target
                self._healthy_since = None
            else:
                if self._healthy_since is None:
                    self._healthy_since = now
                elif now - self._healthy_since >= self.hold_seconds:
                    self._level = target
                    self._healthy_since = None if target == 0 else now
            # set UNCONDITIONALLY, not just on transitions: another
            # controller's constructor (a side engine, a test) zeroes
            # the shared gauge, and a steady level would otherwise
            # never repair it — every refresh re-asserts the truth
            self._m_level.set(self._level)
            return self._level

    def level(self) -> int:
        if not self.enabled:
            return 0
        with self._lock:
            return self._level

    def shedding(self) -> bool:
        return self.level() > 0

    def pressure(self) -> bool:
        """Raw pressure (the scheduler's interactive-preemption flag):
        true while the controller is at any shed level."""
        return self.level() > 0

    def decide(self, priority: str, over_quota: bool) -> Optional[str]:
        """The shed verdict for one request: a reason string (shed) or
        None (admit). In-quota traffic is NEVER shed (work
        conservation: quotas are the provisioned capacity — the
        controller sheds only the excess)."""
        if not over_quota:
            return None
        level = self.level()
        if level >= 2:
            return "over_quota"
        if level >= 1 and priority == BATCH:
            return "over_quota_batch"
        return None

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled,
                "level": self._level if self.enabled else 0,
                "shedding": self.enabled and self._level > 0,
                "signals": dict(self._signals),
                "thresholds": {
                    "burn": self.burn_threshold,
                    "queue_wait_s": self.queue_wait_target_s,
                    "depth_frac": self.depth_frac_target,
                    "hold_s": self.hold_seconds,
                },
            }


class AdmissionDecision:
    """One admitted request's admission metadata — what the engine
    threads into the batcher queue for the fair scheduler."""

    __slots__ = ("tenant", "priority", "over_quota", "decision")

    def __init__(self, tenant: str, priority: str, over_quota: bool,
                 decision: str):
        self.tenant = tenant
        self.priority = priority
        self.over_quota = over_quota
        self.decision = decision


class AdmissionController:
    """Tenant resolution + token-bucket quotas + the shed gate.

    ``admit`` either returns an ``AdmissionDecision`` or raises
    ``ShedLoad`` — and in BOTH cases increments
    ``sparkml_serve_admission_total{tenant,decision}`` and (for sheds
    and over-quota tags) files a ``serve:admission`` audit span into the
    active request trace, so every decision at this boundary is
    attributable per request."""

    def __init__(
        self,
        *,
        tenant_quotas: Optional[Dict[str, Any]] = None,
        tenant_weights: Optional[Dict[str, float]] = None,
        default_rate: Optional[float] = None,
        default_burst: Optional[float] = None,
        default_tenant: Optional[str] = None,
        default_priority: Optional[str] = None,
        max_tenants: Optional[int] = None,
        shed: Optional[ShedController] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.clock = clock
        self.default_tenant = (default_tenant
                               or _env_str("TENANT_DEFAULT", "default"))
        default_priority = (default_priority
                            or _env_str("PRIORITY_DEFAULT", INTERACTIVE))
        self.default_priority = (default_priority
                                 if default_priority in PRIORITIES
                                 else INTERACTIVE)
        self.default_rate = float(
            default_rate if default_rate is not None
            else _env_float("TENANT_RATE", 0.0))
        self.default_burst = (
            float(default_burst) if default_burst is not None
            else (_env_float("TENANT_BURST", 0.0) or None))
        self.max_tenants = int(
            max_tenants if max_tenants is not None
            else _env_float("TENANT_MAX", 64))
        quotas: Dict[str, Tuple[float, float]] = parse_tenant_quotas(
            os.environ.get(ENV_PREFIX + "TENANT_QUOTAS", ""))
        for name, spec in (tenant_quotas or {}).items():
            if isinstance(spec, (int, float)):
                quotas[name] = (float(spec), 4.0 * float(spec))
            else:
                rate, burst = spec
                quotas[name] = (float(rate), float(burst))
        self._quota_config = quotas
        self.tenant_weights = dict(parse_tenant_weights(
            os.environ.get(ENV_PREFIX + "TENANT_WEIGHTS", "")))
        self.tenant_weights.update(tenant_weights or {})
        self.shed = shed if shed is not None else ShedController(
            clock=clock)
        self._signals_fn: Optional[Callable[[], Dict[str, float]]] = None
        self._retry_after_fn: Optional[Callable[[], float]] = None
        self._tiering_gate: Optional[Callable[[str], None]] = None
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        reg = get_registry()
        self._m_admission = reg.counter(
            "sparkml_serve_admission_total",
            "admission decisions at the tenant/priority boundary "
            "(admit, admit_over_quota, shed)", ("tenant", "decision"),
        )
        self._m_shed = reg.counter(
            "sparkml_serve_shed_total",
            "requests shed by the adaptive overload controller, by "
            "tenant and reason", ("tenant", "reason"),
        )
        self._m_admission.inc(0, tenant=self.default_tenant,
                              decision="admit")
        self._m_shed.inc(0, tenant=self.default_tenant, reason="shed")

    # -- wiring ------------------------------------------------------------

    def bind(self, signals_fn: Callable[[], Dict[str, float]],
             retry_after_fn: Callable[[], float]) -> None:
        """The engine hands over its live-signal and Retry-After
        estimators after construction (the controller must not import
        the engine)."""
        self._signals_fn = signals_fn
        self._retry_after_fn = retry_after_fn

    def bind_tiering(self, gate_fn: Callable[[str], None]) -> None:
        """Install the tiering controller's reactivation gate
        (``TieringController.ensure_active``): ``admit`` calls it with
        the model name AFTER the shed decision passes — the first
        request to a COLD model blocks briefly right here while the
        model is restaged and warmed, and a request the overload
        controller would shed anyway never triggers a reactivation."""
        self._tiering_gate = gate_fn

    # -- tenant plumbing ---------------------------------------------------

    def resolve_tenant(self, tenant: Optional[str]) -> str:
        """Normalize + cardinality-bound a caller-supplied tenant id."""
        name = (str(tenant).strip() if tenant else "") or \
            self.default_tenant
        with self._lock:
            if name in self._buckets or name in self._quota_config:
                return name
            if len(self._buckets) >= self.max_tenants:
                return OVERFLOW_TENANT
        return name

    def resolve_priority(self, priority: Optional[str]) -> str:
        name = str(priority).strip().lower() if priority else ""
        return name if name in PRIORITIES else self.default_priority

    def _bucket_for(self, tenant: str) -> TokenBucket:
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                rate, burst = self._quota_config.get(
                    tenant, (self.default_rate, self.default_burst))
                bucket = TokenBucket(rate, burst, clock=self.clock)
                self._buckets[tenant] = bucket
            return bucket

    def weight_for(self, tenant: str) -> float:
        return float(self.tenant_weights.get(tenant, 1.0))

    # -- the decision ------------------------------------------------------

    def admit(self, tenant: Optional[str], priority: Optional[str],
              rows: int, model: str = "") -> AdmissionDecision:
        """Admit (possibly tagged over-quota) or raise ``ShedLoad``.

        Every path through here lands in the admission counter; sheds
        and over-quota tags additionally file a ``serve:admission``
        audit span into the active request trace — no silent drops."""
        t0 = time.perf_counter()
        tenant = self.resolve_tenant(tenant)
        priority = self.resolve_priority(priority)
        over_quota = not self._bucket_for(tenant).take(max(int(rows), 1))
        if self.shed.enabled and self._signals_fn is not None:
            self.shed.maybe_refresh(self._signals_fn)
        reason = self.shed.decide(priority, over_quota) \
            if self.shed.enabled else None
        if reason is not None:
            retry_after = (self._retry_after_fn()
                           if self._retry_after_fn is not None else 1.0)
            self._m_admission.inc(tenant=tenant, decision="shed")
            self._m_shed.inc(tenant=tenant, reason=reason)
            self._audit(t0, model=model, tenant=tenant,
                        priority=priority, decision="shed",
                        reason=reason, over_quota=over_quota,
                        retry_after=round(retry_after, 3))
            raise ShedLoad(
                f"{model or 'serve'}: overload shed (level "
                f"{self.shed.level()}, {reason}) for tenant "
                f"{tenant!r}/{priority} — retry after "
                f"~{retry_after:.1f}s",
                retry_after=retry_after, reason=reason, tenant=tenant,
            )
        if over_quota:
            self._m_admission.inc(tenant=tenant,
                                  decision="admit_over_quota")
            self._audit(t0, model=model, tenant=tenant,
                        priority=priority, decision="admit_over_quota",
                        over_quota=True)
        else:
            self._m_admission.inc(tenant=tenant, decision="admit")
        if self._tiering_gate is not None and model:
            # the cold-model gate (serve.tiering): a COLD model's first
            # request blocks here through its reactivation — bounded,
            # counted, and only for requests that already passed quota
            # + shed
            self._tiering_gate(model)
        return AdmissionDecision(tenant, priority, over_quota,
                                 "admit_over_quota" if over_quota
                                 else "admit")

    def fast_shed(self, tenant: Optional[str],
                  priority: Optional[str]) -> Optional[ShedLoad]:
        """The pre-parse fast path: decide a shed from HEADERS alone.

        Returns a ``ShedLoad`` to reply with (counted + audited exactly
        like an ``admit``-path shed) when the controller is at a shed
        level, the tenant's bucket is already dry (probed WITHOUT
        consuming — the real charge happens at ``admit`` for requests
        that pass), and the priority class is shedable at this level;
        None means "go parse the body and run the full admission". The
        point is the COST of a rejection: under a reject storm, a shed
        that still pays the JSON body parse re-spends the capacity it
        was trying to protect.

        Header-less requests (``tenant`` falsy) always decline to the
        full path: with no tenant the probe would judge the DEFAULT
        tenant's bucket, and a body-identified in-quota tenant could be
        shed against a bucket that is not its own — violating the
        in-quota-never-shed contract."""
        if not self.shed.enabled or not tenant:
            return None
        if self._signals_fn is not None:
            self.shed.maybe_refresh(self._signals_fn)
        level = self.shed.level()
        if level <= 0:
            return None
        # At level 1 only EXPLICIT batch priority sheds here: with no
        # priority header, resolve_priority would apply the env default
        # — and under PRIORITY_DEFAULT=batch that would fast-shed a
        # request whose body declares interactive, which the full path
        # would have admitted. (At level 2 the verdict is
        # priority-independent for over-quota work, so the default is
        # safe to apply.)
        explicit = self.resolve_priority(priority) if priority else None
        if level < 2 and explicit != BATCH:
            return None
        priority = explicit if explicit else self.resolve_priority(None)
        tenant = self.resolve_tenant(tenant)
        bucket = self._bucket_for(tenant)
        if bucket.unlimited or bucket.tokens() >= 1.0:
            return None  # in quota (or close enough) — full path decides
        t0 = time.perf_counter()
        # same reason vocabulary as decide(): the label reflects the
        # LEVEL that shed it, not which code path (headers vs body)
        # happened to carry the verdict
        reason = "over_quota" if level >= 2 else "over_quota_batch"
        retry_after = (self._retry_after_fn()
                       if self._retry_after_fn is not None else 1.0)
        self._m_admission.inc(tenant=tenant, decision="shed")
        self._m_shed.inc(tenant=tenant, reason=reason)
        self._audit(t0, tenant=tenant, priority=priority,
                    decision="shed", reason=reason, over_quota=True,
                    fast_path=True, retry_after=round(retry_after, 3))
        return ShedLoad(
            f"overload shed at the door (level {level}, {reason}) for "
            f"tenant {tenant!r}/{priority} — retry after "
            f"~{retry_after:.1f}s",
            retry_after=retry_after, reason=reason, tenant=tenant,
        )

    def _audit(self, t0: float, **args) -> None:
        """File the decision into the request's trace tree (the active
        ``TraceContext`` — the engine calls ``admit`` inside the
        ``serve:request`` span, so the audit nests under it)."""
        ctx = tracectx.capture()
        spans_mod.record_event(
            "serve:admission", t0, time.perf_counter(),
            trace_id=ctx.trace_id if ctx is not None else None,
            parent_span_id=spans_mod.current_span_id()
            or (ctx.span_id if ctx is not None else None),
            **args,
        )

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            buckets = dict(self._buckets)
        return {
            "default_tenant": self.default_tenant,
            "default_priority": self.default_priority,
            "max_tenants": self.max_tenants,
            "tenants": {
                name: {
                    "rate": bucket.rate,
                    "burst": bucket.burst,
                    "tokens": (None if bucket.unlimited
                               else round(bucket.tokens(), 1)),
                    "unlimited": bucket.unlimited,
                    "weight": self.weight_for(name),
                }
                for name, bucket in sorted(buckets.items())
            },
            "shed": self.shed.snapshot(),
        }


__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "BATCH",
    "INTERACTIVE",
    "OVERFLOW_TENANT",
    "PRIORITIES",
    "ShedController",
    "ShedLoad",
    "TokenBucket",
    "parse_tenant_quotas",
    "parse_tenant_weights",
]
