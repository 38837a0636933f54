"""The serving front door: multi-tenant admission, deadlines, graceful
drain — and the self-healing layer: retries, circuit breakers, degraded
mode.

The port's core of the JAX package's ``serve/engine.py``. ``ServeEngine``
ties the registry and one micro-batcher per model version into one
synchronous ``predict(model_ref, rows, tenant=, priority=)`` call that a
thread pool (or the HTTP server in ``serve.server``) can hammer:

* **multi-tenant admission** (``serve.admission``) — before the breaker
  or any device work, each request's tenant runs through its token-bucket
  quota (over quota → tagged, not rejected) and the shed controller,
  whose levels follow the live overload signals (``_overload_signals``:
  the SLO fast-burn rate, the batchers' queue-wait estimate, the fullest
  queue's depth fraction — host counters only, never a device read); a
  shed raises ``ShedLoad`` (counted, audited as a ``serve:admission``
  span, never retried, never breaker food);
* **weighted-fair scheduling** (``serve.scheduler``) — each batcher's
  queue is a ``FairQueue`` over ``(tenant, priority)`` flows with the
  tenant weights, interactive-first while the controller sheds, and
  preemption of lower-ranked work on a full queue;
  ``SPARK_RAPIDS_ML_TORCH_SERVE_SCHED=fifo`` (or ``fair_scheduling=False``)
  restores the FIFO deque and ``..._SHED=0`` turns the controller off;
* **SLOs** (``obs.slo``) — every request's outcome is recorded in
  ``self.slo``; its fast-burn rate drives shed level 2 and, when
  ``breaker_burn_threshold`` > 0, trips the breaker on backend failures;
* **admission at the queue** — each model's queue is bounded at
  ``max_queue_depth``; a request past it is rejected with ``QueueFull``;
* **per-request deadlines** — ``deadline_ms`` stamps a monotonic
  deadline; a request that expires while queued is
  shed with ``DeadlineExpired`` before it costs device time;
* **bounded retry with backoff** — a transient backend failure (a device
  error, a crashed worker, a NaN-guard trip) is retried up to ``retries``
  times with exponential backoff and jitter, under the same deadline
  (``sparkml_serve_retries_total``);
* **per-model circuit breaker** (``serve.breaker``) — consecutive backend
  failures open it, and requests stop touching the device until a
  half-open probe proves recovery;
* **degraded CPU fallback** (``serve.fallback``) — while a breaker is
  open, a model with a row-independent host equivalent is served on the
  host, counted in ``sparkml_serve_degraded_total`` and tagged
  ``degraded``; models without one shed fast with ``BreakerOpen``;
* **NaN guard** — a batch whose real output rows carry NaN/Inf fails with
  ``NumericsError`` (retryable, breaker-counted) instead of serving
  poison;
* **precision ladder** — ``precision="bf16"`` / ``"int8"`` serves the
  reduced-precision program, but only after an offline max-error check
  against the native program (``_precision_ok``); a failed check serves
  native and counts ``sparkml_serve_precision_fallback_total``;
* **graceful drain** — ``shutdown()`` stops admissions and serves (or
  fails, with ``drain=False``) everything already queued.

A model with a ``serving_transform_program`` runs the pipelined batcher on
that program (on the card unless the CPU was asked for); if the program
cannot be built the engine counts ``error="serving_program"`` and keeps
the blocking path through ``model.transform``. A ``PipelineModel``
whose every stage has a serving hook serves as ONE fused program under
its own ``algo`` (``pipeline``), a ``KMeansModel`` as ``kmeans``: their
int32 labels pass through the batcher, ``extract_output`` on the blocking
path (pipeline depth 1 at native precision, the kill switch, which serves
the same rows) and the offline check, which holds labels to their
mismatch fraction.

Every request runs under a ``TraceContext`` (the caller's, or a fresh
root) inside a ``serve:request:<model>`` span whose id the batcher's
queue span and the admission audit parent under.

Every model version's staged weights are charged to the cost ledger
(``obs.accounting``) when its batcher is built from a ``ServingProgram``
and released on ``evict``; every request's outcome is noted there too
(``costs_snapshot`` serves ``GET /debug/costs``). The tiering plane
(``serve.tiering``) drives ``deactivate`` / ``reactivate`` through
``attach_tiering``, which also binds its first-hit gate into admission.

Not ported yet (see ``ROADMAP.md``): replicas, placement and sharded
requests, rollout and autoscale. The engine is configured through its
constructor; of the JAX engine's environment knobs only admission's and
the scheduler's
(``SPARK_RAPIDS_ML_TORCH_SERVE_{TENANT_*,PRIORITY_DEFAULT,SHED*,SCHED}``)
and the SLOs' (``SPARK_RAPIDS_ML_TORCH_SLO_*``) are read.
"""

from __future__ import annotations

import random
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_ml_tpu_torch.models._serving import on_serving_thread
from spark_rapids_ml_tpu_torch.obs import accounting as accounting_mod
from spark_rapids_ml_tpu_torch.obs import spans as spans_mod
from spark_rapids_ml_tpu_torch.obs import tracectx
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
from spark_rapids_ml_tpu_torch.obs.serving import (
    ServingProgram,
    check_output_numerics,
)
from spark_rapids_ml_tpu_torch.obs.slo import SloSet, default_slos
from spark_rapids_ml_tpu_torch.serve import breaker as breaker_mod
from spark_rapids_ml_tpu_torch.serve import faults as faults_mod
from spark_rapids_ml_tpu_torch.serve.admission import (
    AdmissionController,
    AdmissionDecision,
    ShedController,
    ShedLoad,
    retry_after_cap,
)
from spark_rapids_ml_tpu_torch.serve.batching import (
    AsyncTransformSpec,
    BatcherClosed,
    DeadlineExpired,
    MicroBatcher,
    QueueFull,
    WaitTimeout,
    WorkerCrashed,
)
from spark_rapids_ml_tpu_torch.serve.breaker import (
    BreakerOpen,
    CircuitBreaker,
)
from spark_rapids_ml_tpu_torch.serve.fallback import cpu_fallback
from spark_rapids_ml_tpu_torch.serve.registry import (
    ModelRegistry,
    RegisteredModel,
    _infer_features,
)
from spark_rapids_ml_tpu_torch.serve.scheduler import (
    FairQueue,
    fair_scheduling_from_env,
)


class EngineClosed(RuntimeError):
    """The engine is shut down (or shutting down) and accepts no new
    requests."""


# Live engines, for the sampler-driven SLO publisher (weak: an engine
# a test abandoned must be collectable, not pinned by telemetry).
_live_engines: "weakref.WeakSet[ServeEngine]" = weakref.WeakSet()


def publish_all_slos() -> None:
    """Mirror every live engine's SLO verdict into the metrics registry.

    Registered as a sampler collector by ``start_serve_server``, so the
    ``sparkml_slo_*`` gauges are fresh every sweep and earn history;
    without it they move only when someone polls ``/debug/slo``.
    """
    for engine in list(_live_engines):
        if engine._closed:
            continue
        try:
            engine.slo.publish(get_registry())
        except Exception:
            get_registry().counter(
                "sparkml_serve_errors_total",
                "serving errors by type: batch failures (exception "
                "class), worker crashes/wedges, breaker rejections",
                ("model", "error"),
            ).inc(model="(engine)", error="slo_publish")


class NumericsError(RuntimeError):
    """A transform output failed the engine's NaN guard (or a degraded
    fallback produced non-finite values). Retryable and breaker-counted:
    NaN corruption from a sick device is a backend fault."""


_PRECISION_ALIASES = {
    "": "native", "native": "native", "f32": "native", "float32": "native",
    "f64": "native", "float64": "native",
    "bf16": "bf16", "bfloat16": "bf16",
    "int8": "int8",
}


def _normalize_precision(value: str) -> str:
    """'native' / 'bf16' / 'int8'; unknown spellings degrade to native —
    a typo must never enable a reduced-precision ladder."""
    return _PRECISION_ALIASES.get(str(value).strip().lower(), "native")


# Output-column getters tried in order when a transform returns a frame.
_OUTPUT_GETTERS = ("getOutputCol", "getProbabilityCol", "getPredictionCol")


def extract_output(model, result) -> np.ndarray:
    """The row-aligned prediction array from a model's transform result:
    ndarray results pass through; frame results yield the model's output
    column (outputCol, then probabilityCol, then predictionCol)."""
    if isinstance(result, np.ndarray):
        return result
    columns = getattr(result, "columns", None)
    column = getattr(result, "column", None)
    if columns and callable(column):
        for getter in _OUTPUT_GETTERS:
            fn = getattr(model, getter, None)
            if not callable(fn):
                continue
            try:
                name = fn()
            except (TypeError, ValueError, AttributeError, KeyError):
                continue
            if name in columns:
                return np.asarray(column(name))
    raise TypeError(
        f"cannot extract a serving output from {type(result).__name__} "
        f"for {type(model).__name__}"
    )


def _rows_estimate(rows) -> int:
    """Row count of a raw request without materializing it (the quota
    cost must not pay an array copy before admission): array shapes are
    read directly, a flat sequence counts as one row."""
    shape = getattr(rows, "shape", None)
    if shape is not None:
        return int(shape[0]) if len(shape) >= 2 else 1
    try:
        if rows and isinstance(rows[0], (list, tuple, np.ndarray)):
            return len(rows)
    except (TypeError, KeyError):
        pass
    return 1


# Exception shapes that mean "the device backend failed", as opposed to a
# client error or an orderly rejection: these feed the breaker and the
# retry loop.
_HARD_BACKEND_ERRORS = (OSError, ConnectionError, TimeoutError,
                        MemoryError, SystemError)


def is_backend_error(exc: BaseException) -> bool:
    if isinstance(exc, WaitTimeout):
        # the caller's wait elapsed: congestion, and the request is still
        # queued, so a retry would duplicate it
        return False
    if isinstance(exc, (faults_mod.InjectedBackendError, NumericsError,
                        WorkerCrashed)):
        return True
    if isinstance(exc, _HARD_BACKEND_ERRORS):
        return True
    name = type(exc).__name__
    return "AcceleratorError" in name or "OutOfMemoryError" in name


class PredictResult:
    """One served request: the outputs plus how they were produced
    (``degraded`` CPU fallback? how many ``retries``?) and the request's
    ``trace_id``."""

    __slots__ = ("outputs", "model", "version", "degraded", "retries",
                 "trace_id")

    def __init__(self, outputs: np.ndarray, model: str, version: int,
                 degraded: bool, retries: int, trace_id: str):
        self.outputs = outputs
        self.model = model
        self.version = version
        self.degraded = degraded
        self.retries = retries
        self.trace_id = trace_id


class ServeEngine:
    """Synchronous front door over a ``ModelRegistry``."""

    def __init__(
        self,
        registry: Optional[ModelRegistry] = None,
        *,
        max_batch_rows: int = 1024,
        max_wait_ms: float = 5.0,
        max_queue_depth: int = 256,
        buckets: Optional[Sequence[int]] = None,
        retries: int = 2,
        backoff_ms: float = 25.0,
        breaker_failures: int = 5,
        breaker_cooldown_ms: float = 5000.0,
        max_worker_restarts: Optional[int] = None,
        pipeline_depth: int = 2,
        precision: str = "native",
        precision_max_err: float = 0.05,
        slo: Optional[SloSet] = None,
        breaker_burn_threshold: float = 0.0,
        fair_scheduling: Optional[bool] = None,
        admission: Optional[AdmissionController] = None,
        tenant_quotas: Optional[Dict[str, Any]] = None,
        tenant_weights: Optional[Dict[str, float]] = None,
        shed: Optional[ShedController] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        """``buckets`` None → the powers of two up to ``max_batch_rows``;
        ``max_worker_restarts`` None → unlimited; ``pipeline_depth`` 1 at
        native precision is the blocking path; ``precision_max_err`` is
        the offline check's bar for a reduced ladder.

        ``slo`` None → ``default_slos()``; ``breaker_burn_threshold`` > 0
        arms the breakers' SLO fast-burn trip wire (off by default);
        ``fair_scheduling`` None → ``fair_scheduling_from_env()``. The
        admission layer is ``admission``, or one built from
        ``tenant_quotas`` (``{name: rate}`` or ``{name: (rate, burst)}``,
        rows/s), ``tenant_weights`` and ``shed`` (the shed controller and
        its thresholds; None → one from the environment)."""
        self.registry = registry if registry is not None else ModelRegistry()
        self.max_batch_rows = int(max_batch_rows)
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue_depth = int(max_queue_depth)
        self.buckets = tuple(buckets) if buckets else None
        self.retries = int(retries)
        self.backoff_ms = float(backoff_ms)
        self.breaker_failures = int(breaker_failures)
        self.breaker_cooldown_ms = float(breaker_cooldown_ms)
        self.max_worker_restarts = max_worker_restarts
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self.precision = _normalize_precision(precision)
        self.precision_max_err = float(precision_max_err)
        # (name, version, precision) → {"error", "verdict", "bar"}, the
        # offline max-error checks this engine ran
        self.precision_checks: Dict[Tuple[str, int, str], Dict[str, Any]] = {}
        self._clock = clock
        self.slo = slo if slo is not None else default_slos()
        self.breaker_burn_threshold = float(breaker_burn_threshold)
        self.fair_scheduling = bool(
            fair_scheduling if fair_scheduling is not None
            else fair_scheduling_from_env())
        if admission is not None:
            self.admission = admission
        else:
            self.admission = AdmissionController(
                tenant_quotas=tenant_quotas,
                tenant_weights=tenant_weights,
                shed=shed, clock=clock,
            )
        self.admission.bind(self._overload_signals,
                            self.retry_after_estimate)
        self._retry_after_max_s = retry_after_cap()
        self._batchers: Dict[Tuple[str, int], MicroBatcher] = {}
        self._async_specs: Dict[
            Tuple[str, int], Optional[AsyncTransformSpec]] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._fallbacks: Dict[Tuple[str, int], Any] = {}
        self._lock = threading.Lock()
        self._closed = False
        # the hot/cold tiering plane (serve.tiering), attached via
        # attach_tiering
        self._tiering = None
        # the per-model cost ledger (obs.accounting): batcher builds
        # charge the staged weights, evict releases them, every request
        # notes its vitals
        self._ledger = accounting_mod.get_ledger()
        reg = get_registry()
        self._m_latency = reg.summary(
            "sparkml_serve_request_latency_seconds",
            "end-to-end serving request latency (admit → split)",
            ("model",),
        )
        self._m_retries = reg.counter(
            "sparkml_serve_retries_total",
            "predict attempts re-entered after a transient backend "
            "failure", ("model",),
        )
        self._m_degraded = reg.counter(
            "sparkml_serve_degraded_total",
            "requests served by the degraded CPU fallback while the "
            "model's breaker was open", ("model",),
        )
        self._m_errors = reg.counter(
            "sparkml_serve_errors_total",
            "serving errors by type: batch failures (exception class), "
            "worker crashes/wedges, breaker rejections", ("model", "error"),
        )
        self._m_tenant = reg.counter(
            "sparkml_serve_tenant_requests_total",
            "serving requests per tenant by outcome (ok, shed, "
            "rejected, expired, error)", ("tenant", "outcome"),
        )
        self._m_tenant.inc(0, tenant=self.admission.default_tenant,
                           outcome="ok")
        _live_engines.add(self)

    # -- the request path --------------------------------------------------

    def predict(self, model_ref: str, rows, *,
                deadline_ms: Optional[float] = None,
                version: Optional[int] = None,
                timeout: Optional[float] = 120.0,
                tenant: Optional[str] = None,
                priority: Optional[str] = None) -> np.ndarray:
        """Serve one request: resolve, admit, coalesce, return its rows
        (``predict_detailed``'s outputs; same raises)."""
        return self.predict_detailed(
            model_ref, rows, deadline_ms=deadline_ms, version=version,
            timeout=timeout, tenant=tenant, priority=priority).outputs

    def predict_detailed(self, model_ref: str, rows, *,
                         deadline_ms: Optional[float] = None,
                         version: Optional[int] = None,
                         timeout: Optional[float] = 120.0,
                         tenant: Optional[str] = None,
                         priority: Optional[str] = None) -> PredictResult:
        """Serve one request with full fault handling, under the active
        ``TraceContext`` (or a fresh root). ``tenant`` / ``priority`` feed
        the admission controller: quota verdict, shed gate and the
        fair-queue position. Raises ``KeyError`` (unknown model),
        ``ValueError`` (bad request shape), ``ShedLoad`` (the overload
        controller, or preempted from a full queue), ``QueueFull``,
        ``DeadlineExpired`` (shed while queued), ``WaitTimeout``,
        ``WorkerCrashed`` (batcher dead — fast, never a hang),
        ``BreakerOpen`` (breaker open, no fallback), ``NumericsError``,
        ``EngineClosed``."""
        if self._closed:
            raise EngineClosed("serving engine is shut down")
        t0 = time.perf_counter()
        entry = self.registry.resolve_entry(model_ref, version)
        ctx = tracectx.ensure_context()
        brk = self._breaker_for(entry.name)
        # submitted[0] flips once a batcher accepted the request: a
        # ValueError before that is the client's (bad shape), after it
        # the batch failing — the outage the SLO layer sees
        submitted = [False]
        tenant_id = self.admission.resolve_tenant(tenant)
        try:
            with tracectx.activate(ctx), tracectx.inflight_request(
                ctx, model=entry.name, version=entry.version,
            ), spans_mod.span(
                f"serve:request:{entry.name}", trace_id=ctx.trace_id,
                model=entry.name, version=entry.version,
            ):
                # the queue handoff carries THIS span as the parent, so
                # the worker's queue span nests under the request span
                handoff = tracectx.TraceContext(
                    trace_id=ctx.trace_id,
                    span_id=spans_mod.current_span_id() or ctx.span_id,
                    sampled=ctx.sampled,
                    baggage=ctx.baggage,
                )
                deadline = (time.monotonic() + deadline_ms / 1000.0
                            if deadline_ms and deadline_ms > 0 else None)
                # the admission boundary, before the breaker or any
                # device work: an overload shed raises ShedLoad here
                decision = self.admission.admit(
                    tenant_id, priority, _rows_estimate(rows),
                    model=entry.name,
                )
                gate = brk.allow()
                if gate == "open":
                    out = self._degraded_predict(entry, rows)
                    degraded, retries = True, 0
                else:
                    out, retries, degraded = self._attempts(
                        entry, rows, deadline, handoff, timeout, brk, gate,
                        ctx, submitted, decision)
        except BaseException as exc:
            # client errors (unknown model, a bad shape rejected at
            # submit) spend no error budget; a ValueError after the
            # submit is the batch failing
            client_error = isinstance(exc, KeyError) or (
                isinstance(exc, ValueError) and not submitted[0])
            if not client_error:
                outcome = ("shed" if isinstance(exc, ShedLoad)
                           else "rejected" if isinstance(exc, QueueFull)
                           else "expired"
                           if isinstance(exc, DeadlineExpired)
                           else "error")
                self._m_tenant.inc(tenant=tenant_id, outcome=outcome)
                self._ledger.note_request(
                    entry.name, entry.version, tenant_id,
                    self.admission.resolve_priority(priority),
                    _rows_estimate(rows), outcome)
                if isinstance(exc, ShedLoad) and not submitted[0]:
                    # an admission shed; a preemption victim (submitted,
                    # then evicted) was counted by its batcher
                    self._m_errors.inc(model=entry.name, error="load_shed")
                self.slo.record_request(False, time.perf_counter() - t0)
                # the SLO fast-burn trip wire: only device-side failures
                # feed it — an overload burst burns the budget above but
                # must not open a breaker guarding a healthy device
                if is_backend_error(exc) and brk.burn_threshold > 0:
                    brk.note_burn(self.slo.fast_burn_rate())
            raise
        elapsed = time.perf_counter() - t0
        self.slo.record_request(True, elapsed)
        self._m_tenant.inc(tenant=tenant_id, outcome="ok")
        self._ledger.note_request(
            entry.name, entry.version, tenant_id,
            self.admission.resolve_priority(priority),
            _rows_estimate(rows), "ok")
        self._m_latency.observe(elapsed, trace_id=ctx.trace_id,
                                model=entry.name)
        return PredictResult(outputs=out, model=entry.name,
                             version=entry.version, degraded=degraded,
                             retries=retries, trace_id=ctx.trace_id)

    # -- the retry / breaker / degraded machinery --------------------------

    def _attempts(self, entry: RegisteredModel, rows,
                  deadline: Optional[float],
                  handoff: tracectx.TraceContext, timeout: Optional[float],
                  brk: CircuitBreaker, gate: str,
                  ctx: tracectx.TraceContext, submitted: List[bool],
                  decision: AdmissionDecision,
                  ) -> Tuple[np.ndarray, int, bool]:
        """The bounded-retry loop: (outputs, retries used, degraded).
        Retries are ``serve:retry:<model>`` child spans of the request."""
        probe = gate == "probe"
        max_attempts = 1 + max(self.retries, 0)
        attempt = 0
        while True:
            attempt += 1
            try:
                if attempt == 1:
                    out = self._one_attempt(entry, rows, deadline, handoff,
                                            timeout, submitted, decision,
                                            revive=probe)
                else:
                    with spans_mod.span(
                        f"serve:retry:{entry.name}", trace_id=ctx.trace_id,
                        model=entry.name, attempt=attempt - 1,
                    ):
                        out = self._one_attempt(entry, rows, deadline,
                                                handoff, timeout, submitted,
                                                decision)
            except BaseException as exc:  # noqa: BLE001 - classified below
                if isinstance(exc, (QueueFull, ShedLoad, DeadlineExpired,
                                    KeyError, EngineClosed,
                                    WaitTimeout)) or (
                        isinstance(exc, ValueError) and not submitted[0]):
                    # orderly rejections / client errors: the device was
                    # never consulted, so no breaker verdict
                    if probe:
                        brk.release_probe()
                    raise
                backend = is_backend_error(exc)
                if backend:
                    brk.record_failure(probe=probe,
                                       error=type(exc).__name__)
                elif probe:
                    brk.release_probe()
                probe = False
                # once the breaker is open, stop touching the device: with
                # a fallback this request degrades, without one its own
                # error propagates now and the next request sheds
                if brk.state == breaker_mod.OPEN:
                    if self._fallback_for(entry) is not None:
                        return (self._degraded_predict(entry, rows),
                                attempt - 1, True)
                    raise
                retryable = backend or isinstance(exc, BatcherClosed)
                if retryable and attempt < max_attempts:
                    delay = self._backoff_delay(attempt)
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise  # one deadline governs every attempt
                        delay = min(delay, max(remaining - 0.001, 0.0))
                    self._m_retries.inc(model=entry.name)
                    if delay > 0:
                        time.sleep(delay)
                    continue
                raise
            else:
                brk.record_success(probe=probe)
                return out, attempt - 1, False

    def _one_attempt(self, entry: RegisteredModel, rows, deadline,
                     handoff: tracectx.TraceContext, timeout,
                     submitted: List[bool], decision: AdmissionDecision,
                     revive: bool = False) -> np.ndarray:
        batcher = self._batcher_for(entry)
        if revive and batcher.dead():
            # the breaker's half-open probe replaces a dead batcher; the
            # probe cadence bounds recreate storms
            batcher = self._revive_batcher(entry, batcher)
        req = batcher.submit(rows, deadline=deadline, trace_ctx=handoff,
                             tenant=decision.tenant,
                             priority=decision.priority,
                             over_quota=decision.over_quota)
        submitted[0] = True
        return req.wait(timeout)

    def _backoff_delay(self, failed_attempt: int) -> float:
        """Exponential backoff with jitter: base · 2^(attempt-1), scaled
        by a random factor in [0.5, 1.0]."""
        base = max(self.backoff_ms, 0.0) / 1000.0
        return base * (2 ** (failed_attempt - 1)) * (
            0.5 + 0.5 * random.random())

    def _degraded_predict(self, entry: RegisteredModel, rows) -> np.ndarray:
        """Serve one request from the CPU fallback (breaker open)."""
        fb = self._fallback_for(entry)
        if fb is None:
            self._m_errors.inc(model=entry.name, error="breaker_open")
            raise BreakerOpen(
                f"{entry.name}: circuit breaker open and the model has no "
                "CPU fallback — shedding fast (retry after the cooldown)"
            )
        out = np.asarray(fb(rows))
        # The degraded path answers AROUND the instrumented transform, so
        # it runs the numerics sentinel itself: a fallback emitting NaN
        # is an outage, not a fallback.
        verdict = check_output_numerics(out)
        if verdict and (verdict["nan_rows"] or verdict["inf_rows"]):
            self._m_errors.inc(model=entry.name, error="degraded_numerics")
            raise NumericsError(
                f"{entry.name}: degraded CPU fallback produced "
                f"{verdict['nan_rows']} NaN / {verdict['inf_rows']} Inf "
                "rows")
        self._m_degraded.inc(model=entry.name)
        return out

    # -- batcher / breaker / fallback plumbing -----------------------------

    def _make_transform_fn(self, entry: RegisteredModel):
        """The blocking path's transform: fault-plane hook → the model's
        own ``transform``."""
        model = entry.model
        name = entry.name

        def transform(matrix: np.ndarray) -> np.ndarray:
            spec = faults_mod.fault_plane().begin_call(name)
            if spec is not None:
                faults_mod.apply_pre(spec)
            out = np.asarray(extract_output(model, model.transform(matrix)))
            if spec is not None and spec.kind == "nan":
                out = faults_mod.corrupt(spec, out)
            return out

        return transform

    def _make_output_check(self, entry: RegisteredModel):
        """The NaN guard, as the batcher's post-slice ``output_check``: it
        sees only the REAL rows, never the padding."""
        name = entry.name

        def check(out: np.ndarray) -> None:
            if (np.issubdtype(out.dtype, np.floating)
                    and not np.all(np.isfinite(out))):
                raise NumericsError(
                    f"{name}: transform output contains NaN/Inf")

        return check

    def _serving_program(self, entry: RegisteredModel,
                         precision: str) -> Optional[ServingProgram]:
        """The model's device-resident serving program at ``precision``,
        or None (no hook, a host-path model, or construction failed —
        counted as ``error="serving_program"``, never raised: the blocking
        path is always there)."""
        hook = getattr(entry.model, "serving_transform_program", None)
        if not callable(hook):
            return None
        try:
            return hook(precision=precision)
        except Exception:  # noqa: BLE001 - counted; the sync path remains
            self._m_errors.inc(model=entry.name, error="serving_program")
            return None

    def _precision_ok(self, entry: RegisteredModel,
                      native: ServingProgram,
                      reduced: ServingProgram) -> bool:
        """The offline max-error check gating reduced precision: both
        programs run one seeded random batch at the LARGEST bucket and
        are compared — relative max-abs error for float outputs, mismatch
        fraction for labels — against ``precision_max_err``. A failed (or
        crashed) check means the reduced ladder never serves. The
        measured error and verdict land in ``precision_checks``."""
        checks = get_registry().counter(
            "sparkml_serve_precision_checks_total",
            "offline reduced-precision max-error checks by verdict",
            ("model", "precision", "verdict"),
        )
        key = (entry.name, entry.version, reduced.precision)
        err = None
        try:
            n_features = _infer_features(entry.model)
            if n_features is None:
                verdict = "unknown_features"
            else:
                buckets = (self.buckets or entry.buckets
                           or (self.max_batch_rows,))
                bucket = int(max(buckets))
                rng = np.random.default_rng(7)
                x = rng.standard_normal((bucket, int(n_features))).astype(
                    native.dtype)
                ref_raw, red_raw = on_serving_thread(
                    getattr(native, "device", None), lambda: (
                        np.asarray(native.fetch(native.run(native.put(x)))),
                        np.asarray(reduced.fetch(
                            reduced.run(reduced.put(x.copy()))))))
                if ref_raw.shape != red_raw.shape:
                    verdict = "shape_mismatch"
                else:
                    ref = ref_raw.astype(np.float64)
                    red = red_raw.astype(np.float64)
                    if np.issubdtype(ref_raw.dtype, np.integer):
                        err = float(np.mean(ref != red))
                    else:
                        scale = float(np.max(np.abs(ref))) or 1.0
                        err = float(np.max(np.abs(ref - red))) / scale
                    ok = np.isfinite(err) and err <= self.precision_max_err
                    verdict = "pass" if ok else "fail"
        except Exception:  # noqa: BLE001 - a crashed check fails closed
            verdict = "error"
        checks.inc(model=entry.name, precision=reduced.precision,
                   verdict=verdict)
        self.precision_checks[key] = {"error": err, "verdict": verdict,
                                      "bar": self.precision_max_err}
        return verdict == "pass"

    def _make_async_spec(self, entry: RegisteredModel,
                         prog: ServingProgram) -> AsyncTransformSpec:
        """Wrap a ``ServingProgram`` with the fault plane: ``raise`` fires
        at dispatch, ``nan`` corruption at the fetch so the NaN guard sees
        it exactly like the blocking path."""
        name = entry.name

        def dispatch(x_dev, _prog=prog):
            spec_ = faults_mod.fault_plane().begin_call(name)
            if spec_ is not None:
                faults_mod.apply_pre(spec_)
            return _prog.run(x_dev), spec_

        def complete(handle, _prog=prog):
            out_dev, spec_ = handle
            out = _prog.fetch(out_dev)
            if spec_ is not None and spec_.kind == "nan":
                out = faults_mod.corrupt(spec_, out)
            return out

        device = getattr(prog, "device", None)
        return AsyncTransformSpec(
            stage=prog.put, dispatch=dispatch, complete=complete,
            dtype=prog.dtype, algo=prog.algo, precision=prog.precision,
            program=prog,
            pinned=getattr(device, "type", None) == "cuda",
        )

    def _async_spec_for(self, entry: RegisteredModel,
                        ) -> Optional[AsyncTransformSpec]:
        """Build (and cache) the pipelined-batcher spec for one model
        version: its ``ServingProgram`` at the engine's precision
        (max-error-guarded, falling back to native), fault-plane-wrapped.
        None when the pipeline is off (depth 1 at native precision) or
        the model has no program."""
        key = (entry.name, entry.version)
        with self._lock:
            if key in self._async_specs:
                return self._async_specs[key]
        spec: Optional[AsyncTransformSpec] = None
        if self.pipeline_depth > 1 or self.precision != "native":
            prog = self._serving_program(entry, self.precision)
            if prog is not None and self.precision != "native":
                native = self._serving_program(entry, "native")
                if native is None or not self._precision_ok(
                        entry, native, prog):
                    get_registry().counter(
                        "sparkml_serve_precision_fallback_total",
                        "models served at native precision because the "
                        "reduced-precision max-error check failed",
                        ("model", "precision"),
                    ).inc(model=entry.name, precision=self.precision)
                    prog = native
            if prog is not None:
                spec = self._make_async_spec(entry, prog)
        with self._lock:
            self._async_specs[key] = spec
        return spec

    def _make_batcher(self, entry: RegisteredModel,
                      spec: Optional[AsyncTransformSpec]) -> MicroBatcher:
        return MicroBatcher(
            self._make_transform_fn(entry),
            name=entry.name,
            max_batch_rows=self.max_batch_rows,
            max_wait_ms=self.max_wait_ms,
            max_queue_depth=self.max_queue_depth,
            buckets=self.buckets or entry.buckets,
            max_restarts=self.max_worker_restarts,
            output_check=self._make_output_check(entry),
            dtype=spec.dtype if spec is not None else np.float64,
            async_spec=spec,
            pipeline_depth=self.pipeline_depth,
            queue=self._make_queue(),
        )

    def _make_queue(self) -> Optional[FairQueue]:
        """A new batcher's queue discipline: the weighted-fair queue with
        the tenant weights, interactive-first while the shed controller
        reports pressure; None (→ the batcher's FIFO deque) under the
        ``SCHED=fifo`` kill switch."""
        if not self.fair_scheduling:
            return None
        return FairQueue(
            tenant_weights=self.admission.tenant_weights,
            pressure_fn=self.admission.shed.pressure,
        )

    def _batcher_for(self, entry: RegisteredModel) -> MicroBatcher:
        """The model version's batcher, built on first use (the serving
        program is staged outside the engine lock)."""
        key = (entry.name, entry.version)
        with self._lock:
            batcher = self._batchers.get(key)
        if batcher is not None:
            return batcher
        # builds bill to this model in the cost ledger
        with self._ledger.compile_attribution(entry.name, entry.version):
            spec = self._async_spec_for(entry)
        with self._lock:
            if self._closed:
                raise EngineClosed("serving engine is shut down")
            batcher = self._batchers.get(key)
            if batcher is not None:
                return batcher  # lost the construction race
            batcher = self._make_batcher(entry, spec)
            self._batchers[key] = batcher
            # flat-0 series for the engine-level counters too
            self._m_retries.inc(0, model=entry.name)
            self._m_degraded.inc(0, model=entry.name)
            stale = self._stale_keys(entry.name)
        self._charge_batcher(entry, batcher)
        # versions the registry dropped would otherwise leak a worker each
        for k in stale:
            self.evict(*k)
        return batcher

    def _charge_batcher(self, entry: RegisteredModel,
                        batcher: MicroBatcher) -> None:
        """Account one batcher's staged weights to the cost ledger: the
        ``weight_bytes`` of the program that serves (after the precision
        check, the reduced one or the native fallback), under the
        program's device. A blocking-path batcher (no program) charges 0
        under ``default``: the key still lands, so ``/debug/costs`` shows
        the model is live. Never raises into the build path."""
        spec = batcher.async_spec
        prog = spec.program if spec is not None else None
        try:
            self._ledger.charge_memory(
                entry.name, entry.version,
                batcher.device_label or "default",
                accounting_mod.COMPONENT_WEIGHTS,
                int(getattr(prog, "weight_bytes", 0) or 0))
        except Exception:  # noqa: BLE001 - accounting is telemetry
            self._m_errors.inc(model=entry.name, error="ledger_charge")

    def _revive_batcher(self, entry: RegisteredModel,
                        corpse: MicroBatcher) -> MicroBatcher:
        """Replace a DEAD batcher (restart budget exhausted) with a fresh
        one on the breaker's half-open probe."""
        key = (entry.name, entry.version)
        with self._lock:
            if self._closed:
                raise EngineClosed("serving engine is shut down")
            current = self._batchers.get(key)
            if current is not corpse:
                return current if current is not None else corpse
            fresh = self._make_batcher(entry, self._async_specs.get(key))
            self._batchers[key] = fresh
        corpse.close(drain=False, timeout=0.1)  # the final sweep
        return fresh

    def _breaker_for(self, name: str) -> CircuitBreaker:
        with self._lock:
            brk = self._breakers.get(name)
            if brk is None:
                brk = CircuitBreaker(
                    name,
                    failure_threshold=self.breaker_failures,
                    cooldown_seconds=self.breaker_cooldown_ms / 1000.0,
                    burn_threshold=self.breaker_burn_threshold,
                    clock=self._clock,
                )
                self._breakers[name] = brk
            return brk

    def _fallback_for(self, entry: RegisteredModel):
        key = (entry.name, entry.version)
        with self._lock:
            if key not in self._fallbacks:
                self._fallbacks[key] = cpu_fallback(entry.model)
            return self._fallbacks[key]

    def _stale_keys(self, name: str):
        """Batcher keys for ``name`` whose version the registry dropped.
        Caller holds the lock."""
        stale = []
        for key in self._batchers:
            if key[0] != name:
                continue
            try:
                self.registry.resolve_entry(key[0], key[1])
            except KeyError:
                stale.append(key)
        return stale

    def evict(self, name: str, version: int, drain: bool = True) -> bool:
        """Close and drop one (name, version) batcher — call after
        ``registry.deregister`` (or rely on the sweep when the next
        version's batcher is created). Returns whether one existed."""
        with self._lock:
            batcher = self._batchers.pop((name, version), None)
            self._fallbacks.pop((name, version), None)
            self._async_specs.pop((name, version), None)
        if batcher is None:
            return False
        batcher.close(drain=drain)
        # eviction is the path that FREES accounted residency
        try:
            self._ledger.release_memory(name, version)
        except Exception:  # noqa: BLE001 - eviction already happened
            self._m_errors.inc(model=name, error="ledger_release")
        return True

    def warmup(self, model_ref: str, *, n_features: Optional[int] = None):
        """Warm ``model_ref`` at the buckets THIS engine pads to: the
        registry's blocking-path warmup, then the pipeline ladder — the
        serving program at the engine's precision (after its max-error
        check), one zero batch per bucket through put → run → fetch, so
        the first request meets warm cuBLAS handles and a warm caching
        allocator. Returns the registry's report with a ``pipeline``
        entry ``{"precision", "buckets": {rows: seconds}}``."""
        entry = self.registry.resolve_entry(model_ref)
        # every warm and build inside bills to this model in the ledger
        with self._ledger.compile_attribution(entry.name, entry.version):
            return self._warmup_entry(entry, model_ref, n_features,
                                      self.buckets or entry.buckets)

    def _warmup_entry(self, entry: RegisteredModel, model_ref: str,
                      n_features: Optional[int], buckets):
        spec = self._batcher_for(entry).async_spec
        prog = spec.program if spec is not None else None

        def warm():
            report = self.registry.warmup(
                model_ref, n_features=n_features, buckets=buckets,
                max_bucket_rows=self.max_batch_rows,
            )
            features = (_infer_features(entry.model) if n_features is None
                        else n_features)
            if prog is None or features is None:
                return report
            ladder: Dict[int, float] = {}
            for bucket in sorted(int(b) for b in report["buckets"]):
                zeros = np.zeros((bucket, int(features)), dtype=spec.dtype)
                t0 = time.perf_counter()
                prog.fetch(prog.run(prog.put(zeros)))
                ladder[bucket] = time.perf_counter() - t0
            report["pipeline"] = {"precision": spec.precision,
                                  "buckets": ladder}
            return report

        # on the card the blocking transforms run on the serving stream
        # too, and the cuBLAS handle they draw goes back to the pool for
        # the batcher's worker: a warm makes no workspace serving lacks
        return on_serving_thread(getattr(prog, "device", None), warm)

    # -- the tiering plane (serve.tiering drives these) --------------------

    def deactivate(self, name: str) -> List[str]:
        """Park every (name, *) batcher COLD: each closes with a full
        drain (queued work is never dropped) and is dropped with its
        serving program, so the staged weights leave the card and the
        accounted residency — while the registry entry and its
        ``warmed_buckets`` SURVIVE for the reactivation. Returns the
        version refs that were parked."""
        with self._lock:
            versions = sorted(v for (n, v) in self._batchers if n == name)
        dropped = []
        for version in versions:
            if self.evict(name, version, drain=True):
                dropped.append(f"{name}@{version}")
        return dropped

    def reactivate(self, name: str) -> Dict[str, Any]:
        """Bring a COLD model back: restage its serving program and warm
        its bucket ladder by executing it (``warmup``; the port has no
        executable cache to replay from, ``ServingProgram.prime`` is
        None). The ladder is the registry entry's ``warmed_buckets``,
        else the one ``warmup`` would use. Returns ``{"model", "version",
        "buckets"}``, the buckets being the ones warmed."""
        entry = self.registry.resolve_entry(name)
        with self._ledger.compile_attribution(entry.name, entry.version):
            report = self._warmup_entry(
                entry, name, None,
                entry.warmed_buckets or self.buckets or entry.buckets)
        return {"model": entry.name, "version": entry.version,
                "buckets": sorted(int(b) for b in report["buckets"])}

    def attach_tiering(self, controller) -> None:
        """Install a ``serve.tiering.TieringController``: its
        ``ensure_active`` gate binds into admission (the first request
        to a COLD model blocks there through its reactivation instead of
        404ing), and its snapshot serves ``GET /debug/tiering``."""
        self._tiering = controller
        self.admission.bind_tiering(controller.ensure_active)

    def tiering_controller(self):
        return self._tiering

    def tiering_snapshot(self) -> Dict[str, Any]:
        """The ``GET /debug/tiering`` payload (``{"enabled": False}``
        without an attached controller)."""
        if self._tiering is None:
            return {"enabled": False}
        return self._tiering.snapshot()

    def costs_snapshot(self) -> Dict[str, Any]:
        """The ``GET /debug/costs`` payload: the cost ledger's per-model
        rollups, cold-model ranking and reconciliation verdict. (The JAX
        engine attaches its replica states; the port has no replica
        sets.)"""
        return self._ledger.costs_document()

    # -- overload introspection --------------------------------------------

    def _overload_signals(self) -> Dict[str, float]:
        """The shed controller's live inputs: the worst short-window SLO
        burn, the worst batcher queue-wait estimate and the fullest
        queue's depth fraction — host counters only. Called through
        ``ShedController.maybe_refresh`` at a bounded cadence, never per
        request."""
        with self._lock:
            batchers = list(self._batchers.values())
        depth_frac = max(
            (b.depth() / b.max_queue_depth
             for b in batchers if b.max_queue_depth > 0),
            default=0.0)
        burn = self.slo.fast_burn_rate() if len(self.slo) else 0.0
        return {"burn": burn, "queue_wait_s": self._worst_queue_wait(),
                "depth_frac": depth_frac}

    def _worst_queue_wait(self) -> float:
        with self._lock:
            batchers = list(self._batchers.values())
        return max((b.queue_wait_estimate() for b in batchers),
                   default=0.0)

    def shed_posture(self) -> ShedController:
        """Refresh-then-read the shed controller, for probes: signals
        otherwise refresh only on predict traffic, so a replica drained
        on its shedding ``/readyz`` would never run the de-escalation
        timeline again — probes let it cool down and re-enter rotation."""
        shed = self.admission.shed
        if shed.enabled and not self._closed:
            shed.maybe_refresh(self._overload_signals)
        return shed

    def fast_shed(self, tenant: Optional[str],
                  priority: Optional[str]) -> Optional[ShedLoad]:
        """The HTTP layer's pre-parse shed probe: a ``ShedLoad`` to reply
        with (counted and audited; recorded here as an SLO failure and a
        per-tenant shed, like any other shed) or None (parse the body and
        run the full path). Headers only — the point is skipping the
        body decode."""
        if self._closed:
            return None
        exc = self.admission.fast_shed(tenant, priority)
        if exc is None:
            return None
        self._m_tenant.inc(tenant=exc.tenant, outcome="shed")
        self._m_errors.inc(model="(preparse)", error="load_shed")
        self.slo.record_request(False, 0.0)
        return exc

    def retry_after_estimate(self) -> float:
        """Seconds a rejected caller should wait before retrying: twice
        the live queue-wait estimate, clamped to ``[1,
        SHED_RETRY_AFTER_MAX_S]`` — the ``Retry-After`` header on
        429/503/504 responses."""
        return float(min(max(2.0 * self._worst_queue_wait(), 1.0),
                         max(self._retry_after_max_s, 1.0)))

    def overload_state(self) -> Dict[str, Any]:
        """The overload posture: shed level and signals, the scheduling
        discipline, per-tenant quotas, and the current Retry-After."""
        snap = self.admission.snapshot()
        snap["fair_scheduling"] = self.fair_scheduling
        snap["retry_after_seconds"] = self.retry_after_estimate()
        return snap

    def slo_snapshot(self) -> Dict[str, Any]:
        """Evaluate the engine's SLOs now (burn rates per window, budget
        remaining, firing alerts) and publish them as ``sparkml_slo_*``
        gauges."""
        return self.slo.publish(get_registry())

    # -- lifecycle / introspection ----------------------------------------

    def queue_depth(self, model_ref: Optional[str] = None) -> int:
        with self._lock:
            batchers = list(self._batchers.items())
        return sum(b.depth() for (name, _v), b in batchers
                   if model_ref is None or name == model_ref)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            batchers = dict(self._batchers)
        return {
            "closed": self._closed,
            "queues": {
                f"{name}@{version}": {
                    "depth": b.depth(),
                    "buckets": list(b.buckets),
                    "max_batch_rows": b.max_batch_rows,
                    "precision": (b.async_spec.precision
                                  if b.async_spec is not None else None),
                }
                for (name, version), b in batchers.items()
            },
            "breakers": self.breaker_snapshot(),
            "overload": self.overload_state(),
        }

    def breaker_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            breakers = dict(self._breakers)
        return {name: b.snapshot() for name, b in breakers.items()}

    def drain(self, timeout: float = 30.0) -> None:
        """Serve everything queued, keep accepting afterwards (a quiesce
        point, e.g. before a model rollover)."""
        deadline = time.monotonic() + timeout
        while self.queue_depth() > 0 and time.monotonic() < deadline:
            time.sleep(0.005)

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop admissions, then drain (or fail, with ``drain=False``)
        what is queued, and release each closed batcher's charges in
        the cost ledger, as ``evict`` does (the ledger is process-wide:
        a later engine's tiering budget must not count them).
        Idempotent. (The JAX engine's shutdown releases nothing.)"""
        with self._lock:
            first = not self._closed
            self._closed = True
            batchers = list(self._batchers.items())
        for (name, version), b in batchers:
            b.close(drain=drain, timeout=timeout)
            if not first:
                continue
            try:
                self._ledger.release_memory(name, version)
            except Exception:  # noqa: BLE001 - the batcher is closed
                self._m_errors.inc(model=name, error="ledger_release")

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


__all__ = [
    "BatcherClosed",
    "BreakerOpen",
    "DeadlineExpired",
    "EngineClosed",
    "MicroBatcher",
    "NumericsError",
    "PredictResult",
    "QueueFull",
    "ServeEngine",
    "ShedLoad",
    "WaitTimeout",
    "WorkerCrashed",
    "extract_output",
    "is_backend_error",
    "publish_all_slos",
]
