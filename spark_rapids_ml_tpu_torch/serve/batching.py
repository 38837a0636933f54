"""Shape-bucketed dynamic micro-batching with a pipelined inner loop.

The port's counterpart of the JAX package's ``serve/batching.py``.
Requests enqueue; one worker per batcher coalesces them — up to
``max_batch_rows`` rows or ``max_wait_ms`` of linger, whichever comes
first — writes their rows into a reusable per-bucket staging array
(``utils.padding.StagingPool``, pinned host memory on the card), runs ONE
model call over it, and splits the result back per request in enqueue
order. Steady-state traffic therefore runs one program shape per bucket,
however ragged the request sizes.

For a model with a device-resident ``ServingProgram`` each batch travels
three steps, which the worker interleaves across batches:

* **stage**    — pad batch N+1 into a staging slot (in the model's
  transform dtype) and start its host→device copy (``put``) while batch N
  computes; the slot is not rewritten before that copy's event completes;
* **dispatch** — launch the product (``run``) on the program's compute
  stream, with no host sync;
* **complete** — the only host sync (``fetch``, in ``_complete_batch``):
  the oldest entry of a bounded in-flight window (``pipeline_depth``,
  default 2) is drained,
  padding sliced off, the output check run, and rows split to requests.

All CUDA work happens on the worker thread, on the program's own streams;
callers only enqueue and wait. The queue discipline is pluggable
(``serve.scheduler``): ``FifoQueue`` by default, the engine's weighted-fair
``FairQueue`` over tenants and priorities otherwise; the queue-wait EWMA
(``queue_wait_estimate``) is noted where each request leaves the queue for
a batch, and feeds the shed controller and ``Retry-After``. Each request
carries its caller's ``TraceContext``: the worker files its
``serve:queue:<model>`` span, runs each batch in a ``serve:batch:<model>``
span that links every member's trace, and resolves each latch under the
member's own context. A pipelined batch bypasses the model's decorated
``transform``, so the worker files its ``TransformReport`` itself
(``obs.serving.PipelineTransform``: the stage / dispatch / sync split, a
``transform:<algo>`` span under the batch span, the latency summary with
the batch's trace id as exemplar, the numerics sentinel on the real
rows). A model without a program keeps the blocking path (window depth
1): one ``transform_fn`` call per batch, through the model's decorated
``transform``.
Each completed batch's union busy time
(``sparkml_serve_device_busy_seconds_total``) is also attributed to the
program's device through ``obs.devmon``
(``sparkml_serve_device_batch_seconds_total{model,device}``) and, with
the same number, to the model in the cost ledger (``obs.accounting``).

Invariants (tested in ``tests/test_torch_serve_engine.py`` and
``tests/test_torch_serve_fairness.py``):

* padded rows never appear in any response, at any pipeline depth;
* each request gets exactly its own rows back, in its own order;
* a request whose deadline expired while queued is shed with
  ``DeadlineExpired`` before touching the device — the whole queue is
  swept (``pop_expired``) before each coalesce, not only its head;
* on a full queue an arrival may preempt a strictly lower-ranked queued
  request (``FairQueue.select_victim``): the victim fails at once with
  ``ShedLoad(reason="preempted")``, counted per tenant. Only requests
  still in the queue are candidates: once coalesced into a staged batch a
  request is past preemption, so no staged batch ever carries a hole;
* a batch-level failure reaches every request of that batch, and only
  that batch: the rest of the in-flight window completes normally.

Worker supervision: a worker that **crashes** (an exception escaping the
batch path; the fault plane's ``crash_worker`` injects one) has its
in-flight window failed fast with ``WorkerCrashed`` and is restarted
(``sparkml_serve_worker_restarts_total``); past ``max_restarts`` the
batcher is dead and every queued and future request fails fast. A worker
that **wedges** (one batch exceeding ``worker_budget_s`` between stage and
completion; default the flight recorder's transform budget,
``SPARK_RAPIDS_ML_TORCH_TRANSFORM_BUDGET_SECONDS``, 120 s) is caught by a
watchdog that fails the whole in-flight window, abandons the stuck thread
(generation-guarded: its late results resolve nothing), starts a
replacement with a fresh staging pool, and then writes a
``budget_exceeded:serve_worker:<model>`` flight dump (``obs.flight``:
every thread's stack, the open spans, the in-flight requests, the
breakers' events, the metrics history). ``close()`` ends with a sweep, so
every request gets exactly one terminal outcome.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_ml_tpu_torch.obs import accounting
from spark_rapids_ml_tpu_torch.obs import flight
from spark_rapids_ml_tpu_torch.obs import serving as obs_serving
from spark_rapids_ml_tpu_torch.obs.devmon import get_device_monitor
from spark_rapids_ml_tpu_torch.obs import spans as spans_mod
from spark_rapids_ml_tpu_torch.obs import tracectx
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
from spark_rapids_ml_tpu_torch.serve.admission import (
    INTERACTIVE,
    ShedLoad,
    retry_after_cap,
)
from spark_rapids_ml_tpu_torch.serve.faults import (
    InjectedWorkerCrash,
    fault_plane,
)
from spark_rapids_ml_tpu_torch.serve.scheduler import FifoQueue
from spark_rapids_ml_tpu_torch.utils.padding import (
    StagingPool,
    default_buckets,
    pad_to_bucket,
    padding_waste,
)


class QueueFull(RuntimeError):
    """Admission control: the bounded request queue is at
    ``max_queue_depth``; shed load at the door instead of building an
    unbounded latency backlog."""


class DeadlineExpired(RuntimeError):
    """The request's deadline passed before (or while) it could be
    served; it was shed without spending device time."""


class BatcherClosed(RuntimeError):
    """The batcher is draining/closed and accepts no new requests."""


class WaitTimeout(TimeoutError):
    """The caller's ``wait`` timeout elapsed before the batcher resolved
    the request. Congestion, not a device verdict: the engine neither
    retries it (the request is still queued) nor feeds it to the
    breaker."""


class WorkerCrashed(RuntimeError):
    """The batcher's worker died or wedged past its watchdog budget; the
    request is failed fast and counted in
    ``sparkml_serve_errors_total{error="worker_crashed"}``. Retryable: a
    supervised restart usually restores service at once."""


class AsyncTransformSpec:
    """The engine-built async serving contract for one model: the three
    pipeline steps the worker interleaves, plus the staging dtype.

    ``stage(staged_host) → device handle`` starts the host→device copy;
    ``dispatch(handle) → opaque`` launches the transform (a synchronous
    raise fails only that batch); ``complete(opaque) → array`` is the host
    sync, called only from the completion step. ``dtype`` is what
    ``submit`` coerces rows to; ``algo`` / ``precision`` label the
    per-batch record; ``pinned`` asks for pinned staging buffers (the
    program's device is a card); ``program`` is the raw
    ``ServingProgram``, which warmup drives without the fault plane.
    """

    __slots__ = ("stage", "dispatch", "complete", "dtype", "algo",
                 "precision", "program", "pinned")

    def __init__(self, stage: Callable, dispatch: Callable,
                 complete: Callable, dtype, algo: str,
                 precision: str = "native", program=None,
                 pinned: bool = False):
        self.stage = stage
        self.dispatch = dispatch
        self.complete = complete
        self.dtype = np.dtype(dtype)
        self.algo = algo
        self.precision = precision
        self.program = program
        self.pinned = bool(pinned)


class _Request:
    """One enqueued predict request; a latch the caller waits on.

    ``trace_ctx`` is the submitter's captured ``TraceContext`` (the worker
    re-activates it around every resolution and files the queue-wait span
    into its trace); ``tenant`` / ``priority`` / ``over_quota`` are the
    admission verdict the fair queue orders and ranks by."""

    __slots__ = ("rows", "n", "enqueued", "enqueued_perf", "deadline",
                 "trace_ctx", "tenant", "priority", "over_quota",
                 "_event", "result", "error")

    def __init__(self, rows: np.ndarray, deadline: Optional[float],
                 trace_ctx: Optional[tracectx.TraceContext] = None,
                 tenant: str = "default", priority: str = INTERACTIVE,
                 over_quota: bool = False):
        self.rows = rows
        self.n = int(rows.shape[0])
        self.enqueued = time.monotonic()
        self.enqueued_perf = time.perf_counter()  # the spans' clock
        self.deadline = deadline
        self.trace_ctx = trace_ctx
        self.tenant = tenant
        self.priority = priority
        self.over_quota = over_quota
        self._event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now or time.monotonic()) >= self.deadline)

    def set_result(self, value: np.ndarray) -> bool:
        """First writer wins: a wedged worker's late result never
        overwrites the ``WorkerCrashed`` the watchdog delivered."""
        if self._event.is_set():
            return False
        self.result = value
        self._event.set()
        return True

    def set_error(self, exc: BaseException) -> bool:
        if self._event.is_set():
            return False
        self.error = exc
        self._event.set()
        return True

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until served; raises the request's error if it was shed
        or its batch failed."""
        if not self._event.wait(timeout):
            raise WaitTimeout("request not served within wait timeout")
        if self.error is not None:
            raise self.error
        return self.result


class _InFlight:
    """One batch traveling stage → dispatch → complete; the unit the
    crash and wedge handlers fail."""

    __slots__ = ("batch", "ctx", "handle", "n", "bucket", "features",
                 "bytes_in", "watchdog", "dispatched", "stage_seconds",
                 "dispatch_seconds", "sync_seconds", "record",
                 "batch_span_id")

    def __init__(self, batch: List[_Request], ctx: tracectx.TraceContext):
        self.batch = batch
        self.ctx = ctx  # the batch's own trace, linked to its members'
        self.handle: Any = None
        self.n = 0
        self.bucket = 0
        self.features: Optional[int] = None
        self.bytes_in: Optional[int] = None
        self.watchdog: Optional[int] = None
        self.dispatched = False
        self.stage_seconds = 0.0
        self.dispatch_seconds = 0.0
        self.sync_seconds = 0.0
        self.record: Optional[obs_serving.PipelineTransform] = None
        self.batch_span_id: Optional[str] = None


class _Watchdog:
    """Deadlines for in-flight batches, on one thread of the batcher's own
    (started at the first ``arm``, ended by ``stop``). ``on_expire`` runs
    on that thread, outside the watchdog's lock; after it, the expiry
    writes a ``budget_exceeded:serve_worker:<name>`` flight dump carrying
    the deadline's ``info``."""

    def __init__(self, name: str):
        self._name = name
        self._label = f"serve_worker:{name}"
        self._cond = threading.Condition()
        self._due: Dict[int, Tuple[float, Callable[[], None],
                                   Dict[str, Any]]] = {}
        self._tokens = 0
        self._thread: Optional[threading.Thread] = None
        self._stopped = False

    def arm(self, budget_s: float, on_expire: Callable[[], None],
            info: Dict[str, Any]) -> int:
        with self._cond:
            self._tokens += 1
            self._due[self._tokens] = (time.monotonic() + budget_s,
                                       on_expire, info)
            if self._thread is None and not self._stopped:
                self._thread = threading.Thread(
                    target=self._loop, name=f"sparkml-watchdog-{self._name}",
                    daemon=True)
                self._thread.start()
            self._cond.notify()
            return self._tokens

    def disarm(self, token: int) -> None:
        with self._cond:
            self._due.pop(token, None)

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify()
            thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5.0)

    def _loop(self) -> None:
        while True:
            with self._cond:
                if self._stopped:
                    return
                now = time.monotonic()
                fired = [tok for tok, (at, _, _) in self._due.items()
                         if at <= now]
                if not fired:
                    nearest = min((at for at, _, _ in self._due.values()),
                                  default=None)
                    self._cond.wait(None if nearest is None
                                    else max(nearest - now, 0.001))
                    continue
                expired = [self._due.pop(tok)[1:] for tok in fired]
            for hook, info in expired:
                hook()
                self._dump(info)

    def _dump(self, info: Dict[str, Any]) -> None:
        """The wedge's artifact, written after the hook has failed the
        window (outside every batcher lock). Never raises into the
        watchdog: a failed dump must not stop the next deadline."""
        try:
            flight.dump(f"budget_exceeded:{self._label}", extra={
                "label": self._label,
                "budget_info": info,
                "overdue_at_utc": spans_mod.utcnow_iso(),
            })
        except Exception:  # noqa: BLE001 - diagnostics only
            pass


def _identity(value):
    return value


class MicroBatcher:
    """One model's request queue + pipelined coalescing worker.

    ``transform_fn`` receives the staged (bucket, d) matrix and returns a
    row-aligned array-like; it is the blocking path, used when no
    ``async_spec`` is given (window depth pinned at 1). ``async_spec``
    replaces it with the stage / dispatch / complete steps, and
    ``pipeline_depth`` bounds their in-flight window (1 is the fully
    synchronous loop).

    ``dtype`` is what ``submit`` coerces request rows to. ``output_check``
    (optional) runs over the REAL rows only, after the padding slice and
    before the split; a raise there fails the whole batch. ``queue`` is
    the queue discipline (None → ``FifoQueue``).
    """

    def __init__(
        self,
        transform_fn: Callable[[np.ndarray], Any],
        *,
        name: str = "model",
        max_batch_rows: int = 1024,
        max_wait_ms: float = 5.0,
        max_queue_depth: int = 256,
        buckets: Optional[Sequence[int]] = None,
        worker_budget_s: Optional[float] = None,
        max_restarts: Optional[int] = None,
        output_check: Optional[Callable[[np.ndarray], None]] = None,
        dtype=np.float64,
        async_spec: Optional[AsyncTransformSpec] = None,
        pipeline_depth: int = 2,
        queue=None,
    ):
        if max_batch_rows < 1:
            raise ValueError("max_batch_rows must be >= 1")
        self.transform_fn = transform_fn
        self.output_check = output_check
        self.name = name
        self.max_batch_rows = int(max_batch_rows)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.max_queue_depth = int(max_queue_depth)
        self.dtype = np.dtype(dtype)
        self.async_spec = async_spec
        # only an async spec can overlap batches
        self.pipeline_depth = (max(int(pipeline_depth), 1)
                               if async_spec is not None else 1)
        if async_spec is not None:
            self._stage_fn = async_spec.stage
            self._dispatch_fn = async_spec.dispatch
            self._complete_fn = async_spec.complete
            self._record_algo: Optional[str] = async_spec.algo
            self._precision = async_spec.precision
        else:
            self._stage_fn = _identity
            self._dispatch_fn = self.transform_fn
            self._complete_fn = _identity
            self._record_algo = None
            self._precision = "native"
        # None → the flight recorder's transform budget; <= 0 / inf
        # disables wedge detection; max_restarts None = unlimited
        if worker_budget_s is None:
            self.worker_budget_s = flight.transform_budget_seconds()
        elif worker_budget_s <= 0:
            self.worker_budget_s = float("inf")
        else:
            self.worker_budget_s = float(worker_budget_s)
        self.max_restarts = (None if max_restarts is None
                             else int(max_restarts))
        if buckets:
            self.buckets: Tuple[int, ...] = tuple(
                sorted(int(b) for b in buckets))
            # an explicit ladder is a shape contract: never build a batch
            # the ladder cannot hold
            self.max_batch_rows = min(self.max_batch_rows, self.buckets[-1])
        else:
            self.buckets = default_buckets(self.max_batch_rows)
        self._queue = queue if queue is not None else FifoQueue()
        # queue-wait estimate: an EWMA updated as requests leave the
        # queue, decayed toward 0 while idle (an estimate frozen at the
        # last overload would keep the shed controller shedding an empty
        # queue). Worker-thread writes; readers tolerate staleness.
        self._wait_ewma = 0.0
        self._wait_ewma_at = time.monotonic()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self._crashed = False
        self._generation = 1
        self._restarts = 0
        self._inflight: List[_InFlight] = []
        self._restart_pause_s = 0.02  # crash-storm brake
        # union device-busy accounting, on its own lock so completion
        # never contends with the queue lock
        self._busy_lock = threading.Lock()
        self._busy_active = 0
        self._busy_marker = 0.0
        self._overlap_marker = 0.0
        self._watchdog = _Watchdog(name)
        # per-device attribution of each batch's busy time (obs.devmon):
        # the program's device, else the monitor's first device
        self._devmon = get_device_monitor()
        self._ledger = accounting.get_ledger()
        program = async_spec.program if async_spec is not None else None
        device = getattr(program, "device", None)
        self.device_label: Optional[str] = (
            str(device) if device is not None else None)
        self._declare_metrics()
        self._worker = self._spawn_worker()

    def _declare_metrics(self) -> None:
        """Create this model's serving series up front (a dashboard sees a
        flat 0, not an absent series) and keep the family handles."""
        reg = get_registry()
        self._m_depth = reg.gauge(
            "sparkml_serve_queue_depth",
            "requests waiting in the serving queue", ("model",),
        )
        self._m_depth.set(0, model=self.name)
        self._m_occupancy = reg.gauge(
            "sparkml_serve_batch_occupancy",
            "real rows / bucket rows of the last executed batch",
            ("model",),
        )
        self._m_occupancy.set(0.0, model=self.name)
        self._m_waste = reg.gauge(
            "sparkml_serve_padding_waste",
            "fraction of the last executed batch that was padding",
            ("model",),
        )
        self._m_waste.set(0.0, model=self.name)
        self._m_expired = reg.counter(
            "sparkml_serve_deadline_expired_total",
            "requests shed because their deadline expired before serving",
            ("model",),
        )
        self._m_expired.inc(0, model=self.name)
        self._m_rejected = reg.counter(
            "sparkml_serve_rejected_total",
            "requests rejected by admission control (queue full)",
            ("model",),
        )
        self._m_rejected.inc(0, model=self.name)
        self._m_requests = reg.counter(
            "sparkml_serve_requests_total",
            "serving requests by outcome", ("model", "outcome"),
        )
        self._m_batches = reg.counter(
            "sparkml_serve_batches_total",
            "coalesced batches executed", ("model",),
        )
        self._m_batch_rows = reg.counter(
            "sparkml_serve_batch_rows_total",
            "real (caller) rows executed in coalesced batches", ("model",),
        )
        self._m_bucket_rows = reg.counter(
            "sparkml_serve_bucket_rows_total",
            "bucket (padded-shape) rows executed — with "
            "sparkml_serve_batch_rows_total this yields mean occupancy",
            ("model",),
        )
        self._m_coalesced = reg.counter(
            "sparkml_serve_coalesced_requests_total",
            "requests served via coalesced batches", ("model",),
        )
        self._m_stage = reg.summary(
            "sparkml_serve_stage_latency_seconds",
            "per-stage serving latency (queue wait, stage, dispatch, "
            "sync, and the combined execute)", ("model", "stage"),
        )
        self._m_errors = reg.counter(
            "sparkml_serve_errors_total",
            "serving errors by type: batch failures (exception class), "
            "worker crashes/wedges, breaker rejections", ("model", "error"),
        )
        self._m_errors.inc(0, model=self.name, error="worker_crashed")
        self._m_shed_tenant = reg.counter(
            "sparkml_serve_shed_total",
            "requests shed by the adaptive overload controller, by "
            "tenant and reason", ("tenant", "reason"),
        )
        self._m_restarts = reg.counter(
            "sparkml_serve_worker_restarts_total",
            "batcher worker restarts after a crash or watchdog-declared "
            "wedge", ("model",),
        )
        self._m_restarts.inc(0, model=self.name)
        self._m_busy = reg.counter(
            "sparkml_serve_device_busy_seconds_total",
            "union wall-clock with >= 1 batch in flight (dispatched, not "
            "yet completed)", ("model",),
        )
        self._m_busy.inc(0, model=self.name)
        self._m_overlap = reg.counter(
            "sparkml_serve_pipeline_overlap_seconds_total",
            "wall-clock with >= 2 batches in flight (stage/transfer of "
            "batch N+1 overlapping compute of batch N)", ("model",),
        )
        self._m_overlap.inc(0, model=self.name)
        self._m_window = reg.gauge(
            "sparkml_serve_pipeline_inflight",
            "batches currently in the async in-flight window", ("model",),
        )
        self._m_window.set(0, model=self.name)

    # -- submission --------------------------------------------------------

    def submit(self, rows: np.ndarray,
               deadline: Optional[float] = None,
               trace_ctx: Optional[tracectx.TraceContext] = None,
               tenant: str = "default", priority: str = INTERACTIVE,
               over_quota: bool = False) -> _Request:
        """Enqueue a (n, d) request; returns the latch to ``wait`` on.

        Rows are coerced once, here, to the model's transform ``dtype``
        (no copy when they already match). ``trace_ctx`` is the caller's
        captured ``TraceContext`` (None → the active one);
        ``tenant`` / ``priority`` / ``over_quota`` are the admission
        verdict the queue orders by. Raises ``QueueFull`` past
        ``max_queue_depth``, ``BatcherClosed`` after ``close()`` and
        ``WorkerCrashed`` once the batcher is dead — all before the
        request occupies queue memory. Under the fair queue a FULL queue
        may instead preempt a strictly lower-ranked queued request: the
        victim is shed with ``ShedLoad`` (counted per tenant) and the
        arrival takes its slot.
        """
        rows = np.asarray(rows, dtype=self.dtype)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[0] == 0:
            raise ValueError(
                f"expected a non-empty (n, d) request, got shape {rows.shape}"
            )
        if rows.shape[0] > self.max_batch_rows:
            raise ValueError(
                f"{self.name}: request of {rows.shape[0]} rows exceeds "
                f"max_batch_rows {self.max_batch_rows} — split it, or "
                "configure a larger top bucket"
            )
        req = _Request(rows, deadline,
                       trace_ctx=trace_ctx or tracectx.capture(),
                       tenant=tenant, priority=priority,
                       over_quota=over_quota)
        victim: Optional[_Request] = None
        with self._not_empty:
            if self._closed:
                raise BatcherClosed(f"batcher {self.name!r} is closed")
            if self._crashed or not self._worker.is_alive():
                # fail fast: a request accepted into a dead batcher's
                # queue would hang until its deadline
                self._crashed = True
                self._m_requests.inc(model=self.name, outcome="error")
                self._m_errors.inc(model=self.name, error="worker_crashed")
                raise WorkerCrashed(
                    f"{self.name}: batcher worker is dead (restart "
                    "budget exhausted) — evict and re-create the batcher"
                )
            if len(self._queue) >= self.max_queue_depth:
                # preemption: a strictly lower-ranked queued request may
                # be evicted for the arrival (FairQueue only; FifoQueue
                # always declines and the newcomer is rejected)
                victim = self._queue.select_victim(req)
                if victim is None:
                    self._m_requests.inc(model=self.name,
                                         outcome="rejected")
                    self._m_rejected.inc(model=self.name)
                    raise QueueFull(
                        f"{self.name}: queue depth {len(self._queue)} >= "
                        f"max_queue_depth {self.max_queue_depth}"
                    )
            self._queue.append(req)
            self._record_depth()
            self._not_empty.notify()
        if victim is not None:
            self._shed_preempted(victim)
        return req

    def _shed_preempted(self, victim: _Request) -> None:
        """Resolve a preemption victim at once: shed with ``ShedLoad``
        (the arrival outranked it), counted per tenant and as the distinct
        ``load_shed`` error, its queue-wait span filed into its trace."""
        with tracectx.activate(victim.trace_ctx):
            self._record_queue_span(victim, shed=True, error="ShedLoad")
            victim.set_error(ShedLoad(
                f"{self.name}: preempted from a full queue by a "
                "higher-priority arrival",
                retry_after=min(self.queue_wait_estimate() + 1.0,
                                retry_after_cap()),
                reason="preempted", tenant=victim.tenant,
            ))
        self._m_requests.inc(model=self.name, outcome="shed")
        self._m_errors.inc(model=self.name, error="load_shed")
        self._m_shed_tenant.inc(tenant=victim.tenant, reason="preempted")

    def queue_wait_estimate(self) -> float:
        """The live queue-wait estimate (seconds): an EWMA over recent
        waits, taken as each request leaves the queue, halved every 2 s
        of idleness — one overload burst must not read as pressure
        forever. Host state only: no device read. Feeds the shed
        controller and the HTTP ``Retry-After``."""
        age = max(time.monotonic() - self._wait_ewma_at, 0.0)
        return self._wait_ewma * (0.5 ** (age / 2.0))

    def _note_queue_wait(self, wait_s: float) -> None:
        self._wait_ewma = (0.8 * self.queue_wait_estimate()
                           + 0.2 * max(wait_s, 0.0))
        self._wait_ewma_at = time.monotonic()

    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def dead(self) -> bool:
        """Restart budget exhausted: every submit fails fast. The engine
        replaces a dead batcher on the breaker's half-open probe."""
        with self._lock:
            return self._crashed

    # -- lifecycle ---------------------------------------------------------

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting; with ``drain`` the worker serves what is queued
        (draining its in-flight window), otherwise queued requests fail
        with ``BatcherClosed``. Idempotent. Ends with a sweep under the
        lock: whatever is still queued after the join is failed with
        ``BatcherClosed``, and batches still in flight on a worker that
        outlived the join with ``WorkerCrashed``."""
        with self._not_empty:
            self._closed = True
            if not drain:
                while self._queue:
                    req = self._queue.popleft()
                    with tracectx.activate(req.trace_ctx):
                        req.set_error(BatcherClosed(
                            f"batcher {self.name!r} shut down"))
                self._record_depth()
            self._not_empty.notify_all()
        self._worker.join(timeout=timeout)
        with self._not_empty:
            leftovers = []
            while self._queue:
                leftovers.append(self._queue.popleft())
            if leftovers:
                self._record_depth()
            stuck: List[_InFlight] = []
            if self._worker.is_alive() and self._inflight:
                # the join timed out on a stuck worker: retire its
                # generation and fail its window instead of leaving it
                stuck = list(self._inflight)
                self._inflight = []
                self._generation += 1
        if stuck:
            self._disarm_entries(stuck)
            self._fail_requests(
                [req for e in stuck for req in e.batch],
                WorkerCrashed(
                    f"{self.name}: batcher closed while its worker was "
                    "stuck in a transform; in-flight requests failed fast"
                ))
        if leftovers:
            self._fail_requests(
                leftovers,
                BatcherClosed(
                    f"batcher {self.name!r} shut down before serving "
                    "queued requests"),
                error_label="batcher_closed",
            )
        self._watchdog.stop()

    # -- the worker --------------------------------------------------------

    def _pop_live(self) -> Optional[_Request]:
        """Pop the next unexpired request; shed expired ones (counted,
        errored) without touching the device. Caller holds the lock.

        The fair queue first sweeps expired entries from the WHOLE queue
        (``pop_expired``): under pressure its interactive-first pick never
        reaches queued batch work, whose expired entries would otherwise
        hang their clients and pin the queue depth. FIFO's sweep is a
        no-op: its head always drains."""
        for expired in self._queue.pop_expired():
            self._shed(expired)
        while self._queue:
            req = self._queue.popleft()
            if req.expired():
                self._shed(req)
                continue
            return req
        return None

    def _shed(self, req: _Request) -> None:
        self._note_queue_wait(time.monotonic() - req.enqueued)
        with tracectx.activate(req.trace_ctx):
            self._record_queue_span(req, shed=True)
            req.set_error(DeadlineExpired(
                f"{self.name}: deadline expired after "
                f"{time.monotonic() - req.enqueued:.3f}s in queue"
            ))
        self._m_requests.inc(model=self.name, outcome="expired")
        self._m_expired.inc(model=self.name)

    def _record_queue_span(self, req: _Request, shed: bool = False,
                           error: str = "DeadlineExpired") -> None:
        """File the queue-wait interval into the REQUEST's trace (the
        enqueue thread stamped t0; this — pop or shed — is t1)."""
        ctx = req.trace_ctx
        if ctx is None:
            return
        args = {"model": self.name, "rows": req.n}
        if shed:
            args["error"] = error
        spans_mod.record_event(
            f"serve:queue:{self.name}",
            req.enqueued_perf, time.perf_counter(),
            trace_id=ctx.trace_id, parent_span_id=ctx.span_id,
            **args,
        )

    def _spawn_worker(self) -> threading.Thread:
        """Start a worker for the current generation."""
        gen = self._generation
        worker = threading.Thread(
            target=self._supervise, name=f"sparkml-serve-{self.name}-g{gen}",
            daemon=True, kwargs={"gen": gen},
        )
        worker.start()
        return worker

    def _supervise(self, gen: int) -> None:
        """The worker thread's entry point: a crash escaping the serve
        loop fails the in-flight window fast and hands off to a
        replacement worker instead of dying silently."""
        try:
            self._run(gen)
        except BaseException as exc:  # noqa: BLE001 - supervised
            self._m_errors.inc(model=self.name, error="worker_crashed")
            self._on_worker_crash(exc, gen)

    def _on_worker_crash(self, exc: BaseException, gen: int) -> None:
        """Fail the crashed generation's window fast, then either hand
        off to a replacement worker or mark the batcher dead (restart
        budget exhausted — queued requests fail too)."""
        with self._not_empty:
            if gen != self._generation:
                return  # the wedge handler already took over
            stranded = list(self._inflight)
            self._inflight = []
            self._generation += 1
            can_restart = not self._closed and (
                self.max_restarts is None
                or self._restarts < self.max_restarts
            )
            to_fail = [req for e in stranded for req in e.batch]
            if not can_restart:
                self._crashed = True
                while self._queue:
                    to_fail.append(self._queue.popleft())
                self._record_depth()
                self._not_empty.notify_all()
        self._disarm_entries(stranded)
        self._fail_requests(to_fail, WorkerCrashed(
            f"{self.name}: batcher worker crashed "
            f"({type(exc).__name__}: {exc}); in-flight requests failed fast"
        ))
        if can_restart:
            time.sleep(self._restart_pause_s)
            with self._not_empty:
                if not self._closed:
                    self._restarts += 1
                    self._worker = self._spawn_worker()
                    self._m_restarts.inc(model=self.name)

    def _declare_wedged(self, gen: int, entry: _InFlight) -> None:
        """The watchdog's ``on_expire`` hook: one batch has sat between
        stage and completion past ``worker_budget_s``. Fail the whole
        window fast (only the stuck thread could drain it), retire the
        generation, and start a replacement with a fresh staging pool."""
        with self._not_empty:
            if gen != self._generation or entry not in self._inflight:
                return  # resolved (or already handled) meanwhile
            stranded = list(self._inflight)
            self._inflight = []
            self._generation += 1
            can_restart = not self._closed and (
                self.max_restarts is None
                or self._restarts < self.max_restarts
            )
            to_fail = [req for e in stranded for req in e.batch]
            if can_restart:
                self._restarts += 1
                self._worker = self._spawn_worker()
            else:
                self._crashed = True
                while self._queue:
                    to_fail.append(self._queue.popleft())
                self._record_depth()
                self._not_empty.notify_all()
        self._disarm_entries(stranded, skip=entry)
        self._fail_requests(to_fail, WorkerCrashed(
            f"{self.name}: batcher worker wedged — one batch exceeded "
            f"the {self.worker_budget_s:g}s watchdog budget; the "
            "in-flight window failed fast"
        ))
        if can_restart:
            self._m_restarts.inc(model=self.name)

    def _disarm_entries(self, entries: List[_InFlight],
                        skip: Optional[_InFlight] = None) -> None:
        """Release stranded entries: close their busy intervals and
        disarm their watchdogs, outside the batcher lock (the watchdog's
        hook takes it)."""
        for e in entries:
            self._note_complete(e)
            if e is skip or e.watchdog is None:
                continue
            self._watchdog.disarm(e.watchdog)
            e.watchdog = None

    def _fail_requests(self, requests: List[_Request],
                       exc: BaseException,
                       error_label: str = "worker_crashed") -> None:
        for req in requests:
            with tracectx.activate(req.trace_ctx):
                req.set_error(exc)
        if requests:
            self._m_requests.inc(len(requests), model=self.name,
                                 outcome="error")
            self._m_errors.inc(len(requests), model=self.name,
                               error=error_label)

    def _run(self, gen: int) -> None:
        # Each generation owns its staging pool, so an abandoned (wedged)
        # predecessor never scribbles into a buffer this one stages from.
        # The pool exists only for the async pipeline, whose completion
        # always returns fresh host memory; a blocking transform_fn may
        # return views of its input, which must not alias a reused
        # buffer.
        staging = (StagingPool(self.dtype, slots=self.pipeline_depth + 2,
                               pinned=self.async_spec.pinned)
                   if self.async_spec is not None else None)
        window: collections.deque = collections.deque()
        while True:
            batch: Optional[List[_Request]] = None
            with self._not_empty:
                if gen != self._generation:
                    return  # abandoned after a wedge; a replacement runs
                while not self._queue and not self._closed and not window:
                    self._not_empty.wait(timeout=0.1)
                    if gen != self._generation:
                        return
                first = self._pop_live()
                if first is not None:
                    batch = [first]
                    rows = first.n
                    # Linger until the row cap or the wait budget, but
                    # never idle-wait while batches are in flight.
                    t0 = time.monotonic()
                    while rows < self.max_batch_rows:
                        remaining = self.max_wait_s - (
                            time.monotonic() - t0)
                        if not self._queue:
                            if remaining <= 0 or self._closed or window:
                                break
                            self._not_empty.wait(timeout=remaining)
                            continue
                        nxt = self._queue.peek()
                        if nxt.expired():
                            self._queue.popleft()
                            self._shed(nxt)
                            continue
                        if rows + nxt.n > self.max_batch_rows:
                            break  # leave it for the next batch
                        self._queue.popleft()
                        batch.append(nxt)
                        rows += nxt.n
                    self._record_depth()
                    # in flight from here: registered under the lock,
                    # before any fault-prone work, so a crash or wedge
                    # handler fails exactly these requests
                    entry = _InFlight(
                        batch, tracectx.new_context(model=self.name))
                    self._inflight.append(entry)
                elif not window:
                    if self._closed:
                        return
                    self._record_depth()
                    continue
            if batch is None:
                # queue empty with batches in flight: drain the oldest
                self._complete_oldest(window, gen)
                continue
            if fault_plane().worker_fault(self.name) is not None:
                raise InjectedWorkerCrash(
                    f"injected worker crash on {self.name!r}")
            entry = self._stage_dispatch(entry, gen, staging)
            if entry is not None:
                window.append(entry)
            while len(window) >= self.pipeline_depth:
                self._complete_oldest(window, gen)
            if gen != self._generation:
                return

    def _stage_dispatch(self, entry: _InFlight, gen: int,
                        staging: Optional[StagingPool],
                        ) -> Optional[_InFlight]:
        """Stage (pad into a staging buffer + start the host→device copy)
        and dispatch one coalesced batch. Returns the in-flight entry, or
        None when the batch failed synchronously — then only ITS members
        fail and the pipeline keeps running."""
        batch = entry.batch
        with self._not_empty:
            if gen != self._generation:
                return None  # a wedge handler already failed these
        now = time.monotonic()
        for req in batch:
            # measured as the request leaves the queue for a batch (the
            # pipelined overlap included), where the JAX package takes
            # it, so the shed thresholds mean the same in both
            tid = req.trace_ctx.trace_id if req.trace_ctx else None
            wait = now - req.enqueued
            self._note_queue_wait(wait)
            self._m_stage.observe(wait, trace_id=tid, model=self.name,
                                  stage="queue")
            self._record_queue_span(req)
        # the fan-in edge: the coalesced dispatch runs in its own batch
        # trace whose links name every member request's trace
        member_ids: List[str] = []
        for req in batch:
            if req.trace_ctx and req.trace_ctx.trace_id not in member_ids:
                member_ids.append(req.trace_ctx.trace_id)
        if self._record_algo:
            # pipelined batches bypass the models' decorated entry points,
            # so the batcher files the per-batch TransformReport itself
            entry.record = obs_serving.PipelineTransform(
                self._record_algo, trace_id=entry.ctx.trace_id,
                precision=self._precision)
        try:
            # armed BEFORE the host→device copy: a hang inside the copy
            # itself must be caught too
            if self.worker_budget_s != float("inf"):
                entry.watchdog = self._watchdog.arm(
                    self.worker_budget_s,
                    lambda: self._declare_wedged(gen, entry),
                    info={"model": self.name, "requests": len(batch),
                          "rows": sum(r.n for r in batch)})
            t0 = time.perf_counter()
            if staging is not None:
                staged, n = staging.fill([r.rows for r in batch],
                                         self.buckets)
            else:
                # blocking path: a fresh matrix per batch — transform_fn
                # may return views of its input
                matrix = (batch[0].rows if len(batch) == 1
                          else np.concatenate([r.rows for r in batch],
                                              axis=0))
                staged, n = pad_to_bucket(matrix, self.buckets)
            entry.n = n
            entry.bucket = int(staged.shape[0])
            entry.features = int(staged.shape[1])
            entry.bytes_in = int(staged.nbytes)
            handle = self._stage_fn(staged)
            if staging is not None:
                # the slot is rewritten only after this copy completes
                staging.fence(staged, getattr(handle, "copied", None))
            entry.stage_seconds = time.perf_counter() - t0
            t1 = time.perf_counter()
            self._note_dispatch(entry)
            with tracectx.activate(entry.ctx), spans_mod.span(
                f"serve:batch:{self.name}",
                trace_id=entry.ctx.trace_id, links=tuple(member_ids),
                requests=len(batch), rows=n, bucket=entry.bucket,
            ):
                entry.batch_span_id = spans_mod.current_span_id()
                if entry.record is not None:
                    with entry.record.dispatch_scope():
                        entry.handle = self._dispatch_fn(handle)
                else:
                    entry.handle = self._dispatch_fn(handle)
            entry.dispatch_seconds = time.perf_counter() - t1
            with self._not_empty:
                retired = gen != self._generation
            if retired:
                # a wedge handler retired this generation meanwhile; it
                # failed the requests but could not see this entry's
                # watchdog and busy interval
                if entry.watchdog is not None:
                    self._watchdog.disarm(entry.watchdog)
                    entry.watchdog = None
                self._note_complete(entry)
                return None
            return entry
        except Exception as exc:  # noqa: BLE001 - batch-level failure
            # only THIS batch fails; the worker and the window survive
            self._m_errors.inc(model=self.name, error=type(exc).__name__)
            if entry.watchdog is not None:
                self._watchdog.disarm(entry.watchdog)
                entry.watchdog = None
            self._note_complete(entry)
            stale = self._retire_entry(entry, gen)
            if entry.record is not None:
                entry.record.finish(error=exc)
            if not stale:
                for req in batch:
                    with tracectx.activate(req.trace_ctx):
                        req.set_error(exc)
                self._m_requests.inc(len(batch), model=self.name,
                                     outcome="error")
            return None

    def _retire_entry(self, entry: _InFlight, gen: int) -> bool:
        """Remove one entry from the supervision window; True when a
        crash or wedge handler already owned (and failed) it."""
        with self._not_empty:
            if gen != self._generation or entry not in self._inflight:
                return True
            self._inflight.remove(entry)
            return False

    def _complete_oldest(self, window: collections.deque,
                         gen: int) -> None:
        """Drain the oldest in-flight batch: host-sync its result, slice
        the padding, run the output check, resolve every member."""
        entry: _InFlight = window.popleft()
        out = None
        err: Optional[BaseException] = None
        t0 = time.perf_counter()
        try:
            out = self._complete_batch(entry)
            if out.shape[0] < entry.n:
                raise ValueError(
                    f"{self.name}: transform returned {out.shape[0]} rows "
                    f"for a batch of {entry.n}"
                )
            out = out[:entry.n]  # padding never leaks into any response
            if self.output_check is not None:
                self.output_check(out)
        except Exception as exc:  # noqa: BLE001 - batch-level failure
            self._m_errors.inc(model=self.name, error=type(exc).__name__)
            err = exc
        entry.sync_seconds = time.perf_counter() - t0
        if entry.watchdog is not None:
            self._watchdog.disarm(entry.watchdog)
            entry.watchdog = None
        busy = self._note_complete(entry)
        # the same union busy time, attributed to the program's device
        # (never raises): rate() of it is the device's occupancy
        self._devmon.note_batch(self.name, busy, device=self.device_label)
        # same seam, same number, into the per-model cost ledger — so
        # reconcile() can hold the two attributions to each other
        self._ledger.note_batch_seconds(self.name, busy,
                                        device=self.device_label)
        if self._retire_entry(entry, gen):
            return  # the watchdog failed this window; the late result drops
        if err is not None:
            if entry.record is not None:
                entry.record.finish(error=err)
            for req in entry.batch:
                with tracectx.activate(req.trace_ctx):
                    req.set_error(err)
            self._m_requests.inc(len(entry.batch), model=self.name,
                                 outcome="error")
            return
        self._record_batch(entry, out)
        offset = 0
        for req in entry.batch:
            # resolve under the member's own context
            with tracectx.activate(req.trace_ctx):
                req.set_result(out[offset:offset + req.n])
            offset += req.n
        self._m_requests.inc(len(entry.batch), model=self.name,
                             outcome="ok")

    def _complete_batch(self, entry: _InFlight) -> np.ndarray:
        """THE pipeline's host-sync point: the only place in the worker
        loop that waits for the device."""
        return np.asarray(self._complete_fn(entry.handle))

    # -- pipeline accounting -----------------------------------------------

    def _note_dispatch(self, entry: _InFlight) -> None:
        """Open ``entry``'s in-flight interval."""
        now = time.perf_counter()
        with self._busy_lock:
            entry.dispatched = True
            self._busy_active += 1
            if self._busy_active == 1:
                self._busy_marker = now
            elif self._busy_active == 2:
                self._overlap_marker = now
            self._m_window.set(self._busy_active, model=self.name)

    def _note_complete(self, entry: _InFlight) -> float:
        """Close ``entry``'s in-flight interval, exactly once; flush the
        union busy (and >= 2-deep overlap) time since the last flush."""
        now = time.perf_counter()
        with self._busy_lock:
            if not entry.dispatched or self._busy_active <= 0:
                return 0.0
            entry.dispatched = False
            busy = max(now - self._busy_marker, 0.0)
            overlap = 0.0
            if self._busy_active >= 2:
                overlap = max(now - self._overlap_marker, 0.0)
                self._overlap_marker = now
            self._busy_active -= 1
            self._busy_marker = now
            self._m_window.set(self._busy_active, model=self.name)
        if busy > 0:
            self._m_busy.inc(busy, model=self.name)
        if overlap > 0:
            self._m_overlap.inc(overlap, model=self.name)
        return busy

    # -- metrics -----------------------------------------------------------

    def _record_depth(self) -> None:
        self._m_depth.set(len(self._queue), model=self.name)

    def _record_batch(self, entry: _InFlight, out: np.ndarray) -> None:
        """Completion-side telemetry of one served batch (``out``: its
        real rows), filed before any member's result resolves, so a
        member's assembled trace already holds the batch's transform
        span."""
        real_rows, bucket = entry.n, entry.bucket
        self._m_occupancy.set(
            real_rows / bucket if bucket else 0.0, model=self.name)
        self._m_waste.set(padding_waste(real_rows, bucket), model=self.name)
        self._m_batches.inc(model=self.name)
        self._m_batch_rows.inc(real_rows, model=self.name)
        self._m_bucket_rows.inc(bucket, model=self.name)
        self._m_coalesced.inc(len(entry.batch), model=self.name)
        stage = self._m_stage
        tid = entry.ctx.trace_id
        stage.observe(entry.stage_seconds + entry.dispatch_seconds
                      + entry.sync_seconds, trace_id=tid, model=self.name,
                      stage="execute")
        stage.observe(entry.stage_seconds, trace_id=tid, model=self.name,
                      stage="stage")
        stage.observe(entry.dispatch_seconds, trace_id=tid, model=self.name,
                      stage="dispatch")
        stage.observe(entry.sync_seconds, trace_id=tid, model=self.name,
                      stage="sync")
        if entry.record is not None:
            entry.record.add_phase("stage", entry.stage_seconds)
            entry.record.add_phase("dispatch", entry.dispatch_seconds)
            entry.record.add_phase("sync", entry.sync_seconds)
            entry.record.finish(out, rows=entry.n, features=entry.features,
                                bytes_in=entry.bytes_in,
                                parent_span_id=entry.batch_span_id)
