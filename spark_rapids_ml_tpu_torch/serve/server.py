"""Stdlib HTTP front end: predict + health + metrics.

The port's cut of the JAX package's ``serve/server.py``: a thin shim over
``ServeEngine`` so the serving stack is drivable end to end (curl, load
generators, probes) without a web framework.

* ``POST /predict`` — JSON body ``{"model": "name[@version]", "rows":
  [[...], ...], "deadline_ms": 250, "tenant": "team-a", "priority":
  "interactive|batch"}`` → ``{"model", "version", "outputs": [...],
  "trace_id", "degraded", "retries"}``. Tenant and priority are also
  taken from ``X-Tenant`` / ``X-Priority`` headers, and headers win: the
  pre-parse fast shed (``engine.fast_shed``, run before the body is
  decoded) sees only headers. **Binary columnar bodies**
  (``Content-Type: application/x-sparkml-columnar``, ``serve.wire``) skip
  the JSON parse; the response mirrors the request format (or follows an
  explicit ``Accept``), with version / trace id / degraded / retries
  carried as ``X-Model-*`` / ``X-Trace-Id`` headers. Status codes: a full
  queue **429**, an overload shed (``ShedLoad``: admission, the fast
  shed or a preemption) **503** with ``"shed": true``, a shed deadline
  **504**, an unknown model **404**, malformed input **400** (a
  malformed binary frame 400/415 with its ``reason``), an open breaker
  with no fallback, a dead worker or a closing engine **503**; every
  429, 503 and 504 of a live engine carries ``Retry-After`` (whole
  seconds, at least 1) from the engine's queue-wait estimate. A degraded
  answer is still **200** with ``"degraded": true``. An inbound W3C
  ``traceparent`` continues the caller's trace, and every predict reply
  carries one back. Every reply carries an explicit ``Content-Length``,
  and the whole body is read before it is decoded (or drained unread
  after a fast shed), so a bad frame never desyncs a keep-alive
  connection;
* ``GET /healthz`` — liveness (200 while shedding), registered models,
  queue depth, and ``status`` ``ok`` / ``shedding`` / ``draining``;
* ``GET /readyz`` — 503 while the engine drains or the shed controller
  sheds, 200 otherwise; each read refreshes the controller
  (``engine.shed_posture``), so a replica drained by its load balancer
  recovers without predict traffic;
* ``GET /metrics`` — the metrics registry as Prometheus text;
* ``GET /debug/traces[?limit=N]`` — recent request traces assembled into
  trees from the span ring (server → queue → fan-in batch, the batch
  span grafted in through its links); ``?trace_id=<id>`` returns one
  trace, or 404 once the ring has evicted it;
* ``GET /debug/slo`` — burn rates per window, budget remaining and firing
  alerts from the engine's ``SloSet``, with the queue depth, models,
  per-model breaker states, the fault plane's armed faults, the degraded
  / retry / worker-restart totals, the overload posture and the tiering
  snapshot;
* ``GET /debug/costs`` — the cost ledger's document
  (``engine.costs_snapshot``, ``obs.accounting``): per-model residency
  by component, device seconds, rows, requests by outcome, per-tenant
  rollups, the cold-model ranking and the reconciliation verdict;
* ``GET /debug/tiering`` — the tiering controller's snapshot
  (``serve.tiering``; ``{"enabled": false}`` without one): states, pins,
  budget, resident bytes, the ledger's cold ranking and recent
  transitions;
* ``GET /debug/history`` — JSON range queries over the history store
  (``obs.tsdb``): ``?name=<metric>&window=<s>`` for one family
  (``model=`` narrows by label, ``rate=1`` adds reset-aware rate and
  delta), no ``name`` for the default bundle of key serve / SLO / device
  series plus the sampler's health;
* ``GET /debug/profile`` — ``{active, last, dir}``: the in-flight
  capture, the last one's result (``torch_outcome``, artifacts) and the
  profile directory; ``POST /debug/profile?seconds=N&label=L`` starts a
  single-flight ``torch.profiler`` capture (``obs.profiler``; the body,
  if any, is drained): **200** ``{"started": info}``, **409** with the
  ``active`` capture while one runs, **500** with the error (no card and
  no CPU request, an unwritable directory);
* ``GET /debug/incidents`` — the auto-incident engine's snapshot
  (``obs.incidents``): open incidents newest first, recently resolved
  ones, the lifecycle totals and knobs, the evidence root, the detector
  sweeps and the detector catalog;
* ``GET /dashboard`` — the JAX package's live ops page
  (``serve.dashboard``), served as ``text/html; charset=utf-8``: tiles
  and tables polling ``/debug/slo``, ``/healthz``, ``/debug/history``,
  ``/debug/incidents``, ``/debug/fit`` and ``/debug/traces?limit=10`` (its
  ``/debug/fleet`` tiles stay empty: that route is not ported yet);
* ``GET /debug/fit`` — the fit-path monitor's document
  (``obs.fitmon.debug_fit_doc``): active runs with their step tables,
  recent runs, the per-algo rollup, the backend watchdog's last verdict,
  the straggler ratio and the card's peaks.

``start_serve_server`` starts the history sampler (``obs.tsdb``, with the
device monitor ``obs.devmon`` and the fit monitor's backend watchdog
``obs.fitmon`` as collectors) and registers the engine's
SLO and queue-wait publishers and the cost ledger's ``publish`` on it, so
the ``/debug/history`` series move every sweep whether or not anyone
polls; unless ``SPARK_RAPIDS_ML_TORCH_OBS_INCIDENTS=0`` it installs the
incident engine on the sampler's post-sweep hook, after those
collectors, so the detectors read the sweep's live gauges. Handler threads only decode, enqueue and wait: device work
happens on the batchers' worker threads — except a COLD model's first
hit, whose handler runs the reactivation (``serve.tiering``) before it
enqueues — so ``/metrics``, ``/healthz`` and ``/debug/*`` never touch
the card (the device monitor reads the allocator's host-side counters; a
profile capture runs on helper threads of its own). The JAX package's
other tiers' routes (``/debug/fleet``, ``/debug/fleet/export``,
``/debug/rollout``, ``/debug/autoscale``) are not ported yet.
"""

from __future__ import annotations

import http.server
import json
import socketserver
import time
import urllib.parse
import weakref
from typing import Optional

import numpy as np

from spark_rapids_ml_tpu_torch.obs import accounting as accounting_mod
from spark_rapids_ml_tpu_torch.obs import fitmon as fitmon_mod
from spark_rapids_ml_tpu_torch.obs import incidents as incidents_mod
from spark_rapids_ml_tpu_torch.obs import profiler as profiler_mod
from spark_rapids_ml_tpu_torch.obs import spans as spans_mod
from spark_rapids_ml_tpu_torch.obs import tracectx
from spark_rapids_ml_tpu_torch.obs import tsdb as tsdb_mod
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
from spark_rapids_ml_tpu_torch.serve import wire
from spark_rapids_ml_tpu_torch.serve.admission import ShedLoad
from spark_rapids_ml_tpu_torch.serve.batching import (
    BatcherClosed,
    DeadlineExpired,
    QueueFull,
    WaitTimeout,
    WorkerCrashed,
)
from spark_rapids_ml_tpu_torch.serve.breaker import BreakerOpen
from spark_rapids_ml_tpu_torch.serve.dashboard import DASHBOARD_HTML
from spark_rapids_ml_tpu_torch.serve.engine import (
    EngineClosed,
    ServeEngine,
    publish_all_slos,
)
from spark_rapids_ml_tpu_torch.serve.faults import fault_plane

_MAX_BODY_BYTES = 64 * 1024 * 1024  # refuse absurd request bodies
_TRACE_ROOT_PREFIXES = ("serve:http", "serve:request")
_DEFAULT_TRACE_LIMIT = 20
_DEFAULT_HISTORY_WINDOW = 300.0
_MAX_HISTORY_WINDOW = 24 * 3600.0
# the queue-wait estimate, republished every sampler sweep so it earns
# history (the JAX package's obs.forecast QUEUE_WAIT_SERIES)
QUEUE_WAIT_SERIES = "sparkml_serve_queue_wait_seconds"


def _query_float(params, key: str, default: float,
                 lo: float, hi: float) -> float:
    try:
        value = float(params.get(key, [default])[0])
    except (TypeError, ValueError):
        return default
    return min(max(value, lo), hi)


def history_document(params) -> dict:
    """The ``GET /debug/history`` body for parsed query params.

    ``?name=<metric>`` → every matching child series (``model=`` narrows
    by label, ``host=`` by a federated peer's label — the port federates
    nothing yet, so any host matches no series; ``rate=1`` adds
    reset-aware rate/delta for counters); without ``name`` → the default
    bundle of key series, plus sampler health. The bundle keeps the JAX
    package's keys: a series whose tier is not ported is an empty list."""
    store = tsdb_mod.get_tsdb()
    window = _query_float(params, "window", _DEFAULT_HISTORY_WINDOW,
                          1.0, _MAX_HISTORY_WINDOW)
    name = (params.get("name", [None])[0] or "").strip()
    model = (params.get("model", [None])[0] or "").strip()
    host = (params.get("host", [None])[0] or "").strip()
    labels = {}
    if model:
        labels["model"] = model
    if host:
        labels["host"] = host
    labels = labels or None
    if name:
        doc = {
            "name": name,
            "window": window,
            "series": store.range_query(name, labels, window),
        }
        if params.get("rate", [""])[0] in ("1", "true"):
            doc["rate_series"] = store.rate_points(name, labels, window)
            doc["rate_per_sec"] = store.rate(name, labels, window)
            doc["delta"] = store.delta(name, labels, window)
        return doc
    sampler = tsdb_mod.get_sampler()
    return {
        "window": window,
        "series_names": store.series_names(),
        "sampler": {
            "running": sampler.running,
            "interval_seconds": sampler.interval_seconds,
            "sweeps": sampler.sweeps,
            "series_count": store.series_count(),
            "dropped_series": store.dropped_series(),
        },
        "key": {
            "queue_depth": store.range_query(
                "sparkml_serve_queue_depth", None, window),
            "p99_latency_seconds": store.range_query(
                "sparkml_serve_request_latency_seconds",
                {"quantile": "0.99"}, window),
            "request_rate": store.rate_points(
                "sparkml_serve_requests_total", None, window),
            "requests_total": store.range_query(
                "sparkml_serve_requests_total", None, window),
            "device_mem_bytes_in_use": store.range_query(
                "sparkml_device_mem_bytes_in_use", None, window),
            "device_busy_rate": store.rate_points(
                "sparkml_serve_device_batch_seconds_total", None, window),
            "obs_overhead_rate": store.rate_points(
                "sparkml_obs_overhead_seconds_total", None, window),
            "slo_budget_remaining": store.range_query(
                "sparkml_slo_budget_remaining", None, window),
            # the series below belong to tiers not ported yet (the cost
            # ledger, rollout, federation and forecast): empty until then
            "model_hbm_bytes": store.range_query(
                "sparkml_model_hbm_bytes", None, window),
            "model_device_rate": store.rate_points(
                "sparkml_model_device_seconds_total", None, window),
            "model_ewma_rps": store.range_query(
                "sparkml_model_ewma_rps", None, window),
            "canary_arm_p99_seconds": store.range_query(
                "sparkml_serve_canary_arm_p99_seconds", None, window),
            "canary_arm_error_rate": store.range_query(
                "sparkml_serve_canary_arm_error_rate", None, window),
            "fleet_host_up": store.range_query(
                "sparkml_fleet_host_up", None, window),
            "forecast_queue_wait_ms": store.range_query(
                "sparkml_forecast_queue_wait_ms", None, window),
            "forecast_rps": store.range_query(
                "sparkml_forecast_rps", None, window),
        },
    }


def make_handler(engine: ServeEngine):
    """The request-handler class bound to one engine instance."""

    reg = get_registry()
    m_http_latency = reg.summary(
        "sparkml_http_request_latency_seconds",
        "HTTP front-end request latency by path and status",
        ("path", "status"),
    )
    m_http_requests = reg.counter(
        "sparkml_http_requests_total",
        "HTTP front-end requests by path and status", ("path", "status"),
    )
    # /debug/slo totals: family handles summed per poll, not a registry
    # snapshot
    m_degraded = reg.counter(
        "sparkml_serve_degraded_total",
        "requests served by the degraded CPU fallback while the "
        "model's breaker was open", ("model",),
    )
    m_retries = reg.counter(
        "sparkml_serve_retries_total",
        "predict attempts re-entered after a transient backend "
        "failure", ("model",),
    )
    m_restarts = reg.counter(
        "sparkml_serve_worker_restarts_total",
        "batcher worker restarts after a crash or watchdog-declared "
        "wedge", ("model",),
    )

    class _Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # the response is two writes (headers, body): with Nagle on, a
        # small body waits for the client's delayed ACK of the headers
        disable_nagle_algorithm = True

        def _reply(self, status: int, payload: dict,
                   trace_ctx: Optional[tracectx.TraceContext] = None,
                   retry_after: Optional[float] = None) -> int:
            extra = {}
            if retry_after is not None:
                # overload rejections tell the caller when to come back
                extra["Retry-After"] = max(int(retry_after + 0.999), 1)
            return self._reply_bytes(status, json.dumps(payload).encode(
                "utf-8"), "application/json", trace_ctx=trace_ctx,
                extra_headers=extra)

        def _reply_bytes(self, status: int, body: bytes, content_type: str,
                         trace_ctx: Optional[tracectx.TraceContext] = None,
                         extra_headers: Optional[dict] = None) -> int:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for key, value in (extra_headers or {}).items():
                self.send_header(key, str(value))
            if trace_ctx is not None:
                self.send_header(tracectx.TRACEPARENT_HEADER,
                                 trace_ctx.traceparent())
            self.end_headers()
            self.wfile.write(body)
            return status

        def do_GET(self):  # noqa: N802 - http.server API
            parsed = urllib.parse.urlparse(self.path)
            path = parsed.path
            if path == "/healthz":
                # liveness stays 200 while shedding; the status field
                # carries the posture (and the read refreshes it)
                shed = engine.shed_posture()
                status = self._reply(200, {
                    "status": ("draining" if engine._closed
                               else "shedding" if shed.shedding()
                               else "ok"),
                    "models": engine.registry.names(),
                    "queue_depth": engine.queue_depth(),
                    "shed_level": shed.level(),
                    "inflight": tracectx.inflight_requests(),
                })
            elif path == "/readyz":
                # the load balancer's drain signal: 503 while shedding,
                # so a saturated replica is routed around; the read
                # refreshes the controller, so it also recovers
                shedding = engine.shed_posture().shedding()
                if engine._closed:
                    status = self._reply(
                        503, {"status": "draining", "ready": False})
                elif shedding:
                    overload = engine.overload_state()
                    status = self._reply(503, {
                        "status": "shedding", "ready": False,
                        "shed_level": overload["shed"]["level"],
                        "overload": overload["shed"]["signals"],
                    }, retry_after=overload["retry_after_seconds"])
                else:
                    status = self._reply(200, {
                        "status": "ready", "ready": True,
                        "models": engine.registry.names(),
                    })
            elif path == "/metrics":
                status = self._reply_bytes(
                    200, reg.prometheus_text().encode("utf-8"),
                    "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/debug/traces":
                status = self._reply_traces(
                    urllib.parse.parse_qs(parsed.query))
            elif path == "/debug/slo":
                snap = engine.slo_snapshot()
                snap["queue_depth"] = engine.queue_depth()
                snap["models"] = engine.registry.names()
                snap["closed"] = engine._closed
                snap["breakers"] = engine.breaker_snapshot()
                snap["faults"] = fault_plane().active()
                snap["degraded_total"] = m_degraded.total()
                snap["retries_total"] = m_retries.total()
                snap["worker_restarts_total"] = m_restarts.total()
                snap["overload"] = engine.overload_state()
                snap["tiering"] = engine.tiering_snapshot()
                status = self._reply(200, snap)
            elif path == "/debug/history":
                status = self._reply(200, history_document(
                    urllib.parse.parse_qs(parsed.query)))
            elif path == "/debug/profile":
                status = self._reply(200, {
                    "active": profiler_mod.capture_active(),
                    "last": profiler_mod.last_capture(),
                    "dir": profiler_mod.profile_dir(),
                })
            elif path == "/debug/incidents":
                status = self._reply(
                    200, incidents_mod.get_incident_engine().snapshot())
            elif path == "/debug/tiering":
                status = self._reply(200, engine.tiering_snapshot())
            elif path == "/debug/costs":
                status = self._reply(200, engine.costs_snapshot())
            elif path == "/debug/fit":
                status = self._reply(200, fitmon_mod.debug_fit_doc())
            elif path == "/dashboard":
                status = self._reply_bytes(
                    200, DASHBOARD_HTML.encode("utf-8"),
                    "text/html; charset=utf-8")
            else:
                status = self._reply(404,
                                     {"error": f"unknown path {path!r}"})
                # client URLs must not mint unbounded metric children
                path = "(unknown)"
            m_http_requests.inc(path=path, status=str(status))

        def _reply_traces(self, params) -> int:
            """``/debug/traces``: one trace by ``trace_id`` (the resolver
            for the trace ids responses carry), or the ``limit`` most
            recent request traces."""
            trace_id = (params.get("trace_id", [None])[0] or "").strip()
            if trace_id:
                tree = spans_mod.assemble_trace(trace_id)
                if tree.get("span_count"):
                    return self._reply(200, tree)
                return self._reply(404, {
                    "error": "unknown trace_id (not in the span ring, or "
                             "already evicted)",
                    "trace_id": trace_id,
                })
            try:
                limit = int(params.get("limit", [_DEFAULT_TRACE_LIMIT])[0])
            except (TypeError, ValueError):
                limit = _DEFAULT_TRACE_LIMIT
            summaries = spans_mod.recent_traces(
                max(1, min(limit, 200)), name_prefix=_TRACE_ROOT_PREFIXES)
            return self._reply(200, {"traces": [
                spans_mod.assemble_trace(s["trace_id"]) for s in summaries
            ]})

        def do_POST(self):  # noqa: N802 - http.server API
            parsed = urllib.parse.urlparse(self.path)
            path = parsed.path
            if path == "/debug/profile":
                status = self._handle_profile(parsed)
                m_http_requests.inc(path=path, status=str(status))
                return
            if path != "/predict":
                self._drain_body()
                status = self._reply(404,
                                     {"error": f"unknown path {path!r}"})
                m_http_requests.inc(path="(unknown)", status=str(status))
                return
            # continue an inbound W3C traceparent, or mint a fresh root
            inbound = tracectx.parse_traceparent(
                self.headers.get(tracectx.TRACEPARENT_HEADER))
            ctx = inbound if inbound is not None else tracectx.new_context()
            t0 = time.perf_counter()
            with tracectx.activate(ctx), spans_mod.span(
                "serve:http:predict", trace_id=ctx.trace_id,
            ):
                status = self._handle_predict(ctx)
            m_http_latency.observe(
                time.perf_counter() - t0, trace_id=ctx.trace_id,
                path=path, status=str(status),
            )
            m_http_requests.inc(path=path, status=str(status))

        def _handle_profile(self, parsed) -> int:
            """``POST /debug/profile?seconds=N``: start a single-flight
            on-demand capture (``obs.profiler``). 200 with the capture
            info; 409 while one is already running."""
            # Parameters ride the query string, but clients may still
            # POST a body (curl -d '{}') — drain it, or a keep-alive
            # connection parses the leftover bytes as its next request.
            self._drain_body()
            params = urllib.parse.parse_qs(parsed.query)
            seconds = _query_float(params, "seconds", 5.0,
                                   0.05, profiler_mod.MAX_SECONDS)
            label = (params.get("label", ["ondemand"])[0]
                     or "ondemand")
            try:
                info = profiler_mod.start_capture(seconds, label=label)
            except profiler_mod.CaptureInFlight as exc:
                return self._reply(409, {
                    "error": str(exc),
                    "active": profiler_mod.capture_active(),
                })
            except Exception as exc:  # noqa: BLE001 - surface, don't die
                return self._reply(500, {
                    "error": f"{type(exc).__name__}: {exc}"
                })
            return self._reply(200, {"started": info})

        def _drain_body(self) -> None:
            """Read and discard the body: replying before consuming it
            would desync a keep-alive connection."""
            try:
                length = int(self.headers.get("Content-Length", 0) or 0)
            except (TypeError, ValueError):
                length = -1
            if 0 < length <= _MAX_BODY_BYTES:
                self.rfile.read(length)
            elif length != 0:
                self.close_connection = True

        def _handle_predict(self, ctx: tracectx.TraceContext) -> int:
            """Parse, predict, reply; returns the HTTP status it sent."""
            # the pre-parse fast path: when the shed controller already
            # rejects this header-identified tenant/priority, say no
            # before paying the body decode (the body is drained unread,
            # so keep-alive stays in sync)
            shed_exc = engine.fast_shed(self.headers.get("X-Tenant"),
                                        self.headers.get("X-Priority"))
            if shed_exc is not None:
                self._drain_body()
                return self._reply(503, {
                    "error": str(shed_exc),
                    "retryable": True,
                    "shed": True,
                    "reason": shed_exc.reason,
                }, trace_ctx=ctx, retry_after=shed_exc.retry_after)
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0 or length > _MAX_BODY_BYTES:
                    raise ValueError(f"bad Content-Length {length}")
                raw = self.rfile.read(length)
            except (TypeError, ValueError) as exc:
                # nothing (or garbage) was read: close, or the connection
                # desyncs
                self.close_connection = True
                return self._reply(400, {"error": f"bad request: {exc}"},
                                   trace_ctx=ctx)
            try:
                req = wire.decode_body(raw, self.headers.get("Content-Type"))
            except wire.WireError as exc:
                if exc.kind == "binary":
                    # the full body was read: the connection stays in sync
                    return self._reply(exc.status, {
                        "error": f"bad wire body: {exc}",
                        "reason": exc.reason,
                    }, trace_ctx=ctx)
                self.close_connection = True
                return self._reply(400, {"error": f"bad request: {exc}"},
                                   trace_ctx=ctx)
            # headers win over body fields: the fast shed above saw only
            # the headers, and both must judge the same tenant
            tenant = self.headers.get("X-Tenant") or req.tenant
            priority = self.headers.get("X-Priority") or req.priority
            binary_out = wire.wants_binary_response(
                self.headers.get("Accept"), req.binary)
            try:
                result = engine.predict_detailed(
                    req.model, req.rows, deadline_ms=req.deadline_ms,
                    tenant=tenant, priority=priority)
            except KeyError as exc:
                return self._reply(404, {"error": str(exc)}, trace_ctx=ctx)
            except ValueError as exc:
                # request-shape errors (empty / oversize batch)
                return self._reply(400, {"error": str(exc)}, trace_ctx=ctx)
            except QueueFull as exc:
                return self._reply(
                    429, {"error": str(exc)}, trace_ctx=ctx,
                    retry_after=engine.retry_after_estimate())
            except ShedLoad as exc:
                # the overload controller's verdict (or a preemption):
                # distinct from a full queue, with its own Retry-After
                return self._reply(503, {
                    "error": str(exc),
                    "retryable": True,
                    "shed": True,
                    "reason": exc.reason,
                }, trace_ctx=ctx, retry_after=exc.retry_after)
            except (DeadlineExpired, WaitTimeout) as exc:
                return self._reply(
                    504, {"error": str(exc)}, trace_ctx=ctx,
                    retry_after=engine.retry_after_estimate())
            except (BreakerOpen, WorkerCrashed) as exc:
                # self-healing states, retryable
                return self._reply(503, {"error": str(exc),
                                         "retryable": True},
                                   trace_ctx=ctx,
                                   retry_after=engine.retry_after_estimate())
            except (BatcherClosed, EngineClosed) as exc:
                return self._reply(503, {"error": str(exc)}, trace_ctx=ctx)
            except Exception as exc:  # noqa: BLE001 - surface, don't die
                return self._reply(500, {
                    "error": f"{type(exc).__name__}: {exc}"}, trace_ctx=ctx)
            if binary_out:
                return self._reply_bytes(
                    200, wire.encode_response(result.outputs),
                    wire.BINARY_CONTENT_TYPE, trace_ctx=ctx, extra_headers={
                        "X-Model": result.model,
                        "X-Model-Version": result.version,
                        "X-Trace-Id": result.trace_id,
                        "X-Degraded": int(result.degraded),
                        "X-Retries": result.retries,
                    })
            return self._reply(200, {
                "model": result.model,
                "version": result.version,
                "outputs": np.asarray(result.outputs).tolist(),
                "trace_id": result.trace_id,
                "degraded": result.degraded,
                "retries": result.retries,
            }, trace_ctx=ctx)

        def log_message(self, *args):  # silence per-request stderr noise
            pass

    return _Handler


class _Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # a busy server churns connections faster than the default 5-deep
    # accept backlog
    request_queue_size = 128


def start_serve_server(
    engine: ServeEngine, port: int = 0, addr: str = "127.0.0.1",
) -> http.server.HTTPServer:
    """Serve the engine on a daemon thread; returns the HTTPServer (bind
    ``port=0`` for an ephemeral port, read ``server.server_address[1]``;
    stop with ``server.shutdown()`` and ``server.server_close()``, then
    ``engine.shutdown()`` to drain).

    Also starts the process-wide history sampler (``obs.tsdb``, which
    outlives the server: ``tsdb.stop_sampling`` stops it) with the device
    monitor, the fit monitor's backend watchdog, every live engine's SLO
    gauges, the cost ledger's gauges and
    this engine's queue-wait estimate as collectors, so
    ``/debug/history`` has data, and — unless
    ``SPARK_RAPIDS_ML_TORCH_OBS_INCIDENTS=0`` — installs the auto-incident
    engine on it: detectors run at the sampling cadence on the sampler's
    own thread, after the collectors republished the gauges they read."""
    sampler = tsdb_mod.start_sampling()
    sampler.register_collector(publish_all_slos)
    # the cost ledger's time-derived gauges (last-hit age, EWMA rps)
    # refresh every sweep, so the per-model series get history even
    # when nobody polls /debug/costs
    sampler.register_collector(accounting_mod.get_ledger().publish)
    if incidents_mod.enabled():
        incidents_mod.get_incident_engine().install(sampler)
    reg = get_registry()
    g_queue_wait = reg.gauge(
        QUEUE_WAIT_SERIES,
        "the live queue-wait EWMA (the autoscale/shed signal), "
        "republished every sampler sweep for history + forecasting",
    )
    m_collector_errors = reg.counter(
        "sparkml_serve_collector_errors_total",
        "sampler collector callbacks that raised (and were swallowed "
        "so the sweep survives)",
        ("collector",),
    )

    engine_ref = weakref.ref(engine)

    def _publish_queue_wait():
        live = engine_ref()
        if live is None or live._closed:
            # the sampler outlives this engine: stop publishing for it
            sampler.unregister_collector(_publish_queue_wait)
            return
        try:
            g_queue_wait.set(float(
                live._overload_signals().get("queue_wait_s", 0.0)))
        except Exception:  # noqa: BLE001 - a collector must not kill sweeps
            m_collector_errors.inc(collector="queue_wait")

    sampler.register_collector(_publish_queue_wait)
    server = _Server((addr, port), make_handler(engine))
    thread = tracectx.traced_thread(
        server.serve_forever, name="sparkml-serve-http", daemon=True,
        fresh=True,
    )
    thread.start()
    return server
