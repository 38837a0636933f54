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
* ``GET /metrics`` — the metrics registry as Prometheus text.

Handler threads only decode, enqueue and wait: all device work happens on
the batchers' worker threads, so ``/metrics`` and ``/healthz`` never touch
the card. The JAX package's ``/debug/*`` routes and dashboard are not
ported yet.
"""

from __future__ import annotations

import http.server
import json
import socketserver
import threading
import time
import urllib.parse
from typing import Optional

import numpy as np

from spark_rapids_ml_tpu_torch.obs import spans as spans_mod
from spark_rapids_ml_tpu_torch.obs import tracectx
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
from spark_rapids_ml_tpu_torch.serve.engine import EngineClosed, ServeEngine

_MAX_BODY_BYTES = 64 * 1024 * 1024  # refuse absurd request bodies


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
            path = urllib.parse.urlparse(self.path).path
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
            else:
                status = self._reply(404,
                                     {"error": f"unknown path {path!r}"})
                # client URLs must not mint unbounded metric children
                path = "(unknown)"
            m_http_requests.inc(path=path, status=str(status))

        def do_POST(self):  # noqa: N802 - http.server API
            path = urllib.parse.urlparse(self.path).path
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
            m_http_latency.observe(time.perf_counter() - t0, path=path,
                                   status=str(status))
            m_http_requests.inc(path=path, status=str(status))

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
    ``engine.shutdown()`` to drain)."""
    server = _Server((addr, port), make_handler(engine))
    thread = threading.Thread(target=server.serve_forever,
                              name="sparkml-serve-http", daemon=True)
    thread.start()
    return server
