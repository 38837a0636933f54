"""Request-scoped trace context: W3C traceparent in, spans out.

The port's copy of the JAX package's ``obs/tracectx.py``. A served request
crosses four thread boundaries — HTTP handler → engine → batcher queue →
batcher worker → response latch — and this module carries its identity
across them (Dapper-style propagation):

* ``TraceContext`` — an immutable ``(trace_id, span_id, sampled, baggage)``
  tuple. ``trace_id`` is the W3C 32-hex request identity; ``span_id`` is
  the 16-hex id of the context's current span (the parent of anything
  started under it).
* ``parse_traceparent`` / ``TraceContext.traceparent()`` — the W3C Trace
  Context header format (``00-<trace>-<span>-<flags>``), so an inbound
  ``traceparent`` header continues an external trace and responses hand
  the id back.
* ``current_context()`` / ``activate(ctx)`` / ``capture()`` — the
  contextvar plumbing: ``capture()`` at an enqueue site, ``activate(ctx)``
  on the far side of the handoff.
* ``traced_thread(...)`` — a thread whose target runs under the caller's
  contextvars snapshot (or a fresh root with ``fresh=True``).
* ``track_request(...)`` / ``inflight_requests()`` — a cross-thread table
  of in-flight requests (trace id, model, elapsed).

``obs.spans`` consults ``current_context()`` when a root span opens, so
every span under an activated context carries the request's trace id.
"""

from __future__ import annotations

import contextlib
import contextvars
import re
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional

TRACEPARENT_HEADER = "traceparent"
_TRACEPARENT_RE = re.compile(
    r"^(?P<version>[0-9a-f]{2})-(?P<trace_id>[0-9a-f]{32})-"
    r"(?P<span_id>[0-9a-f]{16})-(?P<flags>[0-9a-f]{2})$"
)


def new_trace_id() -> str:
    """A 32-hex W3C trace id (never all-zero)."""
    return uuid.uuid4().hex


def new_span_id() -> str:
    """A 16-hex W3C span id (never all-zero)."""
    return uuid.uuid4().hex[:16]


@dataclass(frozen=True)
class TraceContext:
    """One request's identity as it crosses queue/thread boundaries."""

    trace_id: str
    span_id: str
    sampled: bool = True
    baggage: Mapping[str, str] = field(default_factory=dict)

    def child(self, **baggage) -> "TraceContext":
        """A new context in the SAME trace with a fresh span id — what a
        hop activates so its spans parent under the captured one."""
        merged = dict(self.baggage)
        merged.update(baggage)
        return TraceContext(
            trace_id=self.trace_id,
            span_id=new_span_id(),
            sampled=self.sampled,
            baggage=merged,
        )

    def traceparent(self) -> str:
        """The W3C ``traceparent`` header value for this context."""
        flags = "01" if self.sampled else "00"
        return f"00-{self.trace_id}-{self.span_id}-{flags}"

    def as_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "sampled": self.sampled,
            "baggage": dict(self.baggage),
        }


def new_context(**baggage) -> TraceContext:
    """Mint a fresh root context (no inbound traceparent)."""
    return TraceContext(
        trace_id=new_trace_id(), span_id=new_span_id(), baggage=baggage
    )


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """A ``TraceContext`` from a W3C ``traceparent`` header, or None for a
    missing/malformed/all-zero header (the spec says ignore and restart)."""
    if not header or not isinstance(header, str):
        return None
    match = _TRACEPARENT_RE.match(header.strip().lower())
    if not match:
        return None
    trace_id = match.group("trace_id")
    span_id = match.group("span_id")
    if match.group("version") == "ff":
        return None  # forbidden version
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None  # all-zero ids are invalid per spec
    sampled = bool(int(match.group("flags"), 16) & 0x01)
    return TraceContext(trace_id=trace_id, span_id=span_id, sampled=sampled)


# -- the contextvar plumbing -------------------------------------------------


_current: contextvars.ContextVar = contextvars.ContextVar(
    "sparkml_torch_trace_context", default=None
)


def current_context() -> Optional[TraceContext]:
    """The active request's context in THIS thread/task, or None."""
    return _current.get()


def capture() -> Optional[TraceContext]:
    """Capture the active context for a queue/thread handoff (the enqueue
    half). Returns None outside any request — callers hand the value to
    ``activate`` verbatim either way."""
    return _current.get()


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]):
    """Re-activate a captured context on the far side of a handoff (the
    dequeue half). ``activate(None)`` is a no-op context so call sites
    never need to branch."""
    if ctx is None:
        yield None
        return
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def ensure_context(**baggage) -> TraceContext:
    """The active context, or a freshly minted root (for entry points —
    ``ServeEngine.predict`` called directly, tests — that must always
    produce an attributable trace)."""
    ctx = _current.get()
    return ctx if ctx is not None else new_context(**baggage)


def traced_thread(
    target: Callable,
    *,
    name: Optional[str] = None,
    daemon: bool = True,
    args: tuple = (),
    kwargs: Optional[dict] = None,
    fresh: bool = False,
) -> threading.Thread:
    """A ``threading.Thread`` whose target runs under a contextvars
    snapshot: ``fresh=False`` copies the caller's context (one-shot
    handoffs inherit the live request), ``fresh=True`` starts from an
    empty root context (long-lived workers)."""
    run_ctx = (contextvars.Context() if fresh
               else contextvars.copy_context())
    kwargs = kwargs or {}

    def _run():
        run_ctx.run(target, *args, **kwargs)

    return threading.Thread(target=_run, name=name, daemon=daemon)


# -- the in-flight request table ---------------------------------------------

_inflight_lock = threading.Lock()
_inflight: Dict[int, Dict[str, Any]] = {}
_inflight_seq = 0


def track_request(ctx: TraceContext, **info) -> int:
    """Register an in-flight request; returns the handle
    ``untrack_request`` takes."""
    global _inflight_seq
    with _inflight_lock:
        _inflight_seq += 1
        handle = _inflight_seq
        _inflight[handle] = {
            "seq": handle,
            "trace_id": ctx.trace_id,
            "span_id": ctx.span_id,
            "t0": time.monotonic(),
            "info": dict(info),
        }
    return handle


def untrack_request(handle: int) -> None:
    with _inflight_lock:
        _inflight.pop(handle, None)


@contextlib.contextmanager
def inflight_request(ctx: TraceContext, **info):
    """Track one request for the duration of a block (the engine wraps
    every ``predict`` in this; ``/healthz`` lists the table)."""
    handle = track_request(ctx, **info)
    try:
        yield handle
    finally:
        untrack_request(handle)


def inflight_requests() -> List[Dict[str, Any]]:
    """The active trace table, oldest first: ``{trace_id, span_id,
    elapsed_seconds, info}`` per in-flight request."""
    now = time.monotonic()
    with _inflight_lock:
        entries = sorted(_inflight.values(), key=lambda e: e["seq"])
        return [
            {
                "trace_id": e["trace_id"],
                "span_id": e["span_id"],
                "elapsed_seconds": now - e["t0"],
                "info": dict(e["info"]),
            }
            for e in entries
        ]


__all__ = [
    "TRACEPARENT_HEADER",
    "TraceContext",
    "activate",
    "capture",
    "current_context",
    "ensure_context",
    "inflight_request",
    "inflight_requests",
    "new_context",
    "new_span_id",
    "new_trace_id",
    "parse_traceparent",
    "traced_thread",
    "track_request",
    "untrack_request",
]
