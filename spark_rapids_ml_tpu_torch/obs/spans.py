"""Structured trace spans: nested, per-request trace ids, assembled into
trees.

The port's cut of the JAX package's ``obs/spans.py``: every completed
span lands in this process's own in-memory ring buffer (``SpanRecorder``;
nothing is shared with the JAX package's recorder), tagged with the
innermost active trace id, and ``assemble_trace`` builds one request's
tree from it (server → request → admission / queue → the coalesced batch
it fanned into). ``span(...)`` also opens a ``utils.tracing.TraceRange``,
so on the card each span shows as an NVTX range in a CUDA profiler's
timeline.

The ring exports as Chrome-trace/Perfetto JSON (``chrome_trace``,
``export_chrome_trace``: every profiler capture writes one), and one
trace's slice is written on demand when
``SPARK_RAPIDS_ML_TORCH_TRACE_DIR`` is set (``maybe_export_trace``; unset,
the default, means zero files). ``active_spans`` lists the spans open
across every thread, which the flight recorder dumps.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from spark_rapids_ml_tpu_torch.obs import tracectx
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

TRACE_DIR_ENV = "SPARK_RAPIDS_ML_TORCH_TRACE_DIR"


def utcnow_iso() -> str:
    """Microsecond-precision UTC timestamp — the one formatter every obs
    artifact (flight dumps, log lines) shares, so telemetry from
    different tiers orders correctly within a second."""
    import datetime

    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%fZ"
    )


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class SpanEvent:
    """One completed span, Chrome-trace "complete event" shaped.

    ``span_id``/``parent_span_id`` give each trace's events a tree
    structure (``assemble_trace``); ``links`` carries OTHER trace ids this
    span fans in — the coalesced serving batch span links every member
    request's trace, the Dapper fan-in edge."""

    name: str
    ts_us: float
    dur_us: float
    trace_id: Optional[str]
    depth: int
    tid: int
    color: Optional[str] = None
    args: Dict[str, Any] = field(default_factory=dict)
    span_id: Optional[str] = None
    parent_span_id: Optional[str] = None
    links: tuple = ()


class SpanRecorder:
    """Bounded in-process ring buffer of completed spans."""

    def __init__(self, capacity: int = 8192):
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)

    def record(self, event: SpanEvent) -> None:
        with self._lock:
            self._buf.append(event)

    def events(self, trace_id: Optional[str] = None) -> List[SpanEvent]:
        with self._lock:
            evs = list(self._buf)
        if trace_id is None:
            return evs
        return [e for e in evs if e.trace_id == trace_id]

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def chrome_trace(self, trace_id: Optional[str] = None) -> Dict[str, Any]:
        """The buffer (optionally one trace's slice) as a Chrome-trace
        dict: "complete" events (``ph: "X"``) with microsecond
        ``ts``/``dur``, loadable by ``chrome://tracing`` and Perfetto."""
        pid = os.getpid()
        trace_events = []
        for e in self.events(trace_id):
            args = dict(e.args)
            if e.trace_id:
                args["trace_id"] = e.trace_id
            if e.span_id:
                args["span_id"] = e.span_id
            if e.parent_span_id:
                args["parent_span_id"] = e.parent_span_id
            if e.links:
                args["links"] = list(e.links)
            if e.color:
                args["color"] = e.color
            args["depth"] = e.depth
            trace_events.append(
                {
                    "name": e.name,
                    "cat": "spark_rapids_ml_tpu_torch",
                    "ph": "X",
                    "ts": round(e.ts_us, 3),
                    "dur": round(e.dur_us, 3),
                    "pid": pid,
                    "tid": e.tid,
                    "args": args,
                }
            )
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}

    def export_chrome_trace(
        self, path: str, trace_id: Optional[str] = None
    ) -> str:
        doc = self.chrome_trace(trace_id)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


_recorder = SpanRecorder()


def get_recorder() -> SpanRecorder:
    return _recorder


@dataclass(frozen=True)
class _ActiveSpan:
    name: str
    trace_id: str
    span_id: str = ""


_stack: contextvars.ContextVar = contextvars.ContextVar(
    "sparkml_torch_span_stack", default=()
)

# Cross-thread registry of OPEN spans: id -> info dict, guarded by one
# lock, so ``assemble_trace`` can show a span that has not exited yet.
_active_lock = threading.Lock()
_active: Dict[int, Dict[str, Any]] = {}
_active_seq = 0


def active_spans() -> List[Dict[str, Any]]:
    """Every currently-open span across all threads (oldest first):
    ``{name, trace_id, tid, elapsed_seconds}`` — what a flight dump
    reads from the watchdog thread, where the stalled thread's
    contextvars are invisible."""
    now = time.perf_counter()
    with _active_lock:
        entries = sorted(_active.values(), key=lambda e: e["seq"])
        return [
            {
                "name": e["name"],
                "trace_id": e["trace_id"],
                "tid": e["tid"],
                "elapsed_seconds": now - e["t0"],
            }
            for e in entries
        ]


def _activate(name: str, trace_id: str, t0: float,
              span_id: Optional[str] = None,
              parent_span_id: Optional[str] = None) -> int:
    global _active_seq
    with _active_lock:
        _active_seq += 1
        handle = _active_seq
        _active[handle] = {
            "seq": handle,
            "name": name,
            "trace_id": trace_id,
            "tid": threading.get_ident(),
            "t0": t0,
            # span identity, so assemble_trace can synthesize a
            # provisional node for a STILL-OPEN span: the HTTP root
            # (serve:http:predict) records at context exit, after the
            # response bytes hit the socket
            "span_id": span_id,
            "parent_span_id": parent_span_id,
        }
    return handle


def _deactivate(handle: int) -> None:
    with _active_lock:
        _active.pop(handle, None)


def current_trace_id() -> Optional[str]:
    """The innermost open span's trace id; falls back to the activated
    ``TraceContext`` when no span is open in this thread yet."""
    st = _stack.get()
    if st:
        return st[-1].trace_id
    ctx = tracectx.current_context()
    return ctx.trace_id if ctx is not None else None


def current_span_id() -> Optional[str]:
    """The innermost open span's id (the activated context's span id
    outside any span, None outside both)."""
    st = _stack.get()
    if st:
        return st[-1].span_id or None
    ctx = tracectx.current_context()
    return ctx.span_id if ctx is not None else None


def record_event(
    name: str,
    t0_seconds: float,
    t1_seconds: float,
    *,
    trace_id: Optional[str] = None,
    span_id: Optional[str] = None,
    parent_span_id: Optional[str] = None,
    links: tuple = (),
    color: Optional[str] = None,
    **args,
) -> SpanEvent:
    """File a span whose interval was measured elsewhere (queue-wait
    spans: the enqueue thread stamps t0, the batcher worker files the
    event at pop time). Timestamps are ``time.perf_counter()`` seconds,
    the clock ``span`` uses, so both kinds interleave on one timeline."""
    event = SpanEvent(
        name=name,
        ts_us=t0_seconds * 1e6,
        dur_us=max(t1_seconds - t0_seconds, 0.0) * 1e6,
        trace_id=trace_id,
        depth=0,
        tid=threading.get_ident(),
        color=color,
        args=dict(args),
        span_id=span_id or tracectx.new_span_id(),
        parent_span_id=parent_span_id,
        links=tuple(links),
    )
    _recorder.record(event)
    return event


@contextmanager
def span(
    name: str,
    color: TraceColor = TraceColor.WHITE,
    trace_id: Optional[str] = None,
    links: tuple = (),
    **attrs,
):
    """Structured nested span. Yields the effective trace id.

    Inherits the parent span's trace id — or, at the root, the activated
    ``TraceContext``'s — minting one only when neither exists; opens a
    ``TraceRange`` underneath so a CUDA profiler sees the same name.
    ``links`` carries OTHER trace ids this span fans in (the
    coalesced-batch → member-request edges)."""
    parent = _stack.get()
    ctx = tracectx.current_context() if not parent else None
    tid_ = trace_id or (
        parent[-1].trace_id if parent
        else (ctx.trace_id if ctx is not None else new_trace_id())
    )
    span_id = tracectx.new_span_id()
    if parent:
        parent_span_id = parent[-1].span_id or None
    elif ctx is not None and ctx.trace_id == tid_:
        parent_span_id = ctx.span_id
    else:
        parent_span_id = None
    token = _stack.set(parent + (_ActiveSpan(name, tid_, span_id),))
    rng = TraceRange(name, color)
    rng.__enter__()
    t0 = time.perf_counter()
    active_handle = _activate(name, tid_, t0, span_id=span_id,
                              parent_span_id=parent_span_id)
    error_type: Optional[str] = None
    try:
        yield tid_
    except BaseException as exc:
        error_type = type(exc).__name__
        raise
    finally:
        t1 = time.perf_counter()
        _deactivate(active_handle)
        rng.__exit__(None, None, None)
        _stack.reset(token)
        args = dict(attrs)
        if error_type is not None:
            args["error"] = error_type
        _recorder.record(
            SpanEvent(
                name=name,
                ts_us=t0 * 1e6,
                dur_us=(t1 - t0) * 1e6,
                trace_id=tid_,
                depth=len(parent),
                tid=threading.get_ident(),
                color=getattr(color, "name", None),
                args=args,
                span_id=span_id,
                parent_span_id=parent_span_id,
                links=tuple(links),
            )
        )


# -- trace-tree assembly -----------------------------------------------------


def _span_node(e: SpanEvent, link: bool = False) -> Dict[str, Any]:
    node: Dict[str, Any] = {
        "name": e.name,
        "trace_id": e.trace_id,
        "span_id": e.span_id,
        "parent_span_id": e.parent_span_id,
        "start_us": round(e.ts_us, 3),
        "duration_ms": round(e.dur_us / 1000.0, 6),
        "tid": e.tid,
        "children": [],
    }
    if e.args:
        node["args"] = dict(e.args)
    if e.links:
        node["links"] = list(e.links)
    if link:
        node["link"] = True  # fanned in from another trace
    return node


def _build_forest(events: List[SpanEvent], link: bool = False
                  ) -> List[Dict[str, Any]]:
    """Events of ONE trace → root nodes (children nested, sorted by
    start). A parent missing from the ring (still open, or evicted)
    promotes its children to roots — assembly degrades, never fails."""
    nodes = {e.span_id: _span_node(e, link=link)
             for e in events if e.span_id}
    roots: List[Dict[str, Any]] = []
    for e in sorted(events, key=lambda ev: ev.ts_us):
        node = nodes.get(e.span_id)
        if node is None:
            continue
        parent = nodes.get(e.parent_span_id) if e.parent_span_id else None
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    return roots


def assemble_trace(trace_id: str,
                   recorder: Optional[SpanRecorder] = None
                   ) -> Dict[str, Any]:
    """One request's trace tree from the span ring.

    Spans whose ``trace_id`` matches nest by ``parent_span_id``; spans in
    OTHER traces that ``links``-reference this trace (the coalesced batch
    span and everything under it) are grafted under the request's root
    marked ``"link": true``, so the returned document is ONE tree
    spanning server → queue → batch."""
    rec = recorder or _recorder
    open_entries: List[Dict[str, Any]] = []
    if rec is _recorder:
        # Snapshot the OPEN-span table BEFORE the ring: a span exiting
        # between the two reads then lands in the ring snapshot — the
        # other order would miss it in both.
        with _active_lock:
            open_entries = [dict(e) for e in _active.values()
                            if e["trace_id"] == trace_id
                            and e.get("span_id")]
    events = rec.events()
    own = [e for e in events if e.trace_id == trace_id]
    if open_entries:
        # graft still-open spans in as provisional nodes (duration so
        # far, marked "open"); a span that exited between the snapshots
        # is in both, and the recorded event wins
        now = time.perf_counter()
        have = {e.span_id for e in own}
        for entry in open_entries:
            if entry["span_id"] in have:
                continue
            own.append(SpanEvent(
                name=entry["name"],
                ts_us=entry["t0"] * 1e6,
                dur_us=max(now - entry["t0"], 0.0) * 1e6,
                trace_id=trace_id,
                depth=0,
                tid=entry["tid"],
                args={"open": True},
                span_id=entry["span_id"],
                parent_span_id=entry.get("parent_span_id"),
            ))
    linked_trace_ids: List[str] = []
    for e in events:
        if e.links and trace_id in e.links and e.trace_id and \
                e.trace_id != trace_id and e.trace_id not in linked_trace_ids:
            linked_trace_ids.append(e.trace_id)
    roots = _build_forest(own)
    linked_forest: List[Dict[str, Any]] = []
    for linked_tid in linked_trace_ids:
        linked_events = [e for e in events if e.trace_id == linked_tid]
        linked_forest.extend(_build_forest(linked_events, link=True))
    if roots and linked_forest:
        roots[0]["children"].extend(linked_forest)
        linked_forest = []

    def _count(nodes):
        return sum(1 + _count(n["children"]) for n in nodes)

    doc: Dict[str, Any] = {
        "trace_id": trace_id,
        "span_count": _count(roots) + _count(linked_forest),
        "spans": roots,
    }
    if linked_forest:  # no own root to graft under (ring rolled over)
        doc["linked"] = linked_forest
    return doc


def recent_traces(limit: int = 20,
                  recorder: Optional[SpanRecorder] = None,
                  name_prefix=None
                  ) -> List[Dict[str, Any]]:
    """Summaries of the most recent distinct traces in the ring (newest
    first): ``{trace_id, root, spans, started_us, duration_ms, links}``.
    ``name_prefix`` (a string or tuple of strings) keeps only traces
    whose earliest span name starts with it."""
    rec = recorder or _recorder
    by_trace: Dict[str, List[SpanEvent]] = {}
    order: List[str] = []
    for e in rec.events():
        if not e.trace_id:
            continue
        if e.trace_id not in by_trace:
            by_trace[e.trace_id] = []
            order.append(e.trace_id)
        by_trace[e.trace_id].append(e)
    out: List[Dict[str, Any]] = []
    for tid in reversed(order):
        events = by_trace[tid]
        root = min(events, key=lambda ev: ev.ts_us)
        if name_prefix and not root.name.startswith(name_prefix):
            continue
        t0 = min(e.ts_us for e in events)
        t1 = max(e.ts_us + e.dur_us for e in events)
        links: List[str] = []
        for e in events:
            links.extend(lk for lk in e.links if lk not in links)
        out.append({
            "trace_id": tid,
            "root": root.name,
            "spans": len(events),
            "started_us": round(t0, 3),
            "duration_ms": round((t1 - t0) / 1000.0, 6),
            "links": links,
        })
        if len(out) >= limit:
            break
    return out


def trace_dir() -> Optional[str]:
    return os.environ.get(TRACE_DIR_ENV) or None


def maybe_export_trace(trace_id: str, label: str) -> Optional[str]:
    """Write one trace's spans as Chrome-trace JSON when the env gate is
    set. Returns the written path, or None (gate unset / export failed —
    trace export must never break its caller)."""
    directory = trace_dir()
    if not directory:
        return None
    try:
        os.makedirs(directory, exist_ok=True)
        safe_label = "".join(
            c if (c.isalnum() or c in "-_") else "_" for c in label
        )
        path = os.path.join(
            directory, f"trace_{safe_label}_{trace_id}.json"
        )
        return _recorder.export_chrome_trace(path, trace_id=trace_id)
    except Exception:
        return None


__all__ = [
    "SpanEvent",
    "SpanRecorder",
    "TRACE_DIR_ENV",
    "active_spans",
    "assemble_trace",
    "current_span_id",
    "current_trace_id",
    "get_recorder",
    "maybe_export_trace",
    "recent_traces",
    "record_event",
    "span",
    "trace_dir",
    "utcnow_iso",
]
