"""Observability for the port's serving path: the metrics registry
(``obs.metrics``), its quantile sketches (``obs.quantiles``), the
pipelined serving program contract (``obs.serving``), request trace
context (``obs.tracectx``), structured spans assembled into per-request
trees (``obs.spans``), SLO burn-rate objectives (``obs.slo``), the
metrics-history store and its sampler (``obs.tsdb``), and the per-device
monitor (``obs.devmon``) over the allocator's memory readings
(``obs.memory``)."""

from spark_rapids_ml_tpu_torch.obs.metrics import get_registry  # noqa: F401
from spark_rapids_ml_tpu_torch.obs.memory import (  # noqa: F401
    device_memory_stats,
    host_current_rss_bytes,
    host_peak_rss_bytes,
)
from spark_rapids_ml_tpu_torch.obs.slo import (  # noqa: F401
    BURN_POLICIES,
    SLO,
    SloSet,
    WindowedCounts,
    default_slos,
    severity_for_burn,
)
from spark_rapids_ml_tpu_torch.obs.spans import (  # noqa: F401
    SpanEvent,
    SpanRecorder,
    assemble_trace,
    current_span_id,
    current_trace_id,
    get_recorder,
    new_trace_id,
    recent_traces,
    record_event,
    span,
)
from spark_rapids_ml_tpu_torch.obs.tsdb import (  # noqa: F401
    MetricsSampler,
    TimeSeriesStore,
    get_sampler,
    get_tsdb,
    start_sampling,
    stop_sampling,
)
from spark_rapids_ml_tpu_torch.obs.devmon import (  # noqa: F401
    DeviceMonitor,
    get_device_monitor,
)
from spark_rapids_ml_tpu_torch.obs.tracectx import (  # noqa: F401
    TRACEPARENT_HEADER,
    TraceContext,
    activate,
    capture,
    current_context,
    ensure_context,
    inflight_request,
    inflight_requests,
    new_context,
    new_span_id,
    parse_traceparent,
    traced_thread,
)

__all__ = [
    "BURN_POLICIES",
    "DeviceMonitor",
    "MetricsSampler",
    "SLO",
    "SloSet",
    "SpanEvent",
    "SpanRecorder",
    "TRACEPARENT_HEADER",
    "TimeSeriesStore",
    "TraceContext",
    "WindowedCounts",
    "activate",
    "assemble_trace",
    "capture",
    "current_context",
    "current_span_id",
    "current_trace_id",
    "default_slos",
    "device_memory_stats",
    "ensure_context",
    "get_device_monitor",
    "get_recorder",
    "get_registry",
    "get_sampler",
    "get_tsdb",
    "host_current_rss_bytes",
    "host_peak_rss_bytes",
    "inflight_request",
    "inflight_requests",
    "new_context",
    "new_span_id",
    "new_trace_id",
    "parse_traceparent",
    "recent_traces",
    "record_event",
    "severity_for_burn",
    "span",
    "start_sampling",
    "stop_sampling",
    "traced_thread",
]
