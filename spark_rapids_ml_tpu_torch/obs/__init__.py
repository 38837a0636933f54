"""Observability for the port's fit and serving paths: the metrics
registry (``obs.metrics``), its quantile sketches (``obs.quantiles``),
per-fit reports (``obs.report``: ``observed_fit`` /
``fit_instrumentation`` → ``fit_report_``), the instrumented transform
path and the pipelined serving program contract (``obs.serving``:
``observed_transform`` → ``transform_report_``, the numerics sentinel),
device-memory watermarks (``obs.memory``), request trace
context (``obs.tracectx``), structured spans assembled into per-request
trees (``obs.spans``), SLO burn-rate objectives (``obs.slo``), the
metrics-history store and its sampler (``obs.tsdb``), the per-device
monitor (``obs.devmon``) over the allocator's memory readings
(``obs.memory``), structured JSON logging (``obs.logging``), the flight
recorder and its watchdog (``obs.flight``), on-demand ``torch.profiler``
captures (``obs.profiler``), the retention sweeper for their on-disk
artifacts (``obs.retention``), and the auto-incident engine: robust
statistics (``obs.robust``), online detectors (``obs.anomaly``) and the
incident lifecycle with its evidence bundles (``obs.incidents``), and the
fit-path monitor (``obs.fitmon``: per-step rows/s, device time and MFU
against the card's peak from ``obs.xprof``, the backend watchdog)."""

from spark_rapids_ml_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    DEFAULT_BUCKETS,
    Gauge,
    Histogram,
    MetricsRegistry,
    Summary,
    get_registry,
)
from spark_rapids_ml_tpu_torch.obs.memory import (  # noqa: F401
    device_memory_stats,
    host_current_rss_bytes,
    host_peak_rss_bytes,
    memory_watermarks,
    peak_bytes_in_use,
    record_memory_metrics,
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
    active_spans,
    assemble_trace,
    current_span_id,
    current_trace_id,
    get_recorder,
    maybe_export_trace,
    new_trace_id,
    recent_traces,
    record_event,
    span,
)
from spark_rapids_ml_tpu_torch.obs.flight import (  # noqa: F401
    DUMP_DIR_ENV,
    FIT_BUDGET_ENV,
    TRANSFORM_BUDGET_ENV,
    Watchdog,
    build_dump,
    deadline,
    dump,
    dump_dir,
    get_watchdog,
)
from spark_rapids_ml_tpu_torch.obs import flight  # noqa: F401
from spark_rapids_ml_tpu_torch.obs.logging import (  # noqa: F401
    StructuredLogger,
    get_logger,
)
from spark_rapids_ml_tpu_torch.obs.anomaly import (  # noqa: F401
    Detector,
    Finding,
    MadSpikeDetector,
    RateOfChangeDetector,
    ThresholdDetector,
    builtin_detectors,
)
from spark_rapids_ml_tpu_torch.obs.incidents import (  # noqa: F401
    Incident,
    IncidentEngine,
    IncidentManager,
    get_incident_engine,
    reset_incident_engine,
)
from spark_rapids_ml_tpu_torch.obs import retention  # noqa: F401
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
from spark_rapids_ml_tpu_torch.obs import profiler  # noqa: F401
from spark_rapids_ml_tpu_torch.obs.fitmon import (  # noqa: F401
    BackendWatchdog,
    FitMonitor,
    FitRun,
    StepMonitor,
    current_run,
    debug_fit_doc,
    detect_stragglers,
    device_peaks,
    fit_report,
    fit_run,
    get_fit_monitor,
    reset_fitmon,
    roofline_bound,
    step_mfu,
)
from spark_rapids_ml_tpu_torch.obs.xprof import (  # noqa: F401
    analytic_mfu,
    peak_flops_per_second,
    record_execution,
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
from spark_rapids_ml_tpu_torch.obs.report import (  # noqa: F401
    FitContext,
    FitReport,
    REPORT_ATTR,
    attach_report,
    current_fit,
    fit_instrumentation,
    last_fit_report,
    observed_fit,
)
from spark_rapids_ml_tpu_torch.obs.serving import (  # noqa: F401
    NUMERICS_SAMPLE_ENV,
    TRANSFORM_REPORT_ATTR,
    TransformContext,
    TransformReport,
    check_output_numerics,
    current_transform,
    last_transform_report,
    latency_quantiles,
    observed_transform,
    transform_phase,
)
from spark_rapids_ml_tpu_torch.utils.health import (  # noqa: F401
    DeviceHealth,
    check_devices,
    check_devices_subprocess,
)

__all__ = [
    "BURN_POLICIES",
    "BackendWatchdog",
    "Counter",
    "DEFAULT_BUCKETS",
    "DUMP_DIR_ENV",
    "Detector",
    "DeviceHealth",
    "DeviceMonitor",
    "FIT_BUDGET_ENV",
    "Finding",
    "FitContext",
    "FitMonitor",
    "FitReport",
    "FitRun",
    "Gauge",
    "Histogram",
    "Incident",
    "IncidentEngine",
    "IncidentManager",
    "MadSpikeDetector",
    "MetricsRegistry",
    "MetricsSampler",
    "NUMERICS_SAMPLE_ENV",
    "REPORT_ATTR",
    "RateOfChangeDetector",
    "SLO",
    "SloSet",
    "SpanEvent",
    "SpanRecorder",
    "StepMonitor",
    "StructuredLogger",
    "Summary",
    "TRACEPARENT_HEADER",
    "TRANSFORM_BUDGET_ENV",
    "TRANSFORM_REPORT_ATTR",
    "ThresholdDetector",
    "TimeSeriesStore",
    "TraceContext",
    "TransformContext",
    "TransformReport",
    "Watchdog",
    "WindowedCounts",
    "activate",
    "active_spans",
    "analytic_mfu",
    "assemble_trace",
    "attach_report",
    "build_dump",
    "builtin_detectors",
    "capture",
    "check_devices",
    "check_devices_subprocess",
    "check_output_numerics",
    "current_context",
    "current_fit",
    "current_run",
    "current_span_id",
    "current_trace_id",
    "current_transform",
    "deadline",
    "debug_fit_doc",
    "default_slos",
    "detect_stragglers",
    "device_memory_stats",
    "device_peaks",
    "dump",
    "dump_dir",
    "ensure_context",
    "fit_instrumentation",
    "fit_report",
    "fit_run",
    "flight",
    "get_device_monitor",
    "get_fit_monitor",
    "get_incident_engine",
    "get_logger",
    "get_recorder",
    "get_registry",
    "get_sampler",
    "get_tsdb",
    "get_watchdog",
    "host_current_rss_bytes",
    "host_peak_rss_bytes",
    "inflight_request",
    "inflight_requests",
    "last_fit_report",
    "last_transform_report",
    "latency_quantiles",
    "maybe_export_trace",
    "memory_watermarks",
    "new_context",
    "new_span_id",
    "new_trace_id",
    "observed_fit",
    "observed_transform",
    "parse_traceparent",
    "peak_bytes_in_use",
    "peak_flops_per_second",
    "profiler",
    "recent_traces",
    "record_event",
    "record_execution",
    "record_memory_metrics",
    "reset_fitmon",
    "reset_incident_engine",
    "retention",
    "roofline_bound",
    "severity_for_burn",
    "span",
    "start_sampling",
    "step_mfu",
    "stop_sampling",
    "traced_thread",
    "transform_phase",
]
