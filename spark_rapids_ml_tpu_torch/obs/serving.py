"""Serving-side observability: the instrumented transform path.

The port's copy of the JAX package's ``obs/serving.py``. Every public
``transform`` in ``models/`` is wrapped in ``@observed_transform("<algo>")``
(held by ``tests/test_torch_obs_transform.py``), producing:

* a ``TransformReport`` per call — rows, batches, bytes in/out and the
  device-put / compute / host-sync phase split (bodies record phases via
  ``transform_phase(...)``);
* per-call latency into a mergeable streaming quantile sketch
  (``obs.quantiles``) behind a ``Summary`` metric, so the registry reports
  true p50/p95/p99 per algo, beside the fixed-bucket
  ``sparkml_transform_seconds`` histogram;
* a **numerics sentinel**: a cheap NaN/Inf/all-zero check over the new
  output columns (sampled through ``SPARK_RAPIDS_ML_TORCH_NUMERICS_SAMPLE``),
  counted per algo — a model silently emitting NaNs under traffic is an
  outage, not a curiosity;
* the ``obs.flight`` watchdog armed around every call
  (``SPARK_RAPIDS_ML_TORCH_TRANSFORM_BUDGET_SECONDS``, default 120 s), so
  a wedged serving call produces a flight dump instead of a silent hang.

The pipelined serving path runs around the decorated entry points, so it
keeps the program contract (``ServingProgram``: put / run / fetch) and
files the same per-batch record through ``PipelineTransform``.

Nothing compiles in eager PyTorch: a report's ``compiles`` /
``recompiles`` / ``compile_seconds`` stay 0. ``analytic_flops`` sums what
programs file through ``obs.xprof.record_execution`` during the call; no
transform path runs a counted program (only the fit's Gram is counted), so
it stays None.

Delegation shims (``Model.transform`` → ``self._transform``, both
decorated) are deduplicated by instance identity: re-entering the
decorator on the *same* object extends the open report instead of
double-counting the call. Distinct nested models each get their own
report, tagged with the parent algo.

Telemetry never breaks a transform: everything outside the wrapped call
is exception-guarded, mirroring ``obs.report``.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import os
import random
import re
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np

from spark_rapids_ml_tpu_torch.obs import spans
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor

TRANSFORM_REPORT_ATTR = "transform_report_"
NUMERICS_SAMPLE_ENV = "SPARK_RAPIDS_ML_TORCH_NUMERICS_SAMPLE"
LATENCY_SUMMARY = "sparkml_transform_latency_seconds"
LATENCY_QUANTILES = (0.5, 0.95, 0.99)
SKETCH_ALPHA = 0.01
# Sentinel cost ceiling: never isnan/isinf more than this many rows per
# call — large batches are strided down to the cap.
_SENTINEL_ROW_CAP = 65536


def numerics_sample_rate() -> float:
    """Fraction of transform calls whose outputs get the numerics check
    (default 1.0 — the check is vectorized and row-capped; set 0 to
    disable, 0.01 to spot-check one call in a hundred under load)."""
    try:
        rate = float(os.environ.get(NUMERICS_SAMPLE_ENV, "1.0"))
    except ValueError:
        return 1.0
    return min(max(rate, 0.0), 1.0)


# -- the per-call report ---------------------------------------------------


@dataclass
class TransformReport:
    """The uniform per-transform observability artifact (the serving-side
    sibling of ``FitReport``)."""

    algo: str
    trace_id: str
    started_utc: str
    wall_seconds: float
    span_id: Optional[str] = None
    phases: Dict[str, float] = field(default_factory=dict)
    rows: Optional[int] = None
    features: Optional[int] = None
    batches: int = 1
    bytes_in: Optional[int] = None
    bytes_out: Optional[int] = None
    rows_per_second: Optional[float] = None
    # compile attribution: 0 in eager PyTorch (kept for the JAX report's keys)
    compiles: int = 0
    recompiles: int = 0
    compile_seconds: float = 0.0
    analytic_flops: Optional[float] = None
    # numerics sentinel verdict for this call (None: not sampled/no arrays)
    numerics: Optional[Dict[str, Any]] = None
    nested_in: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    # The registry sketch for this algo rides along as a plain attribute
    # (set when the report is recorded, not a dataclass field) so
    # quantiles resolve LAZILY: the hot path pays nothing per call.

    @property
    def latency_quantiles(self) -> Dict[str, Optional[float]]:
        """Registry-wide sketch-backed p50/p95/p99 for this algo, resolved
        at read time."""
        sketch = getattr(self, "_sketch", None)
        if sketch is None:
            return {}
        return sketch.quantiles(LATENCY_QUANTILES)

    def as_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["latency_quantiles"] = self.latency_quantiles
        return d

    def _quantile(self, q: float) -> Optional[float]:
        sketch = getattr(self, "_sketch", None)
        return sketch.quantile(q) if sketch is not None else None

    @property
    def p50(self) -> Optional[float]:
        return self._quantile(0.5)

    @property
    def p95(self) -> Optional[float]:
        return self._quantile(0.95)

    @property
    def p99(self) -> Optional[float]:
        return self._quantile(0.99)


class TransformContext:
    """Mutable accounting for one in-flight transform call.

    Obtained inside an instrumented body via ``current_transform()``;
    bodies record phases (``with ctx.phase("device_put"): ...``) and may
    override the inferred data stats.
    """

    __slots__ = (
        "algo", "trace_id", "span_id", "timer", "rows", "features",
        "bytes_in", "bytes_out", "analytic_flops", "extra",
        "owner_id", "explicit", "nested_in", "_lock",
    )

    def __init__(self, algo: str, trace_id: Optional[str] = None,
                 owner_id: Optional[int] = None, explicit: bool = True,
                 nested_in: Optional[str] = None):
        self.algo = algo
        self.trace_id = trace_id or spans.new_trace_id()
        self.span_id: Optional[str] = None
        self.timer = PhaseTimer()
        self.rows: Optional[int] = None
        self.features: Optional[int] = None
        self.bytes_in: Optional[int] = None
        self.bytes_out: Optional[int] = None
        self.analytic_flops = 0.0
        self.extra: Dict[str, Any] = {}
        self.owner_id = owner_id
        self.explicit = explicit
        self.nested_in = nested_in
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a named serving phase AND emit a nested trace span."""
        with self.timer.phase(name), spans.span(
            f"{self.algo}:{name}", TraceColor.PURPLE
        ):
            yield

    def record_program(self, label: str, flops: Optional[float],
                       nbytes: Optional[float]) -> None:
        """Called by ``obs.xprof.record_execution`` on every counted
        program execution during this call."""
        with self._lock:
            if flops:
                self.analytic_flops += float(flops)

    def set_data(self, rows: Optional[int] = None,
                 features: Optional[int] = None,
                 nbytes: Optional[int] = None) -> None:
        if rows is not None:
            self.rows = int(rows)
        if features is not None:
            self.features = int(features)
        if nbytes is not None:
            self.bytes_in = int(nbytes)

    def note(self, **kwargs) -> None:
        self.extra.update(kwargs)


class _NullTransformContext(TransformContext):
    """No-op context so bodies may call ``current_transform()``
    unconditionally, even outside any instrumented entry point."""

    def __init__(self):
        super().__init__("_unobserved")

    @contextlib.contextmanager
    def phase(self, name: str):
        yield

    def record_program(self, *args, **kwargs) -> None:
        pass

    def set_data(self, *args, **kwargs) -> None:
        pass

    def note(self, **kwargs) -> None:
        pass


_NULL_CONTEXT = _NullTransformContext()
_current_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "sparkml_torch_transform_ctx", default=None
)

_last_reports: Dict[Optional[str], TransformReport] = {}
_last_lock = threading.Lock()


def current_transform() -> TransformContext:
    """The active call's context, or a no-op context outside any call."""
    ctx = _current_ctx.get()
    return ctx if ctx is not None else _NULL_CONTEXT


@contextlib.contextmanager
def transform_phase(name: str):
    """Sugar for ``current_transform().phase(name)`` — what instrumented
    bodies use to record the device-put/compute/host-sync split."""
    with current_transform().phase(name):
        yield


def last_transform_report(algo: Optional[str] = None
                          ) -> Optional[TransformReport]:
    """Most recent report (optionally for one algo) — the escape hatch for
    outputs the report cannot be attached to."""
    with _last_lock:
        return _last_reports.get(algo)


def _latency_summary():
    return get_registry().summary(
        LATENCY_SUMMARY, "transform/predict call latency", ("algo",),
        alpha=SKETCH_ALPHA, quantiles=LATENCY_QUANTILES,
    )


def latency_quantiles(algo: str) -> Dict[str, Optional[float]]:
    """Registry-wide sketch-backed ``{"p50", "p95", "p99"}`` latency
    (seconds) for one algo's instrumented transforms."""
    return _latency_summary().sketch(algo=algo).quantiles(LATENCY_QUANTILES)


# -- data-stat inference ---------------------------------------------------


def _array_nbytes(value) -> Optional[int]:
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    return None


def _dataset_stats(value) -> Dict[str, Optional[int]]:
    """(rows, features, nbytes) for an ndarray or VectorFrame-like input.

    Deliberately cheap: never materializes vector columns — list columns
    are estimated at 8 bytes/element, ndarray columns read ``nbytes``.
    """
    out: Dict[str, Optional[int]] = {
        "rows": None, "features": None, "nbytes": None
    }
    shape = getattr(value, "shape", None)
    if isinstance(shape, tuple) and shape:
        out["rows"] = int(shape[0])
        out["features"] = int(shape[1]) if len(shape) > 1 else None
        out["nbytes"] = _array_nbytes(value)
        return out
    columns = getattr(value, "columns", None)
    column = getattr(value, "column", None)
    if callable(columns):
        columns = None  # Spark DataFrames: columns is an attr, ours too
    if not columns:
        return out
    try:
        out["rows"] = len(value)
    except TypeError:
        # pyspark DataFrames have no len(); counting would run the query
        return out
    if callable(column):
        total = 0
        for name in columns:
            try:
                col = column(name)
            except Exception:
                continue
            nbytes = _array_nbytes(col)
            if nbytes is None:
                # list column: 8 bytes per ELEMENT — vector rows carry
                # len(first) elements each, scalar rows one
                width = 1
                try:
                    first = col[0]
                    if hasattr(first, "__len__"):
                        width = max(len(first), 1)
                except (IndexError, KeyError, TypeError):
                    pass
                nbytes = out["rows"] * width * 8
            total += nbytes
        out["nbytes"] = total
    return out


# -- numerics sentinel -----------------------------------------------------


def _sample_rows(col):
    """A row-capped view/copy of a column for the sentinel check."""
    n = len(col)
    if n <= _SENTINEL_ROW_CAP:
        return col
    step = -(-n // _SENTINEL_ROW_CAP)  # ceil div: stride over the batch
    return col[::step]


def _as_numeric_matrix(col) -> Optional[np.ndarray]:
    """A float ndarray for one sampled output column, or None for
    non-numeric data (strings, token arrays, itemset lists...)."""
    try:
        if isinstance(col, np.ndarray):
            if not np.issubdtype(col.dtype, np.number):
                return None
            return col if np.issubdtype(col.dtype, np.floating) \
                else col.astype(np.float64, copy=False)
        rows = list(col)
        if not rows:
            return None
        first = rows[0]
        if hasattr(first, "toArray"):
            rows = [r.toArray() for r in rows]
        arr = np.asarray(rows, dtype=np.float64)
        if arr.dtype.kind not in "fc":
            return None
        return arr
    except (TypeError, ValueError):
        return None


# Column-name getters models expose for their INPUT columns; the sentinel
# never judges carried-over inputs, only what the model produced. The
# port's models have one (the JAX list adds the getters of its other
# families: extend it as they are ported).
_INPUT_COL_GETTERS = ("getInputCol",)


def _model_input_columns(model) -> List[str]:
    out: List[str] = []
    for getter in _INPUT_COL_GETTERS:
        fn = getattr(model, getter, None)
        if not callable(fn):
            continue
        try:
            name = fn()
        except Exception:
            continue
        if isinstance(name, str) and name:
            out.append(name)
    return out


def check_output_numerics(result, input_columns=()) -> Optional[
        Dict[str, Any]]:
    """The sentinel core: NaN / Inf / all-zero verdict over a transform's
    NEW output columns (or the raw prediction array).

    Returns ``{"checked_rows", "nan_rows", "inf_rows", "all_zero",
    "columns"}`` or None when the output carries nothing checkable.
    Row-capped by striding — cost is bounded regardless of batch size.
    """
    targets: List[Any] = []
    names: List[str] = []
    if isinstance(result, np.ndarray):
        targets.append(result)
        names.append("<array>")
    else:
        columns = getattr(result, "columns", None)
        column = getattr(result, "column", None)
        if columns and not callable(columns) and callable(column):
            known = set(input_columns or ())
            for name in columns:
                if name in known:
                    continue
                try:
                    targets.append(column(name))
                    names.append(name)
                except Exception:
                    continue
    checked = 0
    nan_rows = 0
    inf_rows = 0
    all_zero = False
    checked_names: List[str] = []
    for name, col in zip(names, targets):
        matrix = _as_numeric_matrix(_sample_rows(col))
        if matrix is None or matrix.size == 0:
            continue
        flat = matrix.reshape(matrix.shape[0], -1) if matrix.ndim > 1 \
            else matrix.reshape(-1, 1)
        nan_mask = np.isnan(flat).any(axis=1)
        inf_mask = np.isinf(flat).any(axis=1)
        checked = max(checked, int(flat.shape[0]))
        nan_rows += int(nan_mask.sum())
        inf_rows += int(inf_mask.sum())
        if not np.any(flat):
            all_zero = True
        checked_names.append(name)
    if not checked_names:
        return None
    return {
        "checked_rows": checked,
        "nan_rows": nan_rows,
        "inf_rows": inf_rows,
        "all_zero": all_zero,
        "columns": checked_names,
    }


def _record_numerics(algo: str, verdict: Dict[str, Any]) -> None:
    reg = get_registry()
    reg.counter(
        "sparkml_numerics_checks_total",
        "transform outputs inspected by the numerics sentinel", ("algo",),
    ).inc(algo=algo)
    anomalies = reg.counter(
        "sparkml_numerics_anomalies_total",
        "anomalous transform outputs (rows with NaN/Inf) caught by the "
        "numerics sentinel", ("algo", "kind"),
    )
    if verdict["nan_rows"]:
        anomalies.inc(verdict["nan_rows"], algo=algo, kind="nan")
    if verdict["inf_rows"]:
        anomalies.inc(verdict["inf_rows"], algo=algo, kind="inf")
    if verdict["all_zero"]:
        # All-zero is a heads-up, not an anomaly: class-0 prediction
        # batches, cluster 0 and sparse binarized features are all
        # legitimately zero. Its own series keeps it watchable without
        # polluting the paging counter.
        reg.counter(
            "sparkml_numerics_all_zero_total",
            "all-zero transform output batches (informational — "
            "legitimately nonzero for label/sparse outputs)", ("algo",),
        ).inc(algo=algo)


def _maybe_check_numerics(report: TransformReport, result,
                          input_columns=()) -> None:
    """Run the sentinel on a sampled call and record its verdict."""
    rate = numerics_sample_rate()
    if result is None or rate <= 0 or (
            rate < 1.0 and random.random() >= rate):
        return
    verdict = check_output_numerics(result, input_columns)
    if verdict is not None:
        report.numerics = verdict
        _record_numerics(report.algo, verdict)


# -- report assembly / publication -----------------------------------------


_utcnow = spans.utcnow_iso

_CAMEL_RE = re.compile(r"(?<=[a-z0-9])(?=[A-Z])")


def _derive_algo(obj) -> str:
    """A metrics-label-safe algo name from the instance's class:
    ``StandardScalerModel`` → ``standard_scaler``."""
    name = type(obj).__name__.lstrip("_")
    for suffix in ("Model", "Adapter"):
        if name.endswith(suffix) and len(name) > len(suffix):
            name = name[: -len(suffix)]
    return _CAMEL_RE.sub("_", name).lower()


def _build_report(ctx: TransformContext, started: str,
                  wall: float) -> TransformReport:
    phases = ctx.timer.as_dict()
    phases.setdefault("total", wall)
    rows_per_second = None
    if ctx.rows and wall > 0:
        rows_per_second = ctx.rows / wall
    return TransformReport(
        algo=ctx.algo,
        trace_id=ctx.trace_id,
        started_utc=started,
        wall_seconds=wall,
        span_id=ctx.span_id,
        phases=phases,
        rows=ctx.rows,
        features=ctx.features,
        bytes_in=ctx.bytes_in,
        bytes_out=ctx.bytes_out,
        rows_per_second=rows_per_second,
        analytic_flops=ctx.analytic_flops or None,
        nested_in=ctx.nested_in,
        extra=dict(ctx.extra),
    )


def _record_error(algo: str, error: BaseException) -> None:
    """Failed calls count per algo and exception type, and never feed the
    success sketch: flat transforms with a healthy p99 must not read as
    "no traffic" during an outage."""
    get_registry().counter(
        "sparkml_transform_errors_total",
        "transform/predict calls that raised", ("algo", "error"),
    ).inc(algo=algo, error=type(error).__name__)


def _record_metrics(report: TransformReport) -> None:
    reg = get_registry()
    algo = report.algo
    reg.counter(
        "sparkml_transforms_total", "completed transform/predict calls",
        ("algo",),
    ).inc(algo=algo)
    # Fixed-bucket histogram AND sketch summary: buckets for rate queries,
    # the sketch for true percentiles.
    reg.histogram(
        "sparkml_transform_seconds", "transform/predict wall-clock seconds",
        ("algo",),
    ).observe(report.wall_seconds, algo=algo)
    summary = _latency_summary()
    # trace-id exemplar: a worsening p99 names the exact calls behind it
    summary.observe(report.wall_seconds, trace_id=report.trace_id,
                    algo=algo)
    report._sketch = summary.sketch(algo=algo)  # lazy quantile source
    if report.rows:
        reg.counter(
            "sparkml_rows_transformed_total", "rows seen by transforms",
            ("algo",),
        ).inc(report.rows, algo=algo)
    if report.bytes_in:
        reg.counter(
            "sparkml_transform_bytes_in_total",
            "input bytes seen by transforms", ("algo",),
        ).inc(report.bytes_in, algo=algo)
    if report.bytes_out:
        reg.counter(
            "sparkml_transform_bytes_out_total",
            "output bytes produced by transforms", ("algo",),
        ).inc(report.bytes_out, algo=algo)


def _publish(report: TransformReport) -> None:
    with _last_lock:
        _last_reports[report.algo] = report
        _last_reports[None] = report
    spans.maybe_export_trace(report.trace_id, f"transform_{report.algo}")


def _flight_deadline(algo: str, trace_id: str):
    try:
        from spark_rapids_ml_tpu_torch.obs import flight

        return flight.deadline(
            f"transform:{algo}",
            budget_seconds=flight.transform_budget_seconds(),
            trace_id=trace_id,
        )
    except Exception:
        return contextlib.nullcontext()


# -- the pipelined serving path --------------------------------------------


class ServingProgram(NamedTuple):
    """A model's device-resident serving program for the pipelined
    micro-batcher (``serve.batching``), split into three steps:

    * ``put(host_matrix) → device batch`` — start the host→device copy of
      a staged (bucket, d) batch (on the card: a copy stream, pinned
      source, ``non_blocking``, an event recorded after it);
    * ``run(device batch) → device result`` — launch the product on the
      compute stream, which first waits on the copy's event; no host sync;
    * ``fetch(device result) → np.ndarray`` — the only host sync: a
      device→host copy and a wait on its event, then ``fetch_dtype``.

    ``dtype`` is the numpy dtype the batcher stages requests in;
    ``algo`` labels the per-batch record; ``precision`` names the ladder
    (native / bf16 / int8); ``device`` is where the weights live;
    ``prime`` is a compile-without-execute hook, None here (nothing to
    compile ahead); ``weight_bytes`` the device bytes of the staged
    weights.
    """

    put: Callable[[np.ndarray], Any]
    run: Callable[[Any], Any]
    fetch: Callable[[Any], np.ndarray]
    dtype: Any
    algo: str
    precision: str = "native"
    prime: Optional[Callable[[Any], bool]] = None
    weight_bytes: int = 0
    device: Any = None


class DeviceBatch(NamedTuple):
    """What ``ServingProgram.put`` returns: the batch on the device and
    the event its copy recorded (None where the copy is synchronous). The
    batcher ties its staging slot's reuse to ``copied``."""

    tensor: Any
    copied: Any = None


class PipelineTransform:
    """Per-batch observability for the pipelined serving path.

    The pipeline runs AROUND the models' decorated ``transform`` entry
    points (the decorator's blocking call shape cannot span a
    stage/dispatch/sync split that interleaves across batches), so this
    object replaces it batch for batch: the same ``TransformReport``, the
    same latency sketch (with the batch's trace id as its exemplar), the
    same numerics sentinel — with the phase split attributed as ``stage``
    (pad + host→device copy), ``dispatch`` (the launch) and ``sync`` (the
    completion step's host sync) instead of device_put/compute/host_sync.
    ``dispatch_scope`` activates the batch's context around the launch;
    nothing compiles in eager PyTorch, so the report's compile fields stay
    0. Telemetry never breaks serving: ``finish`` is exception-guarded end
    to end.
    """

    __slots__ = ("_ctx", "_started", "_t0")

    def __init__(self, algo: str, trace_id: Optional[str] = None,
                 precision: str = "native"):
        self._ctx = TransformContext(algo, trace_id=trace_id)
        if precision and precision != "native":
            self._ctx.note(precision=precision)
        self._ctx.note(pipelined=True)
        self._started = _utcnow()
        self._t0 = time.perf_counter()

    def add_phase(self, name: str, seconds: float) -> None:
        """Accumulate one pre-measured pipeline phase (stage / dispatch /
        sync) into the report's phase split."""
        try:
            self._ctx.timer.add(name, seconds)
        except Exception:
            pass

    @contextlib.contextmanager
    def dispatch_scope(self):
        """Activate this batch's context around the launch, so what the
        dispatched body records through ``current_transform()`` lands in
        THIS batch's report."""
        token = _current_ctx.set(self._ctx)
        try:
            yield self._ctx
        finally:
            _current_ctx.reset(token)

    def finish(self, result: Optional[np.ndarray] = None, *,
               rows: Optional[int] = None,
               features: Optional[int] = None,
               bytes_in: Optional[int] = None,
               error: Optional[BaseException] = None,
               parent_span_id: Optional[str] = None,
               ) -> Optional[TransformReport]:
        """Close the batch: build/record/publish its TransformReport (or
        count the error — failed batches never feed the success sketch).
        Also files the batch's ``transform:<algo>`` span (externally
        timed, stage start → completion); ``parent_span_id`` nests it
        under the batcher's fan-in batch span."""
        try:
            ctx = self._ctx
            if error is not None:
                _record_error(ctx.algo, error)
                return None
            wall = time.perf_counter() - self._t0
            ctx.span_id = spans.record_event(
                f"transform:{ctx.algo}",
                self._t0, self._t0 + wall,
                trace_id=ctx.trace_id, parent_span_id=parent_span_id,
                rows=rows, pipelined=True,
            ).span_id
            ctx.set_data(rows=rows, features=features, nbytes=bytes_in)
            if result is not None and ctx.bytes_out is None:
                ctx.bytes_out = _array_nbytes(result)
            report = _build_report(ctx, self._started, wall)
            _maybe_check_numerics(report, result)
            _record_metrics(report)
            _publish(report)
            return report
        except Exception:
            return None  # telemetry must never break a serving batch


# -- the decorator ---------------------------------------------------------


def observed_transform(algo=None, *, check_numerics: bool = True):
    """Wrap a ``transform``/``predict`` method with the full serving
    instrumentation (see module doc).

    Usable with an explicit label (``@observed_transform("pca")``) or bare
    (``@observed_transform`` — the label derives from the class name at
    call time). ``check_numerics=False`` opts the entry point out of the
    NaN/Inf/all-zero sentinel, for models whose contract emits NaN.
    """
    if callable(algo):  # bare @observed_transform
        return _instrument(algo, None, check_numerics)

    def decorator(method):
        return _instrument(method, algo, check_numerics)

    return decorator


def _instrument(method, algo: Optional[str], check_numerics: bool = True):
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        parent = _current_ctx.get()
        if parent is not None and parent.owner_id == id(self):
            # Delegation shim (transform → _transform on the same object):
            # one call, one report. A decorated inner method may refine an
            # auto-derived label with its explicit one.
            if algo and not parent.explicit:
                parent.algo = algo
                parent.explicit = True
            return method(self, *args, **kwargs)
        name = algo or _derive_algo(self)
        ctx = TransformContext(
            name,
            trace_id=spans.current_trace_id(),
            owner_id=id(self),
            explicit=bool(algo),
            nested_in=parent.algo if parent is not None else None,
        )
        token = _current_ctx.set(ctx)
        started = _utcnow()
        t0 = time.perf_counter()
        try:
            with _flight_deadline(name, ctx.trace_id), spans.span(
                f"transform:{name}", TraceColor.PURPLE,
                trace_id=ctx.trace_id
            ), ctx.timer.phase("total"):
                ctx.span_id = spans.current_span_id()
                result = method(self, *args, **kwargs)
        except Exception as exc:
            try:
                _record_error(name, exc)
            except Exception:
                pass
            raise
        finally:
            _current_ctx.reset(token)
        wall = time.perf_counter() - t0
        try:
            dataset = args[0] if args else next(iter(kwargs.values()), None)
            if ctx.rows is None and dataset is not None:
                stats = _dataset_stats(dataset)
                ctx.set_data(rows=stats["rows"], features=stats["features"],
                             nbytes=stats["nbytes"])
            if ctx.bytes_out is None and result is not None:
                ctx.bytes_out = _dataset_stats(result)["nbytes"]
            report = _build_report(ctx, started, wall)
            if check_numerics:
                input_columns = getattr(dataset, "columns", None)
                if input_columns is None or callable(input_columns):
                    input_columns = ()
                input_columns = list(input_columns) + \
                    _model_input_columns(self)
                _maybe_check_numerics(report, result, input_columns)
            _record_metrics(report)
            _publish(report)
            try:
                setattr(self, TRANSFORM_REPORT_ATTR, report)
            except (AttributeError, TypeError):
                pass
            try:
                from spark_rapids_ml_tpu_torch.obs.report import (
                    attach_report,
                )

                result = attach_report(result, report,
                                       attr=TRANSFORM_REPORT_ATTR)
            except Exception:
                pass
        except Exception:
            pass  # telemetry must never break a transform
        return result

    wrapper.__obs_instrumented__ = algo or True
    return wrapper


__all__ = [
    "DeviceBatch",
    "LATENCY_QUANTILES",
    "LATENCY_SUMMARY",
    "NUMERICS_SAMPLE_ENV",
    "PipelineTransform",
    "ServingProgram",
    "TRANSFORM_REPORT_ATTR",
    "TransformContext",
    "TransformReport",
    "check_output_numerics",
    "current_transform",
    "last_transform_report",
    "latency_quantiles",
    "numerics_sample_rate",
    "observed_transform",
    "transform_phase",
]
