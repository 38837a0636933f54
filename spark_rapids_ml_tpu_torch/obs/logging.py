"""Structured JSON logging for library code.

The port's copy of the JAX package's ``obs/logging.py``. A bare print is
invisible to log shippers, carries no severity, and loses the request
identity that the tracing layer worked to thread through every queue.
This module is the sanctioned spelling — one JSON object per line,
machine-parseable, with the active ``TraceContext``'s trace id stamped
automatically so a log line lands next to its request's spans in
whatever aggregator reads the stream:

    {"ts": "...", "level": "info", "logger": "obs.flight",
     "message": "flight dump written", "trace_id": "…", "path": "…"}

Design constraints:

* stdlib only, and **never raises into the caller** — a logger that can
  crash a dying error path is worse than silence;
* the stream is resolved at emit time (default ``sys.stderr``), so
  pytest's capture and stream redirection both just work;
* level gate via ``SPARK_RAPIDS_ML_TORCH_LOG_LEVEL``
  (``debug``/``info``/``warning``/``error``, default ``info``);
* every emitted line is counted in ``sparkml_log_lines_total{level}``
  — log volume is itself a metric the history sampler can watch;
* **per-(level, logger) token-bucket rate limiting**: an incident
  storm emitting ERROR per sweep must not flood stderr into
  uselessness. Each (level, logger) pair gets a burst of
  ``SPARK_RAPIDS_ML_TORCH_LOG_BURST`` lines (default 50) refilled at
  ``SPARK_RAPIDS_ML_TORCH_LOG_RATE`` lines/sec (default 10; <= 0
  disables limiting). Dropped lines are counted in
  ``sparkml_log_suppressed_total{level,logger}`` — suppression is
  itself observable — and the first line emitted after a dry spell
  carries ``suppressed_lines=N`` so a reader of the raw stream sees
  the gap too.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

LEVEL_ENV = "SPARK_RAPIDS_ML_TORCH_LOG_LEVEL"
RATE_ENV = "SPARK_RAPIDS_ML_TORCH_LOG_RATE"
BURST_ENV = "SPARK_RAPIDS_ML_TORCH_LOG_BURST"

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}
_DEFAULT_LEVEL = "info"
_DEFAULT_RATE = 10.0
_DEFAULT_BURST = 50.0


def _threshold() -> int:
    raw = os.environ.get(LEVEL_ENV, _DEFAULT_LEVEL).strip().lower()
    return _LEVELS.get(raw, _LEVELS[_DEFAULT_LEVEL])


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class _TokenBucket:
    """One (level, logger)'s admission state: ``tokens`` refill at
    ``rate``/sec up to ``burst``; each emitted line spends one.
    ``dropped`` accumulates between admissions so the next emitted
    line can report the gap."""

    __slots__ = ("tokens", "last_refill", "dropped")

    def __init__(self, burst: float, now: float):
        self.tokens = burst
        self.last_refill = now
        self.dropped = 0

    def admit(self, rate: float, burst: float, now: float) -> bool:
        elapsed = max(now - self.last_refill, 0.0)
        self.last_refill = now
        self.tokens = min(self.tokens + elapsed * rate, burst)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        self.dropped += 1
        return False


class StructuredLogger:
    """One named logger emitting single-line JSON records.

    ``stream=None`` (the default) resolves ``sys.stderr`` at emit time;
    pass an open file-like to redirect (tests, log files).
    """

    def __init__(self, name: str, stream=None,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self._stream = stream
        self._clock = clock
        self._buckets: Dict[str, _TokenBucket] = {}
        self._buckets_lock = threading.Lock()

    def _admit(self, level: str) -> Tuple[bool, int]:
        """Token-bucket gate per (level, this logger): (emit?, lines
        suppressed since the last emitted one)."""
        rate = _env_float(RATE_ENV, _DEFAULT_RATE)
        if rate <= 0:
            return True, 0
        burst = max(_env_float(BURST_ENV, _DEFAULT_BURST), 1.0)
        now = self._clock()
        with self._buckets_lock:
            bucket = self._buckets.get(level)
            if bucket is None:
                bucket = _TokenBucket(burst, now)
                self._buckets[level] = bucket
            if bucket.admit(rate, burst, now):
                suppressed, bucket.dropped = bucket.dropped, 0
                return True, suppressed
        _count_suppressed(level, self.name)
        return False, 0

    def _emit(self, level: str, message: str,
              fields: Dict[str, Any]) -> None:
        if _LEVELS[level] < _threshold():
            return
        try:
            admitted, suppressed = self._admit(level)
            if not admitted:
                return
            record: Dict[str, Any] = {
                "ts": _utcnow(),
                "level": level,
                "logger": self.name,
                "message": message,
            }
            if suppressed:
                record["suppressed_lines"] = suppressed
            trace_id = _active_trace_id()
            if trace_id:
                record["trace_id"] = trace_id
            for key, value in fields.items():
                if key not in record:
                    record[key] = value
            line = json.dumps(record, default=str)
            stream = self._stream if self._stream is not None else sys.stderr
            stream.write(line + "\n")
            flush = getattr(stream, "flush", None)
            if callable(flush):
                flush()
            _count_line(level)
        except Exception:
            pass  # a logger must never raise into (or kill) its caller

    def debug(self, message: str, **fields) -> None:
        self._emit("debug", message, fields)

    def info(self, message: str, **fields) -> None:
        self._emit("info", message, fields)

    def warning(self, message: str, **fields) -> None:
        self._emit("warning", message, fields)

    def error(self, message: str, **fields) -> None:
        self._emit("error", message, fields)

    def log(self, level: str, message: str, **fields) -> None:
        if level not in _LEVELS:
            level = "info"
        self._emit(level, message, fields)


def _utcnow() -> str:
    from spark_rapids_ml_tpu_torch.obs.spans import utcnow_iso

    return utcnow_iso()


def _active_trace_id() -> Optional[str]:
    """The active request's trace id (activated ``TraceContext`` first,
    then the innermost open span), or None outside any request."""
    try:
        from spark_rapids_ml_tpu_torch.obs import tracectx

        ctx = tracectx.current_context()
        if ctx is not None:
            return ctx.trace_id
        from spark_rapids_ml_tpu_torch.obs import spans

        return spans.current_trace_id()
    except Exception:
        return None


def _count_line(level: str) -> None:
    try:
        from spark_rapids_ml_tpu_torch.obs.metrics import get_registry

        get_registry().counter(
            "sparkml_log_lines_total",
            "structured log lines emitted, by level", ("level",),
        ).inc(level=level)
    except Exception:
        pass


def _count_suppressed(level: str, logger_name: str) -> None:
    try:
        from spark_rapids_ml_tpu_torch.obs.metrics import get_registry

        # help text verbatim from the JAX package (the port's knobs are
        # RATE_ENV / BURST_ENV)
        get_registry().counter(
            "sparkml_log_suppressed_total",
            "structured log lines dropped by the per-(level,logger) "
            "token bucket (raise SPARK_RAPIDS_ML_TPU_LOG_RATE/"
            "_LOG_BURST, or fix the storm)", ("level", "logger"),
        ).inc(level=level, logger=logger_name)
    except Exception:
        pass


_loggers: Dict[str, StructuredLogger] = {}
_loggers_lock = threading.Lock()


def get_logger(name: str) -> StructuredLogger:
    """The process-wide logger for ``name`` (cached; one per name)."""
    with _loggers_lock:
        logger = _loggers.get(name)
        if logger is None:
            logger = StructuredLogger(name)
            _loggers[name] = logger
        return logger


__all__ = ["BURST_ENV", "LEVEL_ENV", "RATE_ENV", "StructuredLogger",
           "get_logger"]
