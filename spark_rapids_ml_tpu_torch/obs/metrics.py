"""Thread-safe metrics registry: counters, gauges, histograms and quantile
summaries.

The port's copy of the JAX package's ``obs/metrics.py``, less its
standalone scrape server (``GET /metrics`` is the serving server's):
the serving engine's ``sparkml_serve_*`` families, the transform and fit
reports' ``sparkml_transform_*`` / ``sparkml_fit_*`` series, exposed as
Prometheus text or a JSON-safe snapshot. Labels are kwargs at
observation time; each label set is its own child series, as in
Prometheus' data model. A summary keeps the slowest observations' trace
ids as exemplars, which the incident engine's evidence bundles start
from. Stdlib only; imports nothing of the port but ``obs/quantiles.py``.
"""

from __future__ import annotations

import math
import re
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from spark_rapids_ml_tpu_torch.obs.quantiles import QuantileSketch

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency-oriented default buckets (seconds): sub-millisecond calls up to
# multi-minute full-scale fits.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0, 300.0,
)


def _escape_label_value(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _format_value(v: float) -> str:
    # the exposition format's spelling; ``int(v)`` below raises on NaN
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Base: one named family holding one child per label-value tuple."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str, labelnames: Tuple[str, ...]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} expects labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def _child(self, labels: Dict[str, str]):
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
            return child

    def _new_child(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def _samples(self) -> Iterable[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())

    def _label_dict(self, key: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.labelnames, key))


class _Value:
    __slots__ = ("value", "lock")

    def __init__(self):
        self.value = 0.0
        self.lock = threading.Lock()


class Counter(_Metric):
    """Monotonically increasing count (``.inc(amount, **labels)``)."""

    kind = "counter"

    def _new_child(self):
        return _Value()

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        child = self._child(labels)
        with child.lock:
            child.value += amount

    def value(self, **labels) -> float:
        child = self._child(labels)
        with child.lock:
            return child.value

    def total(self) -> float:
        """Sum across every labeled child — the family-wide count,
        without walking a full registry snapshot."""
        total = 0.0
        for _key, child in self._samples():
            with child.lock:
                total += child.value
        return total


class Gauge(_Metric):
    """Point-in-time value (``.set(v, **labels)``)."""

    kind = "gauge"

    def _new_child(self):
        return _Value()

    def set(self, value: float, **labels) -> None:
        child = self._child(labels)
        with child.lock:
            child.value = float(value)

    def value(self, **labels) -> float:
        child = self._child(labels)
        with child.lock:
            return child.value


class Histogram(_Metric):
    """Cumulative-bucket histogram (``.observe(v, **labels)``), exposed as
    ``name_bucket{le="..."}`` lines plus ``_sum`` / ``_count``."""

    kind = "histogram"

    class _Child:
        __slots__ = ("counts", "sum", "count", "lock")

        def __init__(self, n_buckets: int):
            self.counts = [0] * n_buckets  # per bucket, not cumulative
            self.sum = 0.0
            self.count = 0
            self.lock = threading.Lock()

    def __init__(
        self,
        name: str,
        help_text: str,
        labelnames: Tuple[str, ...] = (),
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help_text, labelnames)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bounds

    def _new_child(self):
        return Histogram._Child(len(self.buckets))

    def observe(self, value: float, **labels) -> None:
        child = self._child(labels)
        with child.lock:
            child.sum += float(value)
            child.count += 1
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    child.counts[i] += 1
                    break

    def snapshot_child(self, **labels) -> Dict[str, object]:
        child = self._child(labels)
        with child.lock:
            cumulative = {}
            running = 0
            for bound, c in zip(self.buckets, child.counts):
                running += c
                cumulative[_format_value(bound)] = running
            cumulative["+Inf"] = child.count
            return {
                "count": child.count,
                "sum": child.sum,
                "buckets": cumulative,
            }


class Summary(_Metric):
    """Quantile summary backed by a mergeable streaming sketch
    (``obs.quantiles.QuantileSketch``): ``observe`` is O(1),
    ``quantile(q)`` within the sketch's relative error. Exposed as
    ``name{quantile="0.5"}`` lines plus ``_sum`` / ``_count``.

    ``observe(value, trace_id=...)`` also files a **trace-id exemplar**:
    each child keeps the ``EXEMPLAR_CAPACITY`` slowest observations with
    their trace ids, so "the p99 got worse" comes with the requests to
    look at. They appear in ``snapshot()`` and as ``# exemplar:
    <name>{labels} trace_id="..."`` comment lines in the text exposition
    (comments, because the endpoint advertises text format 0.0.4, whose
    parsers would abort a scrape on an inline OpenMetrics exemplar)."""

    kind = "summary"
    DEFAULT_QUANTILES: Tuple[float, ...] = (0.5, 0.95, 0.99)
    EXEMPLAR_CAPACITY = 5

    class _Child:
        __slots__ = ("sketch", "exemplars", "lock")

        def __init__(self, alpha: float, max_bins: int):
            self.sketch = QuantileSketch(alpha=alpha, max_bins=max_bins)
            # slowest-N ring: [(value, trace_id, unix_ts)] kept sorted
            # ascending, so [0] is the cheapest candidate to evict
            self.exemplars: List[Tuple[float, str, float]] = []
            self.lock = threading.Lock()

    def __init__(
        self,
        name: str,
        help_text: str,
        labelnames: Tuple[str, ...] = (),
        alpha: float = 0.01,
        max_bins: int = 4096,
        quantiles: Tuple[float, ...] = DEFAULT_QUANTILES,
    ):
        super().__init__(name, help_text, labelnames)
        self.alpha = float(alpha)
        self.max_bins = int(max_bins)
        self.quantiles = tuple(float(q) for q in quantiles)

    def _new_child(self):
        return Summary._Child(self.alpha, self.max_bins)

    def observe(self, value: float, trace_id: Optional[str] = None,
                **labels) -> None:
        child = self._child(labels)
        child.sketch.observe(value)
        if trace_id:
            self._note_exemplar(child, float(value), str(trace_id))

    def _note_exemplar(self, child: "Summary._Child", value: float,
                       trace_id: str) -> None:
        with child.lock:
            ring = child.exemplars
            if len(ring) >= self.EXEMPLAR_CAPACITY and value <= ring[0][0]:
                return  # faster than every kept exemplar
            ring.append((value, trace_id, time.time()))
            ring.sort(key=lambda e: e[0])
            if len(ring) > self.EXEMPLAR_CAPACITY:
                del ring[0]

    def exemplars(self, **labels) -> List[Dict[str, object]]:
        """The slowest-N exemplars for one label set, slowest first."""
        child = self._child(labels)
        with child.lock:
            ring = list(child.exemplars)
        return [
            {"value": v, "trace_id": tid, "unix_ts": ts}
            for v, tid, ts in reversed(ring)
        ]

    def sketch(self, **labels) -> QuantileSketch:
        """The underlying sketch for one label set."""
        return self._child(labels).sketch

    def snapshot_child(self, **labels) -> Dict[str, object]:
        sketch = self._child(labels).sketch
        return {
            "count": sketch.count,
            "sum": sketch.sum,
            "alpha": self.alpha,
            "quantiles": {
                _format_value(q): sketch.quantile(q) for q in self.quantiles
            },
            "exemplars": self.exemplars(**labels),
        }


class MetricsRegistry:
    """Process-wide metric family registry.

    ``counter`` / ``gauge`` / ``histogram`` / ``summary`` are get-or-create: repeated calls
    with the same name return the SAME family, but a name re-registered as
    a different kind or label set raises.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help_text, labelnames, **kwargs):
        labelnames = tuple(labelnames)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or (
                    existing.labelnames != labelnames
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels {existing.labelnames}"
                    )
                return existing
            metric = cls(name, help_text, labelnames, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name, help_text="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help_text, labelnames)

    def gauge(self, name, help_text="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labelnames)

    def histogram(
        self, name, help_text="", labelnames=(), buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help_text, labelnames, buckets=buckets
        )

    def summary(
        self, name, help_text="", labelnames=(), alpha=0.01,
        max_bins=4096, quantiles=Summary.DEFAULT_QUANTILES,
    ) -> Summary:
        return self._get_or_create(
            Summary, name, help_text, labelnames, alpha=alpha,
            max_bins=max_bins, quantiles=quantiles,
        )

    def reset(self) -> None:
        """Drop every family (a fresh process's registry: tests, drills)."""
        with self._lock:
            self._metrics.clear()

    def families(self):
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> Dict[str, object]:
        """JSON-safe snapshot of every series."""
        out: Dict[str, object] = {}
        for metric in self.families():
            samples = []
            for key, _child in metric._samples():
                labels = metric._label_dict(key)
                if isinstance(metric, (Histogram, Summary)):
                    samples.append(
                        {"labels": labels, **metric.snapshot_child(**labels)})
                else:
                    samples.append(
                        {"labels": labels, "value": metric.value(**labels)})
            out[metric.name] = {
                "type": metric.kind,
                "help": metric.help,
                "samples": samples,
            }
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines = []
        for metric in self.families():
            if metric.help:
                lines.append(f"# HELP {metric.name} {metric.help}")
            lines.append(f"# TYPE {metric.name} {metric.kind}")
            for key, _child in metric._samples():
                labels = metric._label_dict(key)
                label_str = ",".join(
                    f'{k}="{_escape_label_value(v)}"'
                    for k, v in labels.items()
                )
                suffix = f"{{{label_str}}}" if label_str else ""
                if isinstance(metric, Histogram):
                    snap = metric.snapshot_child(**labels)
                    for le, cum in snap["buckets"].items():
                        bl = (label_str + "," if label_str else "") + \
                            f'le="{le}"'
                        lines.append(f"{metric.name}_bucket{{{bl}}} {cum}")
                    lines.append(f"{metric.name}_sum{suffix} "
                                 f"{_format_value(snap['sum'])}")
                    lines.append(f"{metric.name}_count{suffix} "
                                 f"{snap['count']}")
                elif isinstance(metric, Summary):
                    snap = metric.snapshot_child(**labels)
                    emitted = []
                    for q, value in snap["quantiles"].items():
                        if value is None:
                            continue
                        ql = (label_str + "," if label_str else "") + \
                            f'quantile="{q}"'
                        emitted.append(
                            f"{metric.name}{{{ql}}} {_format_value(value)}")
                    lines.extend(emitted)
                    exemplars = snap["exemplars"]
                    if emitted and exemplars:
                        # the slowest observation's trace id, as a comment
                        # line: 0.0.4 parsers pass comments untouched
                        ex = exemplars[0]
                        lines.append(
                            f"# exemplar: {metric.name}{suffix} "
                            f'trace_id="{_escape_label_value(ex["trace_id"])}" '
                            f'{_format_value(ex["value"])} '
                            f'{ex["unix_ts"]:.3f}')
                    lines.append(f"{metric.name}_sum{suffix} "
                                 f"{_format_value(snap['sum'])}")
                    lines.append(f"{metric.name}_count{suffix} "
                                 f"{snap['count']}")
                else:
                    lines.append(
                        f"{metric.name}{suffix} "
                        f"{_format_value(metric.value(**labels))}")
        return "\n".join(lines) + ("\n" if lines else "")


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry the serving stack writes to."""
    return _default_registry
