"""Streaming quantile sketch: mergeable, bounded-memory, relative-error.

The port's copy of the JAX package's ``obs/quantiles.py`` (DDSketch-style,
Masson et al., VLDB 2019): logarithmic buckets sized so every quantile
estimate is within a *relative* error ``alpha`` of a true sample value,
whatever the distribution's scale. It backs the ``Summary`` metrics of the
serving engine (``obs/metrics.py``).

Guarantee: for any quantile ``q`` whose true sample value is ``x`` (within
the un-collapsed index range), the estimate ``x̂`` satisfies
``|x̂ - x| <= alpha * |x|``. Zero is represented exactly. ``observe`` is
O(1) under one lock; at most ``max_bins`` buckets per sign, collapsing the
smallest magnitudes first. The JAX package's merging and serialization
are not ported: nothing in the port merges or ships sketches yet.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, Optional

DEFAULT_ALPHA = 0.01
DEFAULT_MAX_BINS = 4096

# Smallest magnitude the log-index can represent without float underflow;
# observations below it (in magnitude) count into the zero bucket — for
# latency/throughput/output values this is far below measurement noise.
_MIN_INDEXABLE = 1e-300


class QuantileSketch:
    """DDSketch-style log-bucket quantile sketch (see module doc).

    ``alpha`` is the guaranteed relative accuracy; ``max_bins`` bounds
    memory per sign (4096 bins at alpha=0.01 covers ~36 decades — nothing
    collapses in practice, the cap is a safety rail).
    """

    def __init__(self, alpha: float = DEFAULT_ALPHA,
                 max_bins: int = DEFAULT_MAX_BINS):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        if max_bins < 2:
            raise ValueError("max_bins must be >= 2")
        self.alpha = float(alpha)
        self.max_bins = int(max_bins)
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self._gamma)
        self._pos: Dict[int, int] = {}
        self._neg: Dict[int, int] = {}
        self._zero = 0
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._collapsed = False
        self._lock = threading.Lock()

    # -- indexing ----------------------------------------------------------

    def _index(self, magnitude: float) -> int:
        return int(math.ceil(math.log(magnitude) / self._log_gamma))

    def _value(self, index: int) -> float:
        # bucket i covers (gamma^(i-1), gamma^i]; its midpoint estimate
        # 2*gamma^i/(gamma+1) is within alpha of every value in the range
        try:
            return 2.0 * math.exp(index * self._log_gamma) / (self._gamma + 1.0)
        except OverflowError:
            return math.inf

    def _collapse_locked(self, store: Dict[int, int]) -> None:
        """Merge smallest-magnitude buckets until under the cap — the
        large-magnitude tail (upper quantiles of latency) keeps its bound."""
        while len(store) > self.max_bins:
            lowest = min(store)
            second = min(k for k in store if k != lowest)
            store[second] += store.pop(lowest)
            self._collapsed = True

    # -- ingestion ---------------------------------------------------------

    def observe(self, value: float) -> None:
        """Add one observation. NaN is ignored (a sketch of latencies or
        outputs must never be poisoned by one bad sample); infinities are
        clamped into the largest representable bucket."""
        value = float(value)
        if math.isnan(value):
            return
        with self._lock:
            self._count += 1
            self._sum += value if math.isfinite(value) else 0.0
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value
            magnitude = abs(value)
            if magnitude < _MIN_INDEXABLE:
                self._zero += 1
                return
            store = self._pos if value > 0 else self._neg
            if math.isinf(magnitude):
                index = self._index(1e308)
            else:
                index = self._index(magnitude)
            store[index] = store.get(index, 0) + 1
            self._collapse_locked(store)

    # -- queries -----------------------------------------------------------

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def min(self) -> Optional[float]:
        with self._lock:
            return self._min

    @property
    def max(self) -> Optional[float]:
        with self._lock:
            return self._max

    def quantile(self, q: float) -> Optional[float]:
        """The value at quantile ``q`` in [0, 1], or None when empty.

        q=0 and q=1 return the exact tracked min/max; interior quantiles
        return the bucket estimate (within ``alpha`` relative error of a
        true sample value at that rank).
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self._count == 0:
                return None
            if q == 0.0:
                return self._min
            if q == 1.0:
                return self._max
            rank = q * (self._count - 1)
            # ascending value order: negatives (large magnitude first),
            # zero, positives (small magnitude first)
            seen = 0
            for idx in sorted(self._neg, reverse=True):
                seen += self._neg[idx]
                if seen > rank:
                    estimate = -self._value(idx)
                    if self._min is not None:
                        estimate = max(estimate, self._min)
                    if self._max is not None:
                        estimate = min(estimate, self._max)
                    return estimate
            seen += self._zero
            if self._zero and seen > rank:
                return 0.0
            for idx in sorted(self._pos):
                seen += self._pos[idx]
                if seen > rank:
                    estimate = self._value(idx)
                    if self._max is not None:
                        estimate = min(estimate, self._max)
                    if self._min is not None:
                        estimate = max(estimate, self._min)
                    return estimate
            return self._max

    def quantiles(self, qs: Iterable[float]) -> Dict[str, Optional[float]]:
        """``{"p50": v, "p99": v, ...}`` for fractional ``qs`` — the shape
        bench records and ``TransformReport`` embed."""
        out: Dict[str, Optional[float]] = {}
        for q in qs:
            label = f"p{q * 100:g}".replace(".", "_")
            out[label] = self.quantile(q)
        return out
