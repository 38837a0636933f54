"""Structured per-phase timings — the observability the reference lacks.

The reference extends Spark ``Logging`` but emits no metrics
(SURVEY.md §5 "Metrics / logging"). Estimators here record wall-clock per
phase (mean / covariance / solve / transform) into a dict surfaced on the
fitted model as ``model.fit_timings_``. A phase that launches device work
ends in a synchronising read, so its wall clock covers the device time.

Safe for nested and concurrent use: the context manager is re-entrant
(each exit adds its own elapsed interval — note that nesting the SAME
phase name therefore counts the inner interval twice, once on its own and
once inside the outer interval) and the dict is lock-guarded so fits
running on worker threads can share one timer.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict


class PhaseTimer:
    def __init__(self):
        self.timings: Dict[str, float] = {}
        self._lock = threading.RLock()

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Accumulate a pre-measured interval into a phase."""
        with self._lock:
            self.timings[name] = self.timings.get(name, 0.0) + float(seconds)

    def as_dict(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.timings)

    def total(self) -> float:
        """Sum of all phase wall-clock (nested phases count their overlap)."""
        with self._lock:
            return sum(self.timings.values())
