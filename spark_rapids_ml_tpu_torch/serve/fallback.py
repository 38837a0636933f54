"""Degraded-mode CPU fallback: answer slowly instead of 5xx-ing.

The port's copy of the JAX package's ``serve/fallback.py``.

When a model's circuit breaker opens on device-backend errors, the
service has two choices for that model's traffic: reject it fast
(``BreakerOpen`` → 503) or serve it from the host. For the models whose
kernels are **row-independent pure math over small fitted state** — a
PCA projection is one GEMM against ``pc``, a KMeans assignment is a
nearest-center argmin against ``cluster_centers`` — the host answer is
exact (the same float64 arithmetic the models' own ``useXlaDot=False``
path runs), just slower. This module resolves that per-model fallback:

* ``cpu_fallback(model)`` returns a ``fn(rows) -> np.ndarray`` mirroring
  what ``extract_output(model, model.transform(rows))`` yields on the
  device path, or ``None`` when the model has no safe host equivalent
  (the breaker then rejects instead of degrading);
* a model may override resolution by carrying a ``cpu_transform_``
  callable (custom models opt in without touching this table).

The engine tags every fallback answer ``degraded=true`` in metrics,
traces, and HTTP responses, and runs the numerics sentinel over it — a
degraded path that starts emitting NaNs is an outage, not a fallback.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def as_rows(rows) -> np.ndarray:
    """Coerce a request payload to the (n, d) float64 contract every
    fallback sees — the ONE place degraded-path request validation
    lives (the device path's equivalent is ``MicroBatcher.submit``)."""
    x = np.asarray(rows, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2 or x.shape[0] == 0:
        raise ValueError(
            f"expected a non-empty (n, d) request, got shape "
            f"{np.shape(rows)}"
        )
    return x


def _pca_fallback(pc: np.ndarray) -> Callable[[np.ndarray], np.ndarray]:
    pc = np.asarray(pc, dtype=np.float64)

    def project(x: np.ndarray) -> np.ndarray:
        # The reference-parity projection (no mean subtraction) — the
        # exact arithmetic of PCAModel.transform's host path, so a
        # degraded answer is bit-checkable against the direct CPU
        # transform.
        return x @ pc

    return project


def _kmeans_fallback(centers: np.ndarray
                     ) -> Callable[[np.ndarray], np.ndarray]:
    centers = np.asarray(centers, dtype=np.float64)

    def assign(x: np.ndarray) -> np.ndarray:
        # KMeansModel's own host _sqdist formula, for label parity.
        x2 = (x * x).sum(axis=1)[:, None]
        c2 = (centers * centers).sum(axis=1)[None, :]
        d = np.maximum(x2 + c2 - 2.0 * (x @ centers.T), 0.0)
        return d.argmin(axis=1).astype(np.int32)

    return assign


def _normalized(fn: Callable[[np.ndarray], np.ndarray]
                ) -> Callable[[np.ndarray], np.ndarray]:
    """Every resolved fallback — built-in or a model's custom
    ``cpu_transform_`` — answers under the same contract: raw request
    rows in, ``as_rows``-validated (n, d) float64 to the kernel,
    ndarray out."""

    def call(rows) -> np.ndarray:
        return np.asarray(fn(as_rows(rows)))

    return call


def cpu_fallback(model) -> Optional[Callable[[np.ndarray], np.ndarray]]:
    """The degraded-mode host transform for ``model``, or None.

    Resolution order: an explicit ``cpu_transform_`` attribute on the
    model, then the known row-independent families (PCA projection,
    KMeans assignment). Attribute probing is deliberately conservative —
    anything ambiguous resolves to None (no fallback) rather than a
    wrong answer served under an outage.
    """
    explicit = getattr(model, "cpu_transform_", None)
    if callable(explicit):
        return _normalized(explicit)
    pc = getattr(model, "pc", None)
    if pc is not None and getattr(pc, "ndim", 0) == 2:
        return _normalized(_pca_fallback(pc))
    centers = getattr(model, "cluster_centers", None)
    if centers is not None and getattr(centers, "ndim", 0) == 2:
        return _normalized(_kmeans_fallback(centers))
    return None


__all__ = ["as_rows", "cpu_fallback"]
