"""Robust baseline statistics for the online anomaly detectors.

The port's copy of the JAX package's ``obs/robust.py``: the
``max(tolerance, 2·MAD/median)`` noise band the JAX perf sentinel judges
bench records with, and the robust z-score the auto-incident engine
(``obs.anomaly``) judges live series against their own trailing history
with. The arithmetic is the reference's line for line, so the port's
detectors and the reference's give equal verdicts on equal series.

Stdlib only, and no package imports.

The MAD is scaled by 1/0.6745 in ``robust_zscore`` (the normal
consistency constant), so a robust z of 3 means the same thing a
3-sigma excursion means on Gaussian data — but one outlier in the
baseline cannot inflate the band the way it would inflate a stddev.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

# MAD → sigma consistency constant for normal data: sigma ≈ MAD / 0.6745.
MAD_CONSISTENCY = 0.6745


def median(values: Sequence[float]) -> float:
    """The sample median (mean of the middle two for even n)."""
    vs = sorted(values)
    n = len(vs)
    if n == 0:
        raise ValueError("median of an empty sequence")
    mid = n // 2
    return vs[mid] if n % 2 else 0.5 * (vs[mid - 1] + vs[mid])


def mad(values: Sequence[float], center: Optional[float] = None) -> float:
    """Median absolute deviation around ``center`` (default: the
    median). 0.0 for a constant series — callers must guard the
    division (``robust_zscore`` does)."""
    med = median(values) if center is None else center
    return median([abs(v - med) for v in values])


def noise_band(values: Sequence[float], tolerance: float) -> float:
    """Relative half-width of the acceptance band around the median:
    ``max(tolerance, 2·MAD/|median|)``. THE perf-sentinel band —
    single samples (and an exactly-zero median) fall back to the
    tolerance; noisy histories widen to the observed spread."""
    if len(values) < 2:
        return tolerance
    med = median(values)
    if not med:
        return tolerance
    return max(tolerance, 2.0 * mad(values, center=med) / abs(med))


def robust_zscore(value: float, baseline: Sequence[float]) -> float:
    """How many robust sigmas ``value`` sits above/below the baseline's
    median (``0.6745 · (value - median) / MAD``).

    A constant baseline has MAD 0: the z-score is 0.0 when the value
    matches it exactly and ±inf otherwise — callers pair the z test
    with an absolute/relative step guard (``obs.anomaly`` does) so a
    0.1% wiggle off a flat line cannot read as an infinite anomaly.
    """
    med = median(baseline)
    m = mad(baseline, center=med)
    if m == 0.0:
        if value == med:
            return 0.0
        return float("inf") if value > med else float("-inf")
    return MAD_CONSISTENCY * (value - med) / m


def baseline_stats(values: Sequence[float],
                   tolerance: float = 0.15) -> dict:
    """The (median, MAD, band) triple detectors and verdicts report —
    one dict so incident records and sentinel verdicts read alike."""
    med = median(values)
    return {
        "median": med,
        "mad": mad(values, center=med),
        "band": noise_band(values, tolerance),
        "n_samples": len(values),
    }


__all__: List[str] = [
    "MAD_CONSISTENCY",
    "baseline_stats",
    "mad",
    "median",
    "noise_band",
    "robust_zscore",
]
