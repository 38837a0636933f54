"""Analytic cost accounting: the card's peak, analytic MFU, and the seam
every counted device program reports its FLOPs and bytes through.

The port's part of the JAX package's ``obs/xprof.py``. There, every
``tracked_jit`` program carries the FLOPs and bytes of XLA's cost analysis
and ``TrackedJit._record_execution`` files them with the open fit report,
the open transform report and the fit-path monitor on each execution.
Eager PyTorch compiles nothing and has no cost analysis, so the port's
programs declare their cost analytically and call ``record_execution``
themselves (``ops.covariance.centered_gram`` does, once per Gram). Compile
tracking is not ported: nothing compiles.
"""

from __future__ import annotations

from typing import Optional


def record_execution(label: str, flops: Optional[float],
                     nbytes: Optional[float]) -> None:
    """File one program execution's FLOPs and bytes with the current fit
    report (``obs.report.current_fit``), the current transform report
    (``obs.serving.current_transform``) and the current fit-monitor run
    (``obs.fitmon``); a no-op outside them. Never raises."""
    try:
        from spark_rapids_ml_tpu_torch.obs import fitmon
        from spark_rapids_ml_tpu_torch.obs.report import current_fit
        from spark_rapids_ml_tpu_torch.obs.serving import current_transform

        current_fit().record_program(label, flops, nbytes)
        current_transform().record_program(label, flops, nbytes)
        fitmon.record_program(label, flops, nbytes)
    except Exception:
        pass  # telemetry must never break a kernel


def peak_flops_per_second() -> Optional[float]:
    """This process's card's peak dense FLOP/s (bf16), or None when the
    device kind has no published number (CPU included) — the denominator
    for every analytic-MFU figure."""
    try:
        from spark_rapids_ml_tpu_torch.utils.platform import (
            PEAK_FLOPS_BF16,
            device_kind,
        )

        kind = device_kind()
        return PEAK_FLOPS_BF16.get(kind) if kind is not None else None
    except Exception:
        return None


def analytic_mfu(flops: Optional[float],
                 seconds: Optional[float]) -> Optional[float]:
    """Analytic MFU: declared FLOPs over wall-clock over the card's peak.
    None when any input (or the peak) is unknown."""
    if not flops or not seconds or seconds <= 0:
        return None
    peak = peak_flops_per_second()
    if not peak:
        return None
    return flops / seconds / peak


__all__ = ["analytic_mfu", "peak_flops_per_second", "record_execution"]
