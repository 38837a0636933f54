"""Covariance / Gram assembly — the operation-heavy half of PCA.

Counterpart of the JAX package's ``ops/covariance.py``, which replaced the
reference's per-partition ``dgemm`` JNI kernel (``rapidsml_jni.cu:172-258``).
Semantics follow the corrected spec (SURVEY.md §3.6): covariance normalizes
by ``numRows − 1`` everywhere and ``meanCentering=False`` is supported.

Every float32 Gram goes through ``ops.fused_gram.fused_centered_gram``:
the hand-written CUDA kernel for a CUDA tensor, its plain version for a CPU
tensor. Centring, the 1/√(n−1) scale and the row mask are handed to it as
``mean`` and ``rowmul``, so the caller makes no centred or padded copy of X;
on the card the kernel's prep pass writes one centred copy into scratch it
allocates for the call (``ops.fused_gram.scratch_shape``). float64 (which
the kernel does not take) is a plain product.

``centered_gram`` reports its analytic cost on every route through
``obs.xprof.record_execution``, so fit reports and the fit-path monitor
count each Gram's FLOPs and bytes.

All functions take an optional per-row 0/1 ``mask`` for padded buckets.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from spark_rapids_ml_tpu_torch.obs.xprof import record_execution
from spark_rapids_ml_tpu_torch.ops.fused_gram import fused_centered_gram
from spark_rapids_ml_tpu_torch.utils.numeric import (
    GRAM_PRECISIONS as _ALLOWED_PRECISIONS,
)


def default_gram_precision() -> str:
    """Gram precision from ``TPUML_GRAM_PRECISION`` (default bfloat16_3x),
    the JAX package's variable, so one setting governs both packages."""
    value = os.environ.get("TPUML_GRAM_PRECISION", "bfloat16_3x")
    if value not in _ALLOWED_PRECISIONS:
        raise ValueError(
            f"TPUML_GRAM_PRECISION={value!r} is not one of {_ALLOWED_PRECISIONS}"
        )
    return value


def resolve_gram_precision(value) -> str:
    """An estimator's ``gramPrecision`` param → the concrete precision:
    ``None``/'auto' defers to the env-configured default; an explicit value
    is validated and wins over the env var."""
    if value is None or value == "auto":
        return default_gram_precision()
    if value not in _ALLOWED_PRECISIONS:
        raise ValueError(
            f"gramPrecision={value!r} is not one of "
            f"('auto',) + {_ALLOWED_PRECISIONS}"
        )
    return value


def _masked(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x
    return x * mask[:, None].to(x.dtype)


def row_count(x: torch.Tensor, mask: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Number of valid rows as an int64 scalar tensor on x's device.

    An integer, NOT x's dtype: an f32 count stops being exact at 2²⁴ rows,
    inside the out-of-core regime, and would corrupt the mean and the
    ``n·μμᵀ`` correction. Callers divide by it, which promotes to float.
    """
    if mask is None:
        return torch.tensor(x.shape[0], dtype=torch.int64, device=x.device)
    return torch.count_nonzero(mask).to(device=x.device)


def column_means(x: torch.Tensor, mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Per-column mean over valid rows (the reference's
    ``Statistics.colStats(rows).mean`` pass, ``RapidsRowMatrix.scala:152-162``)."""
    return _masked(x, mask).sum(dim=0) / row_count(x, mask)


def gram_cost(rows: int, n: int, in_itemsize: int, out_itemsize: int):
    """(FLOPs, bytes) of one ``centered_gram`` over ``rows`` × ``n``: the
    upper triangle with its diagonal, ``rows·n·(n+1)/2`` multiply-adds at 2
    FLOPs each, one pass whatever the precision; X read once and the n×n
    output written once. The count PERF.md's bound uses."""
    return rows * n * (n + 1), rows * n * in_itemsize + n * n * out_itemsize


def centered_gram(x: torch.Tensor, mean: Optional[torch.Tensor] = None,
                  rowmul: Optional[torch.Tensor] = None,
                  precision=None) -> torch.Tensor:
    """``(diag(rowmul)·(x − mean))ᵀ(diag(rowmul)·(x − mean))``; ``mean``
    None means no centring, ``rowmul`` None means ones. float32 takes the
    fused Gram (see module docstring); ``precision`` applies to it.

    Each call files ``gram_cost`` with ``obs.xprof.record_execution``, on
    the kernel, its plain version and float64 alike; ``rows`` counts every
    row handed in, padding included, as the JAX package's cost analysis of
    a static shape does. The port has no HLO cost analysis, so the other
    work of a fit (the mean pass, ``eigh``, the randomized solve) reports
    no FLOPs: it is absent from the accounting, not guessed."""
    rows, n = x.shape
    if x.dtype == torch.float32:
        if mean is None:
            mean = torch.zeros(n, dtype=x.dtype, device=x.device)
        if rowmul is None:
            rowmul = torch.ones(rows, dtype=x.dtype, device=x.device)
        out = fused_centered_gram(
            x.contiguous(), mean.to(x.dtype).contiguous(),
            rowmul.to(x.dtype).contiguous(), precision=precision)
    else:
        xc = x if mean is None else x - mean[None, :]
        if rowmul is not None:
            xc = xc * rowmul[:, None].to(x.dtype)
        out = xc.T @ xc
    record_execution("centered_gram",
                     *gram_cost(rows, n, x.element_size(), out.element_size()))
    return out


def gram(x: torch.Tensor, precision=None) -> torch.Tensor:
    """Uncentred Gram XᵀX (TruncatedSVD's operator): ``centered_gram``
    with no mean and unit rows, so a float32 input takes the kernel and
    its FLOPs are filed like every other Gram's."""
    return centered_gram(x, None, None, precision=precision)


def covariance(
    x: torch.Tensor,
    mean: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    ddof: int = 1,
    precision=None,
) -> torch.Tensor:
    """Sample covariance ``(X−μ)ᵀ(X−μ) / (n − ddof)`` over valid rows.

    The ``1/√(n−ddof)`` row scale and the mask travel into the Gram as
    ``rowmul`` (the reference folded the same normalizer into rows before
    its GEMM, ``RapidsRowMatrix.scala:169,179-181``). ``mean=None`` skips
    centering (the ``meanCentering=false`` mode).
    """
    n = row_count(x, mask)
    scale = 1.0 / torch.sqrt(torch.clamp(n - ddof, min=1).to(x.dtype))
    if mask is None:
        rowmul = scale.expand(x.shape[0])
    else:
        rowmul = mask.to(x.dtype) * scale
    return centered_gram(x, mean, rowmul, precision=precision)


def partial_gram_stats(
    x: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    precision=None,
):
    """One-pass sufficient statistics of a batch: (xᵀx, Σx, count), the
    masked tail going into the Gram as ``rowmul = mask``."""
    g = centered_gram(x, rowmul=mask, precision=precision)
    s = _masked(x, mask).sum(dim=0)
    return g, s, row_count(x, mask)


def covariance_from_stats(
    g: torch.Tensor, s: torch.Tensor, cnt: torch.Tensor, ddof: int = 1,
    mean_centering: bool = True,
) -> torch.Tensor:
    """Combine global (Σxxᵀ, Σx, n) into covariance: (G − n·μμᵀ)/(n−ddof).

    The one-pass formulation. Its accuracy limit is the f32 cancellation in
    ``G − n·μμᵀ`` when |μ| ≫ σ; for large-mean data the two-pass variant
    (center first, then Gram) is the one to use.
    """
    denom = torch.clamp(cnt - ddof, min=1).to(g.dtype)
    if not mean_centering:
        return g / denom
    mu = s / cnt
    return (g - cnt * torch.outer(mu, mu)) / denom
