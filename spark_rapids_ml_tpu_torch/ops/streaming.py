"""Streaming (chunked) PCA fit: bounded device memory for unbounded rows.

Counterpart of the JAX package's ``ops/streaming.py``. The reference streams
per-partition chunks through the GPU (``RapidsRowMatrix.scala:168-202``);
here an on-device accumulator ``(Σxxᵀ, Σx, n)`` is updated per batch, so
device memory holds one batch plus one n×n Gram whatever the row count.

Every float32 batch's Gram goes through ``ops.covariance.centered_gram`` and
so through the fused kernel on a CUDA tensor, the masked tail bucket
included (as ``rowmul = mask``): the kernel masks ragged shapes itself, so
no batch is turned away, unlike the TPU dispatch that needed aligned tiles.
The accumulators are updated in place (``add_``), which saves the n×n copy
per batch that the JAX package avoided by donating the buffer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from spark_rapids_ml_tpu_torch.ops.covariance import (
    _masked,
    centered_gram,
    covariance_from_stats,
    partial_gram_stats,
    row_count,
)
from spark_rapids_ml_tpu_torch.ops.eigh import pca_from_covariance
from spark_rapids_ml_tpu_torch.ops.pca_kernel import PCAFitResult
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device


class GramStats(NamedTuple):
    """Device-resident accumulator: Gram (n×n), column sum (n,), row count
    (int64 scalar)."""

    gram: torch.Tensor
    col_sum: torch.Tensor
    count: torch.Tensor


def init_stats(n_features: int, dtype=torch.float32, device=None) -> GramStats:
    """Zeroed accumulator on ``device`` (None: the card, unless the CPU is
    requested; see ``utils.resources.resolve_device``)."""
    device = resolve_device() if device is None else torch.device(device)
    return GramStats(
        gram=torch.zeros((n_features, n_features), dtype=dtype, device=device),
        col_sum=torch.zeros((n_features,), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int64, device=device),
    )


def _to_device(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype, device=device).contiguous()


def update_stats(
    stats: GramStats, batch, mask=None, precision: Optional[str] = None,
) -> GramStats:
    """Accumulate one batch into ``stats`` in place and return it."""
    device = stats.gram.device
    b = _to_device(batch, stats.gram.dtype, device)
    m = None if mask is None else _to_device(mask, stats.gram.dtype, device)
    g, s, cnt = partial_gram_stats(b, m, precision=precision)
    stats.gram.add_(g)
    stats.col_sum.add_(s)
    stats.count.add_(cnt)
    return stats


def finalize_stats(
    stats: GramStats,
    k: int,
    mean_centering: bool = True,
    flip_signs: bool = True,
    solver: str = "eigh",
) -> PCAFitResult:
    cov = covariance_from_stats(
        stats.gram, stats.col_sum, stats.count, mean_centering=mean_centering
    )
    if mean_centering:
        mean = stats.col_sum / stats.count
    else:
        mean = torch.zeros_like(stats.col_sum)
    # 'auto' is the ungated shape rule here; eager callers wanting the
    # residual gate use ops.eigh.pca_from_covariance_gated, as the PCA
    # model does
    components, evr = pca_from_covariance(
        cov, k, flip_signs=flip_signs, solver=solver
    )
    return PCAFitResult(components, evr, mean)


class StreamingPCA:
    """Convenience wrapper: ``StreamingPCA(n).partial_fit(b)...finalize(k)``."""

    def __init__(self, n_features: int, dtype=torch.float32, device=None):
        self._stats = init_stats(n_features, dtype=dtype, device=device)

    def partial_fit(self, batch, mask=None) -> "StreamingPCA":
        self._stats = update_stats(self._stats, batch, mask)
        return self

    @property
    def rows_seen(self) -> float:
        return float(self._stats.count)

    def finalize(
        self, k: int, mean_centering: bool = True, solver: str = "eigh"
    ) -> PCAFitResult:
        return finalize_stats(
            self._stats, k, mean_centering=mean_centering, solver=solver
        )


# -- two-pass streaming (exact reference semantics, out-of-core) -----------
#
# The one-pass accumulator loses accuracy to f32 cancellation in G − n·μμᵀ
# when |μ| ≫ σ. A re-iterable source affords the reference's own schedule
# out-of-core: pass 1 streams (Σx, n) → μ, pass 2 streams the CENTERED Gram,
# with device memory bounded at one batch + one n×n accumulator.

class MeanStats(NamedTuple):
    col_sum: torch.Tensor
    count: torch.Tensor


def update_mean_stats(stats: MeanStats, batch, mask=None) -> MeanStats:
    """Accumulate one batch's masked column sum and row count in place."""
    device = stats.col_sum.device
    b = _to_device(batch, stats.col_sum.dtype, device)
    m = None if mask is None else _to_device(mask, stats.col_sum.dtype, device)
    stats.col_sum.add_(_masked(b, m).sum(dim=0))
    stats.count.add_(row_count(b, m))
    return stats


def update_centered_gram(
    gram_acc: torch.Tensor,
    batch,
    mean: torch.Tensor,
    mask=None,
    precision: Optional[str] = None,
) -> torch.Tensor:
    """``gram_acc += (diag(mask)·(batch − mean))ᵀ(…)`` in place."""
    b = _to_device(batch, gram_acc.dtype, gram_acc.device)
    m = None if mask is None else _to_device(mask, gram_acc.dtype,
                                             gram_acc.device)
    return gram_acc.add_(centered_gram(b, mean, m, precision=precision))


def stream_covariance(
    source,
    mean_centering: bool = True,
    dtype=torch.float32,
    device=None,
    precision: Optional[str] = None,
):
    """Stream a ``data.batches.BatchSource`` into (covariance, mean, count).

    Two-pass (center → Gram) when the source is re-iterable and centering
    is requested; one-pass sufficient statistics otherwise. Returns device
    tensors; covariance is normalized by n−1.
    """
    device = resolve_device() if device is None else torch.device(device)
    n = source.n_features
    if mean_centering and source.reiterable:
        mstats = MeanStats(
            torch.zeros((n,), dtype=dtype, device=device),
            torch.zeros((), dtype=torch.int64, device=device),
        )
        for batch, mask in source.batches():
            mstats = update_mean_stats(mstats, batch, mask)
        count = mstats.count
        mean = mstats.col_sum / count
        gram_acc = torch.zeros((n, n), dtype=dtype, device=device)
        pass2_rows = 0
        for batch, mask in source.batches():
            pass2_rows += batch.shape[0] if mask is None else int(mask.sum())
            update_centered_gram(gram_acc, batch, mean, mask,
                                 precision=precision)
        if pass2_rows != int(count):
            # A "re-iterable" factory that hands back a partially-consumed
            # iterator would silently zero the Gram; fail instead.
            raise RuntimeError(
                f"two-pass streaming saw {int(count)} rows on pass 1 but "
                f"{pass2_rows} on pass 2; the source factory must return a "
                f"FRESH iterator on every call"
            )
        denom = torch.clamp(count - 1, min=1)
        return gram_acc / denom, mean, count

    stats = init_stats(n, dtype=dtype, device=device)
    for batch, mask in source.batches():
        stats = update_stats(stats, batch, mask, precision=precision)
    cov = covariance_from_stats(
        stats.gram, stats.col_sum, stats.count, mean_centering=mean_centering
    )
    if mean_centering:
        mean = stats.col_sum / stats.count
    else:
        mean = torch.zeros_like(stats.col_sum)
    return cov, mean, stats.count
