"""KMeans on the device: k-means++ seeding and Lloyd iterations.

Counterpart of the JAX package's ``ops/kmeans_kernel.py``. The hot ops are
matrix products (the −2·X·Cᵀ cross term of the pairwise distances and the
one-hot cluster-sum reduction ``onehotᵀ·X``); the JAX package computes them
as XLA dot products at ``Precision.HIGHEST``, not in a Pallas kernel, so
here they are PyTorch products (cuBLAS on the card). Padded rows are
excluded through ``mask`` everywhere (assignment statistics, sums, cost);
a fractional mask is a per-row weight.

Full float32 whatever the process's TF32 setting: as in
``ops/pca_kernel._project``, a float32 operand is multiplied in float64,
which no such setting reaches, and rounded back. Here the whole distance
||x||² + ||c||² − 2·x·c is taken in float64 and rounded once to float32,
so (a) the expanded form's cancellation, which in float32 costs a
relative error of about ε·||x||²/d per distance and, through each centre's
rounded ||c||², a bias shared by all of that centre's rows, does not reach
the cost; (b) a row's distances do not depend on the batch it arrives in
(no reduction order of a float32 sum is left to the shape), which keeps a
served batch's labels equal to the same rows assigned alone. The Lloyd
loop widens its data once, before the first iteration. Float64 data takes
the JAX package's arithmetic as it is.

Two differences from the JAX package, both by design:

* ``lloyd_iterations`` is a host loop, where JAX's is a ``lax.while_loop``
  compiled into the program: each iteration reads ``moved <= tol`` on the
  host, one scalar synchronisation per iteration. ``n_iter`` counts as JAX
  counts (the converging step is counted; ``max_iter = 0`` runs none and
  returns the cost under the initial centres), and the final cost is one
  more statistics pass under the final centres.
* seeding draws from a ``torch.Generator``; ``jax.random`` cannot be
  matched draw for draw, so parity holds from shared initial centres.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from spark_rapids_ml_tpu_torch.ops.pca_kernel import (
    INT8_MIN_ROWS,
    INT8_MULTIPLE,
    _round_up,
)
from spark_rapids_ml_tpu_torch.ops.quantize import quantize_symmetric


class KMeansResult(NamedTuple):
    centers: torch.Tensor     # (k, n_features)
    cost: torch.Tensor        # 0-d: sum of squared distances (inertia)
    n_iter: torch.Tensor      # 0-d int32
    converged: torch.Tensor   # 0-d bool


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the precision its products and norms are taken in:
    float64 for a float32 tensor, itself otherwise."""
    return t.double() if t.dtype == torch.float32 else t


def _pairwise_sqdist(x: torch.Tensor, centers: torch.Tensor,
                     x_wide: Optional[torch.Tensor] = None) -> torch.Tensor:
    """||x−c||² via the expanded form; the cross term is one product.
    Taken in ``_wide``'s precision and returned in x's dtype; ``x_wide``
    is ``_wide(x)`` when the caller already holds it."""
    xw = _wide(x) if x_wide is None else x_wide
    cw = _wide(centers).to(xw.dtype)
    x2 = (xw * xw).sum(dim=1, keepdim=True)
    c2 = (cw * cw).sum(dim=1)[None, :]
    cross = xw @ cw.T
    return torch.clamp_min(x2 + c2 - 2.0 * cross, 0.0).to(x.dtype)


def assign_clusters(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The nearest centre of every row (first on ties, as ``jnp.argmin``)."""
    return torch.argmin(_pairwise_sqdist(x, centers), dim=1)


def _assign_bf16(x: torch.Tensor, centers_bf16: torch.Tensor) -> torch.Tensor:
    """bf16 cross term with f32 products and accumulation, norms in f32 of
    the SAME bf16-rounded operands, so the expanded ||x−c||² stays
    consistent. The centres arrive pre-cast (staged once at program
    build). On the card one bf16 GEMM with an f32 output; elsewhere the
    bf16 operands upcast to f32, whose products are exact in f32
    (``ops.pca_kernel._project_bf16``)."""
    xb = x.to(torch.bfloat16)
    if xb.is_cuda:
        cross = torch.mm(xb, centers_bf16.t(), out_dtype=torch.float32)
    else:
        cross = xb.float() @ centers_bf16.float().T
    xf = xb.float()
    cf = centers_bf16.float()
    x2 = (xf * xf).sum(dim=1, keepdim=True)
    c2 = (cf * cf).sum(dim=1)[None, :]
    return torch.argmin(x2 + c2 - 2.0 * cross, dim=1)


def pad_int8_centers(q: np.ndarray) -> np.ndarray:
    """Quantized (k, n) centres, transposed to (n, k) and zero-padded to
    ``torch._int_mm``'s multiples of 8 in both widths. The padding
    columns are sliced off the cross term before the norms and the
    argmin, so a zero padding centre can never win."""
    k, n = q.shape
    return np.pad(np.ascontiguousarray(q.T),
                  ((0, _round_up(n, INT8_MULTIPLE) - n),
                   (0, _round_up(k, INT8_MULTIPLE) - k)))


def _assign_int8(x: torch.Tensor, centers_qt: torch.Tensor,
                 centers_scale: torch.Tensor, *, k: int) -> torch.Tensor:
    """int8 cross term with int32 accumulation (``ops.quantize``), norms of
    the dequantized operands in f32: distances consistent with the
    quantized geometry. The centres arrive pre-quantized, transposed and
    padded (``pad_int8_centers``); only the batch quantizes per call, and
    is zero-padded to ``torch._int_mm``'s shapes (rows to
    ``INT8_MIN_ROWS``, features to the centres' padded width). The rescale
    keeps the JAX package's association, ``acc * (sx * scale)``."""
    rows, n = x.shape
    xq, sx = quantize_symmetric(x)
    pad_rows = max(INT8_MIN_ROWS - rows, 0)
    pad_cols = centers_qt.shape[0] - n
    xq_mm = F.pad(xq, (0, pad_cols, 0, pad_rows)) if (pad_rows or pad_cols) \
        else xq
    acc = torch._int_mm(xq_mm, centers_qt)[:rows, :k]
    cross = acc.float() * (sx * centers_scale)
    xf = xq.float() * sx
    cf = centers_qt[:n, :k].T.float() * centers_scale
    x2 = (xf * xf).sum(dim=1, keepdim=True)
    c2 = (cf * cf).sum(dim=1)[None, :]
    return torch.argmin(x2 + c2 - 2.0 * cross, dim=1)


# The stage bodies, keyed by precision: each model's serving program runs
# one, and the fused pipeline program chains them (models/_serving.py).
# Assignment is output-typed (labels), so KMeans composes only as the
# TERMINAL stage. int8 takes the model's k (``functools.partial``).
SERVING_STAGE_BODIES = {
    "native": assign_clusters,
    "bf16": _assign_bf16,
    "int8": _assign_int8,
}


def _valid(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    return mask.to(device=x.device, dtype=x.dtype)


def _categorical(logits: torch.Tensor, generator) -> torch.Tensor:
    """One draw ∝ exp(logits) by the Gumbel-max trick, as
    ``jax.random.categorical`` draws; a 0-d index tensor (no host sync)."""
    u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype,
                   device=logits.device)
    return torch.argmax(logits + _gumbel(u))


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise −log(−log u) from uniforms ``u``, both logs
    kept finite."""
    tiny = torch.finfo(u.dtype).tiny
    exponential = -torch.log(u.clamp_min(tiny))
    return -torch.log(exponential.clamp_min(tiny))


def kmeans_plus_plus_init(
    x: torch.Tensor,
    n_clusters: int,
    seed: int = 0,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """k-means++ seeding on x's device: each next centre drawn ∝ D².

    The first centre is drawn ∝ the mask value (uniform for 0/1 validity,
    w-proportional when the mask carries weightCol). Rows with mask 0 have
    logit −inf at every draw, even when every valid distance is zero, so a
    padding or zero-weight row never seeds. A fixed ``seed`` on one device
    gives the same centres on every call."""
    generator = torch.Generator(device=x.device).manual_seed(int(seed))
    n = x.shape[1]
    valid = _valid(x, mask)
    neg_inf = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    tiny = torch.full((), 1e-30, dtype=x.dtype, device=x.device)

    def logits_of(weights):
        return torch.where(valid > 0, torch.log(torch.maximum(weights, tiny)),
                           neg_inf)

    centers = torch.zeros((n_clusters, n), dtype=x.dtype, device=x.device)
    first = x.index_select(0, _categorical(logits_of(valid), generator)
                           .reshape(1))
    centers[0] = first[0]
    min_d = ((x - first) ** 2).sum(dim=1) * valid
    for i in range(1, n_clusters):
        c = x.index_select(0, _categorical(logits_of(min_d), generator)
                           .reshape(1))
        centers[i] = c[0]
        min_d = torch.minimum(min_d, ((x - c) ** 2).sum(dim=1) * valid)
    return centers


def _cluster_stats(x, centers, valid, x_wide=None):
    """One Lloyd half-step: assignment + per-cluster (Σx, count, cost).

    The cluster sum is a product ``onehotᵀ·X``, not a scatter, as in the
    JAX package; sums, counts and cost are taken in ``_wide``'s precision
    and rounded to x's dtype."""
    k = centers.shape[0]
    xw = _wide(x) if x_wide is None else x_wide
    d = _pairwise_sqdist(x, centers, xw)
    dmin, labels = torch.min(d, dim=1)
    onehot = F.one_hot(labels, k).to(xw.dtype) * valid.to(xw.dtype)[:, None]
    sums = (onehot.T @ xw).to(x.dtype)
    counts = onehot.sum(dim=0).to(x.dtype)
    cost = (dmin.to(xw.dtype) * valid.to(xw.dtype)).sum().to(x.dtype)
    return sums, counts, cost


def lloyd_iterations(
    x: torch.Tensor,
    init_centers: torch.Tensor,
    mask: Optional[torch.Tensor],
    max_iter: int,
    tol: float,
    reduce_fn: Callable = lambda t: t,
) -> KMeansResult:
    """Lloyd's algorithm, a host loop (see the module docstring).

    ``reduce_fn`` combines (sums, counts, cost) across ranks: identity on
    one device, an ``all_reduce`` in the distributed fit; everything else
    is shared. An empty cluster keeps its previous centre (Spark's
    behaviour), and a centre divides by its cluster's actual weight mass,
    which a fractional weight can bring below 1."""
    valid = _valid(x, mask)
    x_wide = _wide(x)
    centers = init_centers.to(device=x.device, dtype=x.dtype)
    n_iter = 0
    converged = False
    while n_iter < max_iter and not converged:
        sums, counts, _ = reduce_fn(_cluster_stats(x, centers, valid, x_wide))
        filled = counts > 0
        denom = torch.where(filled, counts, torch.ones_like(counts))[:, None]
        new_centers = torch.where(filled[:, None], sums / denom, centers)
        moved = torch.sqrt(((new_centers - centers) ** 2).sum(dim=1).max())
        centers = new_centers
        n_iter += 1
        converged = bool(moved <= tol)  # the one sync of an iteration
    _, _, cost = reduce_fn(_cluster_stats(x, centers, valid, x_wide))
    return KMeansResult(
        centers, cost,
        torch.tensor(n_iter, dtype=torch.int32),
        torch.tensor(converged),
    )


def update_cluster_stats(carry, centers: torch.Tensor, batch: torch.Tensor,
                         mask: Optional[torch.Tensor] = None):
    """Out-of-core Lloyd building block: one batch's per-cluster
    (Σx, count, cost) folded into the accumulator ``carry``. One streamed
    pass of this per batch is one Lloyd assignment half-step over the whole
    dataset, with device memory bounded at one batch plus one (k, n)
    accumulator. The counts accumulate in the carry's integer dtype, so
    totals stay exact past 2²⁴ rows per cluster."""
    sums, counts, cost = carry
    batch = batch.to(sums.dtype)
    s, c, co = _cluster_stats(batch, centers, _valid(batch, mask))
    return sums + s, counts + c.round().to(counts.dtype), cost + co


def kmeans_fit_kernel(
    x: torch.Tensor,
    init_centers: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    max_iter: int = 20,
    tol: float = 1e-4,
) -> KMeansResult:
    return lloyd_iterations(x, init_centers, mask, max_iter, tol)
