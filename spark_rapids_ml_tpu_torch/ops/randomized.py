"""Randomized top-k eigensolver (subspace iteration) for large covariances.

Counterpart of the JAX package's ``ops/randomized.py``: Halko-Martinsson-
Tropp subspace iteration gets the top k eigenpairs with a few tall-skinny
products, O(n²·l) instead of the dense O(n³) ``eigh``, and needs only
``v ↦ Cov·v`` from the matrix.

The random start ``omega`` comes from an explicit ``torch.Generator`` seeded
from ``seed``, or is passed in: ``jax.random`` and ``torch.Generator`` draw
different numbers from one seed, so a caller that must reproduce another
run's start hands ``omega`` over.

Accuracy caveat (as in the JAX package): individual eigenvectors converge
at a rate set by the gaps between consecutive eigenvalues; on decaying
spectra a few iterations reach the dense solver, on near-degenerate ones
only the top-k subspace is determined.

Products here are float32 or float64 matmuls; on the card they are full
f32 only while ``torch.backends.cuda.matmul.allow_tf32`` is False (the
PyTorch default).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from spark_rapids_ml_tpu_torch.ops.eigh import eigh_descending, sign_flip


def _orthonormalize(y: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of range(Y) via eigh-based whitening, as the JAX
    package does: B = YᵀY = VΛVᵀ, Q = Y·V·Λ^(−1/2). Squares the condition
    number, so callers re-orthonormalize every iteration; tiny Λ entries are
    clamped and their directions become exactly-zero columns that sort last
    in Rayleigh-Ritz (zero component rows only when k > rank(Cov)).

    The whitening runs in float64 whatever Y's dtype (for float64 input the
    arithmetic is the JAX package's). In float32 the JAX package's clamp,
    eps·rows of the top eigenvalue of the SQUARED spectrum, zeroes every
    direction below √(eps·rows) ≈ 2e-2 of the top one at 4096 features: on
    a 1/(1+j) spectrum every component past about the 45th came back as a
    zero column, full-rank covariance or not, and the residual gate let
    them through. The (n × l) product and the l × l eigh cost little."""
    y64 = y.to(torch.float64)
    b = y64.T @ y64
    b = (b + b.T) / 2
    evals, vecs = torch.linalg.eigh(b)
    eps = torch.finfo(torch.float64).eps
    floor = torch.clamp(evals[-1], min=0.0) * eps * y.shape[0]
    inv_sqrt = torch.where(evals > floor,
                           1.0 / torch.sqrt(torch.maximum(evals, floor)),
                           torch.zeros_like(evals))
    return (y64 @ (vecs * inv_sqrt[None, :])).to(y.dtype)


def subspace_iteration(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    l: int,
    n_iter: int,
    dtype: torch.dtype,
    device,
    generator: Optional[torch.Generator] = None,
    omega: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-l eigenpairs of a symmetric PSD operator given only its matvec.

    ``matvec`` maps an (n, l) block to Cov @ block. The start is ``omega``
    when given, else standard normals from ``generator``. Returns
    (evals[l] descending, evecs[n, l]).
    """
    if omega is None:
        omega = torch.randn((n, l), generator=generator, dtype=dtype,
                            device=device)
    else:
        omega = torch.as_tensor(omega, dtype=dtype, device=device)
    y = matvec(omega)
    for _ in range(max(n_iter, 0)):
        y = matvec(_orthonormalize(y))
    q = _orthonormalize(y)
    b = q.T @ matvec(q)
    b = (b + b.T) / 2  # exact symmetry for eigh
    evals, vecs = eigh_descending(b)
    return evals, q @ vecs


def topk_from_subspace(
    evals: torch.Tensor,
    evecs: torch.Tensor,
    k: int,
    total_variance: torch.Tensor,
    flip_signs: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sign-flip, top-k truncation and λ/Σλ with the clamped Rayleigh-Ritz
    eigenvalues over the exact ``total_variance`` (= trace(Cov))."""
    if flip_signs:
        evecs = sign_flip(evecs)
    lam = torch.clamp(evals[:k], min=0.0)
    total = torch.as_tensor(total_variance, dtype=lam.dtype, device=lam.device)
    evr = lam / torch.where(total > 0, total, torch.ones_like(total))
    return evecs[:, :k], evr


def randomized_pca_from_covariance(
    cov: torch.Tensor,
    k: int,
    total_variance: torch.Tensor,
    oversample: int = 10,
    n_iter: int = 4,
    seed: int = 0,
    flip_signs: bool = True,
    omega: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(components[n, k], explained_variance_ratio[k]) from a covariance,
    without factorizing the full spectrum. ``omega`` ((n, min(k+oversample,
    n))) overrides the start drawn from a generator seeded with ``seed``."""
    n = cov.shape[0]
    l = min(k + oversample, n)
    generator = torch.Generator(device=cov.device).manual_seed(seed)
    evals, evecs = subspace_iteration(
        lambda v: cov @ v, n, l, n_iter, cov.dtype, cov.device,
        generator=generator, omega=omega,
    )
    return topk_from_subspace(evals, evecs, k, total_variance, flip_signs)
