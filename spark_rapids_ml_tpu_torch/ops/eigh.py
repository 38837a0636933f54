"""Eigendecomposition + PCA postprocessing.

Counterpart of the JAX package's ``ops/eigh.py``, which replaced the
reference's ``calSVD`` (``rapidsml_jni.cu:338-392``: RAFT
``eigDC`` → reverse → sign-flip). The JAX package left ``eigh`` to XLA; here
it is ``torch.linalg.eigh`` (cuSOLVER on the card, LAPACK on the CPU).

Semantics kept from the JAX package (SURVEY.md §3.6): descending order,
explained variance λ/Σλ (not √λ/Σ√λ), and the sign flip that makes each
component's max-|·| coordinate positive (``rapidsml_jni.cu:37-64``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def eigh_descending(cov: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition with eigenvalues in descending order."""
    evals, evecs = torch.linalg.eigh(cov)
    return evals.flip(0), evecs.flip(1)


def sign_flip(evecs: torch.Tensor) -> torch.Tensor:
    """Flip each column's sign so its max-|·| entry is positive."""
    idx = torch.argmax(evecs.abs(), dim=0)
    picked = evecs[idx, torch.arange(evecs.shape[1], device=evecs.device)]
    signs = torch.where(picked < 0, -1.0, 1.0).to(evecs.dtype)
    return evecs * signs[None, :]


def explained_variance_ratio(evals: torch.Tensor) -> torch.Tensor:
    """λᵢ/Σλ over all eigenvalues (clamped at 0 for tiny negatives); the
    truncation to k happens after, as in ``RapidsRowMatrix.scala:101-109``."""
    lam = torch.clamp(evals, min=0.0)
    total = lam.sum()
    return lam / torch.where(total > 0, total, torch.ones_like(total))


def eigh_postprocess_host(evals, evecs):
    """NumPy version of the descending-reorder + sign-flip chain, for the
    host fallbacks. Takes LAPACK ascending-order output; returns
    (evals_descending, evecs_flipped)."""
    evals = np.asarray(evals)[::-1]
    evecs = np.asarray(evecs)[:, ::-1]
    idx = np.argmax(np.abs(evecs), axis=0)
    signs = np.where(evecs[idx, np.arange(evecs.shape[1])] < 0, -1.0, 1.0)
    return evals, evecs * signs[None, :]


def pca_postprocess_host(evals, evecs, k: int):
    """Host postprocessing for PCA: reorder/flip + λ/Σλ + top-k."""
    evals, evecs = eigh_postprocess_host(evals, evecs)
    lam = np.maximum(evals, 0.0)
    total = lam.sum()
    evr = lam / (total if total > 0 else 1.0)
    return evecs[:, :k], evr[:k]


def resolve_auto_solver(n: int, k: int) -> str:
    """Solver choice for ``solver='auto'``: randomized top-k when k ≪ n on
    a covariance big enough for the O(n³) eigh to matter, dense eigh
    otherwise. The JAX package's shape rule, kept as is; a rule for the
    H100 comes only from an H100 measurement."""
    return "randomized" if (n >= 1024 and k * 8 <= n) else "eigh"


def pca_from_covariance(
    cov: torch.Tensor, k: int, flip_signs: bool = True, solver: str = "eigh"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(components[n,k], explained_variance_ratio[k]) from covariance.

    ``solver``: ``"eigh"`` (dense, exact per-vector parity with the LAPACK
    oracle), ``"randomized"`` (subspace iteration for the top k only,
    ``ops.randomized``; λ/Σλ stays exact via trace(cov)) or ``"auto"``
    (``resolve_auto_solver``, ungated; see ``pca_from_covariance_gated``).
    """
    if solver == "auto":
        solver = resolve_auto_solver(cov.shape[0], k)
    if solver == "randomized":
        from spark_rapids_ml_tpu_torch.ops.randomized import (
            randomized_pca_from_covariance,
        )

        return randomized_pca_from_covariance(
            cov, k, torch.trace(cov), flip_signs=flip_signs
        )
    if solver != "eigh":
        raise ValueError(
            f"solver={solver!r}: expected 'eigh', 'randomized', or 'auto'"
        )
    evals, evecs = eigh_descending(cov)
    if flip_signs:
        evecs = sign_flip(evecs)
    evr = explained_variance_ratio(evals)
    return evecs[:, :k], evr[:k]


def pca_from_covariance_gated(
    cov: torch.Tensor,
    k: int,
    flip_signs: bool = True,
    solver: str = "auto",
    residual_rtol: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor, str]:
    """``pca_from_covariance`` with the eigh-vs-randomized residual gate.

    When the solver is randomized, the eigenpair residual
    ``‖Cov·V − V·Λ‖_F / (√k · mean(λ))`` is read once on the host; above
    ``residual_rtol`` (or not finite) the dense eigh result is returned
    instead. Returns ``(components, evr, solver_used)``.
    """
    if solver == "auto":
        solver = resolve_auto_solver(cov.shape[0], k)
    if solver != "randomized":
        pc, evr = pca_from_covariance(cov, k, flip_signs, solver)
        return pc, evr, solver
    pc, evr = pca_from_covariance(cov, k, flip_signs, "randomized")
    lam = evr * torch.trace(cov)
    resid = torch.linalg.norm(cov @ pc - pc * lam[None, :])
    scale = torch.sqrt(torch.tensor(float(k), dtype=cov.dtype)) * max(
        float(lam.mean()), torch.finfo(cov.dtype).tiny
    )
    # inverted comparison so NaN/inf residuals FAIL the gate
    if not (float(resid) / float(scale) <= residual_rtol):
        pc, evr = pca_from_covariance(cov, k, flip_signs, "eigh")
        return pc, evr, "eigh(gated)"
    return pc, evr, "randomized"
