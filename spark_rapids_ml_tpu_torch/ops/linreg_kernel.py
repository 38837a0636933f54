"""Linear regression through sufficient statistics and the normal equations.

Counterpart of the JAX package's ``ops/linreg_kernel.py``, the
"partial-aggregate + small dense solve" shape PCA's covariance shares
(SURVEY.md §7 step 6): the heavy operation is the Gram XᵀX, the solve a
small dense Cholesky on the n-sized system, and the distributed form
all-reduces (XᵀX, Xᵀy, Σx, Σy, n), so rows never leave their shard.

Objective (Spark ``LinearRegression`` with ``solver="normal"``):
    min_w  (1/2n)·Σᵢ (yᵢ − xᵢᵀw − b)² + (λ/2)·||w||²
i.e. ridge on mean-centered data; intercept unpenalized.

The JAX package computes ``xmᵀx`` (xm = diag(m)·x) with ``lax.dot_general``
at ``Precision.HIGHEST``. Here it is ``centered_gram(x, None, √m,
precision="highest")``: (diag(√m)·x)ᵀ(diag(√m)·x) equals xmᵀx in real
arithmetic because m ≥ 0 (a 0/1 mask, or weights that ``HasWeightCol``
has checked), and a float32 input on the card takes the hand kernel's
full-f32 pipeline. The other statistics (Xᵀy, Σx, Σy, Σy², n) and the solve
are plain PyTorch: Xᵀy is a matrix-vector product (cuBLAS gemv, which no
TF32 setting reaches), and the Cholesky solve runs in the input's dtype, as
JAX's ``cho_solve`` does.

A matrix that is not positive definite: JAX's ``cho_factor`` returns NaN,
where ``torch.linalg.cholesky`` would raise. ``cholesky_ex`` reports the
failure in ``info`` without a host sync, and the factor is replaced by NaN
there, so the coefficients come out NaN as the JAX package's do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from spark_rapids_ml_tpu_torch.ops.covariance import centered_gram


class LinRegStats(NamedTuple):
    xtx: torch.Tensor     # (n, n)
    xty: torch.Tensor     # (n,)
    x_sum: torch.Tensor   # (n,)
    y_sum: torch.Tensor   # scalar
    y_sq: torch.Tensor    # scalar Σy²
    count: torch.Tensor   # scalar


class LinRegResult(NamedTuple):
    coefficients: torch.Tensor  # (n,)
    intercept: torch.Tensor     # scalar


def linreg_partial_stats(
    x: torch.Tensor, y: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> LinRegStats:
    """The shard's (XᵀWX, XᵀWy, Σwx, Σwy, Σwy², Σw) with W = diag(mask);
    ``mask`` is a 0/1 row mask or non-negative row weights (ones if None)."""
    m = (torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
         if mask is None else mask.to(x.dtype))
    xm = x * m[:, None]
    ym = y * m
    xtx = centered_gram(x, None, torch.sqrt(m), precision="highest")
    xty = xm.T @ y
    return LinRegStats(
        xtx=xtx,
        xty=xty,
        x_sum=torch.sum(xm, dim=0),
        y_sum=torch.sum(ym),
        y_sq=torch.sum(ym * y),
        count=torch.sum(m),
    )


def _cho_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a·x = b through Cholesky; NaN where a is not positive
    definite (see the module docstring)."""
    factor, info = torch.linalg.cholesky_ex(a)
    factor = torch.where(info == 0, factor,
                         torch.full_like(factor, float("nan")))
    return torch.cholesky_solve(b[:, None], factor)[:, 0]


def solve_normal_equations(
    stats: LinRegStats, reg_param: float, fit_intercept: bool
) -> LinRegResult:
    n = stats.count
    if fit_intercept:
        mu_x = stats.x_sum / n
        mu_y = stats.y_sum / n
        # centered moments: Xcᵀ·Xc = XᵀX − n·μₓμₓᵀ ; Xcᵀ·yc = Xᵀy − n·μₓμ_y
        a = stats.xtx / n - torch.outer(mu_x, mu_x)
        b = stats.xty / n - mu_x * mu_y
    else:
        a = stats.xtx / n
        b = stats.xty / n
    a = a + reg_param * torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    coef = _cho_solve(a, b)
    if fit_intercept:
        intercept = stats.y_sum / n - torch.dot(stats.x_sum / n, coef)
    else:
        intercept = torch.zeros((), dtype=coef.dtype, device=coef.device)
    return LinRegResult(coef, intercept)


def linreg_fit_kernel(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
) -> LinRegResult:
    stats = linreg_partial_stats(x, y, mask)
    return solve_normal_equations(stats, reg_param, fit_intercept)


def linreg_predict_kernel(
    x: torch.Tensor, coefficients: torch.Tensor, intercept: torch.Tensor
) -> torch.Tensor:
    return x @ coefficients.to(x.dtype) + intercept.to(x.dtype)
