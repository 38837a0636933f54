"""Linear SVM (squared hinge) by generalized Newton, on the device.

Counterpart of the JAX package's ``ops/svm_kernel.py``. The objective is
the squared-hinge SVM

    J(w, b) = (1/n) Σᵢ max(0, 1 − ỹᵢ(xᵢ·w + b))² + (λ/2)‖w‖²

with ỹ = 2y − 1 ∈ {−1, +1} and the intercept unpenalized, solved by
generalized Newton: the active set S = {i : 1 − ỹf > 0} gives the exact
gradient and the generalized Hessian (2/n)·X_Sᵀ X_S + λI. Each iteration
is the margins ``X·w``, the gradient ``Xᵀ(aỹ)``, the Hessian
``Xᵀdiag(s)X`` and an (n+1)² Cholesky solve, the same shape as
``ops/logreg_kernel.py`` with the IRLS weights replaced by the active-set
indicator.

**The Hessian is the hand Gram kernel.** The JAX package computes
``Xᵀdiag(s)X`` with ``lax.dot_general`` at ``Precision.HIGHEST``. Here it
is ``centered_gram(x, None, √s, precision="highest")``: s = 1[margin > 0]·
valid ≥ 0, so (diag(√s)·x)ᵀ(diag(√s)·x) equals it in real arithmetic, and
√s is exact where s ∈ {0, 1}. A float32 input on the card takes the
kernel's full-f32 pipeline, one launch per Newton iteration (per bucket
in the streamed form). ``valid`` carries the 0/1 mask or the row weights,
and s already carries ``valid``, so neither is applied twice. The gradient
``Xᵀ(aỹ)`` is a matrix-vector product (cuBLAS gemv, which no TF32 setting
reaches).

The system is JAX's exactly: the 2/n scaling, a 1e-10 diagonal jitter
(which keeps the Cholesky alive when the active set empties at λ = 0) and,
without an intercept, the slot pinned at h[n, n] = 1 with no jitter. The
Cholesky runs in the input's dtype, as JAX's ``cho_factor`` does
(``ops.linreg_kernel._cho_solve``: NaN where H is not positive definite).

The Newton loop is a host loop where JAX's is a ``lax.while_loop``: each
iteration reads its step size on the host (one scalar synchronisation);
``n_iter`` counts as JAX counts (+1 per step, stop at ``max_iter`` or when
the step is at most ``tol``; ``max_iter = 0`` returns zeros).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from spark_rapids_ml_tpu_torch.ops.covariance import centered_gram
from spark_rapids_ml_tpu_torch.ops.kmeans_kernel import _valid
from spark_rapids_ml_tpu_torch.ops.linreg_kernel import _cho_solve


class SvcResult(NamedTuple):
    coefficients: torch.Tensor  # (n_features,)
    intercept: torch.Tensor     # scalar
    n_iter: torch.Tensor        # 0-d int32
    converged: torch.Tensor     # 0-d bool


def _svc_stats(coef, b, x, y_pm, valid):
    """The shard's (Xᵀ(aỹ), XᵀSX, Xᵀs, Σaỹ, Σs, Σvalid) at (w, b): a the
    active slack, s the active-set indicator, both times ``valid``."""
    margin = 1.0 - y_pm * (x @ coef + b)
    a = torch.clamp_min(margin, 0.0) * valid
    s = (margin > 0).to(x.dtype) * valid
    ay = a * y_pm
    hxx = centered_gram(x, None, torch.sqrt(s), precision="highest")
    return (x.T @ ay, hxx, x.T @ s, torch.sum(ay), torch.sum(s),
            torch.sum(valid))


def _svc_grad_hess(w, x, y_pm, valid, reg_param, fit_intercept, reduce_fn):
    """(gradient, generalized Hessian) of the squared-hinge objective.

    ``w`` is (n+1,): coefficients ++ intercept slot (zero-pinned when
    ``fit_intercept`` is False). ``y_pm`` is ±1. ``reduce_fn`` combines
    the per-shard partials: identity on one device, an all-reduce across
    ranks in the distributed form.
    """
    n_feat = x.shape[1]
    coef, b = w[:n_feat], w[n_feat]
    gx, hxx, hxb, aysum, ssum, cnt = reduce_fn(
        _svc_stats(coef, b, x, y_pm, valid))
    two_inv_n = 2.0 / torch.clamp_min(cnt, 1.0)
    eye = torch.eye(n_feat, dtype=w.dtype, device=w.device)
    g = torch.zeros_like(w)
    g[:n_feat] = -two_inv_n * gx + reg_param * coef
    h = 1e-10 * torch.eye(n_feat + 1, dtype=w.dtype, device=w.device)
    h[:n_feat, :n_feat] += two_inv_n * hxx + reg_param * eye
    if fit_intercept:
        g[n_feat] = -two_inv_n * aysum
        h[:n_feat, n_feat] += two_inv_n * hxb
        h[n_feat, :n_feat] += two_inv_n * hxb
        h[n_feat, n_feat] += two_inv_n * ssum
    else:
        h[n_feat, n_feat] = 1.0
    return g, h


def svc_newton_iterations(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: Optional[torch.Tensor],
    reg_param: float,
    fit_intercept: bool,
    max_iter: int,
    tol: float,
    reduce_fn=lambda t: t,
) -> SvcResult:
    """Undamped generalized Newton with a Cholesky solve, as a host loop
    with one scalar read per iteration (see the module docstring)."""
    valid = _valid(x, mask)
    y_pm = 2.0 * y.to(x.dtype) - 1.0
    n_feat = x.shape[1]
    w = torch.zeros((n_feat + 1,), dtype=x.dtype, device=x.device)
    n_iter = 0
    done = False
    while n_iter < max_iter and not done:
        g, h = _svc_grad_hess(w, x, y_pm, valid, reg_param, fit_intercept,
                              reduce_fn)
        delta = _cho_solve(h, g)
        w = w - delta
        n_iter += 1
        done = bool(torch.max(torch.abs(delta)) <= tol)
    return SvcResult(w[:n_feat], w[n_feat],
                     torch.tensor(n_iter, dtype=torch.int32),
                     torch.tensor(done))


def svc_fit_kernel(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
    max_iter: int = 100,
    tol: float = 1e-8,
) -> SvcResult:
    return svc_newton_iterations(
        x, y, mask, reg_param, fit_intercept, max_iter, tol
    )


def svc_decision_kernel(x, coefficients, intercept):
    """Raw decision values x·w + b, Spark's rawPrediction margin."""
    return x @ coefficients.to(x.dtype) + intercept.to(x.dtype)


def update_svc_stats(carry, batch_z, w, b, mask=None):
    """Out-of-core Newton building block: fold one ``[X | y]`` batch's
    squared-hinge partials (Xᵀ(aỹ), XᵀSX, Xᵀs, Σaỹ, Σs, n) at the current
    (w, b) into the accumulator. One streamed pass with this per batch is
    one generalized-Newton gradient/Hessian evaluation over the whole
    dataset. Returns a new carry (the JAX package donates the old one)."""
    dtype = carry[0].dtype
    x = batch_z[:, :-1].to(dtype)
    y_pm = 2.0 * batch_z[:, -1].to(dtype) - 1.0
    stats = _svc_stats(w.to(dtype), b.to(dtype), x, y_pm, _valid(x, mask))
    return tuple(c + s for c, s in zip(carry, stats))
