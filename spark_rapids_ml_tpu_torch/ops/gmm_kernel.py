"""GaussianMixture EM on the device: the fused E-step and statistics pass.

Counterpart of the JAX package's ``ops/gmm_kernel.py``. The driver (host)
keeps the small mixture state (weights, means, covariances) and the
PRECISION Cholesky factors (k × d × d, the sklearn trick), so the per-row
work is products: y_k = (x − μ_k)·P_k, the log-probability from ‖y_k‖²,
responsibilities by logsumexp, then the M-step's sufficient statistics
(Σr, Σr·x, Σr·x·xᵀ, loglik, Σw). The M-step itself is a k × d × d host
float64 update (``m_step``).

Two routes share one definition of the math:

* host numpy (``useXlaDot=False``, the model's ``summary`` and the Spark
  statistics plane's partials): ``log_prob_math``, ``estep_stats_math`` and
  ``responsibilities_math`` take the array module ``xp`` and are the JAX
  package's expressions, unchanged, run with ``xp = numpy``;
* the device (``gmm_estep_device``, ``gmm_responsibilities_device``), on
  torch tensors:

  - **Σ_n r_nk x_n x_nᵀ is the hand Gram kernel.** Per component one
    ``ops.covariance.centered_gram(x, None, rowmul=√r_k,
    precision="highest")``: (diag(√r_k)·x)ᵀ(diag(√r_k)·x) equals
    Σ r_nk x_n x_nᵀ in real arithmetic (r ≥ 0: the prior weights are
    checked non-negative), uncentred, so ``GmmStats.sq_sum`` keeps its
    meaning for ``m_step`` and the Spark partials. A float32 CUDA input
    takes the kernel's full-f32 pipeline, k launches per EM pass; no
    (n, k, d) temporary is built, where the JAX package's three-operand
    ``einsum`` left that to XLA.
  - y = x·P_k − μ_k·P_k and Σ r·x are plain products (the JAX package left
    them to XLA). They are taken in float64, so no process-wide TF32
    setting reaches a float32 fit, and so are the (n, k) log-densities,
    their row logsumexp and the responsibilities: a 784-wide row's
    log-density is ~2400, where float32's half ulp (1.2e-4) would enter
    every responsibility through lp − logsumexp. Each result is rounded
    once to x's dtype: the responsibilities (and √r for the Gram), Σ r,
    Σ r·x, the log-likelihood and Σ w.
  - ``plain=True`` swaps the kernel for its plain version
    (``ops.fused_gram.fused_centered_gram_reference``, the same f32
    arithmetic), which is what ``chip_smoke.py`` holds the kernel route
    against on the card. A CPU tensor takes the plain Gram anyway.

No fallback: a float32 CUDA input the kernel does not take raises.

The numpy helpers (``precision_cholesky``, ``m_step``, ``kmeans_pp_rows``,
``init_from_moments``, ``init_params``) are the JAX package's, copied.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.ops.covariance import centered_gram
from spark_rapids_ml_tpu_torch.ops.fused_gram import (
    fused_centered_gram_reference,
)

_LOG_2PI = float(np.log(2.0 * np.pi))

# the Gram precision of Σ r x xᵀ: full f32, as the JAX package's float32
# einsum on the CPU, and the Newton / IRLS Hessians' precision
SQ_SUM_PRECISION = "highest"


class GmmStats(NamedTuple):
    """One EM pass's reduced outputs."""

    resp_sum: object   # sum_n r_nk                (k,)
    mean_sum: object   # sum_n r_nk x_n            (k, d)
    sq_sum: object     # sum_n r_nk x_n x_n^T      (k, d, d)
    loglik: object     # sum_n w_n log p(x_n)      scalar
    w_sum: object      # sum_n w_n                 scalar


# -- host numpy: the JAX package's xp math ------------------------------------

def _logsumexp(xp, a, axis):
    m = xp.max(a, axis=axis, keepdims=True)
    return (xp.log(xp.sum(xp.exp(a - m), axis=axis, keepdims=True))
            + m).squeeze(axis)


def log_prob_math(xp, x, means, prec_chol, log_det):
    """(n, k) log N(x | mu_k, Sigma_k) from precision Cholesky factors.

    ``prec_chol[k]`` is upper-triangular with Sigma_k^-1 = P P^T;
    ``log_det[k] = log|P_k|`` (= -0.5 log|Sigma_k|).
    """
    d = x.shape[1]
    y = xp.einsum("nd,kde->kne", x, prec_chol) \
        - xp.einsum("kd,kde->ke", means, prec_chol)[:, None, :]
    sq = xp.sum(y * y, axis=2)                      # (k, n)
    return (-0.5 * (d * _LOG_2PI + sq) + log_det[:, None]).T


def estep_stats_math(xp, x, w_prior, means, prec_chol, log_det,
                     log_weights) -> GmmStats:
    """E-step responsibilities + M-step sufficient statistics, fused."""
    lp = log_prob_math(xp, x, means, prec_chol, log_det) \
        + log_weights[None, :]                       # (n, k)
    norm = _logsumexp(xp, lp, axis=1)                # (n,)
    resp = xp.exp(lp - norm[:, None]) * w_prior[:, None]
    return GmmStats(
        resp_sum=xp.sum(resp, axis=0),
        mean_sum=resp.T @ x,
        sq_sum=xp.einsum("nk,nd,ne->kde", resp, x, x),
        loglik=xp.sum(w_prior * norm),
        w_sum=xp.sum(w_prior),
    )


def responsibilities_math(xp, x, means, prec_chol, log_det, log_weights):
    """(n, k) posterior responsibilities (the transform path)."""
    lp = log_prob_math(xp, x, means, prec_chol, log_det) \
        + log_weights[None, :]
    norm = _logsumexp(xp, lp, axis=1)
    return xp.exp(lp - norm[:, None])


# -- the device: torch tensors ------------------------------------------------

def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.double() if t.dtype == torch.float32 else t


def _as(t, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def log_prob_device(x: torch.Tensor, means, prec_chol,
                    log_det) -> torch.Tensor:
    """(n, k) log N(x | μ_k, Σ_k): ``log_prob_math`` with y_k = x·P_k −
    μ_k·P_k and ‖y_k‖² taken one component at a time (an (n, d)
    temporary, never (n, k, d)), in float64 for a float32 x (the
    precision the responsibilities are formed in, see the module
    docstring), else in x's dtype."""
    n, d = x.shape
    xw = _wide(x)
    p = _as(prec_chol, xw)
    mp = torch.einsum("kd,kde->ke", _as(means, xw), p)
    ld = _as(log_det, xw)
    k = p.shape[0]
    sq = torch.empty((n, k), dtype=xw.dtype, device=x.device)
    for j in range(k):
        y = xw @ p[j] - mp[j][None, :]
        sq[:, j] = (y * y).sum(dim=1)
    return -0.5 * (d * _LOG_2PI + sq) + ld[None, :]


def _responsibilities(x, means, prec_chol, log_det, log_weights):
    """(exp(lp − norm), norm) in ``log_prob_device``'s precision, lp the
    log-density plus log π_k and norm its row logsumexp."""
    lp = log_prob_device(x, means, prec_chol, log_det)
    lp = lp + _as(log_weights, lp)[None, :]
    norm = torch.logsumexp(lp, dim=1)
    return torch.exp(lp - norm[:, None]), norm


def gmm_estep_device(x: torch.Tensor, w_prior: torch.Tensor, means,
                     prec_chol, log_det, log_weights, *,
                     plain: bool = False) -> GmmStats:
    """``estep_stats_math`` on torch tensors (see the module docstring):
    a ``GmmStats`` of tensors in x's dtype on x's device. ``w_prior``
    (n,) ≥ 0 weights the rows (0 on padding rows); the mixture state may
    be numpy or tensors. ``plain`` takes Σ r x xᵀ from the kernel's plain
    version."""
    resp, norm = _responsibilities(x, means, prec_chol, log_det,
                                   log_weights)
    w = _as(w_prior, resp)
    resp = resp * w[:, None]
    # (k, n): each component's √r, rounded once, is a contiguous row for
    # the Gram's rowmul
    root = torch.sqrt(resp.T).to(x.dtype).contiguous()
    if plain and x.dtype == torch.float32:
        xc = x.contiguous()
        zero = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
        sq = torch.stack([fused_centered_gram_reference(
            xc, zero, r, SQ_SUM_PRECISION) for r in root])
    else:
        sq = torch.stack([centered_gram(x, None, r,
                                        precision=SQ_SUM_PRECISION)
                          for r in root])
    return GmmStats(
        resp_sum=resp.sum(dim=0).to(x.dtype),
        mean_sum=(resp.T @ _wide(x)).to(x.dtype),
        sq_sum=sq,
        loglik=(w * norm).sum().to(x.dtype),
        w_sum=w.sum().to(x.dtype),
    )


def gmm_responsibilities_device(x: torch.Tensor, means, prec_chol, log_det,
                                log_weights) -> torch.Tensor:
    """(n, k) posterior responsibilities on x's device, in x's dtype (the
    transform path): ``responsibilities_math`` in ``log_prob_device``'s
    precision, rounded once."""
    return _responsibilities(x, means, prec_chol, log_det,
                             log_weights)[0].to(x.dtype)


def stats_to_host(stats: GmmStats) -> GmmStats:
    """A ``GmmStats`` of tensors as host float64 numpy (synchronises)."""
    return GmmStats(*(np.asarray(t.cpu().numpy(), dtype=np.float64)
                      for t in stats))


# -- host float64 helpers (the JAX package's, copied) -------------------------

def precision_cholesky(covs: np.ndarray, reg: float = 0.0):
    """(prec_chol, log_det) from (k, d, d) covariances — host float64.

    Sigma = L L^T  =>  P = (L^-1)^T (upper-triangular), Sigma^-1 = P P^T,
    log|P| = -sum log diag(L).
    """
    from scipy.linalg import solve_triangular

    k, d, _ = covs.shape
    prec = np.empty_like(covs)
    log_det = np.empty(k)
    eye = np.eye(d)
    for i in range(k):
        cov = covs[i] + reg * eye
        try:
            chol = np.linalg.cholesky(cov)
        except np.linalg.LinAlgError as exc:
            raise ValueError(
                "singular component covariance — data may have "
                "(near-)duplicate rows or too-large k; increase "
                "regularization"
            ) from exc
        prec[i] = solve_triangular(chol, eye, lower=True).T
        log_det[i] = -np.sum(np.log(np.diag(chol)))
    return prec, log_det


def m_step(stats: GmmStats, reg: float):
    """Sufficient statistics -> (weights, means, covs), host float64."""
    nk = np.asarray(stats.resp_sum, dtype=np.float64)
    nk = np.maximum(nk, 1e-32)
    w_sum = float(stats.w_sum)
    weights = nk / w_sum
    means = np.asarray(stats.mean_sum, dtype=np.float64) / nk[:, None]
    sq = np.asarray(stats.sq_sum, dtype=np.float64) / nk[:, None, None]
    covs = sq - np.einsum("kd,ke->kde", means, means)
    d = covs.shape[1]
    covs = covs + reg * np.eye(d)[None, :, :]
    return weights, means, covs


def kmeans_pp_rows(x: np.ndarray, k: int, rng) -> np.ndarray:
    """k-means++ D^2-sampled rows of x (host float64) — spread starting
    means. Random-row starts routinely merge adjacent blobs into one
    component; D^2 sampling fixes that."""
    n = x.shape[0]
    means = np.empty((k, x.shape[1]))
    means[0] = x[rng.integers(0, n)]
    d2 = np.sum((x - means[0]) ** 2, axis=1)
    for i in range(1, k):
        total = float(d2.sum())
        if total <= 0.0:   # all remaining rows coincide with a center
            means[i] = x[rng.integers(0, n)] + 1e-3 * rng.normal(
                size=x.shape[1])
            continue
        j = int(np.searchsorted(np.cumsum(d2 / total), rng.random()))
        means[i] = x[min(j, n - 1)]
        d2 = np.minimum(d2, np.sum((x - means[i]) ** 2, axis=1))
    return means


def init_from_moments(n: float, s1: np.ndarray, s2: np.ndarray,
                      sample: np.ndarray, k: int, rng):
    """The ONE GMM start recipe shared by every fit path (in-memory,
    streamed, Spark plane): k-means++ rows from ``sample`` as means, the
    pooled diagonal variance (from the sufficient statistics n, sum x,
    sum x^2) as every component's covariance, uniform weights."""
    mu = s1 / n
    var = np.maximum(s2 / n - mu * mu, 1e-6)
    means = kmeans_pp_rows(np.asarray(sample, dtype=np.float64), k, rng)
    covs = np.tile(np.diag(var), (k, 1, 1))
    return np.full(k, 1.0 / k), means, covs


def init_params(x: np.ndarray, w: np.ndarray, k: int, seed: int):
    """Seeded start over an in-memory matrix (weighted moments)."""
    rng = np.random.default_rng(seed)
    w_sum = float(np.sum(w))
    s1 = w @ x
    s2 = w @ (x * x)
    return init_from_moments(w_sum, s1, s2, x, k, rng)
