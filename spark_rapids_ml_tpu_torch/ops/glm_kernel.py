"""GLM IRLS per-iteration pass (the family × link grid), on the device.

Counterpart of the JAX package's ``ops/glm_kernel.py``. One IRLS pass:
η → μ → working response z and weights W → the weighted sufficient
statistics (XᵀWX, XᵀWz, ΣWx, ΣWz, ΣW) and the deviance. The small (d × d)
solve stays on the host in float64 (``models/glm.py``), the same
statistics/solve split as ``ops/linreg_kernel.py``.

Every family/link function takes an array-module argument ``xp``: numpy
(the host fallback, ``useXlaDot=False``) or ``TORCH_XP`` (the device), so
both run the same formulas. ``TORCH_XP`` maps the numpy names those
functions call onto torch: ``clip``/``maximum`` with a Python bound become
``clamp``/``clamp_min`` (the bound rounds to the tensor's dtype, as it does
under JAX: at float32 binomial's 1 − 1e-10 rounds to 1.0 there too), the
normal CDF and its inverse become ``torch.special.ndtr``/``ndtri``
(scipy's on the host), and ``_xlogy``'s guards keep 0·log 0 = 0 on both.

**XᵀWX is the hand Gram kernel.** The JAX package computes it with
``lax.dot_general`` at ``Precision.HIGHEST``. Here it is
``centered_gram(x, None, √W, precision="highest")``: W = w_prior / (V(μ)·
g′(μ)²) ≥ 0 (prior weights are checked non-negative), so (diag(√W)·x)ᵀ
(diag(√W)·x) equals XᵀWX in real arithmetic, and a float32 input on the
card takes the kernel's full-f32 pipeline, one launch per pass (per bucket
when streamed). XᵀWz and ΣWx are matrix-vector products (cuBLAS gemv,
which no TF32 setting reaches), taken as Xᵀ(W·z) and XᵀW, so no (rows, d)
copy of W·X is made. The host pass keeps the JAX package's numpy
expressions exactly.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.ops.covariance import centered_gram

FAMILIES = ("gaussian", "binomial", "poisson", "gamma", "tweedie")

# Spark's supported link grid per family (GeneralizedLinearRegression
# docs); "tweedie" takes a power link parameterized by linkPower instead
# of a named link.
FAMILY_LINKS = {
    "gaussian": ("identity", "log", "inverse"),
    "binomial": ("logit", "probit", "cloglog"),
    "poisson": ("log", "identity", "sqrt"),
    "gamma": ("inverse", "identity", "log"),
}

CANONICAL_LINK = {
    "gaussian": "identity",
    "binomial": "logit",
    "poisson": "log",
    "gamma": "inverse",
}

_EPS = 1e-10


class _TorchXP:
    """The array module ``xp`` for torch tensors: the numpy names the
    family and link functions call. Every bound they pass is a Python
    float."""

    log = staticmethod(torch.log)
    log1p = staticmethod(torch.log1p)
    exp = staticmethod(torch.exp)
    expm1 = staticmethod(torch.expm1)
    sqrt = staticmethod(torch.sqrt)
    ones_like = staticmethod(torch.ones_like)
    where = staticmethod(torch.where)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def maximum(x, bound):
        return torch.clamp_min(x, bound)

    @staticmethod
    def sum(x, axis=None):
        return torch.sum(x) if axis is None else torch.sum(x, dim=axis)


TORCH_XP = _TorchXP()


def _ndtri(xp, q):
    if xp is np:
        from scipy.special import ndtri

        return ndtri(q)
    return torch.special.ndtri(q)


def _ndtr(xp, x):
    if xp is np:
        from scipy.special import ndtr

        return ndtr(x)
    return torch.special.ndtr(x)


def _norm_pdf(xp, x):
    return xp.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def link_funcs(link: str, link_power: float = 1.0) -> Tuple[
    Callable, Callable, Callable
]:
    """(g, g_inverse, g_prime) for a named link; each takes (xp, array).

    g maps mu -> eta; g_prime is dg/dmu (enters both the working response
    and the IRLS weight).
    """
    if link == "identity":
        return (lambda xp, mu: mu,
                lambda xp, eta: eta,
                lambda xp, mu: xp.ones_like(mu))
    if link == "log":
        return (lambda xp, mu: xp.log(mu),
                lambda xp, eta: xp.exp(eta),
                lambda xp, mu: 1.0 / mu)
    if link == "logit":
        return (lambda xp, mu: xp.log(mu) - xp.log1p(-mu),
                lambda xp, eta: 1.0 / (1.0 + xp.exp(-eta)),
                lambda xp, mu: 1.0 / (mu * (1.0 - mu)))
    if link == "inverse":
        return (lambda xp, mu: 1.0 / mu,
                lambda xp, eta: 1.0 / eta,
                lambda xp, mu: -1.0 / (mu * mu))
    if link == "sqrt":
        return (lambda xp, mu: xp.sqrt(mu),
                lambda xp, eta: eta * eta,
                lambda xp, mu: 0.5 / xp.sqrt(mu))
    if link == "probit":
        return (lambda xp, mu: _ndtri(xp, mu),
                lambda xp, eta: _ndtr(xp, eta),
                lambda xp, mu: 1.0 / _norm_pdf(xp, _ndtri(xp, mu)))
    if link == "cloglog":
        return (lambda xp, mu: xp.log(-xp.log1p(-mu)),
                lambda xp, eta: -xp.expm1(-xp.exp(eta)),
                lambda xp, mu: -1.0 / ((1.0 - mu) * xp.log1p(-mu)))
    if link == "power":
        lp = float(link_power)
        if lp == 0.0:
            return link_funcs("log")
        return (lambda xp, mu: mu ** lp,
                lambda xp, eta: eta ** (1.0 / lp),
                lambda xp, mu: lp * mu ** (lp - 1.0))
    raise ValueError(f"unknown link {link!r}")


def _xlogy(xp, a, b):
    """a * log(a/b) with the a==0 limit handled (binomial/poisson dev)."""
    safe = xp.where(a > 0, a, 1.0)
    safe_b = xp.where(b > 0, b, 1.0)
    return xp.where(a > 0, a * (xp.log(safe) - xp.log(safe_b)), 0.0)


def family_funcs(family: str, var_power: float = 0.0) -> Tuple[
    Callable, Callable, Callable, Callable
]:
    """(variance, unit_deviance, clip_mu, init_mu) for a family.

    variance/unit_deviance/clip_mu take (xp, ...); init_mu takes
    (xp, y, w) and produces the IRLS starting mean (the standard GLM
    start used by R and Spark alike).
    """
    if family == "gaussian":
        return (lambda xp, mu: xp.ones_like(mu),
                lambda xp, y, mu: (y - mu) ** 2,
                lambda xp, mu: mu,
                lambda xp, y, w: y)
    if family == "binomial":
        return (lambda xp, mu: mu * (1.0 - mu),
                lambda xp, y, mu: 2.0 * (_xlogy(xp, y, mu)
                                         + _xlogy(xp, 1.0 - y, 1.0 - mu)),
                lambda xp, mu: xp.clip(mu, _EPS, 1.0 - _EPS),
                lambda xp, y, w: (w * y + 0.5) / (w + 1.0))
    if family == "poisson":
        return (lambda xp, mu: mu,
                lambda xp, y, mu: 2.0 * (_xlogy(xp, y, mu) - (y - mu)),
                lambda xp, mu: xp.maximum(mu, _EPS),
                lambda xp, y, w: y + 0.1)
    if family == "gamma":
        return (lambda xp, mu: mu * mu,
                lambda xp, y, mu: -2.0 * (xp.log(y / mu) - (y - mu) / mu),
                lambda xp, mu: xp.maximum(mu, _EPS),
                lambda xp, y, w: y)
    if family == "tweedie":
        p = float(var_power)
        if p == 0.0:
            return family_funcs("gaussian")
        if p == 1.0:
            return family_funcs("poisson")
        if p == 2.0:
            return family_funcs("gamma")

        def dev(xp, y, mu):
            # 2*[ y^(2-p)/((1-p)(2-p)) - y*mu^(1-p)/(1-p) + mu^(2-p)/(2-p) ]
            ymax = xp.maximum(y, 0.0)
            return 2.0 * (ymax ** (2.0 - p) / ((1.0 - p) * (2.0 - p))
                          - y * mu ** (1.0 - p) / (1.0 - p)
                          + mu ** (2.0 - p) / (2.0 - p))

        return (lambda xp, mu: mu ** p,
                dev,
                lambda xp, mu: xp.maximum(mu, _EPS),
                lambda xp, y, w: y + 0.1)
    raise ValueError(f"unknown family {family!r}")


class GlmStepOut(NamedTuple):
    """One IRLS iteration's reduced outputs (all small: d x d and d)."""

    xtx: object   # X' W X            (d, d)
    xtz: object   # X' W z            (d,)
    x_sum: object  # sum(w x)         (d,)
    z_sum: object  # sum(w z)         scalar
    w_sum: object  # sum(w)           scalar
    deviance: object  # sum(w_prior * unit_dev(y, mu))  scalar


def irls_step_math(xp, x, y, w_prior, offset, coef, intercept, *,
                   family: str, link: str, var_power: float,
                   link_power: float, use_init_mu: bool = False) -> GlmStepOut:
    """The ONE definition of a weighted IRLS pass, under numpy (the host
    fallback) and under ``TORCH_XP`` (the device) alike; only the
    products differ (see the module docstring).

    ``use_init_mu`` is the first-iteration start (R glm.fit's mustart):
    mu comes elementwise from the family's standard starting mean of y,
    NOT from the (zero) coefficients — essential for inverse/log links,
    where eta=0 would put mu at a pole and poison the working weights.
    """
    variance, unit_dev, clip_mu, init_mu = family_funcs(family, var_power)
    g, ginv, gprime = link_funcs(link, link_power)
    if use_init_mu:
        mu = clip_mu(xp, init_mu(xp, y, w_prior))
        eta = g(xp, mu) + offset
    else:
        eta = x @ coef + intercept + offset
        mu = clip_mu(xp, ginv(xp, eta))
    gp = gprime(xp, mu)
    z = (eta - offset) + (y - mu) * gp
    wi = w_prior / (variance(xp, mu) * gp * gp)
    deviance = xp.sum(w_prior * unit_dev(xp, y, mu))
    if xp is np:
        xw = x * wi[:, None]
        return GlmStepOut(
            xtx=x.T @ xw,
            xtz=xw.T @ z,
            x_sum=xp.sum(xw, axis=0),
            z_sum=xp.sum(wi * z),
            w_sum=xp.sum(wi),
            deviance=deviance,
        )
    return GlmStepOut(
        xtx=centered_gram(x, None, torch.sqrt(wi), precision="highest"),
        xtz=x.T @ (wi * z),
        x_sum=x.T @ wi,
        z_sum=torch.sum(wi * z),
        w_sum=torch.sum(wi),
        deviance=deviance,
    )


def glm_irls_device_step(x, y, w_prior, offset, coef, intercept, *, family,
                         link, var_power, link_power, use_init_mu=False):
    """One IRLS pass on device tensors (the JAX package's jitted step):
    its Gram is one kernel launch for a float32 CUDA input."""
    return irls_step_math(
        TORCH_XP, x, y, w_prior, offset, coef, intercept, family=family,
        link=link, var_power=float(var_power), link_power=float(link_power),
        use_init_mu=bool(use_init_mu),
    )


def deviance_math(xp, y, mu, w, *, family: str, var_power: float = 0.0):
    _, unit_dev, _, _ = family_funcs(family, var_power)
    return xp.sum(w * unit_dev(xp, y, mu))


def validate_label_range(y: np.ndarray, *, family: str,
                         var_power: float = 0.0) -> None:
    if family == "binomial":
        if ((y < 0) | (y > 1)).any():
            raise ValueError("binomial labels must lie in [0, 1]")
    elif family == "poisson" or (family == "tweedie" and var_power != 0.0):
        if (y < 0).any():
            raise ValueError(f"{family} labels must be non-negative")
    elif family == "gamma":
        if (y <= 0).any():
            raise ValueError("gamma labels must be positive")
