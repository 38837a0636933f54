"""LogisticRegression on the device: Newton-IRLS, binary and multinomial.

Counterpart of the JAX package's ``ops/logreg_kernel.py``. Binary logistic
regression with L2, in Spark ML's objective convention:

    min_w  (1/n) Σ logloss(yᵢ, σ(xᵢ·w + b)) + (λ/2)·||w||²   (intercept
    unpenalized, like Spark's ``LogisticRegression`` with
    ``elasticNetParam=0``)

solved by Newton-IRLS: each iteration is the logits ``X·w``, the weighted
Hessian ``Xᵀdiag(s)X`` and an (n+1)² Cholesky solve. Masked (padding) rows,
or row weights, enter through ``valid``, which multiplies the residual, the
IRLS weights and the count.

**The Hessian is the hand Gram kernel.** The JAX package computes
``Xᵀdiag(s)X`` with ``lax.dot_general`` at ``Precision.HIGHEST``. Here it is
``centered_gram(x, None, √s, precision="highest")``: (diag(√s)·x)ᵀ
(diag(√s)·x) equals it in real arithmetic because s = p(1 − p)·valid ≥ 0,
and a float32 input on the card takes the kernel's full-f32 pipeline (one
launch per Newton iteration). s already carries the mask or the weights,
so they are not applied twice. The multinomial Hessian's (k, l) block has
weights p_k(δ_kl − p_l)·valid, which are ≥ 0 on the diagonal blocks and
≤ 0 off it: every block is ± a weighted Gram, +``centered_gram`` with
√(p_k(1 − p_k)·valid) or −``centered_gram`` with √(p_k·p_l·valid), and
block (l, k) equals block (k, l), so an iteration launches the kernel
K(K+1)/2 times, not K². The ones column of the JAX package's ``xa = [x |
1]`` is taken as column sums (Σ s·x, Σ s), the same split the binary step
uses, so no (n, d+1) copy of the rows is made; ``h_raw`` is then laid out
exactly as the JAX package lays it out.

Full float32 whatever the process's TF32 setting: the binary logits and
gradient are matrix-vector products (cuBLAS gemv, which no TF32 setting
reaches); the multinomial logits ``X·Wᵀ`` and gradient ``rᵀX`` are
products with K columns, so a float32 operand is multiplied in float64 and
rounded once, as ``ops/kmeans_kernel.py`` takes its cross term. The serving
bodies take the float32 logit and its σ in float64 and round once, so a
row's probability does not depend on the batch it is served in.

One difference from the JAX package, by design: the Newton loops are host
loops, where JAX's are ``lax.while_loop``s compiled into the program. Each
iteration reads its step size on the host (one scalar synchronisation per
iteration); ``n_iter`` counts as JAX counts (+1 per step, stop at
``max_iter`` or when done; ``max_iter = 0`` returns zeros).

A Hessian that is not positive definite gives NaN coefficients, as JAX's
``cho_factor`` does (``ops.linreg_kernel._cho_solve``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from spark_rapids_ml_tpu_torch.ops.covariance import centered_gram
from spark_rapids_ml_tpu_torch.ops.kmeans_kernel import _valid, _wide
from spark_rapids_ml_tpu_torch.ops.linreg_kernel import _cho_solve
from spark_rapids_ml_tpu_torch.ops.pca_kernel import (
    INT8_MIN_ROWS,
    INT8_MULTIPLE,
    _round_up,
)
from spark_rapids_ml_tpu_torch.ops.quantize import quantize_symmetric


class LogRegResult(NamedTuple):
    coefficients: torch.Tensor  # (n_features,)
    intercept: torch.Tensor     # scalar
    n_iter: torch.Tensor        # 0-d int32
    converged: torch.Tensor     # 0-d bool


def _weighted_gram(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Xᵀdiag(s)X for s ≥ 0: the hand kernel's full-f32 pipeline on the
    card (see the module docstring)."""
    return centered_gram(x, None, torch.sqrt(s), precision="highest")


def _newton_stats(w, b, x, y, valid):
    """The shard's (Xᵀr, XᵀSX, Xᵀs, Σr, Σs, Σvalid) at (w, b)."""
    p = torch.sigmoid(x @ w + b)
    r = (p - y) * valid                 # residual, masked
    s = p * (1.0 - p) * valid           # IRLS weights, masked
    return (x.T @ r, _weighted_gram(x, s), x.T @ s, torch.sum(r),
            torch.sum(s), torch.sum(valid))


def _grad_hess(w, x, y, valid, reg_param, fit_intercept, reduce_fn):
    """(gradient, Hessian) of the Spark-convention objective at w.

    ``w`` is (n+1,): coefficients ++ intercept slot (zero-pinned when
    ``fit_intercept`` is False). ``reduce_fn`` combines the per-shard
    (Xᵀr, XᵀWX, Σx·s, Σr, ΣW, n) partials: identity on one device, an
    all-reduce across ranks in the distributed form.
    """
    n_feat = x.shape[1]
    coef, b = w[:n_feat], w[n_feat]
    stats = reduce_fn(_newton_stats(coef, b, x, y, valid))
    gx, hxx, hxb, rsum, ssum, cnt = stats
    inv_n = 1.0 / torch.clamp_min(cnt, 1.0)
    eye = torch.eye(n_feat, dtype=w.dtype, device=w.device)
    g = torch.zeros_like(w)
    g[:n_feat] = gx * inv_n + reg_param * coef
    h = torch.zeros((n_feat + 1, n_feat + 1), dtype=w.dtype, device=w.device)
    h[:n_feat, :n_feat] = hxx * inv_n + reg_param * eye
    if fit_intercept:
        g[n_feat] = rsum * inv_n
        h[:n_feat, n_feat] = hxb * inv_n
        h[n_feat, :n_feat] = hxb * inv_n
        h[n_feat, n_feat] = ssum * inv_n
    else:
        # pin the intercept slot: unit diagonal, zero gradient
        h[n_feat, n_feat] = 1.0
    return g, h


def newton_iterations(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: Optional[torch.Tensor],
    reg_param: float,
    fit_intercept: bool,
    max_iter: int,
    tol: float,
    reduce_fn=lambda t: t,
) -> LogRegResult:
    """Undamped Newton with a Cholesky solve; the ridge term (or the
    pinned intercept slot) keeps H positive definite. A host loop with one
    scalar read per iteration (see the module docstring)."""
    valid = _valid(x, mask)
    y = y.to(x.dtype)
    n_feat = x.shape[1]
    w = torch.zeros((n_feat + 1,), dtype=x.dtype, device=x.device)
    n_iter = 0
    done = False
    while n_iter < max_iter and not done:
        g, h = _grad_hess(w, x, y, valid, reg_param, fit_intercept, reduce_fn)
        delta = _cho_solve(h, g)
        w = w - delta
        n_iter += 1
        done = bool(torch.max(torch.abs(delta)) <= tol)
    return LogRegResult(
        w[:n_feat], w[n_feat],
        torch.tensor(n_iter, dtype=torch.int32),
        torch.tensor(done),
    )


def logreg_fit_kernel(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
    max_iter: int = 100,
    tol: float = 1e-8,
) -> LogRegResult:
    return newton_iterations(
        x, y, mask, reg_param, fit_intercept, max_iter, tol
    )


def update_logreg_stats(carry, batch_z, w, b, mask=None):
    """Out-of-core Newton building block: fold one ``[X | y]`` batch's
    (Xᵀr, XᵀWX, Xᵀs, Σr, Σs, n) partials at the current (w, b) into the
    accumulator. One streamed pass with this per batch = one Newton
    gradient/Hessian evaluation over the full dataset. Returns a new
    carry (the JAX package donates the old one)."""
    dtype = carry[0].dtype
    x = batch_z[:, :-1].to(dtype)
    y = batch_z[:, -1].to(dtype)
    stats = _newton_stats(w.to(dtype), b.to(dtype), x, y, _valid(x, mask))
    return tuple(c + s for c, s in zip(carry, stats))


# -- serving bodies ----------------------------------------------------------
# Each model's serving program runs one, and the fused pipeline program
# chains them (models/_serving.py). The bf16 and int8 bodies reduce only
# the X·w product; their logit and σ stay at full float32 or better.


def _sigmoid_f32(z):
    """σ of a float32 logit, taken in float64 and rounded once. A row's
    probability then does not depend on the batch it is served in: the
    CPU's vectorised float32 σ takes a batch's tail elements by another
    path, one ulp apart."""
    return torch.sigmoid(z.double()).float()


def _predict_sigmoid(x, coefficients, intercept):
    """σ(X·w + b) with X·w + b and σ taken in float64 for a float32 batch
    and rounded once (see the module docstring)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x.double() @ coefficients.double()
                             + intercept.double()).float()
    return torch.sigmoid(x @ coefficients.to(x.dtype) + intercept.to(x.dtype))


# class probabilities of a batch, the model's ``predict_proba``
logreg_predict_kernel = _predict_sigmoid



def _predict_bf16(x, coefficients_bf16, intercept):
    """bf16 operands, f32 products and accumulation, an f32 logit: the JAX
    package's ``preferred_element_type=float32``. The coefficients arrive
    pre-cast (staged once at program build). The bf16-rounded operands are
    upcast to f32 before the product: products of two bf16 values are
    exact in f32 (and in TF32), where a bf16 product would round its
    output to bf16."""
    z = x.to(torch.bfloat16).float() @ coefficients_bf16.float()
    return _sigmoid_f32(z + intercept.float())



def pad_int8_coefficients(q):
    """Quantized (d,) coefficients as a (d8, 8) column block for
    ``torch._int_mm``: the coefficients in column 0, zero-padded to
    multiples of 8 in both widths. Only column 0 is read back."""
    d = q.shape[0]
    out = np.zeros((_round_up(d, INT8_MULTIPLE), INT8_MULTIPLE),
                   dtype=np.int8)
    out[:d, 0] = q
    return out


def _predict_int8(x, coefficients_q, coefficients_scale, intercept):
    """int8 logit with int32 accumulation (``ops.quantize``), dequantized
    in f32. The coefficients arrive pre-quantized and padded
    (``pad_int8_coefficients``); only the batch quantizes per call, and is
    zero-padded to ``torch._int_mm``'s shapes (rows to ``INT8_MIN_ROWS``,
    features to the coefficients' padded width). The rescale keeps the JAX
    package's association, ``acc * (sx * scale)``."""
    rows, n = x.shape
    xq, sx = quantize_symmetric(x)
    pad_rows = max(INT8_MIN_ROWS - rows, 0)
    pad_cols = coefficients_q.shape[0] - n
    if pad_rows or pad_cols:
        xq = F.pad(xq, (0, pad_cols, 0, pad_rows))
    acc = torch._int_mm(xq, coefficients_q)[:rows, 0]
    z = acc.float() * (sx * coefficients_scale)
    return _sigmoid_f32(z + intercept.float())


# σ(X·w+b) is output-typed (probabilities), so logreg composes only as the
# TERMINAL stage of a fused chain.
SERVING_STAGE_BODIES = {
    "native": _predict_sigmoid,
    "bf16": _predict_bf16,
    "int8": _predict_int8,
}


# -- multinomial (softmax) family --------------------------------------------
# Spark's LogisticRegression auto-selects multinomial when the label has
# more than two classes. Parameterization matches Spark/sklearn: one
# coefficient row per class (over-parameterized "symmetric" softmax, made
# identifiable by the L2 term), objective
#   (1/Σw)·Σᵢ wᵢ·CE(softmax(Wxᵢ+b), yᵢ) + (λ/2)·‖W‖²  (intercepts free).
# Full Newton on the (K·(d+1)) system.


class MultinomialResult(NamedTuple):
    coefficients: torch.Tensor  # (K, n_features)
    intercepts: torch.Tensor    # (K,)
    n_iter: torch.Tensor
    converged: torch.Tensor


def multinomial_raw_stats(wb, x, y_oh, valid):
    """Per-batch RAW softmax-Newton partials at the current (K, d+1)
    parameters: (gxa = rᵀ[x,1] (K, d+1), h_raw = the K²·(d+1)² block
    Hessian numerator, cnt = Σvalid). Additive across batches/shards: the
    accumulation unit for the streamed multinomial fit. ``h_raw[k·(d+1)+i,
    l·(d+1)+j]`` is block (k, l)'s entry (i, j), as in the JAX package."""
    n_feat = x.shape[1]
    k = y_oh.shape[1]
    dim = n_feat + 1
    w = wb[:, :n_feat].to(x.dtype)
    b = wb[:, n_feat].to(x.dtype)
    xw = _wide(x)                            # widened once for both products
    z = (xw @ w.T.to(xw.dtype)).to(x.dtype) + b[None, :]
    p = torch.softmax(z, dim=1)
    r = (p - y_oh) * valid[:, None]          # (n, K)
    gx = (r.to(xw.dtype).T @ xw).to(x.dtype)
    del xw
    gxa = torch.cat([gx, r.sum(dim=0)[:, None]], dim=1)
    h_raw = torch.empty((k * dim, k * dim), dtype=x.dtype, device=x.device)
    for kk in range(k):
        for ll in range(kk, k):
            if kk == ll:
                s = p[:, kk] * (1.0 - p[:, kk]) * valid
                sign = 1.0
            else:
                s = p[:, kk] * p[:, ll] * valid
                sign = -1.0
            blk = torch.empty((dim, dim), dtype=x.dtype, device=x.device)
            blk[:n_feat, :n_feat] = _weighted_gram(x, s)
            border = x.T @ s
            blk[:n_feat, n_feat] = border
            blk[n_feat, :n_feat] = border
            blk[n_feat, n_feat] = torch.sum(s)
            if sign < 0:
                blk = -blk
            rk = slice(kk * dim, (kk + 1) * dim)
            rl = slice(ll * dim, (ll + 1) * dim)
            h_raw[rk, rl] = blk
            if kk != ll:
                h_raw[rl, rk] = blk   # each block is symmetric
    return gxa, h_raw, torch.sum(valid)


def assemble_multinomial_system(gxa, h_raw, cnt, wb, reg_param,
                                fit_intercept):
    """(g, h) of the softmax Newton system from accumulated raw partials:
    regularization, intercept pinning and the gauge ridge live HERE, once,
    shared by the in-memory kernel and the streamed assembler."""
    k, dim = wb.shape
    n_feat = dim - 1
    dtype = h_raw.dtype
    dev = h_raw.device
    cnt = torch.clamp_min(torch.as_tensor(cnt, dtype=dtype, device=dev), 1.0)
    w = wb[:, :n_feat].to(dtype)
    g = gxa / cnt
    g[:, :n_feat] += reg_param * w
    if not fit_intercept:
        g[:, n_feat] = 0.0
    h = h_raw / cnt
    if not fit_intercept:
        # Pin the intercept slots COMPLETELY: zero their rows and columns,
        # identity diagonal. Zeroing only the gradient would still let
        # Newton steps couple features to implicit intercepts through the
        # off-diagonal Hessian blocks and silently train the wrong model.
        keep = torch.ones(dim, dtype=dtype, device=dev)
        keep[n_feat] = 0.0
        keep = keep.repeat(k)
        h = h * keep[:, None] * keep[None, :]

    # L2 on coefficients. The softmax parameterization is invariant under
    # a uniform shift of all K (unpenalized) intercepts (an EXACT null
    # direction for any reg_param), and at reg_param=0 the class-shifted
    # coefficient direction joins it. Pin the gauge with a dtype-scaled
    # ridge (sqrt(eps) × the Hessian's diagonal scale): predictions are
    # invariant to the gauge, and the ridge is far above float32 rounding.
    eps_ridge = torch.sqrt(torch.tensor(torch.finfo(dtype).eps, dtype=dtype,
                                        device=dev)) * torch.clamp_min(
        torch.mean(torch.diagonal(h)), 1.0)
    reg_one = torch.full((dim,), reg_param, dtype=dtype, device=dev)
    reg_one[n_feat] = 0.0 if fit_intercept else 1.0
    reg_diag = reg_one.repeat(k)
    h = h + torch.diag(reg_diag) + eps_ridge * torch.eye(k * dim, dtype=dtype,
                                                         device=dev)
    return g, h


def _softmax_grad_hess(wb, x, y_oh, valid, reg_param, fit_intercept):
    gxa, h_raw, cnt = multinomial_raw_stats(wb, x, y_oh, valid)
    return assemble_multinomial_system(
        gxa, h_raw, cnt, wb, reg_param, fit_intercept
    )


def update_multinomial_stats(carry, x, y_oh, wb, mask=None):
    """Out-of-core softmax-Newton building block: fold one batch's raw
    partials at the current parameters into the accumulator. One streamed
    pass = one Newton gradient/Hessian evaluation. Returns a new carry."""
    gxa, h_raw, cnt = carry
    x = x.to(gxa.dtype)
    g, h, c = multinomial_raw_stats(wb, x, y_oh.to(gxa.dtype),
                                    _valid(x, mask))
    return gxa + g, h_raw + h, cnt + c


def multinomial_fit_kernel(
    x: torch.Tensor,
    y_onehot: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
    max_iter: int = 25,
    tol: float = 1e-6,
    n_classes: int = 2,
) -> MultinomialResult:
    """Softmax Newton as a host loop: it runs while ``i < max_iter`` and
    the last step moved more than ``tol`` (so a NaN step stops it, as the
    JAX loop's condition does)."""
    n_feat = x.shape[1]
    valid = _valid(x, mask)
    y_onehot = y_onehot.to(x.dtype)
    wb = torch.zeros((n_classes, n_feat + 1), dtype=x.dtype, device=x.device)
    n_iter = 0
    delta = float("inf")
    while n_iter < max_iter and delta > tol:
        g, h = _softmax_grad_hess(wb, x, y_onehot, valid, reg_param,
                                  fit_intercept)
        step = _cho_solve(h, g.reshape(-1)).reshape(n_classes, n_feat + 1)
        wb = wb - step
        n_iter += 1
        delta = float(torch.max(torch.abs(step)))
    return MultinomialResult(
        coefficients=wb[:, :n_feat],
        intercepts=wb[:, n_feat] * (1.0 if fit_intercept else 0.0),
        n_iter=torch.tensor(n_iter, dtype=torch.int32),
        converged=torch.tensor(delta <= tol),
    )
