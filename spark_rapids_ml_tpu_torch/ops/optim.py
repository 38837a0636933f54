"""The shared smooth-objective optimizer loop: L-BFGS, GD and adamW.

Counterpart of the JAX package's ``ops/optim.py::minimize_kernel``, with
its loop semantics: the loop runs while ``it < max_iter`` and
``|value − prev| ≥ tol`` (a NaN value ends it), each iteration evaluates
the objective at the current iterate and then steps, and the loss it
returns is the one evaluated at the iterate BEFORE the last step, so a
fit's ``final_loss_`` lags its params by one step, as JAX's does.

The JAX package compiles the whole loop into one ``lax.while_loop`` over
optax updates. Here the parameters travel as ONE flat vector on their
device (the leaves of ``params`` concatenated in order; the objective sees
views of it in the leaves' shapes), gradients come from
``torch.autograd``, and the data-dependent control flow (the stop test
and the line search) runs on the host: each line-search trial syncs the
card once, for its value and its slope along the search direction, and
each iteration once more for the slope at its start (GD and adamW once
an iteration, for the value).

The solvers are copies of optax 0.2.6 (Apache-2.0), which the port does
not import:

* ``'l-bfgs'`` is ``optax.lbfgs()``: ``alias.py::lbfgs`` (memory 10,
  ``scale_init_precond=True``, then ``scale(-1)``),
  ``transform.py::scale_by_lbfgs`` (the two-loop recursion; a memory
  entry's weight is 0 where sᵀy = 0; the first direction scaled by
  min(1, 1/‖g‖), later ones by sᵀy/‖y‖²) and
  ``linesearch.py::scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')`` (Nocedal and Wright's Algorithms 3.5 /
  3.6 with optax's Wolfe constants c₁ = 1e-4, c₂ = 0.9, Hager and Zhang's
  approximate decrease at 1e-6, cubic then quadratic interpolation with
  the 0.2 / 0.1 safeguards, bisection otherwise, the 1e-5 interval
  threshold, and optax's safe step when the search fails). The value and
  gradient at the accepted step are those the search computed there,
  where the JAX loop evaluates the same point again: the same numbers for
  half the evaluations;
* ``'adamW'`` is ``optax.adamw(lr, weight_decay=0.0)`` with optax's
  defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias correction);
* ``'gd'`` is p ← p − step_size·∇f.

The line search's scalars (values, slopes, step sizes) are float64 on the
host whatever the parameters' dtype; the vectors stay in it. A float32
product inside the objective is the objective's business
(``ops/mlp_kernel.py`` takes its products in float64 and rounds once).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

SOLVERS = ("l-bfgs", "gd", "adamW")

# optax.lbfgs() and its zoom line search, as optax 0.2.6 sets them
LBFGS_MEMORY = 10
LS_MAX_STEPS = 20
LS_INCREASE = 2.0
LS_SLOPE_RTOL = 1e-4
LS_CURV_RTOL = 0.9
LS_APPROX_DEC_RTOL = 1e-6
LS_INTERVAL_THRESHOLD = 1e-5
LS_TOL = 0.0

# optax.adamw's defaults
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8

# (value, gradient) of the objective at a flat parameter vector
ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def flatten(params: Sequence[torch.Tensor]) -> torch.Tensor:
    """The leaves concatenated, in order, into one detached vector."""
    return torch.cat([p.detach().reshape(-1) for p in params])


def unflatten(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    """Views of ``flat`` in ``shapes``, in order."""
    out, pos = [], 0
    for shape in shapes:
        n = int(np.prod(shape, dtype=np.int64))
        out.append(flat[pos:pos + n].view(shape))
        pos += n
    if pos != flat.numel():
        raise ValueError(
            f"{flat.numel()} parameters do not fill shapes {list(shapes)}")
    return out


def autograd_value_and_grad(loss_fn, data, shapes) -> ValueAndGrad:
    """``loss_fn(params, *data)`` and its gradient by ``torch.autograd``,
    as a function of the flat parameter vector."""

    def value_and_grad(flat: torch.Tensor):
        leaf = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            value = loss_fn(unflatten(leaf, shapes), *data)
            (grad,) = torch.autograd.grad(value, leaf)
        return value.detach(), grad

    return value_and_grad


def weighted_mean_value_and_grad(rowloss_fn, data, weights, shapes,
                                 reduce=None) -> ValueAndGrad:
    """Σ w·rowloss_fn(params, *data) / Σ w and its gradient, as a function
    of the flat parameter vector: the numerator, Σ w and the numerator's
    gradient are packed into one buffer, which ``reduce`` (an in-place sum
    across ranks, or None) sums before the one division. A fit on one
    device and a sharded fit on one rank compute the same bits."""

    def value_and_grad(flat: torch.Tensor):
        leaf = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            num = (weights * rowloss_fn(unflatten(leaf, shapes),
                                        *data)).sum()
            (grad,) = torch.autograd.grad(num, leaf)
        packed = torch.cat([num.detach().reshape(1),
                            weights.sum().reshape(1), grad])
        if reduce is not None:
            reduce(packed)
        den = packed[1]
        return packed[0] / den, packed[2:] / den

    return value_and_grad


def _host(*scalars: torch.Tensor) -> List[np.float64]:
    """0-d tensors as host float64 scalars, in one device → host copy."""
    vals = torch.stack([s.reshape(()).to(torch.float64) for s in scalars])
    return [np.float64(v) for v in vals.tolist()]


# -- optax's zoom line search ---------------------------------------------

class LinesearchResult(NamedTuple):
    """What ``scale_by_zoom_linesearch`` leaves: the step size, the value
    and gradient there, the steps taken and the last trial's errors."""
    stepsize: float
    value: torch.Tensor
    grad: torch.Tensor
    value_host: float
    steps: int
    decrease_error: float
    curvature_error: float


def _decrease_error(t, value, slope, value0, slope0):
    """optax ``_compute_decrease_error``: Armijo, or Hager and Zhang's
    approximate decrease once the value is within 1e-6·|f₀| of f₀."""
    dec = value - value0 - LS_SLOPE_RTOL * t * slope0
    approx = slope - (2 * LS_SLOPE_RTOL - 1.0) * slope0
    delta_values = value - value0 - LS_APPROX_DEC_RTOL * np.abs(value0)
    approx = np.maximum(approx, delta_values)
    dec = np.maximum(np.minimum(approx, dec), 0.0)
    return np.inf if np.isnan(dec) else dec


def _curvature_error(slope, slope0):
    curv = np.maximum(np.abs(slope) - LS_CURV_RTOL * np.abs(slope0), 0.0)
    return np.inf if np.isnan(curv) else curv


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax ``_cubicmin``: the minimiser of the cubic through (a, fa)
    with slope fpa at a, (b, fb) and (c, fc); NaN where there is none."""
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1 = fb - fa - fpa * db
    r2 = fc - fa - fpa * dc
    big_a = (dc ** 2 * r1 - db ** 2 * r2) / denom
    big_b = (-(dc ** 3) * r1 + db ** 3 * r2) / denom
    radical = big_b * big_b - 3.0 * big_a * fpa
    return a + (-big_b + np.sqrt(radical)) / (3.0 * big_a)


def _quadmin(a, fa, fpa, b, fb):
    """optax ``_quadmin``: the minimiser of the quadratic through (a, fa)
    with slope fpa at a and (b, fb)."""
    db = b - a
    big_b = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * big_b)


def zoom_linesearch(value_and_grad: ValueAndGrad, params: torch.Tensor,
                    direction: torch.Tensor, value: torch.Tensor,
                    grad: torch.Tensor, value_host=None) -> LinesearchResult:
    """optax ``scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy='one')`` along ``direction`` from ``params``,
    whose value and gradient are given: the interval search from step 1,
    doubling, then the zoom, as optax's ``zoom_linesearch`` runs them."""
    with np.errstate(all="ignore"):
        return _zoom(value_and_grad, params, direction, value, grad,
                     value_host)


def _zoom(vg, params, d, value0_t, grad0, value0):
    if value0 is None:
        value0, slope0 = _host(value0_t, torch.dot(d, grad0))
    else:
        (slope0,) = _host(torch.dot(d, grad0))
        value0 = np.float64(value0)
    f64 = np.float64
    # the state of optax's ZoomLinesearchState, as host scalars
    t, f_t, g_t, s_t = f64(0.0), value0, grad0, slope0
    f_t_dev = value0_t
    dec = curv = f64(np.inf)
    interval_found = done = failed = False
    low, f_low, s_low = f64(0.0), value0, slope0
    high, f_high, s_high = f64(0.0), value0, slope0
    cubic_ref, f_cubic_ref = f64(0.0), value0
    safe_t, safe_f, safe_f_dev, safe_g = f64(0.0), value0, value0_t, grad0
    count = 0

    def on_line(step):
        val_dev, g = vg(torch.add(params, d, alpha=float(step)))
        val, slope = _host(val_dev, torch.dot(g, d))
        return val, val_dev, g, slope

    while not (done or failed):
        if not interval_found:
            new_t = f64(1.0) if count == 0 else LS_INCREASE * t
            new_f, new_f_dev, new_g, new_s = on_line(new_t)
            dec = _decrease_error(new_t, new_f, new_s, value0, slope0)
            curv = _curvature_error(new_s, slope0)
            err = np.maximum(dec, curv)
            if dec <= LS_TOL:
                safe_t, safe_f, safe_f_dev, safe_g = (new_t, new_f,
                                                      new_f_dev, new_g)
            set_high = (dec > 0.0) or (new_f >= f_t and count > 0)
            set_low = (new_s >= 0.0) and not set_high
            if set_low:
                low, f_low, s_low = new_t, new_f, new_s
                high, f_high, s_high = t, f_t, s_t
            else:
                low, f_low, s_low = t, f_t, s_t
                high, f_high, s_high = new_t, new_f, new_s
            interval_found = set_high or set_low or err <= LS_TOL
            done = bool(err <= LS_TOL)
            failed = (count + 1 >= LS_MAX_STEPS) and not done
            cubic_ref, f_cubic_ref = low, f_low
        else:
            delta = np.abs(high - low)
            left, right = np.minimum(high, low), np.maximum(high, low)
            too_small = delta <= LS_INTERVAL_THRESHOLD
            mc = _cubicmin(low, f_low, s_low, high, f_high, cubic_ref,
                           f_cubic_ref)
            use_cubic = (mc > left + 0.2 * delta) and (
                mc < right - 0.2 * delta)
            mq = _quadmin(low, f_low, s_low, high, f_high)
            use_quad = (not use_cubic) and (mq > left + 0.1 * delta) and (
                mq < right - 0.1 * delta)
            new_t = (mc if use_cubic else mq if use_quad
                     else (low + high) / 2.0)
            new_f, new_f_dev, new_g, new_s = on_line(new_t)
            dec = _decrease_error(new_t, new_f, new_s, value0, slope0)
            curv = _curvature_error(new_s, slope0)
            err = np.maximum(dec, curv)
            if dec <= LS_TOL and new_f < safe_f:
                safe_t, safe_f, safe_f_dev, safe_g = (new_t, new_f,
                                                      new_f_dev, new_g)
            done = bool(err <= LS_TOL)
            set_high_mid = (dec > 0.0) or (new_f >= f_low)
            set_high_low = (new_s * (high - low) >= 0.0) and not set_high_mid
            old_high, old_f_high = high, f_high
            old_low, old_f_low = low, f_low
            if set_high_mid:
                high, f_high, s_high = new_t, new_f, new_s
            elif set_high_low:
                high, f_high, s_high = low, f_low, s_low
            if not set_high_mid:
                low, f_low, s_low = new_t, new_f, new_s
            if set_high_mid or set_high_low:
                cubic_ref, f_cubic_ref = old_high, old_f_high
            else:
                cubic_ref, f_cubic_ref = old_low, old_f_low
            failed = ((count + 1 >= LS_MAX_STEPS)
                      or (too_small and safe_t > 0.0)) and not done
        t, f_t, f_t_dev, g_t, s_t = new_t, new_f, new_f_dev, new_g, new_s
        count += 1
        if failed and (safe_t > 0.0 or np.isinf(dec)):
            # optax's _try_safe_step: the best step that met the decrease
            # criterion, or no step at all when every trial left the domain
            t, f_t, f_t_dev, g_t = safe_t, safe_f, safe_f_dev, safe_g
    return LinesearchResult(float(t), f_t_dev, g_t, float(f_t), count,
                            float(dec), float(curv))


# -- optax's L-BFGS -------------------------------------------------------

class _LBFGSMemory:
    """``scale_by_lbfgs``'s state: the last ``LBFGS_MEMORY`` (s, y, ρ)
    triples in a ring, the previous iterate and gradient, and the count."""

    def __init__(self, like: torch.Tensor):
        m = LBFGS_MEMORY
        self.s = like.new_zeros((m,) + tuple(like.shape))
        self.y = like.new_zeros((m,) + tuple(like.shape))
        self.rho = like.new_zeros((m,))
        self.prev_params = torch.zeros_like(like)
        self.prev_grad = torch.zeros_like(like)
        self.count = 0

    def direction(self, params: torch.Tensor,
                  grad: torch.Tensor) -> torch.Tensor:
        """Record (params, grad) and return −H·grad: the memory update and
        the two-loop recursion of ``scale_by_lbfgs``, then ``scale(-1)``.
        No host sync: every scalar stays a 0-d tensor on the device."""
        m = LBFGS_MEMORY
        if self.count > 0:
            s = params - self.prev_params
            y = grad - self.prev_grad
            sy = torch.dot(y, s)
            slot = (self.count - 1) % m
            self.s[slot] = s
            self.y[slot] = y
            self.rho[slot] = torch.where(sy == 0.0, torch.zeros_like(sy),
                                         1.0 / sy)
            yy = torch.dot(y, y)
            gamma = torch.where(yy > 0.0, sy / yy, torch.ones_like(yy))
        else:
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(grad),
                                max=1.0)
        self.prev_params, self.prev_grad = params, grad
        # newest first; slots never written hold ρ = 0 and change nothing
        filled = min(self.count, m)
        order = [(self.count - 1 - j) % m for j in range(filled)]
        self.count += 1
        q = grad
        alphas = []
        for idx in order:
            alpha = self.rho[idx] * torch.dot(self.s[idx], q)
            q = q - alpha * self.y[idx]
            alphas.append(alpha)
        r = gamma * q
        for idx, alpha in zip(reversed(order), reversed(alphas)):
            beta = self.rho[idx] * torch.dot(self.y[idx], r)
            r = r + (alpha - beta) * self.s[idx]
        return -r


# -- the loop -------------------------------------------------------------

def minimize_flat(x0: torch.Tensor, value_and_grad: ValueAndGrad, *,
                  solver: str, max_iter: int, tol: float,
                  step_size: float = 0.01):
    """The loop of ``minimize`` on a flat parameter vector and any
    (value, gradient) function: (x, n_iter, loss) with the JAX loop's
    stop test and its one-step lag of the returned loss."""
    if solver not in SOLVERS:
        raise ValueError(f"solver {solver!r}: expected one of {SOLVERS}")
    x = x0.detach()
    value, prev = np.inf, 0.0
    it = 0
    if solver == "l-bfgs":
        memory = _LBFGSMemory(x)
        at_x = None  # (value tensor, grad, host value) at x, when known
        while it < max_iter and np.abs(value - prev) >= tol:
            if at_x is None:
                f_dev, g = value_and_grad(x)
                (f_host,) = _host(f_dev)
            else:
                f_dev, g, f_host = at_x
            d = memory.direction(x, g)
            ls = zoom_linesearch(value_and_grad, x, d, f_dev, g,
                                 value_host=f_host)
            x = torch.add(x, d, alpha=ls.stepsize)
            at_x = (ls.value, ls.grad, ls.value_host)
            value, prev = float(f_host), value
            it += 1
        return x, it, value
    mu = torch.zeros_like(x)
    nu = torch.zeros_like(x)
    while it < max_iter and np.abs(value - prev) >= tol:
        f_dev, g = value_and_grad(x)
        if solver == "gd":
            x = x - step_size * g
        else:
            mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
            nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu
            count = it + 1
            mu_hat = mu / (1 - ADAM_B1 ** count)
            nu_hat = nu / (1 - ADAM_B2 ** count)
            x = x + (-step_size) * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
        (f_host,) = _host(f_dev)
        value, prev = float(f_host), value
        it += 1
    return x, it, value


def minimize(params: Sequence[torch.Tensor], data, loss_fn, solver: str,
             max_iter: int, tol: float, step_size: float = 0.01):
    """Minimize ``loss_fn(params, *data)`` from ``params`` (tensors on one
    device, in one dtype): ``(params, n_iter, loss)``, the params as new
    tensors of the same shapes, ``loss`` a host float lagging them by one
    step."""
    shapes = [tuple(p.shape) for p in params]
    x, n_iter, loss = minimize_flat(
        flatten(params), autograd_value_and_grad(loss_fn, data, shapes),
        solver=solver, max_iter=max_iter, tol=tol, step_size=step_size)
    return [p.clone() for p in unflatten(x, shapes)], n_iter, loss
