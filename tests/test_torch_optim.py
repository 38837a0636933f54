"""The port's optimizer loop (``ops/optim.py``) against optax through the
JAX package, at float64, on the same numpy inputs.

* L-BFGS: the port's iterate after each of the first 10 iterations within
  1e-10 (max |Δ| / max |p|) of ``optax.lbfgs()``'s, stepped the way JAX's
  ``ops/optim.py::minimize_kernel`` body steps it (value and gradient at
  p, ``opt.update(..., value_fn=objective)``, ``apply_updates``) in one
  jitted update, on a small MLP objective and on a convex quadratic with
  two leaves; and ``minimize_kernel`` itself run to its loss-change
  tolerance: ``n_iter`` equal, the quadratic's params within 1e-10 (the
  separable MLP's within the MLP bar 1e-8), the loss within 1e-12
  relative and equal to the objective at the iterate before the last
  step (the one-step lag).
* GD and adamW after 50 steps through ``minimize_kernel``: params within
  1e-12, the loss within 1e-12 relative.
* The zoom line search where it fails: on a flat objective
  (f = 1 + 1e-20·‖p‖², the values never change) and along an ascent
  direction, the step size, the number of steps and the last decrease and
  curvature errors equal optax's ``scale_by_zoom_linesearch`` state.
"""

import functools

import numpy as np
import pytest
import torch

F64_ITER_RTOL = 1e-10
LOSS_RTOL = 1e-12
GD_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def _rel(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- the two objectives, each in both packages --------------------------------

def _mlp_problem():
    """A [4, 6, 3] MLP's weighted mean cross-entropy on 3 seeded blobs."""
    from spark_rapids_ml_tpu.ops import mlp_kernel as jax_mlp

    rng = np.random.default_rng(7)
    centers = np.asarray([[0, 0, 0, 0], [3, 3, 0, 0], [0, 3, 3, 0]], float)
    y = rng.integers(0, 3, size=120)
    x = rng.normal(size=(120, 4)) + centers[y]
    w = rng.uniform(0.5, 2.0, size=120)
    layers = [4, 6, 3]
    oh = jax_mlp.validate_and_onehot(x, y, layers)
    init = jax_mlp.init_weights(layers, 3)
    return x, oh, w, init


def _jax_mlp(x, oh, w, init):
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.ops import mlp_kernel as jax_mlp

    params = [{k: jnp.asarray(v) for k, v in layer.items()}
              for layer in init]
    data = (jnp.asarray(x), jnp.asarray(oh), jnp.asarray(w))
    return params, data, jax_mlp.mean_cross_entropy


def _port_mlp(x, oh, w, init):
    from spark_rapids_ml_tpu_torch.ops import mlp_kernel as port_mlp

    params = [torch.as_tensor(layer[k]) for layer in init for k in "wb"]
    data = tuple(torch.as_tensor(a) for a in (x, oh, w))
    return params, data, port_mlp.mean_cross_entropy


def _quad_problem():
    """0.5·zᵀAz − bᵀz over z = [a (5,), m (3, 2) row-major], A SPD with
    eigenvalues spread over 0.5…40."""
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.normal(size=(11, 11)))
    a_mat = (q * np.geomspace(0.5, 40.0, 11)) @ q.T
    b = rng.normal(size=11)
    start = {"a": rng.normal(size=5), "m": rng.normal(size=(3, 2))}
    return a_mat, b, start


def _jax_quad_loss(params, a_mat, b):
    import jax.numpy as jnp

    z = jnp.concatenate([params["a"], params["m"].reshape(-1)])
    return 0.5 * z @ (a_mat @ z) - b @ z


def _port_quad_loss(params, a_mat, b):
    z = torch.cat([params[0], params[1].reshape(-1)])
    return 0.5 * z @ (a_mat @ z) - b @ z


def _jax_quad(a_mat, b, start):
    import jax.numpy as jnp

    params = {k: jnp.asarray(v) for k, v in start.items()}
    return params, (jnp.asarray(a_mat), jnp.asarray(b)), _jax_quad_loss


def _port_quad(a_mat, b, start):
    params = [torch.as_tensor(start["a"]), torch.as_tensor(start["m"])]
    return (params, (torch.as_tensor(a_mat), torch.as_tensor(b)),
            _port_quad_loss)


def _flat_jax(params):
    """The JAX pytree in the port's leaf order: an MLP's layers as
    Spark's flat vector (W, then b), a dict by its sorted keys."""
    import jax

    from spark_rapids_ml_tpu.ops.mlp_kernel import flatten_weights

    if isinstance(params, list):
        return flatten_weights(params)
    return np.concatenate([np.asarray(a).reshape(-1)
                           for a in jax.tree_util.tree_leaves(params)])


def _flat_port(params):
    return np.concatenate([p.numpy().reshape(-1) for p in params])


def _optax_iterates(params, data, loss_fn, n):
    """optax.lbfgs() stepped as ``minimize_kernel``'s body steps it, the
    flat iterate after each of ``n`` iterations."""
    import jax
    import optax

    def objective(p):
        return loss_fn(p, *data)

    opt = optax.lbfgs()
    state = opt.init(params)
    value_and_grad = jax.value_and_grad(objective)

    @jax.jit
    def body(p, state):
        value, grad = value_and_grad(p)
        updates, state = opt.update(grad, state, p, value=value, grad=grad,
                                    value_fn=objective)
        return optax.apply_updates(p, updates), state

    out = []
    for _ in range(n):
        params, state = body(params, state)
        out.append(_flat_jax(params))
    return out


def _problem(name):
    if name == "mlp":
        args = _mlp_problem()
        return _jax_mlp(*args), _port_mlp(*args)
    args = _quad_problem()
    return _jax_quad(*args), _port_quad(*args)


def _port_minimize(port, solver, max_iter, tol=0.0, step_size=0.01):
    from spark_rapids_ml_tpu_torch.ops.optim import minimize

    params, data, loss_fn = port
    return minimize(params, data, loss_fn, solver=solver, max_iter=max_iter,
                    tol=tol, step_size=step_size)


def _jax_minimize(jax_side, solver, max_iter, tol=0.0, step_size=0.01):
    from spark_rapids_ml_tpu.ops.optim import minimize_kernel

    params, data, loss_fn = jax_side
    p, it, loss = minimize_kernel(params, data, loss_fn=loss_fn,
                                  solver=solver, max_iter=max_iter, tol=tol,
                                  step_size=step_size)
    return _flat_jax(p), int(it), float(loss)


@pytest.mark.parametrize("name", ["mlp", "quadratic"])
def test_lbfgs_iterates_match_optax_for_ten_iterations(name):
    jax_side, port = _problem(name)
    want = _optax_iterates(*jax_side, 10)
    for k in range(1, 11):
        got, n_iter, _loss = _port_minimize(port, "l-bfgs", k)
        assert n_iter == k
        assert _rel(_flat_port(got), want[k - 1]) <= F64_ITER_RTOL, k


@pytest.mark.parametrize("name,tol,rtol", [("quadratic", 1e-12, 1e-10),
                                          ("mlp", 1e-9, 1e-8)])
def test_lbfgs_loop_matches_minimize_kernel_and_lags_its_loss(name, tol,
                                                              rtol):
    """Both objectives to the loss-change tolerance through
    ``minimize_kernel``: the JAX loop's own stop test ends both fits at
    the same iteration, and the returned loss is the objective at the
    iterate before the last step. The quadratic's iterates meet at its
    minimiser (1e-10); the MLP's blobs are separable, so its weights keep
    growing and the two libraries' summation orders drift apart along the
    path (2.9e-9 after 39 iterations), held at the MLP parity bar of
    ``tests/test_torch_mlp.py`` (1e-8). The MLP's final loss (1e-9) is a
    mean of row terms whose rounding follows the objective's scale, not
    the mean's, so it is held to 1e-12 of the starting loss."""
    jax_side, port = _problem(name)
    params, data, loss_fn = port
    want_p, want_it, want_loss = _jax_minimize(jax_side, "l-bfgs", 200,
                                               tol=tol)
    got, n_iter, loss = _port_minimize(port, "l-bfgs", 200, tol=tol)
    assert 10 < n_iter == want_it < 200
    assert _rel(_flat_port(got), want_p) <= rtol
    scale = abs(want_loss) if name == "quadratic" else \
        _port_minimize(port, "l-bfgs", 1)[2]
    assert abs(loss - want_loss) <= LOSS_RTOL * scale
    # the lag: the objective at the iterate one step before the returned
    before, _, _ = _port_minimize(port, "l-bfgs", n_iter - 1)
    assert float(loss_fn(before, *data)) == loss
    assert float(loss_fn(got, *data)) < loss


@pytest.mark.parametrize("solver", ["gd", "adamW"])
@pytest.mark.parametrize("name", ["mlp", "quadratic"])
def test_gd_and_adamw_match_minimize_kernel_after_50_steps(name, solver):
    jax_side, port = _problem(name)
    want_p, want_it, want_loss = _jax_minimize(jax_side, solver, 50,
                                               step_size=0.05)
    got, n_iter, loss = _port_minimize(port, solver, 50, step_size=0.05)
    assert n_iter == want_it == 50
    assert _rel(_flat_port(got), want_p) <= GD_RTOL
    assert abs(loss - want_loss) <= GD_RTOL * abs(want_loss)


def test_max_iter_zero_returns_the_start_and_an_infinite_loss():
    jax_side, port = _problem("quadratic")
    want_p, want_it, want_loss = _jax_minimize(jax_side, "gd", 0)
    got, n_iter, loss = _port_minimize(port, "gd", 0)
    assert n_iter == want_it == 0
    assert np.isinf(loss) and np.isinf(want_loss)
    np.testing.assert_array_equal(_flat_port(got), want_p)


def test_unknown_solver_raises():
    _jax_side, port = _problem("quadratic")
    with pytest.raises(ValueError, match="solver"):
        _port_minimize(port, "newton", 3)


# -- the line search where it fails ------------------------------------------

def _flat_objective(pkg):
    if pkg == "jax":
        import jax.numpy as jnp

        return lambda p: 1.0 + 1e-20 * jnp.sum(p * p)
    return lambda p: 1.0 + 1e-20 * torch.sum(p * p)


def _bowl(pkg):
    if pkg == "jax":
        import jax.numpy as jnp

        return lambda p: jnp.sum((p - 1.0) ** 2) + 0.1 * jnp.sum(p ** 4)
    return lambda p: torch.sum((p - 1.0) ** 2) + 0.1 * torch.sum(p ** 4)


@functools.lru_cache(maxsize=None)
def _optax_linesearch_jit(kind):
    """optax's ``scale_by_zoom_linesearch`` as ``optax.lbfgs()`` builds
    it, one jitted update of the ``kind`` objective (``"flat"`` or
    ``"bowl"``) along a direction: (stepsize, steps, decrease error,
    curvature error). Jitted once per objective, so the ascent and
    descent cases share one compile."""
    import jax

    from optax._src.linesearch import scale_by_zoom_linesearch

    fn = _flat_objective("jax") if kind == "flat" else _bowl("jax")
    ls = scale_by_zoom_linesearch(max_linesearch_steps=20,
                                  initial_guess_strategy="one")

    @jax.jit
    def update(p, direction):
        value, grad = jax.value_and_grad(fn)(p)
        _updates, state = ls.update(direction, ls.init(p), p, value=value,
                                    grad=grad, value_fn=fn)
        return (state.learning_rate, state.info.num_linesearch_steps,
                state.info.decrease_error, state.info.curvature_error)

    return update


def _optax_linesearch(kind, p0, direction):
    import jax.numpy as jnp

    out = _optax_linesearch_jit(kind)(jnp.asarray(p0),
                                      jnp.asarray(direction))
    return float(out[0]), int(out[1]), float(out[2]), float(out[3])


def _port_linesearch(fn, p0, direction):
    from spark_rapids_ml_tpu_torch.ops.optim import zoom_linesearch

    def value_and_grad(flat):
        leaf = flat.detach().requires_grad_(True)
        value = fn(leaf)
        (grad,) = torch.autograd.grad(value, leaf)
        return value.detach(), grad

    p = torch.as_tensor(p0)
    value, grad = value_and_grad(p)
    res = zoom_linesearch(value_and_grad, p, torch.as_tensor(direction),
                          value, grad)
    return (res.stepsize, res.steps, res.decrease_error,
            res.curvature_error)


@pytest.mark.parametrize("case", ["flat", "ascent", "descent"])
def test_zoom_linesearch_matches_optax(case):
    """The flat objective fails on the curvature criterion and returns
    its safe step; the ascent direction never decreases and makes optax's
    unsafe last step; a plain descent direction succeeds. All three as
    optax ends them."""
    p0 = np.linspace(-1.0, 2.0, 6)
    if case == "flat":
        kind, port_fn = "flat", _flat_objective("port")
        direction = -2e-20 * p0
    else:
        kind, port_fn = "bowl", _bowl("port")
        grad = 2 * (p0 - 1.0) + 0.4 * p0 ** 3
        direction = grad if case == "ascent" else -0.1 * grad
    want = _optax_linesearch(kind, p0, direction)
    got = _port_linesearch(port_fn, p0, direction)
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=0)
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-9, atol=1e-300)
    if case == "flat":
        assert want[1] > 1 and want[3] > 0      # it failed: curvature unmet
    if case == "ascent":
        assert want[1] == 20 and want[2] > 0    # every trial rose


def test_minimize_on_a_flat_objective_matches_minimize_kernel():
    from spark_rapids_ml_tpu.ops.optim import minimize_kernel
    from spark_rapids_ml_tpu_torch.ops.optim import minimize

    import jax.numpy as jnp

    p0 = np.linspace(-1.0, 2.0, 6)
    jax_fn, port_fn = _flat_objective("jax"), _flat_objective("port")
    p, it, loss = minimize_kernel(
        jnp.asarray(p0), (), loss_fn=lambda q: jax_fn(q), solver="l-bfgs",
        max_iter=5, tol=0.0)
    got, n_iter, got_loss = minimize(
        [torch.as_tensor(p0)], (), lambda q: port_fn(q[0]),
        solver="l-bfgs", max_iter=5, tol=0.0)
    assert n_iter == int(it)
    assert got_loss == float(loss)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(p), rtol=1e-15,
                               atol=0)
