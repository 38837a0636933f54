"""MultilayerPerceptron kernels on PyTorch.

Counterpart of the JAX package's ``ops/mlp_kernel.py``, with the same
functions and Spark's ``MultilayerPerceptronClassifier`` semantics:
sigmoid hidden layers, a softmax output, the weighted mean cross-entropy,
and the full-batch solvers of ``ops/optim.py`` ('l-bfgs', Spark's
default, and 'gd'). ``SigmoidMLP`` is the network as a ``torch.nn.Module``
(its parameters in Spark's order: per layer W of shape (d_in, d_out), then
b); the functions below take those tensors as a list,
``[w₀, b₀, w₁, b₁, …]``, the order of Spark's flat weight vector.

The JAX package compiles the whole training run into one XLA program;
here the loop is ``ops/optim.minimize``'s host loop over autograd
evaluations of the objective. Two differences from the JAX package, by
design:

* a float32 layer product is taken in float64 and rounded once, in the
  forward pass and in both products of its backward pass (``matmul``, a
  ``torch.autograd.Function``), so no TF32 setting reaches it whatever
  ``torch.set_float32_matmul_precision`` says (the port's rule,
  ``ops/pca_kernel.py::_project``); JAX multiplies in float32;
* the hidden activation is ``torch.sigmoid``, whose derivative σ(1 − σ)
  is finite everywhere. JAX differentiates ``1 / (1 + exp(−z))`` by the
  quotient rule, exp(−z)/(1 + exp(−z))², which is inf/inf = NaN once
  exp(−z) overflows (z < −88.7 in float32): a float32 L-BFGS fit that
  drives a hidden unit that far gets a NaN gradient at a finite loss, and
  JAX's loop then ends on NaN parameters (ROADMAP queue 3 item 5).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def init_weights(layers: Sequence[int], seed: int) -> List[dict]:
    """Glorot-uniform init per affine layer, host-side, float64 — the JAX
    package's draws, bit for bit: [{"w": (d_in, d_out), "b": (d_out,)},
    ...]."""
    rng = np.random.default_rng(seed)
    params = []
    for d_in, d_out in zip(layers[:-1], layers[1:]):
        limit = np.sqrt(6.0 / (d_in + d_out))
        params.append({
            "w": rng.uniform(-limit, limit, size=(d_in, d_out)),
            "b": np.zeros(d_out),
        })
    return params


class _Matmul64(torch.autograd.Function):
    """a @ b for float32 operands, forward and backward, each product in
    float64 and rounded once to float32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return (a.double() @ b.double()).to(a.dtype)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g = grad.double()
        grad_a = grad_b = None
        if ctx.needs_input_grad[0]:
            grad_a = (g @ b.double().T).to(a.dtype)
        if ctx.needs_input_grad[1]:
            grad_b = (a.double().T @ g).to(b.dtype)
        return grad_a, grad_b


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b; a float32 product in float64, rounded once (no TF32)."""
    if a.dtype == torch.float32:
        return _Matmul64.apply(a, b)
    return a @ b


def forward_logits(weights: Sequence[torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
    """Sigmoid hidden layers + final affine: the pre-softmax logits
    (Spark's rawPrediction). ``weights`` is [w₀, b₀, w₁, b₁, …]."""
    h = x
    n_layers = len(weights) // 2
    for i in range(n_layers - 1):
        h = torch.sigmoid(matmul(h, weights[2 * i]) + weights[2 * i + 1])
    return matmul(h, weights[-2]) + weights[-1]


def validate_and_onehot(x, y, layers):
    """Spark MLP label conventions in ONE place (shared by the local fit
    and ``parallel.distributed_mlp_fit``): layers[0] must match the
    feature width, labels must be class indices 0..layers[-1]-1; returns
    the (n, n_classes) float64 one-hot matrix."""
    x = np.asarray(x)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    if y.shape[0] != x.shape[0]:
        raise ValueError(
            f"labels length {y.shape[0]} != rows {x.shape[0]}")
    if x.shape[1] != layers[0]:
        raise ValueError(
            f"layers[0]={layers[0]} != feature width {x.shape[1]}")
    n_classes = int(layers[-1])
    y_idx = y.astype(np.int64)
    if not np.array_equal(y_idx, y) or y_idx.min() < 0 \
            or y_idx.max() >= n_classes:
        raise ValueError(
            f"labels must be class indices 0..{n_classes - 1} "
            "(Spark MLP convention)")
    y_onehot = np.zeros((y.shape[0], n_classes))
    y_onehot[np.arange(y.shape[0]), y_idx] = 1.0
    return y_onehot


def rowwise_cross_entropy(weights, x, y_onehot):
    """Per-row softmax cross-entropy: the ONE objective the local and the
    distributed MLP fits share (the reduction differs: the weighted mean
    here, the all-reduced global mean in parallel/distributed_optim.py)."""
    logp = torch.log_softmax(forward_logits(weights, x), dim=1)
    return -(y_onehot * logp).sum(dim=1)


def mean_cross_entropy(weights, x, y_onehot, w):
    return (w * rowwise_cross_entropy(weights, x, y_onehot)).sum() / w.sum()


def mlp_train_kernel(weights: Sequence[torch.Tensor], x, y_onehot, w, *,
                     solver: str, max_iter: int, tol, step_size):
    """Full-batch training by ``ops/optim.py``'s loop on the MLP's weighted
    mean softmax cross-entropy (``mean_cross_entropy``): (weights, n_iter,
    final_loss), ``final_loss`` the one evaluated before the last step, as
    the JAX kernel returns it. The sharded fit is
    ``parallel/distributed_optim.distributed_minimize``."""
    from spark_rapids_ml_tpu_torch.ops.optim import (
        flatten,
        minimize_flat,
        unflatten,
        weighted_mean_value_and_grad,
    )

    shapes = [tuple(t.shape) for t in weights]
    x_flat, n_iter, loss = minimize_flat(
        flatten(weights),
        weighted_mean_value_and_grad(rowwise_cross_entropy, (x, y_onehot),
                                     w, shapes),
        solver=solver, max_iter=max_iter, tol=tol, step_size=step_size)
    return ([t.clone() for t in unflatten(x_flat, shapes)], n_iter, loss)


class SigmoidMLP(torch.nn.Module):
    """Spark's MLP as a module: ``layers`` = [in, hidden…, n_classes], its
    parameters [w₀, b₀, w₁, b₁, …] with w of shape (d_in, d_out); the
    forward pass returns the logits."""

    def __init__(self, weights: Sequence[torch.Tensor]):
        super().__init__()
        self.weights = torch.nn.ParameterList(
            [torch.nn.Parameter(t.detach().clone(), requires_grad=False)
             for t in weights])
        self.layers = [int(weights[0].shape[0])] + [
            int(w.shape[1]) for w in weights[0::2]]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward_logits(list(self.weights), x)


def mlp_params_from_jax(params: Sequence[dict], *, device,
                        dtype) -> SigmoidMLP:
    """Carry JAX MLP parameters (the pytree
    [{"w": (d_in, d_out), "b": (d_out,)}, …] that ``init_weights`` and the
    JAX fits return, as numpy or JAX arrays) into the port: a
    ``SigmoidMLP`` on ``device`` at ``dtype``."""
    return SigmoidMLP([torch.as_tensor(np.array(layer[key]), dtype=dtype,
                                       device=device)
                       for layer in params for key in ("w", "b")])


def mlp_params_to_numpy(module: SigmoidMLP) -> List[dict]:
    """The inverse of ``mlp_params_from_jax``: the JAX package's pytree
    layout, float64 numpy."""
    ts = [t.detach().cpu().to(torch.float64).numpy()
          for t in module.weights]
    return [{"w": ts[i], "b": ts[i + 1]} for i in range(0, len(ts), 2)]


def flatten_weights(params: List[dict]) -> np.ndarray:
    """Spark-layout flat weight vector: per layer, W row-major then b."""
    parts = []
    for layer in params:
        parts.append(np.asarray(layer["w"], dtype=np.float64).ravel())
        parts.append(np.asarray(layer["b"], dtype=np.float64).ravel())
    return np.concatenate(parts)


def unflatten_weights(flat: np.ndarray,
                      layers: Sequence[int]) -> List[dict]:
    params = []
    pos = 0
    for d_in, d_out in zip(layers[:-1], layers[1:]):
        w = flat[pos:pos + d_in * d_out].reshape(d_in, d_out)
        pos += d_in * d_out
        b = flat[pos:pos + d_out]
        pos += d_out
        params.append({"w": np.asarray(w), "b": np.asarray(b)})
    if pos != flat.shape[0]:
        raise ValueError(
            f"weight vector length {flat.shape[0]} does not match "
            f"layers {list(layers)} (expected {pos})")
    return params
