"""Distributed smooth-objective training over the ``data`` ranks: the MLP.

Counterpart of the JAX package's ``parallel/distributed_optim.py``. Rows
split over the ``data`` group (rank d of D takes the d-th of D equal
blocks of the padded rows, as the JAX row sharding does), parameters are
replicated, and the objective is the exact global weighted mean,
Σ_ranks Σ w·loss / Σ_ranks Σ w (JAX's ``psum(Σ w·loss) / psum(Σ w)``):
each evaluation computes this rank's Σ w·loss, Σ w and the gradient of
the first by ``torch.autograd``, and ONE ``all_reduce`` sums the three
packed into one buffer (NCCL on cards, gloo on CPU ranks) before the one
division (``ops/optim.weighted_mean_value_and_grad``, the local fit's
objective too, so one rank computes the local fit's bits). Every rank
then holds the same value and gradient, so ``ops/optim.py``'s host loop
and line search take the same decisions and every rank returns the same
parameters. Padding rows carry weight 0 and zero features, contributing
nothing to either sum.

The JAX package compiles the whole loop into one ``shard_map`` program
whose gradient ``psum`` autodiff inserts; here the loop is the host loop
of ``ops/optim.minimize_flat``, one all-reduce per objective evaluation.

Collectives are recorded at their true counts: one all-reduce of (P + 2)
elements of the dtype per objective evaluation, line-search trials
included; JAX's ``_note_grad_psums`` records one per iteration (an
accounting difference, ROADMAP queue 3 item 22 (aa)).

The FM and AFT fits of the JAX module (``distributed_fm_fit``,
``distributed_aft_fit``) come with their families, the next slice
(ROADMAP queue 1 item 7e).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from spark_rapids_ml_tpu_torch.obs.fitmon import current_run
from spark_rapids_ml_tpu_torch.obs.report import (
    current_fit,
    fit_instrumentation,
)
from spark_rapids_ml_tpu_torch.ops.optim import (
    flatten,
    minimize_flat,
    unflatten,
    weighted_mean_value_and_grad,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_size,
    collective_nbytes,
    mesh_device,
    pad_rows_to_multiple,
)


def _all_reduce_counted(group, calls: list):
    """An in-place sum over ``group`` that counts itself in ``calls[0]``."""

    def reduce(packed: torch.Tensor) -> None:
        dist.all_reduce(packed, group=group)
        calls[0] += 1

    return reduce


def distributed_minimize(params: Sequence[torch.Tensor], data, rowloss_fn,
                         *, mesh, solver: str, max_iter: int, tol,
                         step_size=0.01):
    """``ops/optim.minimize`` with the rows sharded: ``data`` is this
    rank's (x, per-row tensors…, weights), the weights last, on the mesh's
    device; ``rowloss_fn(params, x, per-row tensors…)`` the per-row loss.
    Every rank of the mesh's ``data`` group must call it; each returns the
    same (params, n_iter, loss). The all-reduces are recorded on the
    current fit."""
    shapes = [tuple(p.shape) for p in params]
    x0 = flatten(params)
    calls = [0]
    vg = weighted_mean_value_and_grad(
        rowloss_fn, tuple(data[:-1]), data[-1], shapes,
        reduce=_all_reduce_counted(mesh.get_group(DATA_AXIS), calls))
    x, n_iter, loss = minimize_flat(x0, vg, solver=solver,
                                    max_iter=max_iter, tol=tol,
                                    step_size=step_size)
    ctx = current_fit()
    ctx.set_iterations(n_iter)
    ctx.record_collective(
        "all_reduce", nbytes=collective_nbytes((x0.numel() + 2,), x0.dtype),
        count=calls[0],
    )
    return [p.clone() for p in unflatten(x, shapes)], n_iter, loss


def _shard_rows(mesh, x, *row_vectors, dtype):
    """This rank's block of the padded (x, per-row vectors…) on the mesh's
    device. Vectors pad with ZEROS: the weight vector travels last, so its
    padding rows carry weight 0 and drop out of both sums."""
    n_dev = axis_size(mesh, DATA_AXIS)
    x_padded, _mask = pad_rows_to_multiple(np.asarray(x), n_dev)
    per = x_padded.shape[0] // n_dev
    rank = mesh.get_local_rank(DATA_AXIS)
    rows = slice(rank * per, (rank + 1) * per)
    device = mesh_device(mesh)
    nd = np.dtype(dtype)
    out = [torch.as_tensor(np.asarray(x_padded[rows], dtype=nd),
                           device=device)]
    n_rows = np.asarray(x).shape[0]
    for v in row_vectors:
        v = np.asarray(v, dtype=np.float64)
        if v.ndim != 2 or v.shape[1] == 1:
            v = v.reshape(-1)
        if v.shape[0] != n_rows:
            raise ValueError(
                f"per-row vector length {v.shape[0]} != rows {n_rows}")
        v_padded = np.zeros((x_padded.shape[0],) + v.shape[1:])
        v_padded[: v.shape[0]] = v
        out.append(torch.as_tensor(np.asarray(v_padded[rows], dtype=nd),
                                   device=device))
    return out


@fit_instrumentation("distributed_mlp")
def distributed_mlp_fit(
    x_host: np.ndarray,
    y_host: np.ndarray,
    layers,
    mesh,
    max_iter: int = 100,
    tol: float = 1e-6,
    step_size: float = 0.03,
    solver: str = "l-bfgs",
    seed: int = 0,
    weights: np.ndarray = None,
    dtype=np.float32,
):
    """MultilayerPerceptron classifier trained over the ranks (Spark MLP
    conventions: ``layers`` = [in, hidden…, n_classes], labels are class
    indices), called on every rank with the same full (X, y). Returns
    (params pytree as float64 numpy, n_iter, final loss), the same on
    every rank."""
    from spark_rapids_ml_tpu_torch.ops.mlp_kernel import (
        SigmoidMLP,
        init_weights,
        mlp_params_from_jax,
        mlp_params_to_numpy,
        rowwise_cross_entropy,
        validate_and_onehot,
    )

    x_host = np.asarray(x_host)
    layers = [int(v) for v in layers]
    y_onehot = validate_and_onehot(x_host, y_host, layers)
    w = np.ones(x_host.shape[0]) if weights is None else weights
    x_dev, oh_dev, w_dev = _shard_rows(mesh, x_host, y_onehot, w,
                                       dtype=dtype)
    torch_dtype = x_dev.dtype
    net = mlp_params_from_jax(init_weights(layers, seed),
                              device=x_dev.device, dtype=torch_dtype)
    with current_fit().phase("execute"), current_run().step(
        "minimize", rows=x_host.shape[0]
    ) as mon:
        params, n_iter, loss = distributed_minimize(
            list(net.weights), (x_dev, oh_dev, w_dev),
            rowwise_cross_entropy, mesh=mesh, solver=solver,
            max_iter=max_iter, tol=tol, step_size=step_size)
        mon.note(n_iter=int(n_iter), loss=float(loss))
    return (mlp_params_to_numpy(SigmoidMLP(params)), int(n_iter),
            float(loss))
