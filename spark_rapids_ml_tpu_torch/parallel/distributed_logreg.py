"""Data-parallel LogisticRegression: each rank's Newton partials, all-reduced.

Counterpart of the JAX package's ``parallel/distributed_logreg.py``, the
same shape as the other distributed fits: rows split over the ``data``
group, each rank builds its shard's (Xᵀr, XᵀSX, Xᵀs, Σr, Σs, n) partials on
its device (``ops.logreg_kernel``: on the card the Hessian is one launch of
the hand kernel's full-f32 pipeline), ONE ``all_reduce`` per Newton
iteration sums them packed into one buffer over NCCL (gloo on CPU ranks),
and every rank solves the same (n+1)² system, so every rank returns the
same result. The JAX package runs the loop inside a compiled
``while_loop`` with a ``psum``; here it is the host loop of
``newton_iterations``, with the all-reduce as its ``reduce_fn``.

``distributed_logreg_fit`` is instrumented as the JAX function is: a fit
report with the phases ``prepare`` (pad, slice, cast), ``placement`` (the
host → device copy) and ``execute``, one fit-monitor step ``newton`` over
the whole loop noted with ``n_iter`` and ``converged``, and the
collective accounted as the JAX function accounts it: d² + d elements of
the input dtype (d = n + 1 with an intercept, n without) once per
iteration.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from spark_rapids_ml_tpu_torch.obs.fitmon import current_run
from spark_rapids_ml_tpu_torch.obs.report import (
    current_fit,
    fit_instrumentation,
)
from spark_rapids_ml_tpu_torch.ops.logreg_kernel import (
    LogRegResult,
    newton_iterations,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_size,
    collective_nbytes,
    mesh_device,
    pad_rows_to_multiple,
)


def _all_reduce_stats(group):
    """``reduce_fn`` for ``newton_iterations``: the six partials summed
    over the group in ONE packed ``all_reduce``."""

    def reduce_fn(stats):
        gx, hxx, hxb, rsum, ssum, cnt = stats
        n = gx.shape[0]
        packed = torch.cat([gx, hxx.reshape(-1), hxb, rsum.reshape(1),
                            ssum.reshape(1), cnt.reshape(1)])
        dist.all_reduce(packed, group=group)
        tail = n + n * n + n
        return (packed[:n], packed[n:n + n * n].view(n, n),
                packed[n + n * n:tail], packed[tail], packed[tail + 1],
                packed[tail + 2])

    return reduce_fn


def distributed_logreg_fit_kernel(
    x,
    y,
    mask,
    *,
    mesh,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
    max_iter: int = 100,
    tol: float = 1e-8,
) -> LogRegResult:
    """The sharded fit on this rank's rows ``x`` (rows, n), labels ``y``
    and 0/1 ``mask``, placed on the mesh's device if they are not there.
    Every rank of the mesh's ``data`` group must call it; each returns the
    same replicated result."""
    device = mesh_device(mesh)
    x = torch.as_tensor(x, device=device)
    y = torch.as_tensor(y, device=device)
    mask = torch.as_tensor(mask, device=device)
    return newton_iterations(
        x, y, mask, reg_param, fit_intercept, max_iter, tol,
        reduce_fn=_all_reduce_stats(mesh.get_group(DATA_AXIS)))


@fit_instrumentation("distributed_logreg")
def distributed_logreg_fit(
    x_host: np.ndarray,
    y_host: np.ndarray,
    mesh,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
    max_iter: int = 100,
    tol: float = 1e-8,
    dtype=None,
) -> LogRegResult:
    """Host-side entry point, called on every rank with the same full
    (X, y): pad the rows to the mesh, take this rank's block (rank d of D takes the
    d-th of D equal blocks, as the JAX row sharding does), place it on the
    rank's device and run the kernel. ``dtype`` (a numpy dtype) casts the
    host rows first."""
    ctx = current_fit()
    x_host = np.asarray(x_host)
    y_host = np.asarray(y_host).reshape(-1)
    n_dev = axis_size(mesh, DATA_AXIS)
    with ctx.phase("prepare"):
        x_padded, mask = pad_rows_to_multiple(x_host, n_dev)
        y_padded = np.zeros(x_padded.shape[0], dtype=y_host.dtype)
        y_padded[: y_host.shape[0]] = y_host
        per = x_padded.shape[0] // n_dev
        d = mesh.get_local_rank(DATA_AXIS)
        rows = slice(d * per, (d + 1) * per)
        x_local, y_local, mask_local = x_padded[rows], y_padded[rows], mask[rows]
        if dtype is not None:
            x_local = x_local.astype(dtype)
            y_local = y_local.astype(dtype)
            mask_local = mask_local.astype(dtype)
    with ctx.phase("placement"):
        device = mesh_device(mesh)
        x_dev = torch.as_tensor(x_local, device=device)
        y_dev = torch.as_tensor(y_local, dtype=x_dev.dtype, device=device)
        mask_dev = torch.as_tensor(mask_local, dtype=x_dev.dtype,
                                   device=device)
    # The Newton loop runs on the host, one all-reduce per iteration; the
    # step covers the whole loop, with the realized iteration count as a
    # convergence scalar.
    with ctx.phase("execute"), current_run().step(
        "newton", rows=x_host.shape[0]
    ) as step:
        result = distributed_logreg_fit_kernel(
            x_dev, y_dev, mask_dev, mesh=mesh, reg_param=reg_param,
            fit_intercept=fit_intercept, max_iter=max_iter, tol=tol)
        n_iter = int(result.n_iter)
        step.note(n_iter=n_iter, converged=int(result.converged))
    # one packed all-reduce of (gradient, Hessian) per Newton iteration
    d = x_host.shape[1] + (1 if fit_intercept else 0)
    ctx.set_iterations(n_iter)
    ctx.record_collective(
        "all_reduce", nbytes=collective_nbytes((d * d + d,), x_local.dtype),
        count=max(n_iter, 1),
    )
    return result
