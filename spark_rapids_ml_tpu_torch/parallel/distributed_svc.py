"""Data-parallel LinearSVC: each rank's squared-hinge partials, all-reduced.

Counterpart of the JAX package's ``parallel/distributed_svc.py``, the same
shape as ``distributed_logreg``: rows split over the ``data`` group, each
rank builds its shard's (Xᵀ(aỹ), XᵀSX, Xᵀs, Σaỹ, Σs, n) partials on its
device (``ops.svm_kernel``: on the card the Hessian is one launch of the
hand kernel's full-f32 pipeline), ONE ``all_reduce`` per generalized-
Newton iteration sums them packed into one buffer over NCCL (gloo on CPU
ranks), and every rank solves the same (n+1)² system, so every rank
returns the same result. The JAX package runs the loop inside a compiled
``while_loop`` with a ``psum``; here it is the host loop of
``svc_newton_iterations``, with the all-reduce as its ``reduce_fn``.

``distributed_svc_fit`` is instrumented as the JAX function is: a fit
report with the phases ``prepare``, ``placement`` and ``execute``, one
fit-monitor step ``newton`` over the whole loop noted with ``n_iter`` and
``converged``, and the collective accounted as JAX accounts it: d² + d
elements of the input dtype (d = n + 1 with an intercept, n without) once
per iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.obs.fitmon import current_run
from spark_rapids_ml_tpu_torch.obs.report import (
    current_fit,
    fit_instrumentation,
)
from spark_rapids_ml_tpu_torch.ops.svm_kernel import (
    SvcResult,
    svc_newton_iterations,
)
from spark_rapids_ml_tpu_torch.parallel.distributed_logreg import (
    _all_reduce_stats,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_size,
    collective_nbytes,
    mesh_device,
    pad_rows_to_multiple,
)


def distributed_svc_fit_kernel(
    x,
    y,
    mask,
    *,
    mesh,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
    max_iter: int = 100,
    tol: float = 1e-8,
) -> SvcResult:
    """The sharded fit on this rank's rows ``x`` (rows, n), labels ``y``
    and 0/1 ``mask``, placed on the mesh's device if they are not there.
    Every rank of the mesh's ``data`` group must call it; each returns the
    same replicated result. The six partials travel in the logreg fit's
    packed all-reduce (the same six slots)."""
    device = mesh_device(mesh)
    x = torch.as_tensor(x, device=device)
    y = torch.as_tensor(y, device=device)
    mask = torch.as_tensor(mask, device=device)
    return svc_newton_iterations(
        x, y, mask, reg_param, fit_intercept, max_iter, tol,
        reduce_fn=_all_reduce_stats(mesh.get_group(DATA_AXIS)))


@fit_instrumentation("distributed_svc")
def distributed_svc_fit(
    x_host: np.ndarray,
    y_host: np.ndarray,
    mesh,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
    max_iter: int = 100,
    tol: float = 1e-8,
    dtype=None,
) -> SvcResult:
    """Host-side entry point, called on every rank with the same full
    (X, y): pad the rows to the mesh, take this rank's block (rank d of D
    takes the d-th of D equal blocks, as the JAX row sharding does), place
    it on the rank's device and run the kernel. ``dtype`` (a numpy dtype)
    casts the host rows first."""
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
    with ctx.phase("execute"), current_run().step(
        "newton", rows=x_host.shape[0]
    ) as step:
        result = distributed_svc_fit_kernel(
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
