"""Data-parallel LinearRegression: each rank's statistics, all-reduced.

Counterpart of the JAX package's ``parallel/distributed_linreg.py``, the
same shape as ``distributed_pca``: rows split over the ``data`` group, each
rank builds its shard's sufficient statistics (XᵀX, Xᵀy, Σx, Σy, n) on its
device (``ops.linreg_kernel.linreg_partial_stats``: on the card the Gram is
one launch of the hand kernel's full-f32 pipeline), ONE ``all_reduce`` sums
them packed into one buffer over NCCL (gloo on CPU ranks), and every rank
solves the small normal-equations system, so every rank returns the same
result. Σy², which the solve does not read, is left out of the collective.

``distributed_linreg_fit`` is instrumented as ``distributed_pca_fit`` is: a
fit report with the phases ``prepare`` (pad, slice, cast), ``placement``
(the host → device copy) and ``execute``, the collective's payload bytes,
and one fit-monitor step ``normal_equations`` that synchronises the card
before it ends. The count travels as two floats (``mesh.pack_count``), so
the collective moves one element more than the JAX program accounts for,
and is accounted as such.
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
from spark_rapids_ml_tpu_torch.ops.covariance import row_count
from spark_rapids_ml_tpu_torch.ops.linreg_kernel import (
    LinRegResult,
    LinRegStats,
    linreg_partial_stats,
    solve_normal_equations,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_size,
    collective_nbytes,
    mesh_device,
    pack_count,
    pad_rows_to_multiple,
    unpack_count,
)


def distributed_linreg_fit_kernel(
    x,
    y,
    mask,
    *,
    mesh,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
) -> LinRegResult:
    """The sharded fit on this rank's rows ``x`` (rows, n), labels ``y``
    and 0/1 ``mask``, placed on the mesh's device if they are not there.
    Every rank of the mesh's ``data`` group must call it; each returns the
    same replicated result."""
    device = mesh_device(mesh)
    x = torch.as_tensor(x, device=device)
    y = torch.as_tensor(y, device=device)
    mask = torch.as_tensor(mask, device=device)
    n = x.shape[1]
    stats = linreg_partial_stats(x, y, mask)
    # ONE all-reduce of (XᵀX, Xᵀy, Σx, Σy, packed count)
    packed = torch.cat([
        stats.xtx.reshape(-1), stats.xty, stats.x_sum,
        stats.y_sum.reshape(1), pack_count(row_count(x, mask), x.dtype),
    ])
    dist.all_reduce(packed, group=mesh.get_group(DATA_AXIS))
    count = unpack_count(packed[n * n + 2 * n + 1:]).to(x.dtype)
    total = LinRegStats(
        xtx=packed[:n * n].view(n, n),
        xty=packed[n * n:n * n + n],
        x_sum=packed[n * n + n:n * n + 2 * n],
        y_sum=packed[n * n + 2 * n],
        y_sq=None,  # not reduced: the solve does not read it
        count=count,
    )
    return solve_normal_equations(total, reg_param, fit_intercept)


@fit_instrumentation("distributed_linreg")
def distributed_linreg_fit(
    x_host: np.ndarray,
    y_host: np.ndarray,
    mesh,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
    dtype=None,
) -> LinRegResult:
    """Host-side driver, called on every rank with the same full (X, y):
    pad the rows to the mesh, take this rank's block (rank d of D takes the
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
    # ONE all-reduce of (XᵀX, Xᵀy, Σx, Σy, the count as two floats)
    n = x_host.shape[1]
    ctx.record_collective(
        "all_reduce",
        nbytes=collective_nbytes((n * n + 2 * n + 3,), x_local.dtype),
    )
    with ctx.phase("execute"), current_run().step(
        "normal_equations", rows=x_host.shape[0]
    ):
        return distributed_linreg_fit_kernel(
            x_dev, y_dev, mask_dev, mesh=mesh, reg_param=reg_param,
            fit_intercept=fit_intercept)
