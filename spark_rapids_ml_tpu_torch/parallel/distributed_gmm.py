"""Data-parallel GaussianMixture: each rank's EM statistics, all-reduced.

Counterpart of the JAX package's ``parallel/distributed_gmm.py``. Rows
split over the ``data`` group; every EM pass each rank runs the E-step on
its shard (``ops.gmm_kernel.gmm_estep_device``: on the card the hand Gram
kernel once per component for Σ r·x·xᵀ) and ONE ``all_reduce`` sums the
``GmmStats`` tuple (Σr, Σr·x, Σr·x·xᵀ, loglik, Σw) packed into one buffer
in the fit's dtype (NCCL on cards, gloo on CPU ranks). The small host
M-step (k Cholesky factorizations of d × d covariances) and the
mean-loglik convergence rule are the ONE EM loop every GMM path shares
(``models/gaussian_mixture.py::_fit_from_stepper``), so every rank walks
the same iterates and returns the same model. Padding rows carry weight 0
and contribute nothing.

Instrumented as the JAX driver is: under ``fit_instrumentation
("distributed_gmm")``, one ``all_reduce`` of k + k·d + k·d² + 2 elements
recorded per EM pass, and one fit-monitor step ``em_pass`` per pass.
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
from spark_rapids_ml_tpu_torch.ops.gmm_kernel import (
    GmmStats,
    gmm_estep_device,
    init_params,
    stats_to_host,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_size,
    collective_nbytes,
    mesh_device,
    pad_rows_to_multiple,
)


def distributed_gmm_stats_kernel(x, w, means, prec_chol, log_det,
                                 log_weights, *, mesh) -> GmmStats:
    """One EM pass's sufficient statistics over the whole group, from this
    rank's rows ``x`` (rows, d) and weights ``w`` (rows,), tensors on the
    mesh's device. Every rank of the mesh's ``data`` group must call it;
    each returns the same replicated ``GmmStats`` of tensors."""
    stats = gmm_estep_device(x, w, means, prec_chol, log_det, log_weights)
    k, d = stats.mean_sum.shape
    packed = torch.cat([stats.resp_sum, stats.mean_sum.reshape(-1),
                        stats.sq_sum.reshape(-1), stats.loglik.reshape(1),
                        stats.w_sum.reshape(1)])
    dist.all_reduce(packed, group=mesh.get_group(DATA_AXIS))
    ends = np.cumsum([k, k * d, k * d * d, 1, 1])
    return GmmStats(
        resp_sum=packed[:ends[0]],
        mean_sum=packed[ends[0]:ends[1]].view(k, d),
        sq_sum=packed[ends[1]:ends[2]].view(k, d, d),
        loglik=packed[ends[2]],
        w_sum=packed[ends[3]],
    )


@fit_instrumentation("distributed_gmm")
def distributed_gmm_fit(
    x_host: np.ndarray,
    k: int,
    mesh,
    max_iter: int = 100,
    tol: float = 1e-3,
    seed: int = 0,
    reg: float = 1e-6,
    weights: np.ndarray = None,
    dtype=None,
):
    """Host-side driver, called on every rank with the same full X: pad
    the rows to the mesh (padding at weight 0), place this rank's block
    (rank d of D takes the d-th of D equal blocks, as the JAX row sharding
    does) in ``dtype`` (a numpy dtype, float32 when None, as the JAX
    driver) and run EM with the sharded statistics pass. Returns the
    standard ``GaussianMixtureModel`` (the class every fit path
    produces)."""
    from spark_rapids_ml_tpu_torch.models.gaussian_mixture import (
        GaussianMixture,
    )
    from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer

    x_host = np.asarray(x_host, dtype=np.float64)
    n_rows = x_host.shape[0]
    if n_rows < k:
        raise ValueError(f"k={k} components need at least k rows")
    w_host = (np.ones(n_rows) if weights is None
              else np.asarray(weights, dtype=np.float64).reshape(-1))
    n_dev = axis_size(mesh, DATA_AXIS)
    x_padded, _mask = pad_rows_to_multiple(x_host, n_dev)
    w_padded = np.zeros(x_padded.shape[0])
    w_padded[:n_rows] = w_host          # padding rows carry weight 0
    per = x_padded.shape[0] // n_dev
    rank = mesh.get_local_rank(DATA_AXIS)
    rows = slice(rank * per, (rank + 1) * per)
    nd = np.dtype(np.float32 if dtype is None else dtype)
    device = mesh_device(mesh)
    x_dev = torch.as_tensor(np.asarray(x_padded[rows], dtype=nd),
                            device=device)
    w_dev = torch.as_tensor(np.asarray(w_padded[rows], dtype=nd),
                            device=device)

    ctx = current_fit()
    d = x_host.shape[1]
    # one packed all_reduce of GmmStats (Σr, Σr·x, Σr·xxᵀ, loglik, w_sum)
    # per EM pass, recorded per stepper call
    step_nbytes = collective_nbytes((k + k * d + k * d * d + 2,), nd)

    def stepper(means, prec, log_det, log_w):
        ctx.record_collective("all_reduce", nbytes=step_nbytes)
        # the host copy synchronises, so the step's wall time covers the
        # whole pass
        with current_run().step("em_pass", rows=n_rows):
            return stats_to_host(distributed_gmm_stats_kernel(
                x_dev, w_dev, means, prec, log_det, log_w, mesh=mesh))

    est = GaussianMixture()
    est.set("k", int(k))
    est.set("maxIter", int(max_iter))
    est.set("tol", float(tol))
    est.set("seed", int(seed))
    est.set("regParam", float(reg))
    init = init_params(x_host, w_host, k, int(seed))
    return est._fit_from_stepper(stepper, init, PhaseTimer())
