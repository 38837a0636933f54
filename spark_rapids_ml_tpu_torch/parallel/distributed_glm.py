"""Data-parallel GeneralizedLinearRegression: each rank's IRLS statistics,
all-reduced.

Counterpart of the JAX package's ``parallel/distributed_glm.py``. Rows
split over the ``data`` group; every IRLS pass computes this rank's
weighted working statistics (XᵀWX, XᵀWz, sums, deviance: ``GlmStepOut``)
on its device (``ops.glm_kernel``: on the card XᵀWX is one launch of the
hand kernel's full-f32 pipeline), ONE ``all_reduce`` sums them packed into
one buffer over NCCL (gloo on CPU ranks), and the small host solve and
convergence rule are the ONE IRLS loop every other GLM path shares
(``models/glm.py::GeneralizedLinearRegression._irls``). Padding rows carry
weight 0 and a benign y = 1 (inside every family's domain), so every
statistic they touch is exactly zero.

Instrumented as the JAX function is: one fit-monitor step ``irls_pass``
per pass and the collective accounted per pass as d² + d + 6 elements of
the compute dtype.
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
from spark_rapids_ml_tpu_torch.ops.glm_kernel import (
    GlmStepOut,
    glm_irls_device_step,
    validate_label_range,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_size,
    collective_nbytes,
    mesh_device,
    pad_rows_to_multiple,
)


def _all_reduce_step(out: GlmStepOut, group) -> GlmStepOut:
    """The six statistics summed over the group in ONE packed
    ``all_reduce``."""
    n = out.xtz.shape[0]
    packed = torch.cat([out.xtx.reshape(-1), out.xtz, out.x_sum,
                        torch.stack([out.z_sum, out.w_sum, out.deviance])])
    dist.all_reduce(packed, group=group)
    tail = n * n + 2 * n
    return GlmStepOut(packed[:n * n].view(n, n), packed[n * n:n * n + n],
                      packed[n * n + n:tail], packed[tail],
                      packed[tail + 1], packed[tail + 2])


def distributed_glm_step_kernel(
    x, y, w, offset, coef, intercept, *, mesh, family: str, link: str,
    var_power: float, link_power: float, use_init_mu: bool,
) -> GlmStepOut:
    """One global IRLS pass over this rank's rows (tensors on the mesh's
    device): the shard's statistics, all-reduced. Every rank of the
    mesh's ``data`` group must call it."""
    out = glm_irls_device_step(
        x, y, w, offset, coef, intercept, family=family, link=link,
        var_power=var_power, link_power=link_power, use_init_mu=use_init_mu)
    return _all_reduce_step(out, mesh.get_group(DATA_AXIS))


@fit_instrumentation("distributed_glm")
def distributed_glm_fit(
    x_host: np.ndarray,
    y_host: np.ndarray,
    mesh,
    family: str = "gaussian",
    link: str = None,
    var_power: float = 0.0,
    link_power: float = None,
    max_iter: int = 25,
    tol: float = 1e-6,
    reg_param: float = 0.0,
    weights: np.ndarray = None,
    offset: np.ndarray = None,
    dtype=np.float32,
):
    """Host-side entry point, called on every rank with the same full (X, y):
    pads the rows to the mesh and places this rank's block (rank d of D
    takes the d-th of D equal blocks, as the JAX row sharding does).
    Returns the standard ``GeneralizedLinearRegressionModel`` (the class
    every other GLM path produces, with its summary surface populated)."""
    from spark_rapids_ml_tpu_torch.models.glm import (
        GeneralizedLinearRegression,
    )
    from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer

    x_host = np.asarray(x_host, dtype=np.float64)
    y = np.asarray(y_host, dtype=np.float64).reshape(-1)
    if y.shape[0] != x_host.shape[0]:
        raise ValueError(
            f"labels length {y.shape[0]} != rows {x_host.shape[0]}")
    if x_host.shape[0] == 0:
        raise ValueError("empty dataset")

    est = GeneralizedLinearRegression()
    est.set("family", family)
    if link is not None:
        est.set("link", link)
    est.set("variancePower", float(var_power))
    if link_power is not None:
        est.set("linkPower", float(link_power))
    est.set("maxIter", int(max_iter))
    est.set("tol", float(tol))
    est.set("regParam", float(reg_param))
    family_r, link_r, var_power_r, link_power_r = \
        est._resolved_family_link()
    validate_label_range(y, family=family_r, var_power=var_power_r)

    w = (np.ones(x_host.shape[0]) if weights is None
         else np.asarray(weights, dtype=np.float64).reshape(-1))
    o = (np.zeros(x_host.shape[0]) if offset is None
         else np.asarray(offset, dtype=np.float64).reshape(-1))
    for name, v in (("weights", w), ("offset", o)):
        if v.shape[0] != x_host.shape[0]:
            raise ValueError(
                f"{name} length {v.shape[0]} != rows {x_host.shape[0]}")
    if not np.isfinite(w).all() or (w < 0).any():
        # the same contract every other GLM path enforces via
        # _extract_weights — a NaN weight would otherwise all-reduce into
        # silently-NaN coefficients (and √W must be real for the kernel)
        raise ValueError("weights must be finite and non-negative")

    n_dev = axis_size(mesh, DATA_AXIS)
    x_padded, _mask = pad_rows_to_multiple(x_host, n_dev)
    n_pad = x_padded.shape[0]

    def pad_vec(v, fill=0.0):
        out = np.full(n_pad, fill)
        out[: v.shape[0]] = v
        return out

    per = n_pad // n_dev
    rows = slice(mesh.get_local_rank(DATA_AXIS) * per,
                 (mesh.get_local_rank(DATA_AXIS) + 1) * per)
    nd = np.dtype(dtype)
    device = mesh_device(mesh)

    def place(v):
        return torch.as_tensor(np.asarray(v[rows], dtype=nd), device=device)

    x_dev = place(x_padded)
    # y=1 on padding rows: inside every family's domain, so unit_dev
    # stays finite and the zero weight kills the contribution exactly
    y_dev = place(pad_vec(y, 1.0))
    w_dev = place(pad_vec(w, 0.0))
    o_dev = place(pad_vec(o, 0.0))

    ctx = current_fit()
    n_feat = x_host.shape[1]
    # each IRLS pass runs ONE packed all-reduce of the GlmStepOut tuple
    # (XᵀWX, XᵀWz, and the scalar sums) — recorded per actual invocation
    step_nbytes = collective_nbytes(
        (n_feat * n_feat + n_feat + len(GlmStepOut._fields),), nd)

    def step(coef, intercept, first=False):
        ctx.record_collective("all_reduce", nbytes=step_nbytes)
        # the float64 host copies block on the result, so the step's wall
        # time covers the full IRLS pass, not just the dispatch
        with current_run().step("irls_pass", rows=x_host.shape[0]):
            out = distributed_glm_step_kernel(
                x_dev, y_dev, w_dev, o_dev,
                torch.as_tensor(np.asarray(coef, dtype=nd), device=device),
                torch.tensor(float(intercept), dtype=x_dev.dtype,
                             device=device),
                mesh=mesh, family=family_r, link=link_r,
                var_power=float(var_power_r),
                link_power=float(link_power_r),
                use_init_mu=bool(first))
            return GlmStepOut(*(np.asarray(v.cpu().numpy(),
                                           dtype=np.float64) for v in out))

    if offset is not None:
        # the fitted model must refuse offset-less scoring, exactly as
        # an offsetCol-trained local model does (predictions without
        # the training exposure would be silently wrong) — name the
        # column the caller must supply at transform time
        est.set("offsetCol", "offset")

    timer = PhaseTimer()
    coef, intercept, n_iter, dev = est._irls(step, x_host.shape[1],
                                             timer)
    return est._finish(coef, intercept, n_iter, dev, float(w.sum()),
                       timer)
