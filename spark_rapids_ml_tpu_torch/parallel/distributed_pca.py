"""Data-parallel PCA fit: each rank's partial statistics, all-reduced.

Counterpart of the JAX package's ``parallel/distributed_pca.py``. The
reference ships one n×n double matrix per partition to the driver and sums
there (``RapidsRowMatrix.scala:168-202``). The JAX package runs one XLA
program over a mesh with a fused ``psum``. Here every rank of the ``data``
group computes its shard's statistics on its device, ``all_reduce`` sums
them over NCCL (gloo on CPU ranks), and the small eigensolve runs on every
rank, so every rank returns the same result. Each float32 partial Gram goes
through ``ops.covariance.centered_gram``, so on the card it launches the
hand kernel (``csrc/fused_gram.cu``), once per fit per rank, on the whole
shard.

Two communication schedules:

* ``two_pass`` (default): all-reduce the column sums and the count, then
  each rank's Gram of its rows centred by the global mean and scaled by
  1/√(n−1) (passed to the kernel as ``mean`` and ``rowmul``, so no centred
  copy is made), then all-reduce the partial covariances; 2 collectives.
* ``one_pass``: one all-reduce of (Σxxᵀ, Σx, n) packed into one buffer,
  covariance via ``G − n·μμᵀ``; 1 collective, the f32 cancellation caveat
  of ``ops.covariance.covariance_from_stats``.

``distributed_pca_fit`` is instrumented as the JAX one is: a fit report
(``fit_report_``) with the phases ``prepare`` (pad, slice, cast),
``placement`` (the host → device copy) and ``execute``, the collectives'
payload bytes, and one fit-monitor step ``covariance_eigh`` (``obs.fitmon``)
whose FLOPs are the Gram's. The count travels as two floats
(``mesh.pack_count``), so a collective that carries it moves one element
more than the JAX program's, and is accounted as such.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from spark_rapids_ml_tpu_torch.obs.fitmon import current_run
from spark_rapids_ml_tpu_torch.obs.report import (
    current_fit,
    fit_instrumentation,
)
from spark_rapids_ml_tpu_torch.ops.covariance import (
    centered_gram,
    covariance_from_stats,
    partial_gram_stats,
    row_count,
)
from spark_rapids_ml_tpu_torch.ops.eigh import pca_from_covariance
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_size,
    collective_nbytes,
    mesh_device,
    pack_count,
    pad_rows_to_multiple,
    unpack_count,
)


class DistributedPCAResult(NamedTuple):
    components: torch.Tensor
    explained_variance: torch.Tensor
    mean: torch.Tensor


def _shard_fit(x, mask, *, group, k, mean_centering, one_pass, flip_signs):
    """This rank's part of the fit; every rank of ``group`` runs the same
    collectives in the same order."""
    dtype = x.dtype
    n = x.shape[1]
    if one_pass:
        g, s, cnt = partial_gram_stats(x, mask)
        # ONE all-reduce for all three statistics
        packed = torch.cat([g.reshape(-1), s, pack_count(cnt, dtype)])
        dist.all_reduce(packed, group=group)
        g = packed[:n * n].view(n, n)
        s = packed[n * n:n * n + n]
        cnt = unpack_count(packed[n * n + n:])
        cov = covariance_from_stats(g, s, cnt, mean_centering=mean_centering)
        mean = s / cnt if mean_centering else torch.zeros_like(s)
    else:
        m = mask.to(dtype)
        # collective 1: the global column sum and count
        packed = torch.cat([(x * m[:, None]).sum(dim=0),
                            pack_count(row_count(x, mask), dtype)])
        dist.all_reduce(packed, group=group)
        cnt = unpack_count(packed[n:])
        mean = packed[:n] / cnt if mean_centering else torch.zeros_like(packed[:n])
        # the 1/√(n−1) scale rides in the rows (RapidsRowMatrix.scala:169,
        # 179-181), so the partial Grams sum directly to the covariance
        scale = 1.0 / torch.sqrt(torch.clamp(cnt - 1, min=1).to(dtype))
        cov = centered_gram(x, mean if mean_centering else None, m * scale)
        # collective 2: the partial covariances
        dist.all_reduce(cov, group=group)
    components, evr = pca_from_covariance(cov, k, flip_signs=flip_signs)
    return components, evr, mean


def distributed_pca_fit_kernel(
    x,
    mask,
    *,
    mesh,
    k: int,
    mean_centering: bool = True,
    one_pass: bool = False,
    flip_signs: bool = True,
) -> DistributedPCAResult:
    """The sharded fit on this rank's rows ``x`` (rows, n) and their 0/1
    ``mask``, placed on the mesh's device if they are not there. Ranks may
    hold different row counts. Every rank of the mesh's ``data`` group must
    call it; each returns the same replicated result."""
    device = mesh_device(mesh)
    x = torch.as_tensor(x, device=device)
    mask = torch.as_tensor(mask, device=device)
    components, evr, mean = _shard_fit(
        x, mask, group=mesh.get_group(DATA_AXIS), k=k,
        mean_centering=mean_centering, one_pass=one_pass,
        flip_signs=flip_signs)
    return DistributedPCAResult(components, evr, mean)


@fit_instrumentation("distributed_pca")
def distributed_pca_fit(
    x_host: np.ndarray,
    k: int,
    mesh,
    mean_centering: bool = True,
    one_pass: bool = False,
    flip_signs: bool = True,
    dtype=None,
) -> DistributedPCAResult:
    """Host-side driver, called on every rank with the same full matrix:
    pad the rows to the mesh, take this rank's block of them (rank d of D
    takes the d-th of D equal blocks, as the JAX row sharding does), place
    it on the rank's device and run the kernel. ``dtype`` (a numpy dtype)
    casts the host rows first."""
    ctx = current_fit()
    x_host = np.asarray(x_host)
    if k > x_host.shape[1]:
        raise ValueError(
            f"k = {k} must be at most the number of features {x_host.shape[1]}"
        )
    n_dev = axis_size(mesh, DATA_AXIS)
    with ctx.phase("prepare"):
        x_padded, mask = pad_rows_to_multiple(x_host, n_dev)
        per = x_padded.shape[0] // n_dev
        d = mesh.get_local_rank(DATA_AXIS)
        x_local = x_padded[d * per:(d + 1) * per]
        mask_local = mask[d * per:(d + 1) * per]
        if dtype is not None:
            x_local = x_local.astype(dtype)
            mask_local = mask_local.astype(dtype)
    with ctx.phase("placement"):
        device = mesh_device(mesh)
        x_dev = torch.as_tensor(x_local, device=device)
        mask_dev = torch.as_tensor(mask_local, device=device)
    n = x_host.shape[1]
    dt = x_local.dtype
    if one_pass:
        # ONE all-reduce of (Gram, column sum, packed count)
        ctx.record_collective(
            "all_reduce", nbytes=collective_nbytes((n * n + n + 2,), dt))
    else:
        # all-reduce of (column sum, packed count), then of the Gram
        ctx.record_collective(
            "all_reduce", nbytes=collective_nbytes((n + 2,), dt))
        ctx.record_collective(
            "all_reduce", nbytes=collective_nbytes((n, n), dt))
    with ctx.phase("execute"), current_run().step(
        "covariance_eigh", rows=x_host.shape[0]
    ) as step:
        result = distributed_pca_fit_kernel(
            x_dev, mask_dev, mesh=mesh, k=k, mean_centering=mean_centering,
            one_pass=one_pass, flip_signs=flip_signs)
        step.note(k=k, one_pass=int(one_pass))
        return result
