"""Feature-sharded PCA over a 2-D (data × feature) mesh of ranks.

Counterpart of the JAX package's ``parallel/feature_sharded.py``. The
reference caps the feature dimension: its packed triangle overflows past
65,535 columns (``RapidsRowMatrix.scala:147,204-206``) and the whole n×n
covariance is factorised on one device (``:94-95``). Here the Gram is
sharded: rank (d, f) holds an (m/D, n/F) tile of X, and the covariance comes
out as block rows, rank (·, f) holding rows f·n/F.. of it; no rank holds all
of it until the eigh solver gathers it.

Schedules for a rank's (n/F × n) block row of the Gram, over its ``feature``
group:

* ``ring``: F−1 hops; at step t the rank holds the centred tile of its
  neighbour t places on and fills that column block, then passes the tile
  one hop down the ring (``batch_isend_irecv``). Peak extra memory is one
  remote tile. Step 0, the tile against itself, goes through
  ``ops.covariance.centered_gram``, so on the card it launches the hand
  kernel; the cross products are plain ``torch.matmul``, as they are plain
  ``dot_general`` in the JAX package.
* ``allgather``: one all-gather of the row block's full width, then one
  product. Fewer, larger operations; F× the memory of a tile.

Then one all-reduce of the block row over the ``data`` group.

Solvers on the sharded covariance:

* ``eigh``: all-gather the covariance and factorise it on every rank.
* ``randomized``: subspace iteration whose matvec keeps the covariance
  sharded (the local block row's product, then an all-gather of the thin
  (n, l) result over the ``feature`` group). The start is drawn from
  ``torch.Generator(device).manual_seed(seed)`` on every rank, so the
  iterate stays the same everywhere. ``jax.random`` draws another start
  from the same seed, so the two packages agree where the solver is exact
  (a low-rank spectrum), not draw for draw.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from spark_rapids_ml_tpu_torch.ops.covariance import centered_gram, row_count
from spark_rapids_ml_tpu_torch.ops.eigh import pca_from_covariance
from spark_rapids_ml_tpu_torch.ops.randomized import (
    subspace_iteration,
    topk_from_subspace,
)
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FEATURE_AXIS,
    all_gather_rows,
    axis_size,
    mesh_device,
    pack_count,
    pad_rows_to_multiple,
    unpack_count,
)


class FeatureShardedPCAResult(NamedTuple):
    components: torch.Tensor
    explained_variance: torch.Tensor
    mean: torch.Tensor


def _ring_shift(held: torch.Tensor, mesh) -> torch.Tensor:
    """One hop of the feature ring: send ``held`` to the previous rank and
    receive the next rank's."""
    d = mesh.get_local_rank(DATA_AXIS)
    f = mesh.get_local_rank(FEATURE_AXIS)
    n_feature = axis_size(mesh, FEATURE_AXIS)
    group = mesh.get_group(FEATURE_AXIS)
    to_rank = int(mesh.mesh[d, (f - 1) % n_feature])
    from_rank = int(mesh.mesh[d, (f + 1) % n_feature])
    received = torch.empty_like(held)
    requests = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, held, to_rank, group=group),
        dist.P2POp(dist.irecv, received, from_rank, group=group),
    ])
    for request in requests:
        request.wait()
    return received


def _block_row_gram(x, mean_loc, rowmul, *, mesh, schedule):
    """This rank's (n_loc × F·n_loc) block row of the centred, scaled Gram,
    from its (m_loc × n_loc) tile ``x``."""
    n_feature = axis_size(mesh, FEATURE_AXIS)
    f = mesh.get_local_rank(FEATURE_AXIS)
    n_loc = x.shape[1]

    def centred():
        return ((x - mean_loc[None, :]) * rowmul[:, None]).contiguous()

    if schedule == "allgather":
        xc = centred()
        x_full_t = all_gather_rows(xc.T, mesh.get_group(FEATURE_AXIS))
        return xc.T @ x_full_t.T
    g_row = torch.empty((n_loc, n_feature * n_loc), dtype=x.dtype,
                        device=x.device)
    g_row[:, f * n_loc:(f + 1) * n_loc] = centered_gram(x, mean_loc, rowmul)
    if n_feature == 1:
        return g_row
    xc = held = centred()
    for t in range(1, n_feature):
        held = _ring_shift(held, mesh)
        col = ((f + t) % n_feature) * n_loc
        g_row[:, col:col + n_loc] = xc.T @ held
    return g_row


def _sharded_cov_and_mean(x_tile, mask, *, mesh, mean_centering, schedule):
    """(block row of Cov, this rank's slice of the mean). Collectives: one
    all-reduce over ``data`` for the column stats, the feature schedule for
    the Gram, one all-reduce over ``data`` for the block row."""
    dtype = x_tile.dtype
    n_loc = x_tile.shape[1]
    data_group = mesh.get_group(DATA_AXIS)
    m = mask.to(dtype)
    packed = torch.cat([(x_tile * m[:, None]).sum(dim=0),
                        pack_count(row_count(x_tile, mask), dtype)])
    dist.all_reduce(packed, group=data_group)
    cnt = unpack_count(packed[n_loc:])
    mean_loc = (packed[:n_loc] / cnt if mean_centering
                else torch.zeros_like(packed[:n_loc]))
    scale = 1.0 / torch.sqrt(torch.clamp(cnt - 1, min=1).to(dtype))
    g_row = _block_row_gram(x_tile, mean_loc, m * scale, mesh=mesh,
                            schedule=schedule)
    dist.all_reduce(g_row, group=data_group)
    return g_row, mean_loc


def _local_trace(g_row: torch.Tensor, mesh) -> torch.Tensor:
    """Sum of the global diagonal entries that land in this block row."""
    n_loc = g_row.shape[0]
    start = mesh.get_local_rank(FEATURE_AXIS) * n_loc
    return torch.trace(g_row[:, start:start + n_loc])


def feature_sharded_covariance_kernel(x_tile, mask, *, mesh,
                                      mean_centering: bool = True,
                                      schedule: str = "ring"):
    """This rank's block row of the covariance and slice of the mean, from
    its tile of X and the 0/1 mask of its rows (placed on the mesh's device
    if they are not there). Every rank of the mesh must call it."""
    device = mesh_device(mesh)
    x_tile = torch.as_tensor(x_tile, device=device).contiguous()
    mask = torch.as_tensor(mask, device=device)
    return _sharded_cov_and_mean(x_tile, mask, mesh=mesh,
                                 mean_centering=mean_centering,
                                 schedule=schedule)


def randomized_sharded_pca_kernel(g_row, *, mesh, k: int, oversample: int = 10,
                                  n_iter: int = 4, seed: int = 0,
                                  flip_signs: bool = True):
    """(components, evr) of the covariance whose block row this rank holds,
    by subspace iteration with a sharded matvec; the same on every rank."""
    group = mesh.get_group(FEATURE_AXIS)
    n = g_row.shape[1]
    l = min(k + oversample, n)

    def matvec(v):
        return all_gather_rows(g_row @ v, group)

    generator = torch.Generator(device=g_row.device).manual_seed(seed)
    evals, evecs = subspace_iteration(matvec, n, l, n_iter, g_row.dtype,
                                      g_row.device, generator=generator)
    total_var = _local_trace(g_row, mesh)
    dist.all_reduce(total_var, group=group)
    return topk_from_subspace(evals, evecs, k, total_var, flip_signs)


def pad_cols_to_multiple(x: np.ndarray, multiple: int) -> np.ndarray:
    """Zero-pad columns so the feature dim divides the mesh. Zero columns
    contribute zero mean and zero covariance rows and columns, so they are
    inert in both solvers; outputs are sliced back to the true width."""
    rem = (-x.shape[1]) % multiple
    if rem:
        x = np.concatenate(
            [x, np.zeros((x.shape[0], rem), dtype=x.dtype)], axis=1
        )
    return x


def local_tile(x_host: np.ndarray, mesh):
    """This rank's (m/D × n/F) tile of the host matrix, rows and columns
    zero-padded to the mesh, and the 0/1 mask of its rows."""
    n_data = axis_size(mesh, DATA_AXIS)
    n_feature = axis_size(mesh, FEATURE_AXIS)
    x_padded, mask = pad_rows_to_multiple(np.asarray(x_host), n_data)
    x_padded = pad_cols_to_multiple(x_padded, n_feature)
    m_loc = x_padded.shape[0] // n_data
    n_loc = x_padded.shape[1] // n_feature
    d = mesh.get_local_rank(DATA_AXIS)
    f = mesh.get_local_rank(FEATURE_AXIS)
    rows = slice(d * m_loc, (d + 1) * m_loc)
    tile = np.ascontiguousarray(x_padded[rows, f * n_loc:(f + 1) * n_loc])
    return tile, mask[rows]


def feature_sharded_pca_fit(
    x_host: np.ndarray,
    k: int,
    mesh,
    mean_centering: bool = True,
    schedule: str = "ring",
    solver: str = "eigh",
    oversample: int = 10,
    n_iter: int = 4,
    flip_signs: bool = True,
    dtype=None,
    seed: int = 0,
) -> FeatureShardedPCAResult:
    """Full fit over a 2-D mesh, called on every rank with the same full
    matrix: pad, take this rank's tile, the sharded covariance, then the
    solver. ``solver='eigh'`` gathers the covariance (exact, the parity
    path); ``solver='randomized'`` keeps it sharded (the large-n path).
    ``dtype`` (a numpy dtype) casts the host rows first."""
    if schedule not in ("ring", "allgather"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if solver not in ("eigh", "randomized"):
        raise ValueError(f"unknown solver {solver!r}")
    names = tuple(mesh.mesh_dim_names or ())
    if DATA_AXIS not in names or FEATURE_AXIS not in names:
        raise ValueError(
            f"mesh must have ({DATA_AXIS!r}, {FEATURE_AXIS!r}) axes; "
            f"got {names}"
        )
    x_host = np.asarray(x_host)
    n_features = x_host.shape[1]
    if k > n_features:
        raise ValueError(
            f"k = {k} must be at most the number of features {n_features}"
        )
    tile, mask = local_tile(x_host, mesh)
    if dtype is not None:
        tile = tile.astype(dtype)
        mask = mask.astype(dtype)
    g_row, mean_loc = feature_sharded_covariance_kernel(
        tile, mask, mesh=mesh, mean_centering=mean_centering,
        schedule=schedule)
    feature_group = mesh.get_group(FEATURE_AXIS)
    if solver == "randomized":
        components, evr = randomized_sharded_pca_kernel(
            g_row, mesh=mesh, k=k, oversample=oversample, n_iter=n_iter,
            seed=seed, flip_signs=flip_signs)
    else:
        cov = all_gather_rows(g_row, feature_group)[:n_features, :n_features]
        components, evr = pca_from_covariance(cov, k, flip_signs=flip_signs)
    mean = all_gather_rows(mean_loc, feature_group)[:n_features]
    return FeatureShardedPCAResult(components[:n_features], evr, mean)
