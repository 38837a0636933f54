"""PowerIterationClustering (Spark ``ml.clustering.PowerIterationClustering``),
on PyTorch.

Counterpart of the JAX package's ``models/pic.py``, with the same params,
defaults, validators and errors: ``assign_clusters`` on an edge frame
(srcCol, dstCol, optional weightCol) returns (id, cluster); PIC is not an
Estimator/Model pair in Spark either. The row-normalised affinity
``W = D⁻¹A`` goes to the device once and the truncated power iteration
``v ← W v / max(‖W v‖₁, 1e-30)`` runs ``maxIter`` steps there: a host loop
of one matrix-vector product (``torch.mv``, a GEMV, which no TF32 setting
reaches, so a float32 product stays float32 under any
``set_float32_matmul_precision``), one L1 norm and one divide a step, with
no host synchronisation inside the loop. The final 1-D k-means on the
iterate runs on the port's ``ops/kmeans_kernel.py``, as JAX's runs on its
own.

Envelope: the dense affinity is n². Past ``maxDenseNodes`` (default
32,768, 4 GiB at float32) ``build_affinity`` raises with the documented
limit rather than exhausting the device.

One difference from the JAX package, by design: the k-means++ seeding
draws from a ``torch.Generator`` (``ops/kmeans_kernel.py``), so labels
match JAX's as a partition, not draw for draw; the iterate ``v`` depends
only on the numpy ``default_rng(seed)`` start and matches JAX's.
``dtype='auto'`` is float32 here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.models.params import HasDeviceId, Param
from spark_rapids_ml_tpu_torch.models.pca import _resolve_dtype
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

KMEANS_MAX_ITER = 20
KMEANS_TOL = 1e-6


def _power_iterate(w: torch.Tensor, v0: torch.Tensor,
                   max_iter: int) -> torch.Tensor:
    """``max_iter`` steps of v ← W v / max(‖W v‖₁, 1e-30) on w's device."""
    floor = torch.full((), 1e-30, dtype=w.dtype, device=w.device)
    v = v0
    for _ in range(max_iter):
        v = torch.mv(w, v)
        v = v / torch.maximum(v.abs().sum(), floor)
    return v


def cluster_iterate(v: torch.Tensor, n: int, k: int, seed: int) -> np.ndarray:
    """The final 1-D k-means on the iterate's first ``n`` entries, scaled
    to O(1) spread: k-means++ from ``seed``, then Lloyd (20 iterations,
    tol 1e-6) and the nearest centre of every entry, on v's device (shared
    by the local and the distributed PIC)."""
    from spark_rapids_ml_tpu_torch.ops.kmeans_kernel import (
        assign_clusters,
        kmeans_fit_kernel,
        kmeans_plus_plus_init,
    )

    emb = v[:n, None] * n
    init = kmeans_plus_plus_init(emb, k, seed)
    res = kmeans_fit_kernel(emb, init, max_iter=KMEANS_MAX_ITER,
                            tol=KMEANS_TOL)
    return assign_clusters(emb, res.centers).cpu().numpy()


def initial_vector(deg: np.ndarray, n: int, pad: int, init_mode: str,
                   seed: int) -> np.ndarray:
    """The float64 start, (n + pad,) with zero padding: ``deg / Σdeg`` for
    'degree', else ``default_rng(seed).random(n)`` L1-normalised."""
    v0 = np.zeros(n + pad)
    if init_mode == "degree":
        v0[:n] = deg / deg.sum()
    elif init_mode == "random":
        v0[:n] = np.random.default_rng(seed).random(n)
        v0[:n] /= np.abs(v0[:n]).sum()
    else:
        raise ValueError("initMode must be 'random' or 'degree'")
    return v0


def build_affinity(src, dst, wts, max_nodes, np_dtype, pad_rows=0):
    """Validated edges → (ids, row-stochastic dense affinity, degrees): the
    one affinity builder the local and distributed PIC share.

    ``pad_rows`` appends that many all-zero rows/columns by allocating the
    final (n+pad)² buffer up front and scattering into the top-left block:
    a later ``np.pad`` would transiently double the peak host memory of the
    one allocation this builder exists to bound.
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    wts = np.asarray(wts, dtype=np.float64)
    if (wts < 0).any():
        raise ValueError("edge weights must be nonnegative")
    if src.shape[0] == 0:
        raise ValueError("cannot cluster an empty edge frame")
    for name, col in (("srcCol", src), ("dstCol", dst)):
        if (col != np.round(col)).any() or (
                np.abs(col).max(initial=0.0) >= float(2**53)):
            raise ValueError(
                f"{name} must hold float64-exact integer ids "
                "(< 2^53) — larger ids would silently collide")
    ids = np.unique(np.concatenate([src, dst]))
    n = len(ids)
    if n > max_nodes:
        raise ValueError(
            f"{n} distinct ids exceed the dense-affinity "
            f"envelope maxDenseNodes={max_nodes} (n² device bytes); "
            "shard the graph or raise the cap explicitly")
    si = np.searchsorted(ids, src)
    di = np.searchsorted(ids, dst)
    # built at the compute dtype and normalised in place: at the n = 32768
    # cap a float64 matrix and an out-of-place divide would peak at 16 GB
    # on the host for a 4 GB device payload
    a = np.zeros((n + pad_rows, n + pad_rows), dtype=np_dtype)
    np.add.at(a, (si, di), wts)
    off_diag = si != di  # a self-loop contributes its weight once
    np.add.at(a, (di[off_diag], si[off_diag]), wts[off_diag])
    deg = a[:n].sum(axis=1, dtype=np.float64)
    if (deg == 0).any():
        raise ValueError("isolated vertex with zero degree")
    # D⁻¹A, row-stochastic; padding rows stay zero (divided by 1)
    a /= np.concatenate([deg, np.ones(pad_rows)])[:, None].astype(np_dtype)
    return ids, a, deg


class PowerIterationClustering(HasDeviceId):
    k = Param("k", "number of clusters", 2,
              validator=lambda v: isinstance(v, int) and v >= 2)
    maxIter = Param("maxIter", "power iterations", 20,
                    validator=lambda v: isinstance(v, int) and v >= 1)
    initMode = Param("initMode", "'random' | 'degree' starting vector",
                     "random",
                     validator=lambda v: v in ("random", "degree"))
    srcCol = Param("srcCol", "edge source id column", "src")
    dstCol = Param("dstCol", "edge destination id column", "dst")
    weightCol = Param("weightCol", "edge weight column ('' = unit "
                      "weights)", "")
    seed = Param("seed", "rng seed", 0,
                 validator=lambda v: isinstance(v, int))
    maxDenseNodes = Param(
        "maxDenseNodes", "dense-affinity envelope: distinct ids beyond "
        "this raise instead of allocating n² on device", 32768,
        validator=lambda v: isinstance(v, int) and v >= 2)
    dtype = Param("dtype", "device compute dtype: 'float32', 'float64', "
                  "or 'auto' (float32)", "auto",
                  validator=lambda v: v in ("auto", "float32", "float64"))

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @classmethod
    def load(cls, path: str) -> "PowerIterationClustering":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(cls, path)

    def assign_clusters(self, dataset) -> VectorFrame:
        """Spark's ``assignClusters``: edge frame → (id, cluster)."""
        timer = PhaseTimer()
        frame = as_vector_frame(dataset, self.get_or_default("srcCol"))
        dtype = _resolve_dtype(self.get_or_default("dtype"))
        with timer.phase("affinity"):
            src = np.asarray(frame.column(self.get_or_default("srcCol")),
                             dtype=np.float64)
            dst = np.asarray(frame.column(self.get_or_default("dstCol")),
                             dtype=np.float64)
            wc = self.get_or_default("weightCol")
            wts = (np.asarray(frame.column(wc), dtype=np.float64)
                   if wc else np.ones(src.shape[0]))
            np_dtype = (np.float64 if dtype == torch.float64
                        else np.float32)
            ids, w, deg = build_affinity(
                src, dst, wts,
                int(self.get_or_default("maxDenseNodes")), np_dtype)
            n = len(ids)

        device = resolve_device(self.getDeviceId())
        seed = int(self.get_or_default("seed"))
        v0 = initial_vector(deg, n, 0, self.get_or_default("initMode"),
                            seed)
        with timer.phase("power_iteration"), TraceRange(
                "pic iterate", TraceColor.BLUE):
            w_dev = torch.as_tensor(w, device=device)
            del w
            v = _power_iterate(
                w_dev, torch.as_tensor(v0, dtype=dtype, device=device),
                int(self.get_or_default("maxIter")))
            del w_dev
        with timer.phase("kmeans"):
            labels = cluster_iterate(v, n, int(self.getK()), seed)
        self.assign_timings_ = timer.as_dict()
        return VectorFrame({"id": [int(i) for i in ids],
                            "cluster": [int(c) for c in labels]})
