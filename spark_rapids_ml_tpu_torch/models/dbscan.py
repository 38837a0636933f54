"""DBSCAN Estimator / Model (density clustering, fit-predict semantics), on
PyTorch.

Counterpart of the JAX package's ``models/dbscan.py``, with the same params,
defaults and validators: ``DBSCAN().setEps(0.5).setMinPts(5).fit(df)``
labels the FITTED dataset — DBSCAN has no out-of-sample predict.
``model.transform(df)`` appends the fitted labels to (that same) df;
``model.labels_`` and ``model.core_mask_`` expose them directly.

The device path is ``ops/dbscan_kernel.py`` (ε-graph + min-label
propagation): the dense kernel up to ``_DENSE_MAX_ROWS`` rows, the tiled
one past it or when ``blockRows > 0``. The host route
(``useXlaDot=False``) is the JAX package's NumPy BFS with identical
semantics, including the deterministic minimum-core-neighbour border
assignment. ``dtype='auto'`` is float32 here. The JAX package's model has
no writer, so this one has none either.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.models.params import (
    HasDeviceId,
    HasInputCol,
    Param,
)
from spark_rapids_ml_tpu_torch.models.pca import _resolve_dtype
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import observed_transform
from spark_rapids_ml_tpu_torch.ops import dbscan_kernel as _dk
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

class DBSCANParams(HasInputCol, HasDeviceId):
    eps = Param(
        "eps",
        "neighborhood radius",
        0.5,
        validator=lambda v: float(v) > 0,
    )
    minPts = Param(
        "minPts",
        "minimum neighbors (self included) for a core point",
        5,
        validator=lambda v: isinstance(v, int) and v >= 1,
    )
    predictionCol = Param(
        "predictionCol", "output cluster-id column (-1 = noise)", "prediction"
    )
    useXlaDot = Param(
        "useXlaDot",
        "epsilon-graph + propagation on the device (True) or host "
        "NumPy BFS (False)",
        True,
        validator=lambda v: isinstance(v, bool),
    )
    dtype = Param(
        "dtype",
        "device compute dtype: 'float32', 'float64', or 'auto' (float32)",
        "auto",
        validator=lambda v: v in ("auto", "float32", "float64"),
    )
    blockRows = Param(
        "blockRows",
        "rows per tiled ε-graph block. 0 = auto: the one-shot dense "
        "kernel (whole n×n adjacency in device memory) up to 16384 rows, "
        "a 4096-row tiled sweep beyond — memory then scales as block×n "
        "instead of n×n, taking n to the hundreds of thousands. Explicit "
        "values force the tiled path with that block size.",
        0,
        validator=lambda v: isinstance(v, int) and v >= 0,
    )


class DBSCAN(DBSCANParams):
    """``DBSCAN().setEps(0.3).setMinPts(10).fit(df)`` → DBSCANModel."""

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "DBSCAN":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(DBSCAN, path)

    @observed_fit("dbscan")
    def fit(self, dataset) -> "DBSCANModel":
        timer = PhaseTimer()
        frame = as_vector_frame(dataset, self.getInputCol())
        with timer.phase("densify"):
            x = frame.vectors_as_matrix(self.getInputCol())
        if x.shape[0] < 1:
            raise ValueError("fit requires at least one row")
        if self.getUseXlaDot():
            labels, core = self._fit_device(x, timer)
        else:
            labels, core = _host_dbscan(
                x, float(self.getEps()), self.getMinPts()
            )
        labels = _relabel_consecutive(labels)
        model = DBSCANModel(labels=labels, core_mask=np.asarray(core, bool))
        model.uid = self.uid
        model.copy_values_from(self)
        model.fit_timings_ = timer.as_dict()
        return model

    _DENSE_MAX_ROWS = 16384

    def _fit_device(self, x, timer):
        """The JAX package's ``_fit_xla``: dense up to ``_DENSE_MAX_ROWS``
        rows, tiled past it or when ``blockRows > 0``."""
        device = resolve_device(self.getDeviceId())
        dtype = _resolve_dtype(self.getDtype())
        n = x.shape[0]
        block = self.getBlockRows()
        use_blocked = block > 0 or n > self._DENSE_MAX_ROWS
        eps = float(self.getEps())
        with timer.phase("cluster"), TraceRange("dbscan", TraceColor.GREEN):
            if not use_blocked:
                x_dev = torch.as_tensor(x, dtype=dtype, device=device)
                labels, core = _dk.dbscan_labels(x_dev, eps,
                                                 self.getMinPts())
            else:
                if block == 0:
                    block = min(4096, n)
                if n > _dk.LABEL_ENVELOPE:
                    raise ValueError(
                        f"{n} rows exceeds the tiled kernel's 2^24 label "
                        "envelope"
                    )
                from spark_rapids_ml_tpu_torch.parallel.mesh import (
                    pad_rows_to_multiple,
                )

                x_pad, mask = pad_rows_to_multiple(np.asarray(x), block)
                x_dev = torch.as_tensor(x_pad, dtype=dtype, device=device)
                valid = torch.as_tensor(mask > 0, device=device)
                labels, core = _dk.dbscan_labels_blocked(
                    x_dev, valid, eps, self.getMinPts(), block)
                labels = labels[:n]
                core = core[:n]
            labels = labels.cpu().numpy()
            core = core.cpu().numpy()
        return labels, core


class DBSCANModel(DBSCANParams):
    def __init__(
        self,
        labels: Optional[np.ndarray] = None,
        core_mask: Optional[np.ndarray] = None,
    ):
        super().__init__()
        self.labels_ = labels
        self.core_mask_ = core_mask

    def _copy_internal_state(self, other: "DBSCANModel") -> None:
        other.labels_ = self.labels_
        other.core_mask_ = self.core_mask_

    @property
    def n_clusters_(self) -> int:
        if self.labels_ is None:
            return 0
        return int(self.labels_.max()) + 1 if (self.labels_ >= 0).any() else 0

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        """Append the fitted labels. DBSCAN has no out-of-sample predict;
        the dataset must be the fitted one (length-checked)."""
        if self.labels_ is None:
            raise ValueError("model has no labels; fit first")
        frame = as_vector_frame(dataset, self.getInputCol())
        if len(frame) != len(self.labels_):
            raise ValueError(
                f"DBSCAN labels the fitted dataset only: got {len(frame)} "
                f"rows, fitted {len(self.labels_)}"
            )
        return frame.with_column(
            self.getPredictionCol(), self.labels_.astype(np.int64).tolist()
        )


def _relabel_consecutive(labels: np.ndarray) -> np.ndarray:
    """Map cluster representatives to consecutive ids 0..k−1 (order of
    first appearance by representative value — deterministic); −1 stays."""
    labels = np.asarray(labels)
    out = np.full(labels.shape, -1, dtype=np.int64)
    reps = np.unique(labels[labels >= 0])
    for new, rep in enumerate(reps):
        out[labels == rep] = new
    return out


def _host_dbscan(x, eps, min_pts):
    """NumPy BFS oracle with the same semantics as the device kernel."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    d2 = (
        (x * x).sum(1, keepdims=True) - 2.0 * x @ x.T + (x * x).sum(1)[None, :]
    )
    adj = d2 <= eps * eps
    core = adj.sum(axis=1) >= min_pts
    labels = np.full(n, -1, dtype=np.int64)
    for seed in range(n):
        if not core[seed] or labels[seed] >= 0:
            continue
        # flood the core component; label by its minimum member index
        comp = {seed}
        frontier = [seed]
        while frontier:
            i = frontier.pop()
            for j in np.nonzero(adj[i] & core)[0]:
                if j not in comp:
                    comp.add(int(j))
                    frontier.append(int(j))
        rep = min(comp)
        for i in comp:
            labels[i] = rep
    # border points: minimum core-neighbor representative
    for i in range(n):
        if core[i]:
            continue
        neigh = np.nonzero(adj[i] & core)[0]
        if neigh.size:
            labels[i] = labels[neigh].min()
    return labels, core
