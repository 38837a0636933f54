"""TruncatedSVD Estimator / Model (top-k singular structure of X), on PyTorch.

Counterpart of the JAX package's ``models/svd.py``. The reference's native
eigensolver entry is named ``calSVD`` (``rapidsml_jni.cu:338-392``): an SVD
of a symmetric matrix through its eigendecomposition with σ ← √λ. This
estimator is that capability as a model: right singular vectors V and
singular values σ of X, with no mean centring (the difference from PCA).
The Gram XᵀX is built on the device (``ops.covariance.gram``: for float32
on the card, one launch of the hand kernel ``csrc/fused_gram.cu`` with no
mean and unit rows), then ``eigh`` or the gated randomized solver, the
descending reorder, the sign flip and σ = √λ.

``useXlaDot`` / ``useXlaSvd`` keep the JAX names: True computes on the
device (the card, or the CPU when ``SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu``),
False on the host in numpy float64. ``dtype='auto'`` is float32 here.

``transform`` projects X @ V, batched on the device like ``PCAModel``'s.
Both entry points are instrumented: ``fit`` carries a fit report
(``observed_fit("svd")``; the JAX ``fit`` carries none), ``transform`` a
transform report, as every public fit and transform of the port does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.models.params import (
    HasDeviceId,
    HasInputCol,
    HasOutputCol,
    Param,
)
from spark_rapids_ml_tpu_torch.models.pca import _resolve_dtype
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import observed_transform
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange


class TruncatedSVDParams(HasInputCol, HasOutputCol, HasDeviceId):
    k = Param("k", "number of singular vectors", None,
              validator=lambda v: isinstance(v, int) and v >= 1)
    outputCol = Param("outputCol", "output column name", "svd_features")
    useXlaDot = Param(
        "useXlaDot",
        "Gram on the device (True) or host fallback (False)",
        True, validator=lambda v: isinstance(v, bool))
    useXlaSvd = Param(
        "useXlaSvd",
        "eigensolve on the device (True) or host LAPACK (False)",
        True, validator=lambda v: isinstance(v, bool))
    dtype = Param("dtype", "device compute dtype: 'float32', 'float64', or "
                  "'auto' (float32)", "auto",
                  validator=lambda v: v in ("auto", "float32", "float64"))
    svdSolver = Param(
        "svdSolver",
        "eigensolver for the device path: 'eigh', 'randomized' (top-k "
        "subspace iteration), or 'auto' (randomized when k << n, "
        "residual-gated with dense-eigh fallback — the same chooser as "
        "PCA's; the model records the choice in svd_solver_used_). Host "
        "fallbacks always use dense LAPACK.",
        "auto",
        validator=lambda v: v in ("auto", "eigh", "randomized"),
    )


def _synchronize(t: torch.Tensor) -> None:
    """Wait for the card, so a timed phase covers the device work."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class TruncatedSVD(TruncatedSVDParams):
    """``TruncatedSVD().setK(8).fit(X)`` → V (n×k), σ (k,)."""

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "TruncatedSVD":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(TruncatedSVD, path)

    @observed_fit("svd")
    def fit(self, dataset) -> "TruncatedSVDModel":
        timer = PhaseTimer()
        frame = as_vector_frame(dataset, self.getInputCol())
        with timer.phase("densify"):
            x = frame.vectors_as_matrix(self.getInputCol())
        n_rows, n_features = x.shape
        k = self.getK()
        if k is None:
            raise ValueError("k must be set before fit()")
        if k > n_features:
            raise ValueError(
                f"k = {k} must be <= number of features = {n_features}"
            )

        self._svd_solver_used = None  # set by device solves
        g = self._gram(x, timer)
        v, s = self._solve(g, k, timer)

        model = TruncatedSVDModel(components=v, singular_values=s)
        model.copy_values_from(self)
        model.fit_timings_ = timer.as_dict()
        model.svd_solver_used_ = self._svd_solver_used
        return model

    def _gram(self, x, timer):
        """XᵀX — a tensor on the device (useXlaDot), or numpy float64 on the
        host. The host mode never touches a device: that is the flag's
        contract (X may not fit in device memory)."""
        if self.getUseXlaDot():
            from spark_rapids_ml_tpu_torch.ops.covariance import gram

            device = resolve_device(self.getDeviceId())
            dtype = _resolve_dtype(self.getDtype())
            with timer.phase("h2d"):
                xd = torch.as_tensor(x, dtype=dtype, device=device)
                _synchronize(xd)
            with timer.phase("gram"), TraceRange("svd gram", TraceColor.GREEN):
                g = gram(xd)
                _synchronize(g)
                return g
        with timer.phase("gram"), TraceRange("host gram", TraceColor.ORANGE):
            x64 = np.asarray(x, dtype=np.float64)
            return x64.T @ x64

    def _solve(self, g, k: int, timer):
        """Eigensolve of the small n×n Gram + the calSVD postprocessing:
        descending order, sign flip, **σ = √λ** (seqRoot,
        ``rapidsml_jni.cu:374-377``; tiny negatives clamped)."""
        if self.getUseXlaSvd():
            from spark_rapids_ml_tpu_torch.ops.eigh import (
                pca_from_covariance_gated,
            )

            dtype = _resolve_dtype(self.getDtype())
            with timer.phase("solve"), TraceRange("device eigh", TraceColor.BLUE):
                if not isinstance(g, torch.Tensor):
                    g = torch.as_tensor(
                        g, device=resolve_device(self.getDeviceId()))
                gd = g.to(dtype)
                v, _, used = pca_from_covariance_gated(
                    gd, k, solver=self.getSvdSolver()
                )
                # λᵢ as the Rayleigh quotient of the RETURNED basis —
                # exact for dense-eigh vectors and exactly the estimate
                # the randomized solver certifies, with no dependence on
                # the ratio output's normalization
                lam = torch.sum(v * (gd @ v), dim=0)
                s = torch.sqrt(torch.clamp(lam, min=0))
                v = v.cpu().numpy().astype(np.float64)
                s = s.cpu().numpy().astype(np.float64)
            self._svd_solver_used = used
            return v, s
        from spark_rapids_ml_tpu_torch.ops.eigh import eigh_postprocess_host

        if isinstance(g, torch.Tensor):
            g = g.cpu().numpy()
        with timer.phase("solve"), TraceRange("host eigh", TraceColor.BLUE):
            w, u = np.linalg.eigh(np.asarray(g, dtype=np.float64))
            evals, evecs = eigh_postprocess_host(w, u)
        return evecs[:, :k], np.sqrt(np.maximum(evals[:k], 0))


class TruncatedSVDModel(TruncatedSVDParams):
    def __init__(self, components: Optional[np.ndarray] = None,
                 singular_values: Optional[np.ndarray] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.components = components          # (n_features, k), V
        self.singular_values = singular_values  # (k,), descending
        self.fit_timings_ = {}
        self.svd_solver_used_ = None

    def _copy_internal_state(self, other: "TruncatedSVDModel") -> None:
        other.components = self.components
        other.singular_values = self.singular_values
        other.svd_solver_used_ = self.svd_solver_used_

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        """X @ V, batched on the device (the posture the reference's
        transform path declared but disabled, ``RapidsPCA.scala:172-185``)."""
        if self.components is None:
            raise ValueError("model has no components; fit first or load")
        frame = as_vector_frame(dataset, self.getInputCol())
        self.transform_schema(frame.columns)
        x = frame.vectors_as_matrix(self.getInputCol())
        if x.shape[1] != self.components.shape[0]:
            raise ValueError(
                f"input has {x.shape[1]} features, model expects "
                f"{self.components.shape[0]}"
            )
        if self.getUseXlaDot():
            from spark_rapids_ml_tpu_torch.ops.pca_kernel import (
                pca_transform_kernel,
            )

            device = resolve_device(self.getDeviceId())
            dtype = _resolve_dtype(self.getDtype())
            proj = pca_transform_kernel(
                torch.as_tensor(x, dtype=dtype, device=device),
                torch.as_tensor(np.ascontiguousarray(self.components),
                                dtype=dtype, device=device),
            ).cpu().numpy()
        else:
            proj = x @ self.components
        return frame.with_column(self.getOutputCol(), proj.astype(np.float64))

    def transform_schema(self, columns):
        """Appends outputCol; raises when it would clobber an existing
        column (same contract as ``PCAModel.transform_schema``)."""
        out = list(columns)
        if self.getOutputCol() in out:
            raise ValueError(
                f"output column {self.getOutputCol()!r} already exists"
            )
        out.append(self.getOutputCol())
        return out

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_svd_model

        save_svd_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "TruncatedSVDModel":
        from spark_rapids_ml_tpu_torch.io.persistence import load_svd_model

        return load_svd_model(path)
