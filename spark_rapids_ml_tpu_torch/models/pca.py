"""PCA Estimator / Model — the user-facing drop-in API, on PyTorch.

Counterpart of the JAX package's ``models/pca.py``, with the same param
names so saved metadata stays compatible. Parity target:
``com.nvidia.spark.ml.feature.PCA`` → ``RapidsPCA[Model]``: select input
column → require k ≤ numFeatures → covariance → eigensolve → model
(``RapidsPCA.scala:111-125``), transform WITHOUT mean subtraction
(``RapidsPCA.scala:187-189``), metadata JSON + Parquet persistence.

``useXlaDot`` / ``useXlaSvd`` keep their names: True computes on the device
(the card, or the CPU when ``SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu``), False on
the host in numpy float64. A float32 fit on a CUDA device takes the fused
Gram kernel; float64, and the explicit CPU, take the plain path.

``dtype='auto'`` is float32 here: PyTorch has no global x64 switch like the
JAX package's, whose 'auto' is float64 when x64 is on.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.data.batches import (
    BatchSource,
    stream_threshold_bytes,
    streaming_source,
)
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.models.params import (
    HasDeviceId,
    HasInputCol,
    HasOutputCol,
    Param,
)
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import (
    observed_transform,
    transform_phase,
)
from spark_rapids_ml_tpu_torch.ops.covariance import (
    column_means,
    covariance,
    resolve_gram_precision,
)
from spark_rapids_ml_tpu_torch.ops.eigh import (
    pca_from_covariance_gated,
    pca_postprocess_host,
    resolve_auto_solver,
)
from spark_rapids_ml_tpu_torch.ops.fused_gram import covariance_fused
from spark_rapids_ml_tpu_torch.ops.pca_kernel import (
    pca_fit_kernel,
    pca_transform_kernel,
)
from spark_rapids_ml_tpu_torch.ops.streaming import stream_covariance
from spark_rapids_ml_tpu_torch.utils.numeric import (
    GRAM_PRECISIONS as _GRAM_PRECISIONS,
)
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange


class PCAParams(HasInputCol, HasOutputCol, HasDeviceId):
    """Shared params, mirroring ``RapidsPCAParams`` (``RapidsPCA.scala:30-75``)."""

    k = Param(
        "k",
        "number of principal components",
        None,
        validator=lambda v: isinstance(v, int) and v >= 1,
    )
    outputCol = Param("outputCol", "output column name", "pca_features")
    meanCentering = Param(
        "meanCentering",
        "whether to center data before computing covariance",
        True,
        validator=lambda v: isinstance(v, bool),
    )
    useXlaDot = Param(
        "useXlaDot",
        "covariance on the device (True) or in host numpy (False); "
        "analogue of the reference's useGemm",
        True,
        validator=lambda v: isinstance(v, bool),
    )
    useXlaSvd = Param(
        "useXlaSvd",
        "eigensolve on the device (True) or in host numpy (False); "
        "analogue of the reference's useCuSolverSVD",
        True,
        validator=lambda v: isinstance(v, bool),
    )
    dtype = Param(
        "dtype",
        "device compute dtype: 'float32', 'float64', or 'auto' (float32)",
        "auto",
        validator=lambda v: v in ("auto", "float32", "float64"),
    )
    svdSolver = Param(
        "svdSolver",
        "device eigensolver: 'eigh' (dense full spectrum), 'randomized' "
        "(top-k subspace iteration, see ops/randomized.py) or 'auto' "
        "(randomized when k<<n on large covariances, residual-gated with "
        "dense-eigh fallback; the model records the choice in "
        "svd_solver_used_). Host solves (useXlaSvd=False) are always dense.",
        "auto",
        validator=lambda v: v in ("auto", "eigh", "randomized"),
    )
    batchRows = Param(
        "batchRows",
        "rows per streamed device batch for out-of-core fits; 0 = auto-size "
        "so one f32 batch is ~128 MiB",
        0,
        validator=lambda v: isinstance(v, int) and v >= 0,
    )
    gramPrecision = Param(
        "gramPrecision",
        "precision of the float32 Gram: 'auto' (default) defers to "
        "TPUML_GRAM_PRECISION (bfloat16_3x: hi/lo bf16 split, three passes "
        "with f32 accumulation); 'bfloat16'/'default' one bf16 pass, with a "
        "relaxed ~1e-2 relative component accuracy; 'float32'/'highest' "
        "full f32.",
        "auto",
        validator=lambda v: v == "auto" or v in _GRAM_PRECISIONS,
    )


def _resolve_dtype(dtype_param: str) -> torch.dtype:
    return torch.float64 if dtype_param == "float64" else torch.float32


class PCA(PCAParams):
    """Estimator. ``PCA().setK(3).setInputCol('features').fit(df)``."""

    def save(self, path: str, overwrite: bool = False) -> None:
        """Params-only persistence, as ``DefaultParamsWritable``."""
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "PCA":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(PCA, path)

    def _solve_cov_gated(self, cov, k):
        """Device eigensolve honoring svdSolver through the residual gate;
        records the choice for ``model.svd_solver_used_``."""
        pc, evr, used = pca_from_covariance_gated(
            cov, k, solver=self.getSvdSolver()
        )
        self._svd_solver_used = used
        return pc.cpu().numpy(), evr.cpu().numpy()

    @observed_fit("pca")
    def fit(self, dataset) -> "PCAModel":
        timer = PhaseTimer()
        self._svd_solver_used = None  # set by device solves; None = host
        k = self.getK()
        if k is None:
            raise ValueError("k must be set before fit()")

        use_xla_dot = self.getUseXlaDot()
        use_xla_svd = self.getUseXlaSvd()

        source = streaming_source(dataset, self.getBatchRows())
        if source is None:
            frame = as_vector_frame(dataset, self.getInputCol())
            with timer.phase("densify"):
                x_host = frame.vectors_as_matrix(self.getInputCol())
            n_rows, n_features = x_host.shape
            if k > n_features:
                raise ValueError(
                    f"k = {k} must be at most the number of features "
                    f"{n_features}"
                )
            if n_rows < 2 and self.getMeanCentering():
                # matches `require(count > 1)` (RapidsRowMatrix.scala:160)
                raise ValueError("mean centering requires more than one row")
            if use_xla_dot and x_host.nbytes > stream_threshold_bytes():
                # Too big for one copy to the device: stream buckets through
                # the device accumulator, the analogue of the reference's
                # per-partition chunking (RapidsRowMatrix.scala:168-202).
                source = BatchSource(x_host, batch_rows=self.getBatchRows())

        if source is not None:
            if k > source.n_features:
                raise ValueError(
                    f"k = {k} must be at most the number of features "
                    f"{source.n_features}"
                )
            pc, evr, mean = self._fit_streamed(
                source, k, use_xla_dot, use_xla_svd, timer
            )
        elif use_xla_dot or use_xla_svd:
            pc, evr, mean = self._fit_device(
                x_host, k, use_xla_dot, use_xla_svd, timer
            )
        else:
            pc, evr, mean = self._fit_host(x_host, k, timer)

        model = PCAModel(
            pc=np.asarray(pc, dtype=np.float64),
            explained_variance=np.asarray(evr, dtype=np.float64),
            mean=np.asarray(mean, dtype=np.float64),
        )
        model.uid = self.uid
        model.copy_values_from(self)
        model.fit_timings_ = timer.as_dict()
        model.svd_solver_used_ = self._svd_solver_used
        return model

    def _gram_precision(self) -> str:
        """The resolved ``gramPrecision`` param ('auto' → the env default)."""
        return resolve_gram_precision(self.get_or_default("gramPrecision"))

    def _solve(self, cov, k, on_device: bool, timer):
        """Eigensolve per ``useXlaSvd``: gated on the device, or host LAPACK
        in float64. ``cov`` is a tensor or a numpy array."""
        if on_device:
            if not isinstance(cov, torch.Tensor):
                cov = torch.as_tensor(
                    cov, dtype=_resolve_dtype(self.getDtype()),
                    device=resolve_device(self.getDeviceId()))
            with timer.phase("solve"), TraceRange("device eigh", TraceColor.BLUE):
                return self._solve_cov_gated(cov, k)
        if isinstance(cov, torch.Tensor):
            cov = cov.cpu().numpy()
        with timer.phase("solve"), TraceRange("host eigh", TraceColor.BLUE):
            return _host_eig_topk(np.asarray(cov, dtype=np.float64), k)

    # -- streamed (out-of-core) path -------------------------------------
    def _fit_streamed(self, source, k, use_xla_dot, use_xla_svd, timer):
        if use_xla_dot:
            with timer.phase("covariance"), TraceRange(
                "streamed cov", TraceColor.RED
            ):
                cov, mean, count = stream_covariance(
                    source,
                    mean_centering=self.getMeanCentering(),
                    dtype=_resolve_dtype(self.getDtype()),
                    device=resolve_device(self.getDeviceId()),
                    precision=self._gram_precision(),
                )
                count = int(count)  # synchronises: the phase covers the device
            mean = mean.cpu().numpy()
        else:
            # out-of-core on the host in float64
            with timer.phase("covariance"), TraceRange(
                "host cov", TraceColor.ORANGE
            ):
                cov, mean, count = _host_covariance_streamed(
                    source, self.getMeanCentering()
                )
        if self.getMeanCentering() and count < 2:
            raise ValueError("mean centering requires more than one row")
        pc, evr = self._solve(cov, k, use_xla_svd, timer)
        return pc, evr, mean

    # -- device path (the JAX package's _fit_xla) -------------------------
    def _fit_device(self, x_host, k, use_xla_dot, use_xla_svd, timer):
        device = resolve_device(self.getDeviceId())
        dtype = _resolve_dtype(self.getDtype())
        mean_centering = self.getMeanCentering()
        precision = self._gram_precision()

        if not use_xla_dot:
            # host covariance + device eigensolve (useGemm=false /
            # useCuSolverSVD=true — the reference's "pca using cuSolver" mode)
            with timer.phase("covariance"), TraceRange(
                "host cov", TraceColor.ORANGE
            ):
                cov, mean = _host_covariance(x_host, mean_centering)
            pc, evr = self._solve(cov, k, True, timer)
            return pc, evr, mean

        if dtype == torch.float32 and device.type == "cuda":
            # The fused center + scale + mask + Gram kernel
            # (ops/fused_gram.py): X is copied to the card once, never
            # padded, and only the upper Gram tiles are computed.
            with timer.phase("covariance"), TraceRange(
                "fused gram", TraceColor.RED
            ):
                cov, mean = covariance_fused(
                    x_host, mean_centering=mean_centering, device=device,
                    precision=precision,
                )
                torch.cuda.synchronize(device)
            pc, evr = self._solve(cov, k, use_xla_svd, timer)
            return pc, evr, mean.cpu().numpy()

        with timer.phase("h2d"):
            x = torch.as_tensor(x_host, dtype=dtype, device=device)
        solver = self.getSvdSolver()
        if use_xla_svd and not (
                solver == "auto"
                and resolve_auto_solver(x_host.shape[1], k) == "randomized"):
            # the whole fit on the device in one call; 'auto' here is the
            # dense solve, which needs no residual gate
            with timer.phase("fit_kernel"), TraceRange(
                "compute cov", TraceColor.RED
            ):
                result = pca_fit_kernel(
                    x, k, mean_centering=mean_centering, solver=solver,
                    precision=precision,
                )
                pc = result.components.cpu().numpy()
            self._svd_solver_used = (
                resolve_auto_solver(x_host.shape[1], k)
                if solver == "auto" else solver
            )
            return (pc, result.explained_variance.cpu().numpy(),
                    result.mean.cpu().numpy())
        # device covariance, then the gated device solve ('auto' promises
        # the residual gate) or the host solve (the reference's
        # useGemm=true / useCuSolverSVD=false mode)
        with timer.phase("covariance"), TraceRange("compute cov", TraceColor.RED):
            if mean_centering:
                mean = column_means(x)
                cov = covariance(x, mean=mean, precision=precision)
            else:
                mean = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
                cov = covariance(x, precision=precision)
            mean = mean.cpu().numpy()  # synchronises: the phase covers the device
        pc, evr = self._solve(cov, k, use_xla_svd, timer)
        return pc, evr, mean

    # -- host path -------------------------------------------------------
    def _fit_host(self, x_host, k, timer):
        with timer.phase("covariance"), TraceRange("host cov", TraceColor.ORANGE):
            cov, mean = _host_covariance(x_host, self.getMeanCentering())
        pc, evr = self._solve(cov, k, False, timer)
        return pc, evr, mean


def _host_covariance_streamed(source, mean_centering: bool):
    """Out-of-core host covariance: float64 accumulation per bucket.

    Two-pass (mean, then centered Gram) for re-iterable sources — the same
    schedule the device path uses; one-pass sufficient statistics otherwise.
    """
    n = source.n_features
    if mean_centering and source.reiterable:
        col_sum = np.zeros(n)
        count = 0
        for batch, mask in source.batches():
            b = batch if mask is None else batch[mask]
            col_sum += b.sum(axis=0)
            count += b.shape[0]
        mean = col_sum / max(count, 1)
        g = np.zeros((n, n))
        for batch, mask in source.batches():
            b = batch if mask is None else batch[mask]
            bc = np.asarray(b, dtype=np.float64) - mean
            g += bc.T @ bc
        return g / max(count - 1, 1), mean, count

    g = np.zeros((n, n))
    col_sum = np.zeros(n)
    count = 0
    for batch, mask in source.batches():
        b = batch if mask is None else batch[mask]
        b = np.asarray(b, dtype=np.float64)
        g += b.T @ b
        col_sum += b.sum(axis=0)
        count += b.shape[0]
    denom = max(count - 1, 1)
    if not mean_centering:
        return g / denom, np.zeros(n), count
    mean = col_sum / max(count, 1)
    cov = (g - count * np.outer(mean, mean)) / denom
    return cov, mean, count


def _host_covariance(x: np.ndarray, mean_centering: bool):
    """Host covariance in numpy float64, normalized by numRows−1 and with
    ``meanCentering=False`` supported (the reference's spr CPU path,
    ``RapidsRowMatrix.scala:203-252``, minus its bugs)."""
    x = np.asarray(x, dtype=np.float64)
    mean = x.mean(axis=0) if mean_centering else np.zeros(x.shape[1])
    xc = x - mean if mean_centering else x
    return xc.T @ xc / max(x.shape[0] - 1, 1), mean


def _host_eig_topk(cov: np.ndarray, k: int):
    """Host eigensolve (numpy LAPACK) + the shared postprocessing
    (descending order, sign-flip, λ/Σλ)."""
    evals, evecs = np.linalg.eigh(cov)
    return pca_postprocess_host(evals, evecs, k)


class PCAModel(PCAParams):
    """Fitted transformer holding ``pc`` (n_features × k) and
    ``explained_variance`` (k,), as ``RapidsPCAModel`` does
    (``RapidsPCA.scala:146-210``)."""

    def __init__(
        self,
        pc: Optional[np.ndarray] = None,
        explained_variance: Optional[np.ndarray] = None,
        mean: Optional[np.ndarray] = None,
        uid: Optional[str] = None,
    ):
        super().__init__(uid=uid)
        self.pc = pc
        self.explained_variance = explained_variance
        self.mean = mean
        self.fit_timings_ = {}
        self.svd_solver_used_ = None

    @classmethod
    def from_numpy(cls, pc, explained_variance, mean=None,
                   uid: Optional[str] = None) -> "PCAModel":
        """A model from fitted arrays, e.g. those of a model of the JAX
        package (``pc``, ``explained_variance``, ``mean``), copied."""
        pc = np.array(pc, dtype=np.float64)
        evr = np.array(explained_variance, dtype=np.float64).reshape(-1)
        if pc.ndim != 2 or evr.shape[0] != pc.shape[1]:
            raise ValueError(
                f"pc {pc.shape} and explained_variance {evr.shape} disagree")
        if mean is not None:
            mean = np.array(mean, dtype=np.float64).reshape(-1)
            if mean.shape[0] != pc.shape[0]:
                raise ValueError(
                    f"mean has {mean.shape[0]} entries, pc has {pc.shape[0]} rows")
        model = cls(pc=pc, explained_variance=evr, mean=mean, uid=uid)
        model.set("k", int(pc.shape[1]))
        return model

    def _copy_internal_state(self, other: "PCAModel") -> None:
        other.pc = self.pc
        other.explained_variance = self.explained_variance
        other.mean = self.mean
        other.svd_solver_used_ = self.svd_solver_used_

    @property
    def explainedVariance(self):
        return self.explained_variance

    @observed_transform("pca")
    def transform(self, dataset) -> VectorFrame:
        """Batched projection, one product over the whole batch on the
        device (the path the reference disabled, ``RapidsPCA.scala:172-190``);
        host numpy when ``useXlaDot=False``.

        The report's phases: ``device_put`` (the host→device copies),
        ``compute`` (the product's launch — like the JAX package's, it
        does not wait for the card) and ``host_sync`` (``.cpu()``, the
        sync, so it holds the product's device time); the host path
        records ``compute`` alone."""
        if self.pc is None:
            raise ValueError("model has no components; fit first or load")
        frame = as_vector_frame(dataset, self.getInputCol())
        self.transform_schema(frame.columns)
        x_host = frame.vectors_as_matrix(self.getInputCol())
        if x_host.shape[1] != self.pc.shape[0]:
            raise ValueError(
                f"input has {x_host.shape[1]} features, model expects "
                f"{self.pc.shape[0]}"
            )
        if self.getUseXlaDot():
            device = resolve_device(self.getDeviceId())
            dtype = _resolve_dtype(self.getDtype())
            with TraceRange("device transform", TraceColor.GREEN):
                with transform_phase("device_put"):
                    x = torch.as_tensor(x_host, dtype=dtype, device=device)
                    # contiguous, so a loaded model (its pc is a transposed
                    # view) runs the same product as the fitted one
                    pc = torch.as_tensor(np.ascontiguousarray(self.pc),
                                         dtype=dtype, device=device)
                with transform_phase("compute"):
                    out_dev = pca_transform_kernel(x, pc)
                with transform_phase("host_sync"):
                    out = out_dev.cpu().numpy()
        else:
            with TraceRange("host transform", TraceColor.GREEN):
                with transform_phase("compute"):
                    out = x_host @ self.pc
        return frame.with_column(self.getOutputCol(),
                                 np.asarray(out, dtype=np.float64))

    # -- serving ------------------------------------------------------------
    def _serving_weights(self, precision: str, device, dtype):
        """Device-staged constant operands (the components) for one
        precision, staged once per program: bf16 pre-cast; int8
        pre-quantized and zero-padded to ``torch._int_mm``'s widths, with
        its float32 scale; native in float64, the precision a float32 batch
        is multiplied in (``ops.pca_kernel._project``)."""
        from spark_rapids_ml_tpu_torch.ops.pca_kernel import (
            pad_int8_components,
        )
        from spark_rapids_ml_tpu_torch.ops.quantize import (
            quantize_symmetric_host,
        )

        pc = np.ascontiguousarray(self.pc, dtype=np.float64)
        if precision == "bf16":
            return (torch.as_tensor(pc, device=device).to(torch.bfloat16),)
        if precision == "int8":
            q, scale = quantize_symmetric_host(pc)
            return (torch.as_tensor(pad_int8_components(q), device=device),
                    torch.tensor(scale, dtype=torch.float32, device=device))
        return (torch.as_tensor(pc, device=device),)

    def _serving_bodies(self):
        """precision → the projection body; int8's keeps the model's k
        of the padded components' columns."""
        from spark_rapids_ml_tpu_torch.ops import pca_kernel as _pk

        return {
            "native": _pk.pca_transform_serve,
            "bf16": _pk.pca_transform_bf16,
            "int8": functools.partial(_project_int8_columns,
                                      k=int(self.pc.shape[1])),
        }

    def serving_stage(self, precision: str = "native", *,
                      device=None, dtype=None):
        """The composable stage (``models._serving.ServingStage``): the
        projection body + device-staged components at ``precision``.
        None for a host-path model (``useXlaDot=False``)."""
        if self.pc is None or not self.getUseXlaDot():
            return None
        from spark_rapids_ml_tpu_torch.models._serving import (
            ServingStage,
            resolve_serving_context,
        )

        if device is None or dtype is None:
            device, dtype = resolve_serving_context(self)
        body = self._serving_bodies().get(precision)
        if body is None:
            raise ValueError(f"unknown serving precision {precision!r}")
        return ServingStage(
            fn=body,
            weights=self._serving_weights(precision, device, dtype),
            algo="pca",
            fetch_dtype=np.dtype(np.float64),
        )

    def serving_transform_program(self, precision: str = "native",
                                  device=None):
        """The device-resident serving program for the pipelined
        micro-batcher (``obs.serving.ServingProgram``): components staged
        on the device once, ``put`` starting each batch's host→device
        copy, ``run`` launching the projection, ``fetch`` the one host
        sync, returning float64 as ``transform`` does. ``precision``
        selects the ladder (native / bf16 / int8), guarded by the engine's
        offline max-error check; ``device`` overrides the model's own
        device resolution. None for a host-path model
        (``useXlaDot=False``): the engine then keeps the blocking path."""
        if self.pc is None or not self.getUseXlaDot():
            return None
        from spark_rapids_ml_tpu_torch.models._serving import (
            build_serving_program,
            resolve_serving_context,
        )

        device, dtype = resolve_serving_context(self, device=device)
        return build_serving_program(
            device=device, dtype=dtype, algo="pca", precision=precision,
            kernels=self._serving_bodies(),
            weights=self._serving_weights(precision, device, dtype),
            fetch_dtype=np.float64,
        )

    def transform_schema(self, columns):
        """Output schema check: appends outputCol, k-sized vectors
        (``RapidsPCA.scala:193-200``)."""
        out = list(columns)
        if self.getOutputCol() in out:
            raise ValueError(f"output column {self.getOutputCol()!r} already exists")
        out.append(self.getOutputCol())
        return out

    # -- persistence ------------------------------------------------------
    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_pca_model

        save_pca_model(self, path, overwrite=overwrite)

    def write(self) -> "_PCAModelWriter":
        return _PCAModelWriter(self)

    @staticmethod
    def load(path: str) -> "PCAModel":
        from spark_rapids_ml_tpu_torch.io.persistence import load_pca_model

        return load_pca_model(path)

    @staticmethod
    def read() -> "_PCAModelReader":
        return _PCAModelReader()


def _project_int8_columns(x, components_q, components_scale, *, k: int):
    """The int8 projection's first ``k`` columns: the rest are the zero
    padding of the quantized components."""
    from spark_rapids_ml_tpu_torch.ops.pca_kernel import pca_transform_int8

    return pca_transform_int8(x, components_q, components_scale)[:, :k]


class _PCAModelWriter:
    """``model.write().overwrite().save(path)`` fluency, as Spark MLWriter."""

    def __init__(self, model: PCAModel):
        self._model = model
        self._overwrite = False

    def overwrite(self) -> "_PCAModelWriter":
        self._overwrite = True
        return self

    def save(self, path: str) -> None:
        self._model.save(path, overwrite=self._overwrite)


class _PCAModelReader:
    def load(self, path: str) -> PCAModel:
        return PCAModel.load(path)
