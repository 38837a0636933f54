"""GaussianMixture Estimator / Model (EM), on PyTorch.

Counterpart of the JAX package's ``models/gaussian_mixture.py``, with the
same params, so saved metadata stays compatible. Spark
``org.apache.spark.ml.clustering.GaussianMixture`` param surface: k,
maxIter, tol, seed, featuresCol (= inputCol), predictionCol,
probabilityCol, weightCol, plus regParam (sklearn's reg_covar).

The driver holds the small mixture state and its precision Cholesky
factors (host float64, ``ops.gmm_kernel.precision_cholesky``); each EM
iteration is ONE statistics pass (``ops.gmm_kernel.gmm_estep_device``: the
log-probabilities and Σ r·x in float64 rounded once, Σ r·x·xᵀ on the hand
Gram kernel, one launch per component) and a k × d × d host float64
M-step. Convergence follows Spark/sklearn: stop when the mean
log-likelihood improves by less than ``tol``. Every fit path (in-memory,
streamed, ``parallel.distributed_gmm_fit``, the Spark statistics plane)
walks the one EM loop ``_fit_from_stepper`` over its own statistics pass.

Fit routes:

* ``useXlaDot=True`` (default): the statistics pass on the resolved device
  (the card, or the CPU when it was requested) in the fit's ``dtype``
  ('auto' is float32 here);
* ``useXlaDot=False``: host numpy float64 (the JAX package's
  ``estep_stats_math`` with numpy), never a device;
* streamed: a zero-arg callable yielding row chunks re-iterates once per
  EM step with bounded memory; the init pass reservoir-samples the
  k-means++ rows draw for draw as the JAX package does, and a one-shot
  generator is refused.

Initialisation draws only from numpy (``ops.gmm_kernel.init_params``), so
a float64 fit follows the JAX package's EM iterate for iterate.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.data.batches import streaming_source
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.models.params import (
    HasDeviceId,
    HasInputCol,
    HasWeightCol,
    Param,
)
from spark_rapids_ml_tpu_torch.models.pca import _resolve_dtype
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import observed_transform
from spark_rapids_ml_tpu_torch.ops.gmm_kernel import (
    GmmStats,
    estep_stats_math,
    gmm_estep_device,
    gmm_responsibilities_device,
    init_from_moments,
    init_params,
    m_step,
    precision_cholesky,
    responsibilities_math,
    stats_to_host,
)
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange


class GaussianMixtureParams(HasInputCol, HasDeviceId, HasWeightCol):
    k = Param("k", "number of mixture components", 2,
              validator=lambda v: isinstance(v, int) and v >= 1)
    maxIter = Param("maxIter", "maximum EM iterations", 100,
                    validator=lambda v: isinstance(v, int) and v >= 0)
    tol = Param("tol", "mean log-likelihood convergence tolerance", 0.01,
                validator=lambda v: v >= 0)
    seed = Param("seed", "random seed for the component init", 0,
                 validator=lambda v: isinstance(v, int))
    predictionCol = Param("predictionCol", "argmax-component output column",
                          "prediction")
    probabilityCol = Param(
        "probabilityCol",
        "per-component responsibility vector output column",
        "probability")
    regParam = Param(
        "regParam",
        "diagonal covariance regularization added at every M-step "
        "(sklearn's reg_covar; keeps components from collapsing)",
        1e-6, validator=lambda v: v >= 0)
    useXlaDot = Param(
        "useXlaDot",
        "run the EM passes on the device (True) or host NumPy (False)",
        True, validator=lambda v: isinstance(v, bool))
    dtype = Param("dtype", "device compute dtype: 'float32', 'float64', or "
                  "'auto' (float32)", "auto",
                  validator=lambda v: v in ("auto", "float32", "float64"))


class GaussianMixture(GaussianMixtureParams):
    """``GaussianMixture(k=3).fit(df)`` → GaussianMixtureModel."""

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "GaussianMixture":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(GaussianMixture, path)

    @observed_fit("gmm")
    def fit(self, dataset) -> "GaussianMixtureModel":
        timer = PhaseTimer()
        k = int(self.getK())
        source = streaming_source(dataset, 0)
        if source is not None:
            self._reject_streamed_weights()
            if not source.reiterable:
                raise ValueError(
                    "GaussianMixture needs one pass per EM iteration: "
                    "pass a zero-arg callable yielding fresh chunks, not "
                    "a one-shot iterator/generator"
                )
            return self._fit_from_stepper(
                *self._streamed_stepper(source, timer), timer)
        frame = as_vector_frame(dataset, self.getInputCol())
        with timer.phase("densify"):
            x = frame.vectors_as_matrix(self.getInputCol()).astype(
                np.float64, copy=False)
        if x.shape[0] < k:
            raise ValueError(
                f"k={k} components need at least k rows, got {x.shape[0]}")
        w = self._extract_weights(frame, x.shape[0])
        if w is None:
            w = np.ones(x.shape[0])
        if self.getUseXlaDot():
            stepper = self._device_stepper(x, w, timer)
        else:
            def stepper(means, prec, log_det, log_w):
                return estep_stats_math(np, x, w, means, prec, log_det,
                                        log_w)

        init = init_params(x, w, k, int(self.getSeed()))
        return self._fit_from_stepper(stepper, init, timer)

    def _device_stepper(self, x, w, timer):
        device = resolve_device(self.getDeviceId())
        dtype = _resolve_dtype(self.getDtype())
        with timer.phase("h2d"):
            x_dev = torch.as_tensor(x, dtype=dtype, device=device)
            w_dev = torch.as_tensor(w, dtype=dtype, device=device)

        def stepper(means, prec, log_det, log_w):
            return stats_to_host(gmm_estep_device(
                x_dev, w_dev, means, prec, log_det, log_w))

        return stepper

    def _streamed_stepper(self, source, timer):
        """(stepper, init) over a re-iterable chunk source: the init pass
        reservoir-samples means + accumulates the pooled variance; each
        EM pass sums per-chunk device/host statistics (host float64)."""
        k = int(self.getK())
        use_device = self.getUseXlaDot()
        if use_device:
            device = resolve_device(self.getDeviceId())
            dtype = _resolve_dtype(self.getDtype())

        rng = np.random.default_rng(int(self.getSeed()))
        cap = max(256, 8 * k)   # reservoir feeding the k-means++ start
        sample = []
        seen = 0
        s1 = s2 = None
        for batch, mask in source.batches():
            b = np.asarray(batch if mask is None else batch[mask],
                           dtype=np.float64)
            if s1 is None:
                s1 = np.zeros(b.shape[1])
                s2 = np.zeros(b.shape[1])
            s1 += b.sum(axis=0)
            s2 += (b * b).sum(axis=0)
            for row in b:
                seen += 1
                if len(sample) < cap:
                    sample.append(np.array(row))
                else:
                    j = int(rng.integers(0, seen))
                    if j < cap:
                        sample[j] = np.array(row)
        if seen < k:
            raise ValueError(f"k={k} components need at least k rows")
        init = init_from_moments(float(seen), s1, s2, np.stack(sample), k,
                                 rng)

        def stepper(means, prec, log_det, log_w):
            totals = None
            for batch, mask in source.batches():
                b = np.asarray(batch if mask is None else batch[mask],
                               dtype=np.float64)
                wb = np.ones(b.shape[0])
                if use_device:
                    out = stats_to_host(gmm_estep_device(
                        torch.as_tensor(b, dtype=dtype, device=device),
                        torch.as_tensor(wb, dtype=dtype, device=device),
                        means, prec, log_det, log_w))
                else:
                    out = estep_stats_math(np, b, wb, means, prec,
                                           log_det, log_w)
                totals = out if totals is None else GmmStats(
                    *(a + b2 for a, b2 in zip(totals, out)))
            if totals is None:
                raise ValueError("empty dataset")
            return totals

        return stepper, init

    def _fit_from_stepper(self, stepper, init, timer):
        """The one EM loop: ``stepper(means, prec, log_det, log_w)`` is a
        statistics pass returning host float64 ``GmmStats``."""
        weights, means, covs = init
        reg = float(self.getRegParam())
        tol = float(self.getTol())
        max_iter = int(self.getMaxIter())
        ll = -np.inf
        ll_prev = -np.inf
        n_iter = 0
        with timer.phase("fit_kernel"), TraceRange("gmm em",
                                                   TraceColor.GREEN):
            for it in range(max_iter):
                prec, log_det = precision_cholesky(covs)
                stats = stepper(means, prec, log_det, np.log(weights))
                weights, means, covs = m_step(stats, reg)
                ll = float(stats.loglik) / float(stats.w_sum)
                n_iter = it + 1
                if abs(ll - ll_prev) < tol:
                    break
                ll_prev = ll
        model = GaussianMixtureModel(
            weights=np.asarray(weights, dtype=np.float64),
            means=np.asarray(means, dtype=np.float64),
            covs=np.asarray(covs, dtype=np.float64),
        )
        model.uid = self.uid
        model.copy_values_from(self)
        model.num_iterations_ = int(n_iter)
        model.log_likelihood_ = float(ll)
        model.fit_timings_ = timer.as_dict()
        return model


class GaussianMixtureModel(GaussianMixtureParams):
    """Fitted mixture: ``weights`` (k,), ``means`` (k, d), ``covs``
    (k, d, d), host float64. ``transform`` appends the responsibility
    vector (probabilityCol) and the argmax component (predictionCol)."""

    def __init__(self, weights: Optional[np.ndarray] = None,
                 means: Optional[np.ndarray] = None,
                 covs: Optional[np.ndarray] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.weights = weights
        self.means = means
        self.covs = covs
        self.num_iterations_ = 0
        self.log_likelihood_ = float("nan")
        self.fit_timings_ = {}

    @property
    def classes_(self) -> np.ndarray:
        """Component ids 0..k-1 (lets the classifier adapter derive the
        argmax prediction from the responsibility vector)."""
        return np.arange(self.weights.shape[0], dtype=np.float64)

    def _copy_internal_state(self, other) -> None:
        other.weights = self.weights
        other.means = self.means
        other.covs = self.covs
        other.num_iterations_ = self.num_iterations_
        other.log_likelihood_ = self.log_likelihood_

    @observed_transform
    def predict_proba(self, x) -> np.ndarray:
        """(n, k) responsibilities for a feature matrix, host float64."""
        if self.weights is None:
            raise ValueError("model has no components; fit first or load")
        x = np.asarray(x, dtype=np.float64)
        prec, log_det = precision_cholesky(self.covs)
        if self.getUseXlaDot():
            device = resolve_device(self.getDeviceId())
            dtype = _resolve_dtype(self.getDtype())
            resp = gmm_responsibilities_device(
                torch.as_tensor(x, dtype=dtype, device=device),
                self.means, prec, log_det, np.log(self.weights),
            ).cpu().numpy()
        else:
            resp = responsibilities_math(
                np, x, self.means, prec, log_det, np.log(self.weights))
        return np.asarray(resp, dtype=np.float64)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        resp = self.predict_proba(x)
        out = frame
        proba_col = self.get_or_default("probabilityCol")
        if proba_col:
            out = out.with_column(proba_col, list(resp))
        pred_col = self.get_or_default("predictionCol")
        if pred_col:
            out = out.with_column(
                pred_col, np.argmax(resp, axis=1).astype(np.float64))
        return out

    def summary(self, dataset) -> dict:
        """logLikelihood + per-component soft sizes (Spark's
        GaussianMixtureSummary core), host float64."""
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        prec, log_det = precision_cholesky(self.covs)
        stats = estep_stats_math(
            np, np.asarray(x, dtype=np.float64),
            np.ones(x.shape[0]), self.means, prec, log_det,
            np.log(self.weights))
        return {
            "logLikelihood": float(stats.loglik),
            "clusterSizes": np.asarray(stats.resp_sum).tolist(),
            "numIterations": self.num_iterations_,
        }

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_gmm_model

        save_gmm_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "GaussianMixtureModel":
        from spark_rapids_ml_tpu_torch.io.persistence import load_gmm_model

        return load_gmm_model(path)
