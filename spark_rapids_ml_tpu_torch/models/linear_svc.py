"""LinearSVC Estimator / Model (squared-hinge linear SVM), on PyTorch.

Counterpart of the JAX package's ``models/linear_svc.py``, with the same
params, so saved metadata stays compatible. Spark
``org.apache.spark.ml.classification.LinearSVC``'s param surface, subset:
featuresCol (= inputCol), labelCol, predictionCol, rawPredictionCol,
maxIter, tol, regParam, fitIntercept, standardization, threshold,
weightCol.

Documented deviation from Spark (the JAX package's): Spark minimizes the
non-smooth hinge with OWLQN; here the objective is the squared hinge

    J(w, b) = (1/Σwᵢ) Σᵢ wᵢ·max(0, 1 − ỹᵢ(xᵢ·w + b))² + (λ/2)‖w‖²

(ỹ = 2y − 1, intercept unpenalized), solved by generalized Newton
(``ops/svm_kernel.py``). ``standardization=True`` (Spark's default)
optimizes over per-column std-scaled features, so the L2 penalty applies
to the scaled coefficients, and returns coefficients on the original
scale.

Fit routes:

* one shot (``useXlaDot``): generalized Newton on the device; the Hessian
  is the hand Gram kernel's full-f32 pipeline on the card, one launch per
  iteration, with √(s·w) (s the active-set indicator) as its row
  multiplier;
* streamed: a zero-arg callable of (X, y) chunks, one pass per Newton
  iteration folding each bucket into a device accumulator (the kernel
  once per bucket), the small solve on the host in float64;
  standardization and weights are refused there, as in the JAX package;
* host (``useXlaDot=False``): numpy float64, never a device.

The Newton loops run on the host with one scalar read per iteration.
``dtype='auto'`` is float32 here. ``fit_timings_`` keeps the JAX phase
names: ``densify``, ``h2d``, ``fit_kernel``. ``fit`` gives the model a
``fit_report_`` (``observed_fit``), as every fit of the port does; the
JAX package's ``LinearSVC.fit`` has none.

Output shape: this model's ``rawPredictionCol`` holds the scalar margin
x·w + b, as the JAX package's local model does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.models.params import (
    HasDeviceId,
    HasInputCol,
    HasWeightCol,
    Param,
)
from spark_rapids_ml_tpu_torch.models.logistic_regression import _host
from spark_rapids_ml_tpu_torch.models.pca import _resolve_dtype
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import observed_transform
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange


class LinearSVCParams(HasInputCol, HasDeviceId, HasWeightCol):
    labelCol = Param("labelCol", "label column name (binary 0/1)", "label")
    predictionCol = Param("predictionCol", "predicted class column",
                          "prediction")
    rawPredictionCol = Param("rawPredictionCol",
                             "decision value x·w + b output column",
                             "rawPrediction")
    maxIter = Param("maxIter", "maximum Newton iterations", 100,
                    validator=lambda v: isinstance(v, int) and v >= 0)
    tol = Param("tol", "Newton step-size convergence tolerance", 1e-8,
                validator=lambda v: v >= 0)
    regParam = Param("regParam", "L2 regularization strength lambda", 0.0,
                     validator=lambda v: v >= 0)
    fitIntercept = Param("fitIntercept", "whether to fit an intercept", True,
                         validator=lambda v: isinstance(v, bool))
    standardization = Param(
        "standardization",
        "std-scale features during optimization (Spark default True); "
        "returned coefficients are always on the original scale",
        True, validator=lambda v: isinstance(v, bool))
    threshold = Param(
        "threshold",
        "decision threshold on the raw prediction (Spark default 0.0)",
        0.0, validator=lambda v: isinstance(v, (int, float)))
    useXlaDot = Param(
        "useXlaDot",
        "solve on the device (True) or host NumPy (False)",
        True, validator=lambda v: isinstance(v, bool))
    dtype = Param("dtype", "device compute dtype: 'float32', 'float64', or "
                  "'auto' (float32)", "auto",
                  validator=lambda v: v in ("auto", "float32", "float64"))


class LinearSVC(LinearSVCParams):
    """``LinearSVC().setRegParam(0.01).fit(df)``; df carries the features
    + binary 0/1 label columns (or pass ``labels=`` explicitly).
    Out-of-core: ``dataset`` may be a zero-arg callable yielding
    ``(X_chunk, y_chunk)`` pairs — re-iterable, one pass per Newton step
    (standardization is not supported on the streamed path)."""

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "LinearSVC":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(LinearSVC, path)

    @observed_fit("linear_svc")
    def fit(self, dataset, labels=None) -> "LinearSVCModel":
        from spark_rapids_ml_tpu_torch.models.logistic_regression import (
            _check_binary,
            _xy_source,
        )

        timer = PhaseTimer()
        source = _xy_source(dataset, labels)
        if source is not None:
            self._reject_streamed_weights()
            if self.getStandardization():
                raise ValueError(
                    "standardization=True needs column stds up front; "
                    "set standardization=False for streamed input"
                )
            coef, intercept, n_iter = self._fit_streamed(source, timer)
        else:
            frame = as_vector_frame(dataset, self.getInputCol())
            with timer.phase("densify"):
                x = frame.vectors_as_matrix(self.getInputCol())
                if labels is not None:
                    y = np.asarray(labels, dtype=np.float64).reshape(-1)
                else:
                    y = np.asarray(frame.column(self.getLabelCol()),
                                   dtype=np.float64)
            if y.shape[0] != x.shape[0]:
                raise ValueError(
                    f"labels length {y.shape[0]} != rows {x.shape[0]}"
                )
            if not np.isfinite(y).all():
                raise ValueError("labels must be finite")
            _check_binary(y, estimator="LinearSVC")
            weights = self._extract_weights(frame, x.shape[0])
            scale = None
            if self.getStandardization():
                # weighted sample std with the frequency-weight (Σw − 1)
                # denominator, so weightCol=k is exactly k-fold row
                # duplication; unweighted this is the usual ddof=1 std.
                # Zero-variance columns pass through unscaled.
                sd = _weighted_std(x, weights)
                if sd is not None:
                    scale = np.where(sd > 0, sd, 1.0)
                    x = x / scale[None, :]
            if self.getUseXlaDot():
                coef, intercept, n_iter = self._fit_device(x, y, timer,
                                                           weights)
            else:
                coef, intercept, n_iter = self._fit_host(x, y, timer, weights)
            if scale is not None:
                coef = np.asarray(coef, dtype=np.float64) / scale
        model = LinearSVCModel(
            coefficients=np.asarray(coef, dtype=np.float64),
            intercept=float(intercept),
        )
        model.uid = self.uid
        model.copy_values_from(self)
        model.n_iter_ = int(n_iter)
        model.fit_timings_ = timer.as_dict()
        return model

    def _fit_device(self, x, y, timer, weights=None):
        """The JAX package's ``_fit_xla``."""
        from spark_rapids_ml_tpu_torch.ops.svm_kernel import svc_fit_kernel

        device = resolve_device(self.getDeviceId())
        dtype = _resolve_dtype(self.getDtype())
        with timer.phase("h2d"):
            x_dev = torch.as_tensor(x, dtype=dtype, device=device)
            y_dev = torch.as_tensor(y, dtype=dtype, device=device)
            # the kernel's mask slot multiplies slack, active-set
            # indicator, and count — exactly the weighted objective
            w_dev = (
                None
                if weights is None
                else torch.as_tensor(weights, dtype=dtype, device=device)
            )
        with timer.phase("fit_kernel"), TraceRange("svc newton",
                                                   TraceColor.GREEN):
            result = svc_fit_kernel(
                x_dev, y_dev, w_dev,
                reg_param=float(self.getRegParam()),
                fit_intercept=self.getFitIntercept(),
                max_iter=self.getMaxIter(),
                tol=float(self.getTol()),
            )
            # the host copies synchronise: the phase covers the device
            return (_host(result.coefficients), float(result.intercept),
                    int(result.n_iter))

    def _fit_host(self, x, y, timer, weights=None):
        """NumPy generalized Newton, same objective and update rule."""
        with timer.phase("fit_kernel"), TraceRange("svc host",
                                                   TraceColor.ORANGE):
            coef, intercept, n_iter = _host_svc_newton(
                x, y, weights, float(self.getRegParam()),
                self.getFitIntercept(), self.getMaxIter(),
                float(self.getTol()),
            )
        return coef, intercept, n_iter

    def _fit_streamed(self, source, timer):
        """Generalized Newton with one streamed accumulation pass per
        iteration: each bucket folds its partials on the device (one
        kernel launch for its Hessian), the (n+1)² solve runs on the host
        in float64."""
        if not source.reiterable:
            raise ValueError(
                "LinearSVC streaming requires a re-iterable source "
                "(a zero-arg callable returning a fresh chunk iterator): "
                "Newton makes one pass per iteration"
            )
        from spark_rapids_ml_tpu_torch.models.logistic_regression import (
            _check_binary,
            _init_logreg_carry,
        )

        use_device = self.getUseXlaDot()
        if use_device:
            from spark_rapids_ml_tpu_torch.ops.svm_kernel import (
                update_svc_stats,
            )

            device = resolve_device(self.getDeviceId())
            dtype = _resolve_dtype(self.getDtype())
        n = source.n_features - 1       # the last column is the label
        lam = float(self.getRegParam())
        fit_b = self.getFitIntercept()
        w = np.zeros(n)
        b = 0.0
        n_iter = 0
        with timer.phase("fit_kernel"), TraceRange(
            "svc streamed",
            TraceColor.GREEN if use_device else TraceColor.ORANGE,
        ):
            for n_iter in range(1, self.getMaxIter() + 1):
                if use_device:
                    # the same six-slot accumulator as the logreg planes
                    carry = _init_logreg_carry(n, dtype, device)
                    w_dev = torch.as_tensor(w, dtype=dtype, device=device)
                    b_dev = torch.tensor(b, dtype=dtype, device=device)
                else:
                    carry = [np.zeros(n), np.zeros((n, n)), np.zeros(n),
                             0.0, 0.0, 0.0]
                for batch, mask in source.batches():
                    if n_iter == 1:
                        yb = batch[:, -1] if mask is None else batch[mask, -1]
                        _check_binary(np.asarray(yb, dtype=np.float64),
                                      estimator="LinearSVC")
                    if use_device:
                        carry = update_svc_stats(
                            carry,
                            torch.as_tensor(batch, dtype=dtype,
                                            device=device),
                            w_dev, b_dev,
                            None if mask is None else torch.as_tensor(
                                mask, device=device))
                    else:
                        zb = np.asarray(
                            batch if mask is None else batch[mask],
                            dtype=np.float64,
                        )
                        xb, yb = zb[:, :n], zb[:, n]
                        ypm = 2.0 * yb - 1.0
                        margin = 1.0 - ypm * (xb @ w + b)
                        a = np.maximum(margin, 0.0)
                        s = (margin > 0).astype(np.float64)
                        ay = a * ypm
                        xs = xb * s[:, None]
                        carry[0] += xb.T @ ay
                        carry[1] += xb.T @ xs
                        carry[2] += xs.sum(axis=0)
                        carry[3] += float(ay.sum())
                        carry[4] += float(s.sum())
                        carry[5] += float(len(yb))
                # the host copies synchronise
                gx, hxx, hxb, aysum, ssum, cnt = (_host(v) for v in carry)
                g, h = _assemble_svc_newton(
                    gx, hxx, hxb, float(aysum), float(ssum), float(cnt),
                    w, lam, fit_b,
                )
                delta = np.linalg.solve(h, g)
                w = w - delta[:n]
                if fit_b:
                    b = b - delta[n]
                if np.max(np.abs(delta)) <= float(self.getTol()):
                    break
        return w, b, n_iter


def _weighted_std(x, weights):
    """Per-column std; with weights, the frequency-weight convention
    Σw(x−μ_w)²/(Σw−1) (weight k ≡ k duplicated rows). None when the
    effective count is too small to standardize."""
    if weights is None:
        return x.std(axis=0, ddof=1) if x.shape[0] > 1 else None
    wsum = float(weights.sum())
    if wsum <= 1.0:
        return None
    mu = (weights[:, None] * x).sum(axis=0) / wsum
    var = (weights[:, None] * (x - mu[None, :]) ** 2).sum(axis=0) / (wsum - 1.0)
    return np.sqrt(var)


def _assemble_svc_newton(gx, hxx, hxb, aysum, ssum, cnt, w, lam,
                         fit_intercept):
    """(2/n)-scaled squared-hinge gradient/generalized-Hessian with
    unpenalized intercept — host mirror of ``ops.svm_kernel``."""
    n = w.shape[0]
    two_inv_n = 2.0 / max(cnt, 1.0)
    g = np.zeros(n + 1)
    g[:n] = -two_inv_n * gx + lam * w
    h = 1e-10 * np.eye(n + 1)
    h[:n, :n] += two_inv_n * hxx + lam * np.eye(n)
    if fit_intercept:
        g[n] = -two_inv_n * aysum
        h[:n, n] += two_inv_n * hxb
        h[n, :n] += two_inv_n * hxb
        h[n, n] += two_inv_n * ssum
    else:
        h[n, n] = 1.0
    return g, h


def _host_svc_newton(x, y, weights, lam, fit_intercept, max_iter, tol):
    ypm = 2.0 * y - 1.0
    wts = np.ones(len(y)) if weights is None else weights
    n = x.shape[1]
    w = np.zeros(n)
    b = 0.0
    n_iter = 0
    for n_iter in range(1, max_iter + 1):
        margin = 1.0 - ypm * (x @ w + b)
        a = np.maximum(margin, 0.0) * wts
        s = (margin > 0).astype(np.float64) * wts
        xs = x * s[:, None]
        g, h = _assemble_svc_newton(
            x.T @ (a * ypm), x.T @ xs, xs.sum(axis=0),
            float((a * ypm).sum()), float(s.sum()), float(wts.sum()),
            w, lam, fit_intercept,
        )
        delta = np.linalg.solve(h, g)
        w = w - delta[:n]
        if fit_intercept:
            b = b - delta[n]
        if np.max(np.abs(delta)) <= tol:
            break
    return w, b, n_iter


class LinearSVCModel(LinearSVCParams):
    """Raw decision values x·w + b in ``rawPredictionCol``; class 1.0
    where the raw value exceeds ``threshold`` (Spark's margin rule)."""

    def __init__(self, coefficients: Optional[np.ndarray] = None,
                 intercept: float = 0.0, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.coefficients = coefficients
        self.intercept = intercept
        self.n_iter_ = None
        self.fit_timings_ = {}

    @property
    def num_classes(self) -> int:
        return 2

    def _copy_internal_state(self, other: "LinearSVCModel") -> None:
        other.coefficients = self.coefficients
        other.intercept = self.intercept
        other.n_iter_ = self.n_iter_

    def decision_function(self, dataset) -> np.ndarray:
        if self.coefficients is None:
            raise ValueError("model has no coefficients; fit first or load")
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        if self.getUseXlaDot():
            from spark_rapids_ml_tpu_torch.ops.svm_kernel import (
                svc_decision_kernel,
            )

            device = resolve_device(self.getDeviceId())
            dtype = _resolve_dtype(self.getDtype())
            raw = svc_decision_kernel(
                torch.as_tensor(x, dtype=dtype, device=device),
                torch.as_tensor(self.coefficients, dtype=dtype,
                                device=device),
                torch.tensor(self.intercept, dtype=dtype, device=device),
            ).cpu().numpy()
        else:
            raw = x @ self.coefficients + self.intercept
        return raw.astype(np.float64)

    # per-class score = the margin (a real def, not an alias, so the
    # serving instrumentation sees it)
    @observed_transform
    def predict_proba(self, dataset) -> np.ndarray:
        return self.decision_function(dataset)

    @observed_transform
    def predict(self, dataset) -> np.ndarray:
        raw = self.decision_function(dataset)
        return (raw > float(self.getThreshold())).astype(np.float64)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, self.getInputCol())
        raw = self.decision_function(frame)
        out = frame.with_column(self.getRawPredictionCol(), raw.tolist())
        return out.with_column(
            self.getPredictionCol(),
            (raw > float(self.getThreshold())).astype(np.float64).tolist(),
        )

    def evaluate(self, dataset, labels=None) -> dict:
        frame = as_vector_frame(dataset, self.getInputCol())
        if labels is not None:
            y = np.asarray(labels, dtype=np.float64).reshape(-1)
        else:
            y = np.asarray(frame.column(self.getLabelCol()), dtype=np.float64)
        raw = self.decision_function(frame)
        pred = (raw > float(self.getThreshold())).astype(np.float64)
        acc = float((pred == y).mean())
        ypm = 2.0 * y - 1.0
        hinge2 = float(np.maximum(0.0, 1.0 - ypm * raw).__pow__(2).mean())
        return {"accuracy": acc, "squaredHinge": hinge2}

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_svc_model

        save_svc_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "LinearSVCModel":
        from spark_rapids_ml_tpu_torch.io.persistence import load_svc_model

        return load_svc_model(path)
