"""LogisticRegression Estimator / Model (binary and multinomial, Newton-IRLS),
on PyTorch.

Counterpart of the JAX package's ``models/logistic_regression.py``, with the
same params, so saved metadata stays compatible. Spark
``org.apache.spark.ml.classification.LogisticRegression``'s param surface,
subset: featuresCol (= inputCol), labelCol, predictionCol, probabilityCol,
maxIter, tol, regParam, elasticNetParam, fitIntercept, weightCol,
thresholds; the objective is Spark's ((1/n)·logloss + λ/2·||w||²,
intercept unpenalized). ``family`` is Spark's "auto": two classes fit the
binary model (labels must be 0/1), more than two (at most 100) the
multinomial one.

Fit routes:

* one shot (``useXlaDot``): Newton on the device (``ops/logreg_kernel.py``);
  the Hessian is the hand Gram kernel's full-f32 pipeline on the card, one
  launch per iteration, with √(p(1 − p)·w) as its row multiplier;
* elastic net (``elasticNetParam`` > 0 with ``regParam`` > 0, binary,
  in-memory): proximal Newton, each iteration's unregularized gradient and
  Hessian on the device (or the host), its L1/L2 subproblem by FISTA on the
  host in float64 (``linear_regression._elastic_net_solve``);
* multinomial (more than two classes): full Newton on the K·(d+1) system on
  the device, K(K+1)/2 kernel launches per iteration;
* streamed: a generator or zero-arg callable of (X, y) chunks, one pass
  per Newton iteration folding each bucket into a device accumulator (the
  kernel once per bucket), the small solve on the host in float64; the
  multinomial form assembles and solves its K(d+1) system on the host in
  float64, as the JAX package does;
* host (``useXlaDot=False``): numpy float64, never a device.

The Newton loops run on the host with one scalar read per iteration (see
``ops/logreg_kernel.py``). ``dtype='auto'`` is float32 here. Float32 Newton
may stall above the default ``tol`` of 1e-8 (its steps stop near eps·|w|),
and then runs to ``maxIter``, as the JAX package's does. ``fit_timings_``
keeps the JAX phase names: ``densify``, ``h2d``, ``fit_kernel``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.models.params import (
    HasDeviceId,
    HasInputCol,
    HasThresholds,
    HasWeightCol,
    Param,
)
from spark_rapids_ml_tpu_torch.models.pca import _resolve_dtype
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import observed_transform
from spark_rapids_ml_tpu_torch.utils.numeric import sigmoid as _sigmoid
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

# Spark's family="auto" guard: more distinct labels than this is a
# continuous target passed by mistake (the Newton system is (K·(d+1))²)
MAX_CLASSES = 100


class LogisticRegressionParams(HasInputCol, HasDeviceId, HasWeightCol,
                               HasThresholds):
    labelCol = Param("labelCol", "label column name (binary 0/1)", "label")
    predictionCol = Param("predictionCol", "predicted class column",
                          "prediction")
    probabilityCol = Param("probabilityCol", "P(y=1) output column",
                           "probability")
    maxIter = Param("maxIter", "maximum Newton iterations", 100,
                    validator=lambda v: isinstance(v, int) and v >= 0)
    tol = Param("tol", "Newton step-size convergence tolerance", 1e-8,
                validator=lambda v: v >= 0)
    regParam = Param("regParam", "regularization strength lambda", 0.0,
                     validator=lambda v: v >= 0)
    elasticNetParam = Param(
        "elasticNetParam",
        "L1/L2 mixing alpha in [0, 1] (Spark semantics): 0 = pure L2 "
        "Newton-IRLS; >0 adds the L1 term, solved by proximal Newton "
        "(GLMNET shape) — each outer iteration's quadratic subproblem "
        "runs the shared FISTA with the intercept unpenalized. Binary "
        "in-memory fits only.",
        0.0,
        validator=lambda v: 0.0 <= float(v) <= 1.0,
    )
    fitIntercept = Param("fitIntercept", "whether to fit an intercept", True,
                         validator=lambda v: isinstance(v, bool))
    useXlaDot = Param(
        "useXlaDot",
        "solve on the device (True) or host NumPy (False)",
        True, validator=lambda v: isinstance(v, bool))
    dtype = Param("dtype", "device compute dtype: 'float32', 'float64', or "
                  "'auto' (float32)", "auto",
                  validator=lambda v: v in ("auto", "float32", "float64"))


def _host(t) -> np.ndarray:
    return np.asarray(t.cpu().numpy() if isinstance(t, torch.Tensor) else t,
                      dtype=np.float64)


def _too_many_classes(n: int) -> ValueError:
    return ValueError(
        f"{n} distinct label values: looks like a continuous target, not "
        f"classes (multinomial supports up to {MAX_CLASSES})"
    )


def _xy_source(dataset, labels):
    """The streamed (X, y) source of ``linear_regression._streaming_xy_
    source``, its buckets sized by X's width: every bucket's Gram is over
    X alone (8192 rows at 4096 features, the kernel's measured bucket),
    where the linear fit's is over Z = [X | y]."""
    from spark_rapids_ml_tpu_torch.data.batches import auto_batch_rows
    from spark_rapids_ml_tpu_torch.models.linear_regression import (
        _streaming_xy_source,
    )

    source = _streaming_xy_source(dataset, labels)
    if source is not None:
        source.batch_rows = auto_batch_rows(source.n_features - 1)
    return source


class LogisticRegression(LogisticRegressionParams):
    """``LogisticRegression().setRegParam(0.01).fit(df)``; df carries the
    features + label columns (or pass ``labels=`` explicitly).
    Out-of-core: ``dataset`` may be a zero-arg callable yielding
    ``(X_chunk, y_chunk)`` pairs — re-iterable, one pass per Newton step."""

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "LogisticRegression":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(LogisticRegression, path)

    def _elastic(self) -> bool:
        return (float(self.getElasticNetParam()) > 0.0
                and float(self.getRegParam()) > 0.0)

    @observed_fit("logreg")
    def fit(self, dataset, labels=None) -> "LogisticRegressionModel":
        timer = PhaseTimer()
        source = _xy_source(dataset, labels)
        if source is not None:
            self._reject_streamed_weights()
            if self._elastic():
                raise ValueError(
                    "elasticNetParam > 0 is not supported on streamed/"
                    "out-of-core fits yet; fit in-memory or set "
                    "elasticNetParam=0"
                )
            # optimistic binary first — the common case pays no extra
            # pass; Spark's family="auto" kicks in when iteration 1's
            # label validation sees more than two classes
            try:
                coef, intercept, n_iter = self._fit_streamed(source, timer)
            except _NonBinaryLabelsError:
                classes = _streamed_classes(source)
                if classes.size <= 2:
                    # two or fewer distinct values that are not {0,1}:
                    # genuinely bad binary labels, not a multiclass target
                    raise
                if classes.size > MAX_CLASSES:
                    raise _too_many_classes(classes.size) from None
                return self._fit_multinomial_streamed(source, classes, timer)
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
            weights = self._extract_weights(frame, x.shape[0])
            if not np.isfinite(y).all():
                raise ValueError("labels must be finite")
            classes = np.unique(y)
            if classes.size > 2:
                if classes.size > MAX_CLASSES:
                    raise _too_many_classes(classes.size)
                return self._fit_multinomial(x, y, classes, weights, timer)
            _check_binary(y)
            if self._elastic():
                coef, intercept, n_iter = self._fit_elastic(
                    x, y, timer, weights, float(self.getElasticNetParam())
                )
            elif self.getUseXlaDot():
                coef, intercept, n_iter = self._fit_device(x, y, timer,
                                                           weights)
            else:
                coef, intercept, n_iter = self._fit_host(x, y, timer, weights)
        return self._model(timer, n_iter, coefficients=_host(coef),
                           intercept=float(intercept))

    def _model(self, timer, n_iter, **state) -> "LogisticRegressionModel":
        model = LogisticRegressionModel(**state)
        model.uid = self.uid
        model.copy_values_from(self)
        model.n_iter_ = int(n_iter)
        model.fit_timings_ = timer.as_dict()
        return model

    def _require_device_multinomial(self) -> None:
        if not self.getUseXlaDot():
            raise ValueError(
                "multinomial (>2 classes) LogisticRegression runs on the "
                "device path only; set useXlaDot=True or use OneVsRest for "
                "a host-only multiclass reduction"
            )

    def _fit_multinomial(self, x, y, classes, weights, timer):
        """Softmax family (Spark auto-selects it for >2 classes): full
        Newton on the K·(d+1) system, K(K+1)/2 kernel launches per
        iteration (``ops.logreg_kernel.multinomial_fit_kernel``)."""
        if self._elastic():
            raise ValueError(
                "elasticNetParam > 0 is not supported for multinomial "
                "(>2 classes) fits yet; set elasticNetParam=0 or use "
                "OneVsRest over the binary elastic-net fit"
            )
        self._require_device_multinomial()
        from spark_rapids_ml_tpu_torch.ops.logreg_kernel import (
            multinomial_fit_kernel,
        )

        device = resolve_device(self.getDeviceId())
        dtype = _resolve_dtype(self.getDtype())
        y_oh = np.eye(classes.size)[np.searchsorted(classes, y)]
        with timer.phase("h2d"):
            x_dev = torch.as_tensor(x, dtype=dtype, device=device)
            yoh_dev = torch.as_tensor(y_oh, dtype=dtype, device=device)
            w_dev = (
                None
                if weights is None
                else torch.as_tensor(weights, dtype=dtype, device=device)
            )
        with timer.phase("fit_kernel"), TraceRange(
            "logreg softmax", TraceColor.GREEN
        ):
            result = multinomial_fit_kernel(
                x_dev, yoh_dev, w_dev,
                reg_param=float(self.getRegParam()),
                fit_intercept=self.getFitIntercept(),
                max_iter=self.getMaxIter(),
                tol=float(self.getTol()),
                n_classes=int(classes.size),
            )
            # the host copies synchronise: the phase covers the device
            coef = _host(result.coefficients)
            intercepts = _host(result.intercepts)
        return self._model(timer, result.n_iter, coefficient_matrix=coef,
                           intercept_vector=intercepts,
                           classes=classes.astype(np.float64))

    def _fit_multinomial_streamed(self, source, classes, timer):
        """Softmax family out-of-core: one streamed raw-partials pass per
        Newton iteration into a device accumulator
        (``ops.logreg_kernel.update_multinomial_stats``); the K(d+1)
        system assembles and solves on the host in float64 per iteration,
        through the same ``assemble_multinomial_system`` the in-memory
        kernel uses."""
        if not source.reiterable:
            raise ValueError(
                "LogisticRegression streaming requires a re-iterable "
                "source: Newton makes one pass per iteration"
            )
        self._require_device_multinomial()
        from spark_rapids_ml_tpu_torch.ops.logreg_kernel import (
            assemble_multinomial_system,
            update_multinomial_stats,
        )

        device = resolve_device(self.getDeviceId())
        dtype = _resolve_dtype(self.getDtype())
        n = source.n_features - 1
        k = int(classes.size)
        dim = n + 1
        lam = float(self.getRegParam())
        fit_b = self.getFitIntercept()
        wb = np.zeros((k, dim))
        n_iter = 0
        eye_k = np.eye(k)
        with timer.phase("fit_kernel"), TraceRange(
            "logreg softmax streamed", TraceColor.GREEN
        ):
            for n_iter in range(1, self.getMaxIter() + 1):
                carry = (
                    torch.zeros((k, dim), dtype=dtype, device=device),
                    torch.zeros((k * dim, k * dim), dtype=dtype,
                                device=device),
                    torch.zeros((), dtype=dtype, device=device),
                )
                wb_dev = torch.as_tensor(wb, dtype=dtype, device=device)
                for batch, mask in source.batches():
                    yb = np.asarray(batch[:, n], dtype=np.float64)
                    if n_iter == 1:
                        real = yb if mask is None else yb[np.asarray(mask)]
                        ridx = np.searchsorted(classes, real)
                        ok = (ridx < k) & (
                            classes[np.minimum(ridx, k - 1)] == real
                        )
                        if not ok.all():
                            raise ValueError(
                                "streamed labels contain values outside "
                                "the observed class set"
                            )
                    idx = np.searchsorted(classes, yb)
                    y_oh = eye_k[np.clip(idx, 0, k - 1)]
                    carry = update_multinomial_stats(
                        carry,
                        torch.as_tensor(batch[:, :n], dtype=dtype,
                                        device=device),
                        torch.as_tensor(y_oh, dtype=dtype, device=device),
                        wb_dev,
                        None if mask is None else torch.as_tensor(
                            mask, device=device),
                    )
                # assembled on the host in the statistics' dtype, as the
                # JAX package's jnp assembly is under its default float32:
                # the gauge ridge then scales with that dtype's eps, above
                # the accumulators' rounding; solved in float64
                gxa, h_raw, cnt = (v.cpu() for v in carry)
                g, h = assemble_multinomial_system(
                    gxa, h_raw, float(cnt),
                    torch.as_tensor(wb, dtype=gxa.dtype), lam, fit_b,
                )
                step = np.linalg.solve(
                    _host(h), _host(g).reshape(-1)
                ).reshape(k, dim)
                wb = wb - step
                if np.max(np.abs(step)) <= float(self.getTol()):
                    break
        return self._model(
            timer, n_iter, coefficient_matrix=wb[:, :n],
            intercept_vector=wb[:, n] if fit_b else np.zeros(k),
            classes=classes.astype(np.float64))

    def _fit_elastic(self, x, y, timer, weights, alpha):
        """Elastic-net binary fit by proximal Newton (the GLMNET shape):
        per outer iteration, the UNregularized logloss gradient/Hessian
        at (w, b) define a quadratic model whose L1/L2-penalized minimum
        is found by the shared FISTA (``linear_regression._elastic_net_
        solve``), intercept exempt. The (n+1)² model assembly reuses
        ``_assemble_newton`` with lam=0; the XᵀWX work runs wherever
        useXlaDot points (on the card, one kernel launch per iteration)."""
        from spark_rapids_ml_tpu_torch.models.linear_regression import (
            _elastic_net_solve,
        )

        lam = float(self.getRegParam())
        fit_b = self.getFitIntercept()
        n = x.shape[1]
        w = np.zeros(n)
        b = 0.0
        penalty_mask = np.ones(n + 1)
        penalty_mask[n] = 0.0    # intercept unpenalized
        n_iter = 0
        use_device = self.getUseXlaDot()
        if use_device:
            device = resolve_device(self.getDeviceId())
            dtype = _resolve_dtype(self.getDtype())
            with timer.phase("h2d"):
                x_dev = torch.as_tensor(x, dtype=dtype, device=device)
                y_dev = torch.as_tensor(y, dtype=dtype, device=device)
                w_mask = (
                    None if weights is None
                    else torch.as_tensor(weights, dtype=dtype, device=device)
                )
        with timer.phase("fit_kernel"), TraceRange(
            "logreg elastic", TraceColor.GREEN
        ):
            for n_iter in range(1, self.getMaxIter() + 1):
                if use_device:
                    g, h = _device_logloss_grad_hess(
                        x_dev, y_dev, w, b, w_mask, fit_b
                    )
                else:
                    g, h = _full_grad_hess(x, y, w, b, 0.0, fit_b, weights)
                # curvature floor: on (near-)separable data the IRLS
                # weights underflow and the lam=0 Hessian collapses,
                # leaving the L1 subproblem unbounded along the
                # unpenalized intercept; a scale-aware ridge keeps every
                # FISTA subproblem strongly convex (GLMNET's damping role)
                ridge = 1e-6 * max(1.0, float(np.trace(h)) / h.shape[0])
                h = h + ridge * np.eye(h.shape[0])
                wb = np.concatenate([w, [b]])
                # quadratic model around wb: ½w̃ᵀHw̃ − (Hwb − g)ᵀw̃
                target = h @ wb - g
                wb_new = _elastic_net_solve(
                    h, target, lam, alpha,
                    penalty_mask=penalty_mask,
                )
                step = np.max(np.abs(wb_new - wb))
                w = wb_new[:n]
                b = float(wb_new[n]) if fit_b else 0.0
                if step <= float(self.getTol()):
                    break
        return w, b, n_iter

    def _fit_device(self, x, y, timer, weights=None):
        """The JAX package's ``_fit_xla``."""
        from spark_rapids_ml_tpu_torch.ops.logreg_kernel import (
            logreg_fit_kernel,
        )

        device = resolve_device(self.getDeviceId())
        dtype = _resolve_dtype(self.getDtype())
        with timer.phase("h2d"):
            x_dev = torch.as_tensor(x, dtype=dtype, device=device)
            y_dev = torch.as_tensor(y, dtype=dtype, device=device)
            # the kernel's mask multiplies residual, IRLS weights, and the
            # count — exactly the weighted MLE (Spark's weightCol)
            w_dev = (
                None
                if weights is None
                else torch.as_tensor(weights, dtype=dtype, device=device)
            )
        with timer.phase("fit_kernel"), TraceRange("logreg newton",
                                                   TraceColor.GREEN):
            result = logreg_fit_kernel(
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
        """NumPy Newton-IRLS, same objective and update rule."""
        with timer.phase("fit_kernel"), TraceRange("logreg host",
                                                   TraceColor.ORANGE):
            coef, intercept, n_iter = _host_newton(
                lambda w, b: _full_grad_hess(
                    x, y, w, b, float(self.getRegParam()),
                    self.getFitIntercept(), weights,
                ),
                x.shape[1],
                self.getMaxIter(),
                float(self.getTol()),
                self.getFitIntercept(),
            )
        return coef, intercept, n_iter

    def _fit_streamed(self, source, timer):
        """Newton with one streamed accumulation pass per iteration.

        Requires a re-iterable source. Per pass, each fixed-shape batch
        contributes its (Xᵀr, XᵀWX, Xᵀs, Σr, ΣW, n) partials on the device
        to the accumulator; the (n+1)² solve happens on the host in f64.
        """
        if not source.reiterable:
            raise ValueError(
                "LogisticRegression streaming requires a re-iterable source "
                "(a zero-arg callable returning a fresh chunk iterator): "
                "Newton makes one pass per iteration"
            )
        use_device = self.getUseXlaDot()
        if use_device:
            from spark_rapids_ml_tpu_torch.ops.logreg_kernel import (
                update_logreg_stats,
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
            "logreg streamed",
            TraceColor.GREEN if use_device else TraceColor.ORANGE,
        ):
            for n_iter in range(1, self.getMaxIter() + 1):
                if use_device:
                    carry = _init_logreg_carry(n, dtype, device)
                    w_dev = torch.as_tensor(w, dtype=dtype, device=device)
                    b_dev = torch.tensor(b, dtype=dtype, device=device)
                else:
                    carry = [np.zeros(n), np.zeros((n, n)), np.zeros(n),
                             0.0, 0.0, 0.0]
                for batch, mask in source.batches():
                    if n_iter == 1:
                        # labels only need validating once, on the host
                        yb = batch[:, -1] if mask is None else batch[mask, -1]
                        _check_binary(np.asarray(yb, dtype=np.float64))
                    if use_device:
                        carry = update_logreg_stats(
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
                        p = _sigmoid(xb @ w + b)
                        r = p - yb
                        s = p * (1.0 - p)
                        carry[0] += xb.T @ r
                        carry[1] += xb.T @ (xb * s[:, None])
                        carry[2] += xb.T @ s
                        carry[3] += float(r.sum())
                        carry[4] += float(s.sum())
                        carry[5] += float(len(yb))
                # the host copies synchronise
                gx, hxx, hxb, rsum, ssum, cnt = (_host(v) for v in carry)
                g, h = _assemble_newton(
                    gx, hxx, hxb, float(rsum), float(ssum), float(cnt),
                    w, lam, fit_b,
                )
                delta = np.linalg.solve(h, g)
                w = w - delta[:n]
                if fit_b:
                    b = b - delta[n]
                if np.max(np.abs(delta)) <= float(self.getTol()):
                    break
        return w, b, n_iter


def _init_logreg_carry(n: int, dtype, device):
    """The (gx, hxx, hxb, rsum, ssum, cnt) device accumulator every logreg
    plane shares: one site for the carry contract."""
    return tuple(
        torch.zeros(shape, dtype=dtype, device=device)
        for shape in ((n,), (n, n), (n,), (), (), ())
    )


def _device_logloss_grad_hess(x_dev, y_dev, w, b, w_mask, fit_b):
    """One full-pass UNregularized logloss (gradient, Hessian) at (w, b)
    on the device, from which the prox-Newton quadratic model is built
    (the JAX package's ``_xla_logloss_grad_hess``, which stages Z = [X | y]
    and folds it through ``update_logreg_stats``; here the rows and labels
    stay apart, which spares an (n, d+1) copy)."""
    from spark_rapids_ml_tpu_torch.ops.logreg_kernel import (
        _newton_stats,
        _valid,
    )

    dtype = x_dev.dtype
    stats = _newton_stats(
        torch.as_tensor(w, dtype=dtype, device=x_dev.device),
        torch.tensor(b, dtype=dtype, device=x_dev.device),
        x_dev, y_dev, _valid(x_dev, w_mask))
    gx, hxx, hxb, rsum, ssum, cnt = (_host(v) for v in stats)
    return _assemble_newton(
        gx, hxx, hxb, float(rsum), float(ssum), float(cnt), w, 0.0, fit_b
    )


def _streamed_classes(source) -> np.ndarray:
    """One pass over a re-iterable [X | y] source collecting the distinct
    label values (the streamed analogue of np.unique(y)); raises on
    non-finite labels like the in-memory fit does."""
    seen = set()
    for batch, mask in source.batches():
        yb = np.asarray(batch, dtype=np.float64)[:, -1]
        if mask is not None:
            yb = yb[np.asarray(mask)]
        if not np.isfinite(yb).all():
            raise ValueError("labels must be finite")
        seen.update(np.unique(yb).tolist())
        if len(seen) > MAX_CLASSES + 1:
            break  # enough to trigger the continuous-target guard
    return np.asarray(sorted(seen))


def class_indices(y: np.ndarray, classes: np.ndarray) -> np.ndarray:
    """Label values → indices into the sorted class set; raises when a
    value is outside it — ONE definition for every softmax plane."""
    k = classes.size
    idx = np.searchsorted(classes, y)
    ok = (idx < k) & (classes[np.minimum(idx, k - 1)] == y)
    if not ok.all():
        raise ValueError(
            "labels contain values outside the discovered class set"
        )
    return idx


def softmax_log_loss(x: np.ndarray, wb: np.ndarray, idx: np.ndarray) -> float:
    """Σ per-row softmax NLL at (K, d+1) parameters (max-shifted, clipped)
    — shared by the host and device statistics planes."""
    n = wb.shape[1] - 1
    z = x @ wb[:, :n].T + wb[:, n][None, :]
    z = z - z.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    return float(-np.log(
        np.maximum(p[np.arange(len(idx)), idx], 1e-300)
    ).sum())


class _NonBinaryLabelsError(ValueError):
    """Raised by _check_binary — a subtype so the streamed fit can catch
    it and re-dispatch to the multinomial family without string
    matching."""


def _check_binary(y: np.ndarray, estimator: str = "LogisticRegression") -> None:
    bad = ~np.isin(y, (0.0, 1.0))
    if bad.any():
        raise _NonBinaryLabelsError(
            f"binary {estimator} requires 0/1 labels; found "
            f"{np.unique(y[bad])[:5]}"
        )


def _full_grad_hess(x, y, w, b, lam, fit_intercept, weights=None):
    z = x @ w + b
    p = _sigmoid(z)
    r = p - y
    s = p * (1.0 - p)
    if weights is not None:
        r = r * weights
        s = s * weights
    gx = x.T @ r
    hxx = x.T @ (x * s[:, None])
    cnt = float(len(y)) if weights is None else float(np.sum(weights))
    return _assemble_newton(
        gx, hxx, x.T @ s, float(r.sum()), float(s.sum()), cnt,
        w, lam, fit_intercept,
    )


def _assemble_newton(gx, hxx, hxb, rsum, ssum, cnt, w, lam, fit_intercept):
    """Spark-convention (1/n)-scaled gradient/Hessian with unpenalized
    intercept, shared by the host and streamed paths."""
    n = w.shape[0]
    inv_n = 1.0 / max(cnt, 1.0)
    g = np.zeros(n + 1)
    g[:n] = gx * inv_n + lam * w
    h = np.zeros((n + 1, n + 1))
    h[:n, :n] = hxx * inv_n + lam * np.eye(n)
    if fit_intercept:
        g[n] = rsum * inv_n
        h[:n, n] = hxb * inv_n
        h[n, :n] = hxb * inv_n
        h[n, n] = ssum * inv_n
    else:
        h[n, n] = 1.0
    return g, h


def _host_newton(grad_hess, n, max_iter, tol, fit_intercept):
    w = np.zeros(n)
    b = 0.0
    n_iter = 0
    for n_iter in range(1, max_iter + 1):
        g, h = grad_hess(w, b)
        delta = np.linalg.solve(h, g)
        w = w - delta[:n]
        if fit_intercept:
            b = b - delta[n]
        if np.max(np.abs(delta)) <= tol:
            break
    return w, b, n_iter


class LogisticRegressionModel(LogisticRegressionParams):
    """Binary fits populate ``coefficients``/``intercept`` (Spark's
    binary-only accessors); multinomial fits populate
    ``coefficient_matrix`` (K, d) / ``intercept_vector`` (K,) /
    ``classes_`` — mirroring Spark's coefficientMatrix/interceptVector."""

    def __init__(self, coefficients: Optional[np.ndarray] = None,
                 intercept: float = 0.0, uid: Optional[str] = None,
                 coefficient_matrix: Optional[np.ndarray] = None,
                 intercept_vector: Optional[np.ndarray] = None,
                 classes: Optional[np.ndarray] = None):
        super().__init__(uid=uid)
        self.coefficients = coefficients
        self.intercept = intercept
        self.coefficient_matrix = coefficient_matrix
        self.intercept_vector = intercept_vector
        self.classes_ = classes
        self.n_iter_ = None
        self.fit_timings_ = {}

    @property
    def num_classes(self) -> int:
        if self.coefficient_matrix is not None:
            return int(self.coefficient_matrix.shape[0])
        return 2

    def _copy_internal_state(self, other: "LogisticRegressionModel") -> None:
        other.coefficients = self.coefficients
        other.intercept = self.intercept
        other.coefficient_matrix = self.coefficient_matrix
        other.intercept_vector = self.intercept_vector
        other.classes_ = self.classes_
        other.n_iter_ = self.n_iter_

    def _binary_serving(self) -> bool:
        """Whether this model has a device serving body: binary, fitted,
        on the device path (the multinomial path is a host softmax)."""
        return (self.coefficient_matrix is None
                and self.coefficients is not None
                and self.getUseXlaDot())

    @observed_transform
    def predict_proba(self, dataset) -> np.ndarray:
        """Binary: (n,) P(y=1). Multinomial: (n, K) softmax rows."""
        if self.coefficient_matrix is not None:
            frame = as_vector_frame(dataset, self.getInputCol())
            x = frame.vectors_as_matrix(self.getInputCol())
            z = x @ self.coefficient_matrix.T + self.intercept_vector[None, :]
            z = z - z.max(axis=1, keepdims=True)
            e = np.exp(z)
            return e / e.sum(axis=1, keepdims=True)
        if self.coefficients is None:
            raise ValueError("model has no coefficients; fit first or load")
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        if self.getUseXlaDot():
            from spark_rapids_ml_tpu_torch.ops.logreg_kernel import (
                logreg_predict_kernel,
            )

            device = resolve_device(self.getDeviceId())
            dtype = _resolve_dtype(self.getDtype())
            proba = logreg_predict_kernel(
                torch.as_tensor(x, dtype=dtype, device=device),
                torch.as_tensor(self.coefficients, dtype=dtype,
                                device=device),
                torch.tensor(self.intercept, dtype=dtype, device=device),
            ).cpu().numpy()
        else:
            proba = _sigmoid(x @ self.coefficients + self.intercept)
        return proba.astype(np.float64)

    def _serving_weights(self, precision: str, device, dtype):
        """Device-staged (coefficients, [scale,] intercept) for one
        precision, shared by the standalone serving program and the
        fused-pipeline stage: bf16 pre-cast; int8 pre-quantized and padded
        (``ops.logreg_kernel.pad_int8_coefficients``) with its float32
        scale; native at the transform dtype."""
        from spark_rapids_ml_tpu_torch.ops import logreg_kernel as _lk
        from spark_rapids_ml_tpu_torch.ops.quantize import (
            quantize_symmetric_host,
        )

        coef = np.ascontiguousarray(self.coefficients, dtype=np.float64)
        b_dev = torch.tensor(float(self.intercept), dtype=dtype,
                             device=device)
        if precision == "bf16":
            return (torch.as_tensor(coef, device=device).to(torch.bfloat16),
                    b_dev)
        if precision == "int8":
            q, scale = quantize_symmetric_host(coef)
            return (torch.as_tensor(_lk.pad_int8_coefficients(q),
                                    device=device),
                    torch.tensor(scale, dtype=torch.float32, device=device),
                    b_dev)
        return (torch.as_tensor(coef, dtype=dtype, device=device), b_dev)

    def serving_stage(self, precision: str = "native", *,
                      device=None, dtype=None):
        """Composable fused-pipeline stage: the σ(X·w + b) body + staged
        weights. TERMINAL — probabilities are the pipeline's answer, not a
        feature column. Binary models only; None otherwise."""
        if not self._binary_serving():
            return None
        from spark_rapids_ml_tpu_torch.models._serving import (
            ServingStage,
            resolve_serving_context,
        )
        from spark_rapids_ml_tpu_torch.ops import logreg_kernel as _lk

        if device is None or dtype is None:
            device, dtype = resolve_serving_context(self)
        body = _lk.SERVING_STAGE_BODIES.get(precision)
        if body is None:
            raise ValueError(f"unknown serving precision {precision!r}")
        return ServingStage(
            fn=body,
            weights=self._serving_weights(precision, device, dtype),
            algo="logistic_regression",
            terminal=True,
            fetch_dtype=np.dtype(np.float64),
        )

    def serving_transform_program(self, precision: str = "native",
                                  device=None):
        """The device-resident serving program for the pipelined batcher
        (``obs.serving.ServingProgram``): σ(X·w + b) with the weights
        staged once; the bf16/int8 variants reduce only the logit product
        (the sigmoid stays f32). Binary models only — the multinomial path
        is a host softmax, and host-path models return None."""
        if not self._binary_serving():
            return None
        from spark_rapids_ml_tpu_torch.models._serving import (
            build_serving_program,
            resolve_serving_context,
        )
        from spark_rapids_ml_tpu_torch.ops import logreg_kernel as _lk

        device, dtype = resolve_serving_context(self, device=device)
        return build_serving_program(
            device=device, dtype=dtype, algo="logistic_regression",
            precision=precision,
            kernels=_lk.SERVING_STAGE_BODIES,
            weights=self._serving_weights(precision, device, dtype),
            # f64 probabilities, matching predict_proba's sync output
            fetch_dtype=np.float64,
        )

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, self.getInputCol())
        proba = self.predict_proba(frame)  # reuse the built frame
        out = frame.with_column(self.getProbabilityCol(), proba.tolist())
        if self.coefficient_matrix is not None:
            pred = self.classes_[self._predict_index(proba)]
            return out.with_column(
                self.getPredictionCol(), pred.astype(np.float64).tolist()
            )
        return out.with_column(
            self.getPredictionCol(),
            self._predict_index(
                np.stack([1.0 - proba, proba], axis=1)
            ).astype(np.int32).tolist(),
        )

    def evaluate(self, dataset, labels=None) -> dict:
        """Accuracy / log-loss summary (binary or multinomial)."""
        frame = as_vector_frame(dataset, self.getInputCol())
        if labels is not None:
            y = np.asarray(labels, dtype=np.float64).reshape(-1)
        else:
            y = np.asarray(frame.column(self.getLabelCol()), dtype=np.float64)
        p = np.clip(self.predict_proba(dataset), 1e-12, 1 - 1e-12)
        if self.coefficient_matrix is not None:
            y_idx = np.searchsorted(self.classes_, y)
            if not (
                (y_idx < self.classes_.size)
                & (self.classes_[np.minimum(y_idx, self.classes_.size - 1)]
                   == y)
            ).all():
                raise ValueError("labels contain values outside classes_")
            # accuracy follows the SAME prediction rule transform uses
            # (thresholds-aware), so reported metrics can never disagree
            # with the emitted prediction column
            acc = float((self._predict_index(p) == y_idx).mean())
            logloss = float(
                -np.log(p[np.arange(len(y_idx)), y_idx]).mean()
            )
            return {"accuracy": acc, "logLoss": logloss}
        pred = self._predict_index(np.stack([1.0 - p, p], axis=1))
        acc = float((pred == (y >= 0.5)).mean())
        logloss = float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())
        return {"accuracy": acc, "logLoss": logloss}

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_logreg_model

        save_logreg_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "LogisticRegressionModel":
        from spark_rapids_ml_tpu_torch.io.persistence import load_logreg_model

        return load_logreg_model(path)
