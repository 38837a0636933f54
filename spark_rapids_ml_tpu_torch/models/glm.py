"""GeneralizedLinearRegression Estimator / Model (IRLS), on PyTorch.

Counterpart of the JAX package's ``models/glm.py``, with the same params,
so saved metadata stays compatible. Spark
``org.apache.spark.ml.regression.GeneralizedLinearRegression``'s param
surface, subset: family (gaussian/binomial/poisson/gamma/tweedie), link
(per-family grid, canonical default), variancePower/linkPower for tweedie,
maxIter, tol, regParam (L2, intercept unpenalized), fitIntercept,
weightCol, offsetCol, linkPredictionCol.

Each IRLS iteration is one device pass (``ops/glm_kernel.py``) giving the
weighted sufficient statistics (XᵀWX, XᵀWz, sums) and the deviance; XᵀWX
is the hand Gram kernel's full-f32 pipeline on the card, one launch per
pass, with √W as its row multiplier. The small (d × d) weighted
normal-equations solve runs on the host in float64. Fit routes:

* in memory (``useXlaDot``): the rows, labels, weights and offset placed
  on the device once, one pass per iteration;
* streamed: a zero-arg callable of (X, y) chunks, one pass over it per
  iteration, each bucket's statistics summed on the device in float64 (the
  JAX package sums them on the host in float64; the order is the same),
  one kernel launch per bucket; no weights or offset;
* host (``useXlaDot=False``): the same pass in numpy float64.

Convergence follows R/Spark: stop when the relative deviance change
|dev − dev_prev| / (|dev_prev| + 0.1) drops below ``tol``. When the loop
reaches ``maxIter`` one more pass gives the deviance at the final
coefficients, as in the JAX package; that pass launches the Gram too.
``dtype='auto'`` is float32 here; a float32 deviance may never meet the
default tol 1e-6 and then runs to ``maxIter``, as the JAX package's does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.models.linear_regression import (
    _centered_moments,
)
from spark_rapids_ml_tpu_torch.models.params import (
    HasDeviceId,
    HasInputCol,
    HasWeightCol,
    Param,
)
from spark_rapids_ml_tpu_torch.models.pca import _resolve_dtype
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import observed_transform
from spark_rapids_ml_tpu_torch.ops.glm_kernel import (
    CANONICAL_LINK,
    FAMILIES,
    FAMILY_LINKS,
    GlmStepOut,
    deviance_math,
    family_funcs,
    glm_irls_device_step,
    irls_step_math,
    link_funcs,
    validate_label_range,
)
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange


class GeneralizedLinearRegressionParams(HasInputCol, HasDeviceId,
                                        HasWeightCol):
    labelCol = Param("labelCol", "label column name", "label")
    predictionCol = Param("predictionCol",
                          "predicted mean mu = g^-1(eta) output column",
                          "prediction")
    linkPredictionCol = Param(
        "linkPredictionCol",
        "optional linear-predictor eta output column ('' = not emitted)",
        "", validator=lambda v: isinstance(v, str))
    family = Param("family", "error distribution family", "gaussian",
                   validator=lambda v: v in FAMILIES)
    link = Param(
        "link",
        "link function name ('' = the family's canonical link); tweedie "
        "uses linkPower instead of a named link",
        "", validator=lambda v: isinstance(v, str))
    variancePower = Param(
        "variancePower",
        "tweedie variance power p in {0} U [1, inf): Var(mu) = mu^p "
        "(0=gaussian, 1=poisson, 2=gamma)",
        0.0,
        validator=lambda v: float(v) == 0.0 or float(v) >= 1.0)
    linkPower = Param(
        "linkPower",
        "tweedie power-link exponent: eta = mu^linkPower (0 = log link). "
        "None (default) = 1 - variancePower, Spark's default",
        None)
    offsetCol = Param(
        "offsetCol",
        "optional per-row offset column added to the linear predictor "
        "with fixed coefficient 1 ('' = no offset)",
        "", validator=lambda v: isinstance(v, str))
    maxIter = Param("maxIter", "maximum IRLS iterations", 25,
                    validator=lambda v: isinstance(v, int) and v >= 0)
    tol = Param("tol", "relative deviance convergence tolerance", 1e-6,
                validator=lambda v: v >= 0)
    regParam = Param(
        "regParam",
        "L2 strength lambda on the (1/sum(w))-normalized centered normal "
        "equations, intercept unpenalized (the LinearRegression "
        "convention)",
        0.0, validator=lambda v: v >= 0)
    fitIntercept = Param("fitIntercept", "whether to fit an intercept", True,
                         validator=lambda v: isinstance(v, bool))
    useXlaDot = Param(
        "useXlaDot",
        "run the per-iteration pass on the device (True) or host NumPy "
        "(False)",
        True, validator=lambda v: isinstance(v, bool))
    dtype = Param("dtype", "device compute dtype: 'float32', 'float64', or "
                  "'auto' (float32)", "auto",
                  validator=lambda v: v in ("auto", "float32", "float64"))

    def param_map_for_metadata(self):
        """Omit the unset sentinels ('' link, None linkPower) — a real
        Spark DefaultParamsReader rejects both (no '' link name; JSON
        null fails DoubleParam decoding). Unset means canonical/Spark
        default on both sides, so dropping them is lossless."""
        out = super().param_map_for_metadata()
        if not out.get("link"):
            out.pop("link", None)
        if out.get("linkPower") is None:
            out.pop("linkPower", None)
        return out

    def _resolved_family_link(self):
        """(family, link, var_power, link_power) with canonical defaults
        and the Spark family/link grid enforced."""
        family = self.get_or_default("family")
        var_power = float(self.get_or_default("variancePower"))
        if family == "tweedie":
            lp = self.get_or_default("linkPower")
            link_power = 1.0 - var_power if lp is None else float(lp)
            return family, "power", var_power, link_power
        link = self.get_or_default("link") or CANONICAL_LINK[family]
        if link not in FAMILY_LINKS[family]:
            raise ValueError(
                f"link {link!r} is not supported for family {family!r} "
                f"(choose from {FAMILY_LINKS[family]})"
            )
        return family, link, var_power, 1.0


def _host_step(out: GlmStepOut) -> GlmStepOut:
    """A device pass's statistics as float64 numpy (the copies
    synchronise: the pass has run)."""
    return GlmStepOut(*(np.asarray(v.cpu().numpy(), dtype=np.float64)
                        for v in out))


class GeneralizedLinearRegression(GeneralizedLinearRegressionParams):
    """``GeneralizedLinearRegression(family='poisson').fit(df)``; df
    carries features + label columns (or pass ``labels=`` explicitly)."""

    def __init__(self, uid: Optional[str] = None, **params):
        # pyspark-style keyword constructor: GLR(family="poisson", ...)
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "GeneralizedLinearRegression":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(GeneralizedLinearRegression, path)

    @observed_fit("glm")
    def fit(self, dataset, labels=None) -> "GeneralizedLinearRegressionModel":
        from spark_rapids_ml_tpu_torch.models.logistic_regression import (
            _xy_source,
        )

        timer = PhaseTimer()
        family, link, var_power, link_power = self._resolved_family_link()
        source = _xy_source(dataset, labels)
        if source is not None:
            self._reject_streamed_weights()
            if self.get_or_default("offsetCol"):
                raise ValueError(
                    "offsetCol is not supported with streamed/out-of-core "
                    "input; fit in-memory or drop the offset"
                )
            if not source.reiterable:
                raise ValueError(
                    "GeneralizedLinearRegression needs one pass per IRLS "
                    "iteration: pass a zero-arg callable that yields fresh "
                    "(X_chunk, y_chunk) batches, not a one-shot "
                    "iterator/generator"
                )
            return self._finish(
                *self._fit_batched_passes(source, timer, family, link,
                                          var_power, link_power),
                timer,
            )
        frame = as_vector_frame(dataset, self.getInputCol())
        with timer.phase("densify"):
            x = frame.vectors_as_matrix(self.getInputCol()).astype(
                np.float64, copy=False)
            if labels is not None:
                y = np.asarray(labels, dtype=np.float64).reshape(-1)
            else:
                y = np.asarray(frame.column(self.getLabelCol()),
                               dtype=np.float64)
        if y.shape[0] != x.shape[0]:
            raise ValueError(
                f"labels length {y.shape[0]} != rows {x.shape[0]}")
        if x.shape[0] == 0:
            raise ValueError("empty dataset")
        validate_label_range(y, family=family, var_power=var_power)
        w = self._extract_weights(frame, x.shape[0])
        if w is None:
            w = np.ones(x.shape[0])
        offset_col = self.get_or_default("offsetCol")
        offset = (
            np.asarray(frame.column(offset_col), dtype=np.float64).reshape(-1)
            if offset_col else np.zeros(x.shape[0])
        )
        if self.getUseXlaDot():
            step = self._make_device_stepper(x, y, w, offset, family, link,
                                             var_power, link_power)
        else:
            def step(coef, intercept, first=False):
                return irls_step_math(
                    np, x, y, w, offset, coef, intercept, family=family,
                    link=link, var_power=var_power, link_power=link_power,
                    use_init_mu=first)

        coef, intercept, n_iter, dev = self._irls(step, x.shape[1], timer)
        return self._finish(coef, intercept, n_iter, dev, float(w.sum()),
                            timer)

    def _make_device_stepper(self, x, y, w, offset, family, link, var_power,
                             link_power):
        """The rows, labels, weights and offset placed on the device once;
        each call is one IRLS pass over them."""
        device = resolve_device(self.getDeviceId())
        dtype = _resolve_dtype(self.getDtype())
        x_dev, y_dev, w_dev, o_dev = (
            torch.as_tensor(a, dtype=dtype, device=device)
            for a in (x, y, w, offset))

        def step(coef, intercept, first=False):
            return _host_step(glm_irls_device_step(
                x_dev, y_dev, w_dev, o_dev,
                torch.as_tensor(coef, dtype=dtype, device=device),
                torch.tensor(float(intercept), dtype=dtype, device=device),
                family=family, link=link, var_power=var_power,
                link_power=link_power, use_init_mu=first))

        return step

    def _fit_batched_passes(self, source, timer, family, link, var_power,
                            link_power):
        """Out-of-core IRLS: one full pass over the re-iterable source per
        iteration (bounded memory: one bucket + one (d × d) Gram). On the
        device each bucket's statistics are summed in float64 there and
        copied to the host once a pass."""
        n = source.n_features - 1  # [X | y] packing
        use_device = self.getUseXlaDot()
        if use_device:
            device = resolve_device(self.getDeviceId())
            dtype = _resolve_dtype(self.getDtype())

        def step(coef, intercept, first=False):
            totals = None
            if use_device:
                coef_dev = torch.as_tensor(coef, dtype=dtype, device=device)
                b_dev = torch.tensor(float(intercept), dtype=dtype,
                                     device=device)
            for batch, mask in source.batches():
                b = batch if mask is None else batch[mask]
                if use_device:
                    z = torch.as_tensor(b, dtype=dtype, device=device)
                    ones = torch.ones(z.shape[0], dtype=dtype, device=device)
                    out = glm_irls_device_step(
                        z[:, :n], z[:, n], ones, torch.zeros_like(ones),
                        coef_dev, b_dev, family=family, link=link,
                        var_power=var_power, link_power=link_power,
                        use_init_mu=first)
                    out = GlmStepOut(*(v.double() for v in out))
                else:
                    b = np.asarray(b, dtype=np.float64)
                    xb, yb = b[:, :n], b[:, n]
                    out = irls_step_math(
                        np, xb, yb, np.ones(xb.shape[0]),
                        np.zeros(xb.shape[0]), coef, intercept,
                        family=family, link=link, var_power=var_power,
                        link_power=link_power, use_init_mu=first)
                totals = out if totals is None else GlmStepOut(
                    *(a + b2 for a, b2 in zip(totals, out)))
            if totals is None:
                raise ValueError("empty dataset")
            return _host_step(totals) if use_device else totals

        # one cheap pass for label validation + weight total
        w_sum = 0.0
        for batch, mask in source.batches():
            b = np.asarray(batch if mask is None else batch[mask])
            validate_label_range(np.asarray(b[:, n], dtype=np.float64),
                                 family=family, var_power=var_power)
            w_sum += b.shape[0]
        coef, intercept, n_iter, dev = self._irls(step, n, timer)
        return coef, intercept, n_iter, dev, w_sum

    def _irls(self, step, n_features, timer):
        """Host-driven IRLS loop: device (or NumPy) pass -> small f64
        weighted normal-equations solve -> deviance check. The first
        pass runs from the family's elementwise starting mean (R's
        mustart) rather than the zero coefficients — see
        ``irls_step_math(use_init_mu=True)``."""
        lam = float(self.getRegParam())
        fit_b = self.getFitIntercept()
        max_iter = int(self.getMaxIter())
        tol = float(self.getTol())
        coef = np.zeros(n_features)
        intercept = 0.0
        dev_prev = np.inf
        dev = np.inf
        n_iter = 0
        with timer.phase("fit_kernel"), TraceRange("glm irls",
                                                   TraceColor.GREEN):
            for it in range(max_iter):
                out = step(coef, intercept, first=(it == 0))
                a, b, mu_x, mu_z = _centered_moments(
                    out.xtx, out.xtz, out.x_sum, out.z_sum, out.w_sum, fit_b)
                a = a + lam * np.eye(n_features)
                coef_new = np.linalg.solve(a, b)
                intercept_new = (
                    float(mu_z - mu_x @ coef_new) if fit_b else 0.0)
                dev = float(out.deviance)
                n_iter = it + 1
                coef, intercept = coef_new, intercept_new
                if abs(dev - dev_prev) / (abs(dev_prev) + 0.1) < tol:
                    break
                dev_prev = dev
            else:
                if max_iter > 0:
                    # deviance at the final coefficients (loop above
                    # reports the PRE-update deviance of the last step)
                    out = step(coef, intercept)
                    dev = float(out.deviance)
        return coef, intercept, n_iter, dev

    def _finish(self, coef, intercept, n_iter, dev, w_sum, timer):
        model = GeneralizedLinearRegressionModel(
            coefficients=np.asarray(coef, dtype=np.float64),
            intercept=float(intercept),
        )
        model.uid = self.uid
        model.copy_values_from(self)
        model.num_iterations_ = int(n_iter)
        model.deviance_ = float(dev)
        model.weight_sum_ = float(w_sum)
        model.fit_timings_ = timer.as_dict()
        return model


class GeneralizedLinearRegressionModel(GeneralizedLinearRegressionParams):
    """μ = g⁻¹(x·w + b + offset) in ``predictionCol``, on the host in
    float64 (the JAX package's model predicts on the host too)."""

    def __init__(self, coefficients: Optional[np.ndarray] = None,
                 intercept: float = 0.0, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.coefficients = coefficients
        self.intercept = intercept
        self.num_iterations_ = 0
        self.deviance_ = float("nan")
        self.weight_sum_ = 0.0
        self.fit_timings_ = {}

    def _copy_internal_state(self, other) -> None:
        other.coefficients = self.coefficients
        other.intercept = self.intercept
        other.num_iterations_ = self.num_iterations_
        other.deviance_ = self.deviance_
        other.weight_sum_ = self.weight_sum_

    def _eta_mu(self, frame):
        family, link, var_power, link_power = self._resolved_family_link()
        x = frame.vectors_as_matrix(self.getInputCol()).astype(
            np.float64, copy=False)
        eta = x @ self.coefficients + self.intercept
        offset_col = self.get_or_default("offsetCol")
        if offset_col:
            if offset_col not in frame.columns:
                raise ValueError(
                    f"offsetCol {offset_col!r} is set on the model but "
                    "missing from the input; predictions without the "
                    "offset would be silently wrong"
                )
            eta = eta + np.asarray(frame.column(offset_col),
                                   dtype=np.float64).reshape(-1)
        _, ginv, _ = link_funcs(link, link_power)
        return eta, np.asarray(ginv(np, eta), dtype=np.float64)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        if self.coefficients is None:
            raise ValueError("model has no coefficients; fit first or load")
        frame = as_vector_frame(dataset, self.getInputCol())
        eta, mu = self._eta_mu(frame)
        out = frame.with_column(self.getPredictionCol(), mu)
        link_col = self.get_or_default("linkPredictionCol")
        if link_col:
            out = out.with_column(link_col, eta)
        return out

    def evaluate(self, dataset, labels=None) -> dict:
        """Summary core of Spark's GeneralizedLinearRegressionSummary:
        deviance, null deviance (intercept-only, weighted-mean fitted
        value), Pearson chi2, dispersion (1 for binomial/poisson, Pearson
        chi2 / dof otherwise), degrees of freedom."""
        family, link, var_power, link_power = self._resolved_family_link()
        frame = as_vector_frame(dataset, self.getInputCol())
        if labels is not None:
            y = np.asarray(labels, dtype=np.float64).reshape(-1)
        else:
            y = np.asarray(frame.column(self.getLabelCol()), dtype=np.float64)
        w = self._extract_weights(frame, y.shape[0])
        if w is None:
            w = np.ones(y.shape[0])
        _, mu = self._eta_mu(frame)
        variance, _, clip_mu, _ = family_funcs(family, var_power)
        mu = clip_mu(np, mu)
        dev = float(deviance_math(np, y, mu, w, family=family,
                                  var_power=var_power))
        mu_null = clip_mu(np, np.full_like(y, np.average(y, weights=w)))
        null_dev = float(deviance_math(np, y, mu_null, w, family=family,
                                       var_power=var_power))
        pearson = float(np.sum(w * (y - mu) ** 2 / variance(np, mu)))
        rank = self.coefficients.shape[0] + (
            1 if self.getFitIntercept() else 0)
        dof = max(y.shape[0] - rank, 1)
        dispersion = (1.0 if family in ("binomial", "poisson")
                      else pearson / dof)
        return {
            "deviance": dev,
            "nullDeviance": null_dev,
            "pearsonChi2": pearson,
            "dispersion": dispersion,
            "residualDegreeOfFreedom": dof,
            "numIterations": self.num_iterations_,
        }

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_glm_model

        save_glm_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "GeneralizedLinearRegressionModel":
        from spark_rapids_ml_tpu_torch.io.persistence import load_glm_model

        return load_glm_model(path)
