"""NaiveBayes Estimator / Model (multinomial/complement/bernoulli/gaussian),
on PyTorch.

Counterpart of the JAX package's ``models/naive_bayes.py``, with the same
params, so saved metadata stays compatible. Spark
``org.apache.spark.ml.classification.NaiveBayes`` surface: ``modelType``
(multinomial default, complement — Spark 3.0's Rennie et al. variant,
bernoulli, gaussian) and ``smoothing`` (Laplace/Lidstone λ, default 1.0).
The entire fit is per-class sufficient statistics — one one-hot product
per statistic (``y_ohᵀ @ X`` for counts/sums, ``y_ohᵀ @ X²`` for
variances) — then the per-family closed forms of
``spark/aggregate.py::finalize_nb_from_stats``, the one copy the local
fit, ``parallel.distributed_nb_fit`` and the Spark statistics plane share.

Fit routes:

* ``useXlaDot=True`` (default): the class statistics on the resolved
  device (the card, or the CPU when it was requested), in the fit's
  ``dtype`` ('auto' is float32 here). The JAX package multiplies at
  ``Precision.HIGHEST``; on the card a float32 ``torch.matmul`` may run
  in TF32 under a process-wide setting, so a float32 product is taken in
  float64 and rounded once to float32 (``ops/pca_kernel.py::_project``'s
  rule): full f32 whatever the setting;
* ``useXlaDot=False``: host numpy float64, never a device.

Conventions match Spark/sklearn: multinomial requires non-negative
features; bernoulli binarizes at 0 and requires features in {0,1} like
Spark (which raises otherwise); gaussian uses per-class variance with a
tiny epsilon floor. The model's likelihood and transform are host numpy,
as in the JAX package.
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
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

MODEL_TYPES = ("multinomial", "complement", "bernoulli", "gaussian")


class NaiveBayesParams(HasInputCol, HasDeviceId, HasThresholds,
                       HasWeightCol):
    labelCol = Param("labelCol", "label column name", "label")
    predictionCol = Param(
        "predictionCol", "predicted class output column", "prediction"
    )
    probabilityCol = Param(
        "probabilityCol", "per-class probability output column", "probability"
    )
    modelType = Param(
        "modelType",
        "multinomial | complement | bernoulli | gaussian",
        "multinomial",
        validator=lambda v: v in MODEL_TYPES,
    )
    smoothing = Param(
        "smoothing", "Laplace smoothing lambda", 1.0,
        validator=lambda v: float(v) >= 0,
    )
    useXlaDot = Param(
        "useXlaDot",
        "statistics on the device (True) or host NumPy (False)",
        True,
        validator=lambda v: isinstance(v, bool),
    )
    dtype = Param("dtype", "device compute dtype", "auto",
                  validator=lambda v: v in ("auto", "float32", "float64"))


def class_products(x: torch.Tensor, y_oh: torch.Tensor, need_sq: bool):
    """(counts[K], y_ohᵀ·X [K,d], y_ohᵀ·X² [K,d] or None) of tensors on
    one device, in their dtype. A float32 product is taken in float64 and
    rounded once (no TF32 setting reaches it); X² is squared in the input
    dtype first, as the JAX package squares before its product."""
    def dot_t(a, b):
        if a.dtype == torch.float32:
            return (a.double().T @ b.double()).float()
        return a.T @ b

    sums = dot_t(y_oh, x)
    sq = dot_t(y_oh, x * x) if need_sq else None
    return y_oh.sum(dim=0), sums, sq


def _class_stats(x, y_oh, use_device, device, dtype, need_sq):
    """(counts[K], sums[K,d], sq_sums[K,d] or None) as float64 numpy: on
    the device in ``dtype``, or host numpy float64."""
    if use_device:
        # cast on the host, as the JAX package's ``jnp.asarray(x, dtype)``
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        x_dev = torch.as_tensor(np.asarray(x, dtype=np_dtype), device=device)
        oh_dev = torch.as_tensor(np.asarray(y_oh, dtype=np_dtype),
                                 device=device)
        counts, sums, sq = class_products(x_dev, oh_dev, need_sq)
        return (
            counts.cpu().numpy().astype(np.float64),
            sums.cpu().numpy().astype(np.float64),
            sq.cpu().numpy().astype(np.float64) if need_sq else None,
        )
    counts = y_oh.sum(axis=0)
    sums = y_oh.T @ x
    sq = y_oh.T @ (x * x) if need_sq else None
    return counts, sums, sq


def _prepare_nb_inputs(x, y, weights, model_type):
    """Validated (classes, weighted one-hot) — the ONE statistics-input
    prep the local fit and ``parallel.distributed_nb_fit`` share.
    ``weights=None`` means unweighted."""
    x = np.asarray(x)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    if model_type not in MODEL_TYPES:
        raise ValueError(
            f"modelType {model_type!r}: expected multinomial | "
            "complement | bernoulli | gaussian")
    if y.shape[0] != x.shape[0]:
        raise ValueError(
            f"labels length {y.shape[0]} != rows {x.shape[0]}"
        )
    if model_type in ("multinomial", "complement") and (x < 0).any():
        raise ValueError(
            f"{model_type} NaiveBayes requires non-negative features"
        )
    if model_type == "bernoulli" and not np.isin(x, (0.0, 1.0)).all():
        raise ValueError(
            "bernoulli NaiveBayes requires {0,1} features (Spark raises "
            "on anything else)"
        )
    classes = np.unique(y)
    y_oh = np.eye(classes.size)[np.searchsorted(classes, y)]
    if weights is not None:
        w = np.asarray(weights, dtype=np.float64).reshape(-1)
        if w.shape[0] != y.shape[0]:
            raise ValueError(
                f"weight column length {w.shape[0]} != rows {y.shape[0]}"
            )
        if not np.isfinite(w).all() or (w < 0).any():
            raise ValueError(
                "weights must be finite and non-negative"
            )
        # Spark weightCol: every per-class statistic becomes a WEIGHTED
        # sum — one multiply into the one-hot before the products
        y_oh = y_oh * w[:, None]
    return classes, y_oh


class NaiveBayes(NaiveBayesParams):
    """``NaiveBayes().setModelType('gaussian').fit(df)``."""

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "NaiveBayes":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(NaiveBayes, path)

    @observed_fit("naive_bayes")
    def fit(self, dataset, labels=None) -> "NaiveBayesModel":
        timer = PhaseTimer()
        frame = as_vector_frame(dataset, self.getInputCol())
        with timer.phase("densify"):
            x = frame.vectors_as_matrix(self.getInputCol())
            if labels is not None:
                y = np.asarray(labels, dtype=np.float64).reshape(-1)
            else:
                y = np.asarray(
                    frame.column(self.getLabelCol()), dtype=np.float64
                )
        kind = self.getModelType()
        user_w = self._extract_weights(frame, x.shape[0])
        classes, y_oh = _prepare_nb_inputs(x, y, user_w, kind)
        lam = float(self.getSmoothing())

        device = (
            resolve_device(self.getDeviceId()) if self.getUseXlaDot() else None
        )
        dtype = _resolve_dtype(self.getDtype())
        with timer.phase("fit"), TraceRange("naive bayes", TraceColor.GREEN):
            counts, sums, sq = _class_stats(
                x, y_oh, self.getUseXlaDot(), device, dtype,
                need_sq=(kind == "gaussian"),
            )
            # the per-family closed forms live ONCE, shared with the Spark
            # statistics plane — the two fits cannot drift
            from spark_rapids_ml_tpu_torch.spark.aggregate import (
                finalize_nb_from_stats,
            )

            if kind != "gaussian":
                sq = np.zeros_like(sums)
            pi, theta, sigma = finalize_nb_from_stats(
                classes, counts, sums, sq, kind, lam
            )
        model = NaiveBayesModel(
            pi=pi, theta=theta, sigma=sigma, classes=classes
        )
        model.uid = self.uid
        model.copy_values_from(self)
        model.fit_timings_ = timer.as_dict()
        return model


class NaiveBayesModel(NaiveBayesParams):
    def __init__(
        self,
        pi: Optional[np.ndarray] = None,
        theta: Optional[np.ndarray] = None,
        sigma: Optional[np.ndarray] = None,
        classes: Optional[np.ndarray] = None,
    ):
        super().__init__()
        self.pi = pi          # (K,) log priors
        self.theta = theta    # (K,d): log probs, or means for gaussian
        self.sigma = sigma    # (K,d) variances (gaussian only)
        self.classes_ = classes

    def _copy_internal_state(self, other: "NaiveBayesModel") -> None:
        other.pi = self.pi
        other.theta = self.theta
        other.sigma = self.sigma
        other.classes_ = self.classes_

    def _joint_log_likelihood(self, x) -> np.ndarray:
        kind = self.getModelType()
        if kind == "multinomial":
            return self.pi[None, :] + x @ self.theta.T
        if kind == "complement":
            # complement NB ignores the prior for multi-class data
            # (Rennie et al.; sklearn adds it only for a single class)
            jll = x @ self.theta.T
            if self.pi.shape[0] == 1:
                jll = jll + self.pi[None, :]
            return jll
        if kind == "bernoulli":
            xb = (x > 0).astype(np.float64)
            log_p = self.theta
            log_1mp = np.log1p(-np.exp(self.theta))
            return (
                self.pi[None, :]
                + xb @ log_p.T
                + (1.0 - xb) @ log_1mp.T
            )
        # gaussian
        mean, var = self.theta, self.sigma
        ll = -0.5 * (
            np.log(2.0 * np.pi * var)[None, :, :]
            + (x[:, None, :] - mean[None, :, :]) ** 2 / var[None, :, :]
        ).sum(axis=2)
        return self.pi[None, :] + ll

    @observed_transform
    def predict_proba(self, dataset) -> np.ndarray:
        if self.theta is None:
            raise ValueError("model is unfitted")
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        jll = self._joint_log_likelihood(x)
        jll = jll - jll.max(axis=1, keepdims=True)
        e = np.exp(jll)
        return e / e.sum(axis=1, keepdims=True)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, self.getInputCol())
        proba = self.predict_proba(frame)
        pred = self.classes_[self._predict_index(proba)]
        out = frame.with_column(self.getProbabilityCol(), proba.tolist())
        return out.with_column(
            self.getPredictionCol(), pred.astype(np.float64).tolist()
        )

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_nb_model

        save_nb_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "NaiveBayesModel":
        from spark_rapids_ml_tpu_torch.io.persistence import load_nb_model

        return load_nb_model(path)
