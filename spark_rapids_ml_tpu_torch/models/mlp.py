"""MultilayerPerceptronClassifier Estimator / Model, on PyTorch.

Counterpart of the JAX package's ``models/mlp.py``, with the same params,
defaults, validators and errors, so saved metadata stays compatible.
Spark ``org.apache.spark.ml.classification.MultilayerPerceptron
Classifier`` param surface: layers (required, e.g. [in, h1, out]),
maxIter, tol, seed, solver ('l-bfgs' default | 'gd'), stepSize,
featuresCol(=inputCol), labelCol, predictionCol, probabilityCol,
rawPredictionCol, weightCol. blockSize is accepted for surface parity
and ignored — it tunes Spark's row-stacking BLAS batching, which is
moot when the whole batch lives on the device.

The fit runs on the resolved device (the card, or the CPU when it was
requested): sigmoid hidden layers + softmax cross-entropy, L-BFGS with
optax's zoom line search or plain GD (``ops/mlp_kernel.py`` over
``ops/optim.py``'s host-driven loop). Labels are class indices
0..numClasses-1 like Spark. ``dtype='auto'`` is float32 here, where the
JAX package's tests run float64 (x64 on). The fitted model persists
Spark's layout: (layers, flat weight vector); its logits are computed on
the resolved device in the model's dtype, the softmax on the host in
float64, as in the JAX package. ``predict_proba`` takes a frame as well
as a matrix, as the port's other classifiers do, so OneVsRest can score
through it (ROADMAP queue 3 item 22 (dd)).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

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
from spark_rapids_ml_tpu_torch.ops.mlp_kernel import (
    SigmoidMLP,
    flatten_weights,
    init_weights,
    mlp_params_from_jax,
    mlp_params_to_numpy,
    mlp_train_kernel,
    unflatten_weights,
    validate_and_onehot,
)
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange


def _valid_layers(v) -> bool:
    return (isinstance(v, (list, tuple)) and len(v) >= 2
            and all(isinstance(i, int) and i >= 1 for i in v))


class MultilayerPerceptronParams(HasInputCol, HasDeviceId, HasWeightCol):
    layers = Param("layers",
                   "layer sizes input..output, e.g. [4, 8, 3]", None,
                   validator=lambda v: v is None or _valid_layers(v))
    labelCol = Param("labelCol",
                     "class-index label column (0..numClasses-1)", "label")
    predictionCol = Param("predictionCol", "predicted class column",
                          "prediction")
    probabilityCol = Param("probabilityCol",
                           "softmax class-probability vector column",
                           "probability")
    rawPredictionCol = Param("rawPredictionCol",
                             "pre-softmax logits vector column",
                             "rawPrediction")
    maxIter = Param("maxIter", "maximum optimizer iterations", 100,
                    validator=lambda v: isinstance(v, int) and v >= 0)
    tol = Param("tol", "loss-change convergence tolerance", 1e-6,
                validator=lambda v: v >= 0)
    seed = Param("seed", "weight-init seed", 0,
                 validator=lambda v: isinstance(v, int))
    solver = Param("solver", "optimizer: 'l-bfgs' (default) or 'gd'",
                   "l-bfgs", validator=lambda v: v in ("l-bfgs", "gd"))
    stepSize = Param("stepSize", "gd learning rate", 0.03,
                     validator=lambda v: v > 0)
    blockSize = Param(
        "blockSize",
        "accepted for Spark surface parity; ignored (BLAS row-stacking "
        "is moot on an accelerator holding the whole batch)",
        128, validator=lambda v: isinstance(v, int) and v >= 1)
    dtype = Param("dtype", "device compute dtype", "auto",
                  validator=lambda v: v in ("auto", "float32", "float64"))


class MultilayerPerceptronClassifier(MultilayerPerceptronParams):
    """``MultilayerPerceptronClassifier(layers=[4, 8, 3]).fit(df)``."""

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "MultilayerPerceptronClassifier":
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(MultilayerPerceptronClassifier, path)

    @observed_fit("multilayer_perceptron")
    def fit(self, dataset, labels=None) -> "MultilayerPerceptronModel":
        timer = PhaseTimer()
        layers = self.get_or_default("layers")
        if layers is None:
            raise ValueError("layers must be set, e.g. layers=[4, 8, 3]")
        layers = [int(v) for v in layers]
        frame = as_vector_frame(dataset, self.getInputCol())
        with timer.phase("densify"):
            x = frame.vectors_as_matrix(self.getInputCol()).astype(
                np.float64, copy=False)
            if labels is not None:
                y = np.asarray(labels, dtype=np.float64).reshape(-1)
            else:
                y = np.asarray(frame.column(self.getLabelCol()),
                               dtype=np.float64)
        y_onehot = validate_and_onehot(x, y, layers)
        w = self._extract_weights(frame, x.shape[0])
        if w is None:
            w = np.ones(x.shape[0])

        device = resolve_device(self.getDeviceId())
        dtype = _resolve_dtype(self.getDtype())
        net = mlp_params_from_jax(init_weights(layers, int(self.getSeed())),
                                  device=device, dtype=dtype)
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        with timer.phase("h2d"):
            x_dev = torch.as_tensor(np.asarray(x, dtype=np_dtype),
                                    device=device)
            y_dev = torch.as_tensor(np.asarray(y_onehot, dtype=np_dtype),
                                    device=device)
            w_dev = torch.as_tensor(np.asarray(w, dtype=np_dtype),
                                    device=device)
        with timer.phase("fit_kernel"), TraceRange("mlp train",
                                                   TraceColor.GREEN):
            weights, n_iter, loss = mlp_train_kernel(
                list(net.weights), x_dev, y_dev, w_dev,
                solver=self.get_or_default("solver"),
                max_iter=int(self.getMaxIter()),
                tol=float(self.getTol()),
                step_size=float(self.getStepSize()),
            )
        model = MultilayerPerceptronModel(
            layers=layers,
            weights=mlp_params_to_numpy(SigmoidMLP(weights)),
        )
        model.uid = self.uid
        model.copy_values_from(self)
        model.num_iterations_ = int(n_iter)
        model.final_loss_ = float(loss)
        model.fit_timings_ = timer.as_dict()
        return model


class MultilayerPerceptronModel(MultilayerPerceptronParams):
    def __init__(self, layers: Optional[List[int]] = None,
                 weights: Optional[List[dict]] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.layers_ = layers
        self.weights_ = weights
        self.num_iterations_ = 0
        self.final_loss_ = float("nan")
        self.fit_timings_ = {}

    @property
    def classes_(self) -> np.ndarray:
        return np.arange(self.layers_[-1], dtype=np.float64)

    @property
    def flat_weights(self) -> np.ndarray:
        """Spark's MLPModel weight layout (per layer: W row-major, b)."""
        return flatten_weights(self.weights_)

    def _copy_internal_state(self, other) -> None:
        other.layers_ = self.layers_
        other.weights_ = self.weights_
        other.num_iterations_ = self.num_iterations_
        other.final_loss_ = self.final_loss_

    def _forward(self, x: np.ndarray) -> np.ndarray:
        """The logits on the resolved device in the model's dtype, as
        float64 numpy."""
        if self.weights_ is None:
            raise ValueError("model has no weights; fit first or load")
        device = resolve_device(self.getDeviceId())
        dtype = _resolve_dtype(self.getDtype())
        net = mlp_params_from_jax(self.weights_, device=device,
                                  dtype=dtype)
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        with torch.no_grad():
            logits = net(torch.as_tensor(np.asarray(x, dtype=np_dtype),
                                         device=device))
        return logits.cpu().numpy().astype(np.float64)

    @observed_transform
    def predict_proba(self, dataset) -> np.ndarray:
        """(n, numClasses) softmax rows of a matrix or a frame's
        ``inputCol`` (the JAX model's takes a matrix only)."""
        frame = as_vector_frame(dataset, self.getInputCol())
        logits = self._forward(frame.vectors_as_matrix(self.getInputCol()))
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        logits = self._forward(x)
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        proba = e / e.sum(axis=1, keepdims=True)
        out = frame
        raw_col = self.get_or_default("rawPredictionCol")
        if raw_col:
            out = out.with_column(raw_col, list(logits))
        proba_col = self.get_or_default("probabilityCol")
        if proba_col:
            out = out.with_column(proba_col, list(proba))
        pred_col = self.get_or_default("predictionCol")
        if pred_col:
            out = out.with_column(
                pred_col, np.argmax(logits, axis=1).astype(np.float64))
        return out

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_mlp_model

        save_mlp_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "MultilayerPerceptronModel":
        from spark_rapids_ml_tpu_torch.io.persistence import load_mlp_model

        return load_mlp_model(path)


def weights_from_flat(flat: np.ndarray, layers: List[int]) -> List[dict]:
    """Rebuild the per-layer pytree from Spark's flat vector."""
    return unflatten_weights(np.asarray(flat, dtype=np.float64), layers)
