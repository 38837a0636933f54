"""OneVsRest — multiclass reduction over any binary classifier.

Counterpart of the JAX package's ``models/ovr.py``, with the same params
and behaviour. Parity with ``org.apache.spark.ml.classification.
OneVsRest``: K binary sub-models (class k vs rest), prediction by argmax
of the sub-models' scores, mapped back to the class labels (any integer
labels, e.g. 1..7). Spark fits the K sub-models as independent jobs;
here they are independent device fits in sequence: over the port's
LogisticRegression or LinearSVC, each float32 sub-fit launches the hand
Gram kernel once per Newton iteration (``ops/logreg_kernel.py``,
``ops/svm_kernel.py``).

Works with any estimator exposing the binary-classifier surface this
framework uses (``fit(frame)`` reading labelCol, model ``predict_proba``
or a probability output column): LogisticRegression, LinearSVC (its
``predict_proba`` is the margin) and MultilayerPerceptronClassifier.
``copy(extra)`` routes the params OneVsRest does not declare to the
sub-classifier, so a ``CrossValidator`` grid over e.g. regParam tunes it.

One difference from the JAX package, by design: a sub-model whose
``predict_proba`` returns one probability per class (the MLP's (n, 2)
softmax) scores by its last column, P(class k). In the JAX package a
OneVsRest over its MLP cannot transform: the MLP's ``predict_proba``
takes no frame, and the (n, 2) rows would stack as they are (ROADMAP
queue 3 item 22 (dd)).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.models.params import HasInputCol, Param
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import observed_transform


class OneVsRestParams(HasInputCol):
    labelCol = Param("labelCol", "label column name", "label")
    predictionCol = Param(
        "predictionCol", "predicted class-index output column", "prediction"
    )
    rawPredictionCol = Param(
        "rawPredictionCol",
        "per-class score vector output column",
        "rawPrediction",
    )


class OneVsRest(OneVsRestParams):
    """``OneVsRest(classifier=LogisticRegression()).fit(df)``."""

    def __init__(self, classifier=None, uid: Optional[str] = None, **kwargs):
        super().__init__(uid=uid)
        self.classifier = classifier
        for name, value in kwargs.items():
            self.set(name, value)

    def _copy_internal_state(self, other: "OneVsRest") -> None:
        # without this, Params.copy() (used by CrossValidator/_fit_with and
        # Pipeline stage copies) would reconstruct with classifier=None
        other.classifier = (
            self.classifier.copy()
            if hasattr(self.classifier, "copy")
            else self.classifier
        )

    def copy(self, extra=None) -> "OneVsRest":
        """``extra`` params not declared by OneVsRest itself route to the
        sub-classifier — the name-keyed analogue of tuning Spark's OvR
        with classifier-bound Params (e.g. a regParam grid)."""
        extra = dict(extra or {})
        own = {k: v for k, v in extra.items() if self.has_param(k)}
        sub = {k: v for k, v in extra.items() if not self.has_param(k)}
        out = super().copy(extra=own)
        if sub:
            if out.classifier is None:
                raise ValueError(
                    f"params {sorted(sub)} need a classifier to apply to"
                )
            out.classifier = out.classifier.copy(extra=sub)
        return out

    @observed_fit("one_vs_rest")
    def fit(self, dataset) -> "OneVsRestModel":
        if self.classifier is None:
            raise ValueError("classifier must be set")
        frame = as_vector_frame(dataset, self.getInputCol())
        y = np.asarray(frame.column(self.getLabelCol()), dtype=np.float64)
        classes = np.unique(y)
        if classes.size < 2:
            raise ValueError("OneVsRest needs at least two classes")
        if not np.allclose(classes, np.round(classes)):
            raise ValueError("labels must be integer class indices")
        models: List = []
        for cls in classes:
            sub = self.classifier.copy()
            if sub.has_param("inputCol"):
                sub.set("inputCol", self.getInputCol())
            binary = frame.with_column(
                sub.getLabelCol(), (y == cls).astype(np.float64)
            )
            models.append(sub.fit(binary))
        out = OneVsRestModel(
            models=models, classes=classes.astype(np.int64)
        )
        out.uid = self.uid
        out.copy_values_from(self)
        return out


class OneVsRestModel(OneVsRestParams):
    def __init__(
        self,
        models: Optional[List] = None,
        classes: Optional[np.ndarray] = None,
        uid: Optional[str] = None,
    ):
        super().__init__(uid=uid)
        self.models = models or []
        self.classes = classes

    def _copy_internal_state(self, other: "OneVsRestModel") -> None:
        other.models = list(self.models)
        other.classes = self.classes

    def _scores(self, frame) -> np.ndarray:
        cols = []
        for m in self.models:
            if hasattr(m, "predict_proba"):
                p = np.asarray(m.predict_proba(frame), dtype=np.float64)
            else:
                out = m.transform(frame)
                p = np.asarray(out.column(m.getProbabilityCol()),
                               dtype=np.float64)
            # a per-class probability row scores by P(this class)
            cols.append(p[:, -1] if p.ndim == 2 else p)
        return np.stack(cols, axis=1)  # (n, K)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        if not self.models:
            raise ValueError("no sub-models; fit first")
        frame = as_vector_frame(dataset, self.getInputCol())
        scores = self._scores(frame)
        pred = self.classes[np.argmax(scores, axis=1)]
        out = frame.with_column(
            self.getRawPredictionCol(), scores.tolist()
        )
        return out.with_column(
            self.getPredictionCol(), pred.astype(np.int64).tolist()
        )
