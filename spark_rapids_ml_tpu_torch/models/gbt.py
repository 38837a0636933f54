"""GBT Regressor / Classifier — gradient-boosted histogram trees, on
PyTorch.

Counterpart of the JAX package's ``models/gbt.py``, with the same params
(maxIter, stepSize, maxDepth, maxBins, minInstancesPerNode,
subsamplingRate, seed, validationIndicatorCol, validationTol — the Spark
surface). Boosting reuses the level-synchronous histogram grower
(``ops/forest_kernel.py``) unchanged: each round grows one regression tree
on the card to the loss gradient, so the whole fit is maxIter × maxDepth
dense level steps, and the round's residuals, Newton leaf refit and margin
update run on the host in float64 (``boosting_loop``, shared with the
distributed fit), as in the JAX package.

* Regression (squared loss): residual rᵐ = y − Fᵐ; the grower's leaf
  means ARE the optimal squared-loss leaf values.
* Binary classification (logistic loss): trees fit the gradient
  y − σ(F); leaf values are then REFIT with the one-step Newton formula
  Σr/Σσ(1−σ) per leaf (the standard GBM leaf) — structure from the
  gradient, values from the curvature.

Deterministic by seed (Poisson subsampling weights drawn as the JAX
package draws them, dense reductions). The streamed fit (a zero-arg
callable of (x, y) chunks) runs the Spark statistics plane's driver loop
(``spark/forest_estimator.py``): maxIter × (maxDepth + 1) passes over the
chunks, margins recomputed from the growing ensemble in every pass.
"""

from __future__ import annotations

import time

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
from spark_rapids_ml_tpu_torch.models.random_forest import (
    _apply_ensemble,
    _fit_labels,
)
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import observed_transform
from spark_rapids_ml_tpu_torch.ops import forest_kernel as _fk
from spark_rapids_ml_tpu_torch.utils.numeric import sigmoid as _sigmoid
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange


class GBTParams(HasInputCol, HasDeviceId, HasWeightCol):
    labelCol = Param("labelCol", "label column name", "label")
    predictionCol = Param(
        "predictionCol", "prediction output column", "prediction"
    )
    maxIter = Param(
        "maxIter", "number of boosting rounds (trees)", 20,
        validator=lambda v: isinstance(v, int) and v >= 1,
    )
    stepSize = Param(
        "stepSize", "learning rate in (0, 1]", 0.1,
        validator=lambda v: 0.0 < float(v) <= 1.0,
    )
    maxDepth = Param(
        "maxDepth", "tree depth", 5,
        validator=lambda v: isinstance(v, int) and 1 <= v <= 12,
    )
    maxBins = Param(
        "maxBins", "feature quantile bins", 32,
        validator=lambda v: isinstance(v, int) and 2 <= v <= 256,
    )
    minInstancesPerNode = Param(
        "minInstancesPerNode", "minimum samples per child", 1,
        validator=lambda v: isinstance(v, int) and v >= 1,
    )
    subsamplingRate = Param(
        "subsamplingRate",
        "per-round Poisson(rate) row weights (stochastic gradient boosting)",
        1.0,
        validator=lambda v: 0.0 < float(v) <= 1.0,
    )
    seed = Param("seed", "subsampling seed", 0,
                 validator=lambda v: isinstance(v, int))
    validationIndicatorCol = Param(
        "validationIndicatorCol",
        "boolean column marking VALIDATION rows ('' = no early stopping): "
        "trees train on the unmarked rows and boosting stops when the "
        "validation error stops improving by validationTol (Spark's "
        "runWithValidation rule); the fitted ensemble keeps the trees up "
        "to the best validation round",
        "", validator=lambda v: isinstance(v, str))
    validationTol = Param(
        "validationTol",
        "early-stopping threshold on the validation-error improvement",
        0.01, validator=lambda v: float(v) >= 0)
    dtype = Param("dtype", "device compute dtype", "auto",
                  validator=lambda v: v in ("auto", "float32", "float64"))
    executorDevice = Param(
        "executorDevice",
        "DataFrame statistics-plane placement of the per-partition "
        "histogram contraction: auto | on | off (the LOCAL fit always "
        "runs on the driver's device; this governs executors only)",
        "auto", validator=lambda v: v in ("auto", "on", "off"))
    maxMemoryInMB = Param(
        "maxMemoryInMB",
        "per-partition histogram payload budget for level-synchronous "
        "tree groups on the statistics plane (Spark's aggregation-memory "
        "knob; SPARK_RAPIDS_ML_TPU_TREE_GROUP_BYTES overrides)",
        256, validator=lambda v: isinstance(v, int) and v >= 1)


class _GBTBase(GBTParams):
    _classification = False

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @classmethod
    def load(cls, path: str):
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(cls, path)

    @observed_fit("gbt")
    def fit(self, dataset, labels=None):
        # out-of-core: a zero-arg callable yielding (x, y) chunks fits
        # through the statistics-plane driver loop (maxIter × (depth+1)
        # passes; margins recomputed per pass) — bounded memory
        if callable(dataset) and labels is None:
            self._reject_streamed_weights()
            from spark_rapids_ml_tpu_torch.spark.forest_estimator import (
                fit_gbt_streamed,
            )

            return fit_gbt_streamed(self, dataset, self._classification)
        if hasattr(dataset, "__next__"):
            raise ValueError(
                "tree fits need a RE-ITERABLE source (one pass per tree "
                "level): pass a zero-arg callable returning an iterable "
                "of (x, y) chunks, not a one-shot iterator"
            )

        timer = PhaseTimer()
        frame = as_vector_frame(dataset, self.getInputCol())
        with timer.phase("densify"):
            x = frame.vectors_as_matrix(self.getInputCol())
            y = _fit_labels(frame, self.getLabelCol(), labels, x.shape[0])
        # Spark 3.0 weightCol: user weights ride the mask slot of
        # boosting_loop (multiplied into the per-round Poisson draws)
        user_w = self._extract_weights(frame, x.shape[0])

        # validationIndicatorCol: hold marked rows out of training and
        # stop boosting when their error stops improving
        val_col = self.get_or_default("validationIndicatorCol")
        x_val = y_val = None
        if val_col:
            ind = np.asarray(frame.column(val_col)).astype(bool).reshape(-1)
            if ind.shape[0] != x.shape[0]:
                raise ValueError(
                    f"validation indicator length {ind.shape[0]} != rows "
                    f"{x.shape[0]}"
                )
            if ind.all() or not ind.any():
                raise ValueError(
                    "validationIndicatorCol must mark SOME rows as "
                    "validation and leave some for training"
                )
            x_val, y_val = x[ind], y[ind]
            x, y = x[~ind], y[~ind]
            w_val = None
            if user_w is not None:
                w_val = user_w[ind]  # Spark computes a WEIGHTED val error
                user_w = user_w[~ind]
        n, d = x.shape
        depth = self.getMaxDepth()
        n_bins = self.getMaxBins()
        lr = float(self.getStepSize())
        rng = np.random.default_rng(self.getSeed())
        device = resolve_device(self.getDeviceId())
        dtype = _resolve_dtype(self.getDtype())

        with timer.phase("binning"):
            binned_np, edges = _fk.quantile_bins(x, n_bins)
        binned = torch.as_tensor(binned_np, device=device)
        full_mask = torch.ones((depth, d), dtype=dtype, device=device)

        init = gbt_init_margin(y, self._classification, user_w)

        rate = float(self.getSubsamplingRate())

        # each round's grow call, (start, end) on the host clock; the
        # copies back to the host end it, so it spans the device work
        grow_spans = []

        def grow_fn(r, w):
            t0 = time.perf_counter()
            out = _fk.grow_tree_regression(
                binned,
                torch.as_tensor(r, dtype=dtype, device=device),
                torch.as_tensor(w, dtype=dtype, device=device),
                full_mask,
                depth,
                n_bins,
                self.getMinInstancesPerNode(),
                return_leaf_ids=True,
            )
            out = tuple(t.cpu().numpy() for t in out)
            grow_spans.append((t0, time.perf_counter()))
            return out

        val_hook = None
        if x_val is not None:
            binned_val = _fk.apply_bin_edges(x_val, edges)
            f_val = np.full(y_val.shape[0], float(init))
            classification = self._classification
            vw = w_val if w_val is not None else np.ones(y_val.shape[0])
            vw_sum = max(float(vw.sum()), 1e-300)

            def val_hook(ft, tt, leaf, _f=f_val):
                _f += lr * np.asarray(leaf)[
                    _fk.route_to_level_np(binned_val, np.asarray(ft),
                                          np.asarray(tt), depth)
                ]
                if classification:
                    p = _sigmoid(_f)
                    p = np.clip(p, 1e-12, 1 - 1e-12)
                    per_row = -(
                        y_val * np.log(p) + (1 - y_val) * np.log(1 - p)
                    )
                else:
                    per_row = (y_val - _f) ** 2
                return float((vw * per_row).sum() / vw_sum)

        t_boost = time.perf_counter()
        with timer.phase("boost"), TraceRange("gbt boost", TraceColor.RED):
            ensemble, gains = boosting_loop(
                y_padded=y,
                mask=user_w if user_w is not None else np.ones(n),
                n_real=n, init=init,
                val_hook=val_hook,
                validation_tol=float(self.get_or_default("validationTol")),
                max_iter=self.getMaxIter(), step_size=lr,
                classification=self._classification,
                subsampling_rate=rate, rng=rng, max_depth=depth,
                grow_fn=grow_fn,
            )
        t_end = time.perf_counter()
        model = self._model_cls()(
            ensemble=ensemble, edges=edges, init=init, step_size=lr
        )
        model.feature_importances_ = _fk.feature_importances(
            ensemble.feature, gains, d
        )
        model.uid = self.uid
        model.copy_values_from(self)
        model.fit_timings_ = timer.as_dict()
        # per round: its grow call, and the host time from that call's end
        # to the next one's start (refit, margin update, validation and
        # the next residuals; the first round also counts the time before
        # its grow call)
        starts = [start for start, _ in grow_spans] + [t_end]
        model.boost_rounds_ = [
            {"grow_s": end - start,
             "host_s": starts[m + 1] - end + (starts[0] - t_boost
                                               if m == 0 else 0.0)}
            for m, (start, end) in enumerate(grow_spans)
        ]
        return model

    def _model_cls(self):
        raise NotImplementedError


class _GBTModelBase(GBTParams):
    def __init__(self, ensemble=None, edges=None, init=0.0, step_size=0.1):
        super().__init__()
        self.ensemble_ = ensemble
        self.edges_ = edges
        self.init_ = init
        self.step_size_ = step_size
        self.feature_importances_ = None

    def _copy_internal_state(self, other) -> None:
        other.ensemble_ = self.ensemble_
        other.edges_ = self.edges_
        other.init_ = self.init_
        other.step_size_ = self.step_size_
        other.feature_importances_ = self.feature_importances_

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_gbt_model

        save_gbt_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str):
        from spark_rapids_ml_tpu_torch.io.persistence import load_gbt_model

        return load_gbt_model(path)

    def _raw_score(self, x) -> np.ndarray:
        """init + stepSize·Σ trees — boosting SUMS tree outputs (the
        ensemble-mean apply is a forest concept), kept as the JAX
        package's init + stepSize·mean·n_trees."""
        mean = _apply_ensemble(self, self.ensemble_, self.edges_, x)
        n_trees = self.ensemble_.feature.shape[0]
        return self.init_ + self.step_size_ * mean * n_trees


class GBTRegressor(_GBTBase):
    """``GBTRegressor().setMaxIter(50).setStepSize(0.1).fit(df)``."""

    def _model_cls(self):
        return GBTRegressionModel


class GBTRegressionModel(_GBTModelBase):
    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, self.getInputCol())
        pred = self._raw_score(frame.vectors_as_matrix(self.getInputCol()))
        return frame.with_column(
            self.getPredictionCol(), pred.astype(np.float64)
        )


class GBTClassifierParams(HasThresholds, GBTParams):
    """Shared classifier params: declared once so the estimator can set
    them pre-fit and copy_values_from carries them to the model (the
    RandomForest review lesson)."""

    probabilityCol = Param(
        "probabilityCol", "P(y=1) output column", "probability"
    )


class GBTClassifier(GBTClassifierParams, _GBTBase):
    """Binary logistic-loss boosting:
    ``GBTClassifier().setMaxIter(50).fit(df)``."""

    _classification = True

    def _model_cls(self):
        return GBTClassificationModel


class GBTClassificationModel(GBTClassifierParams, _GBTModelBase):
    _classification = True

    @observed_transform
    def predict_proba(self, dataset) -> np.ndarray:
        frame = as_vector_frame(dataset, self.getInputCol())
        z = self._raw_score(frame.vectors_as_matrix(self.getInputCol()))
        return _sigmoid(z)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, self.getInputCol())
        proba = self.predict_proba(frame)
        out = frame.with_column(self.getProbabilityCol(), proba.tolist())
        # double-typed predictions, matching Spark and the RandomForest
        # classifier in this repo; thresholds (if set) scale the implied
        # [1-p, p] probability pair
        pred = self._predict_index(
            np.stack([1.0 - proba, proba], axis=1)
        ).astype(np.float64)
        return out.with_column(self.getPredictionCol(), pred.tolist())


def gbt_init_from_mean(y_mean: float, classification: bool) -> float:
    """Initial boosting margin from the (validated) label mean — THE one
    formula for every fit plane (local, mesh-distributed, and the Spark
    statistics plane, which only ever sees Σy/n): log-odds of the clipped
    base rate for classification, the mean itself for regression."""
    if classification:
        p0 = float(np.clip(y_mean, 1e-6, 1 - 1e-6))
        return float(np.log(p0 / (1.0 - p0)))
    return float(y_mean)


def gbt_init_margin(y, classification, sample_weight=None):
    """Initial boosting margin + label validation — one definition for
    the local and distributed fits (see ``gbt_init_from_mean`` for the
    summary-statistics form the Spark plane uses). ``sample_weight``
    makes the base rate / mean weighted (weightCol semantics)."""
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    if classification and not np.isin(y, (0.0, 1.0)).all():
        raise ValueError("GBT classification requires 0/1 labels")
    if sample_weight is not None:
        mean = float(np.average(y, weights=sample_weight))
    else:
        mean = float(y.mean())
    return gbt_init_from_mean(mean, classification)


def boosting_loop(y_padded, mask, n_real, init, max_iter, step_size,
                  classification, subsampling_rate, rng, max_depth,
                  grow_fn, val_hook=None, validation_tol=0.01):
    """Shared gradient-boosting driver (local and distributed fits).

    ``grow_fn(r, w) -> (feature, threshold, leaf_value, leaf_ids)`` grows
    one regression tree on the residuals — on one device or sharded over
    a mesh; everything else (logistic residuals, Spark's
    subsamplingRate=1.0 no-subsampling convention, the Newton leaf refit
    Σw·r / Σw·h for classification, the margin update) lives here ONCE.
    ``y_padded``/``mask`` may carry zero-weight padding rows; Poisson
    weights are drawn over the REAL ``n_real`` rows so the RNG stream is
    identical with or without padding.

    ``val_hook(feature, threshold, leaf) -> float``: when given, called
    after each round with the new tree; returns the held-out validation
    error. Boosting stops early by Spark's ``runWithValidation`` rule —
    stop when the improvement over the best round is insufficient,
    ``best − err < validationTol · max(err, 0.01)`` (plateaus and slow
    improvement included) — and the returned ensemble is TRUNCATED to
    the best validation round.
    """
    f = np.full(len(y_padded), float(init))
    n_leaves = 2 ** max_depth
    feats_l, thrs_l, leaves_l, gains_l = [], [], [], []
    best_err = np.inf
    best_m = -1
    for m in range(max_iter):
        if classification:
            p = _sigmoid(f)
            r = y_padded - p
            hess = np.maximum(p * (1.0 - p), 1e-12)
        else:
            r = y_padded - f
            hess = np.ones_like(f)
        if subsampling_rate >= 1.0:
            # Spark semantics: 1.0 means NO subsampling (the mask — unit,
            # padding-zeroed, or user weightCol values — IS the weight,
            # deterministic regardless of seed)
            w = np.asarray(mask, dtype=np.float64).copy()
        else:
            w = np.zeros(len(y_padded))
            w[:n_real] = rng.poisson(subsampling_rate, n_real)
            w *= np.asarray(mask, dtype=np.float64)
        ft, tt, leaf, g_tree, leaf_ids = grow_fn(r, w)
        if classification:
            # Newton leaf refit: the grower's mean-residual leaves are
            # only the squared-loss optimum
            num = np.bincount(leaf_ids, weights=w * r, minlength=n_leaves)
            den = np.bincount(leaf_ids, weights=w * hess,
                              minlength=n_leaves)
            leaf = np.where(den > 0, num / np.maximum(den, 1e-12), 0.0)
        f = f + step_size * leaf[leaf_ids]
        feats_l.append(ft)
        thrs_l.append(tt)
        leaves_l.append(leaf)
        gains_l.append(g_tree)
        if val_hook is not None:
            err = float(val_hook(ft, tt, leaf))
            # Spark's runWithValidation rule: stop as soon as the
            # improvement over the best round falls below the tolerance
            # (plateaus and slow improvement included); the best round is
            # NOT advanced on the stopping round
            if best_err - err < validation_tol * max(err, 0.01):
                break
            if err < best_err:
                best_err, best_m = err, m
    if val_hook is not None and best_m >= 0:
        keep = best_m + 1
        feats_l, thrs_l = feats_l[:keep], thrs_l[:keep]
        leaves_l, gains_l = leaves_l[:keep], gains_l[:keep]
    return _fk.TreeEnsemble(
        feature=np.stack(feats_l),
        threshold=np.stack(thrs_l),
        leaf_value=np.stack(leaves_l),
    ), np.stack(gains_l)
