"""RandomForest Regressor / Classifier with the Spark ML param surface, on
PyTorch.

Counterpart of the JAX package's ``models/random_forest.py``, with the same
params, defaults and validators, so saved metadata stays compatible (numTrees,
maxDepth, maxBins, minInstancesPerNode, featureSubsetStrategy,
subsamplingRate via Poisson weights, seed). The grower is
``ops/forest_kernel.py``: level-synchronous histogram trees whose split
search is a dense float64 contraction on the card, so a fit is one
contraction per tree group and level with no per-node host control flow.

Determinism: given a seed, the bootstrap weights and feature subsets are
the JAX package's draw for draw (one numpy ``default_rng``: a tree's
Poisson weights, then one ``choice`` per level, tree by tree), and every
reduction is a dense op in a fixed order, so the trees equal the JAX
package's on the same data (but where two splits tie within rounding)
and a fit repeated on the card is bit-identical.

Trees grow in groups sized by ``_tree_batch_size`` under the
``maxMemoryInMB`` budget; the trees do not depend on the group size. The
streamed fit (a zero-arg callable of chunks) goes through the Spark
statistics plane in the JAX package and is not ported yet (ROADMAP queue
1 item 5): it raises ``NotImplementedError``. ``dtype='auto'`` is float32
here.
"""

from __future__ import annotations

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
from spark_rapids_ml_tpu_torch.ops import forest_kernel as _fk
from spark_rapids_ml_tpu_torch.utils.resources import (
    resolve_device,
    tree_group_budget_bytes,
)
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

STREAMED_TREES = (
    "streamed tree fits (a zero-arg callable of (x, y) chunks) run through "
    "the Spark statistics plane, which is not ported yet (ROADMAP queue 1 "
    "item 5); fit an in-memory matrix instead"
)


class RandomForestParams(HasInputCol, HasDeviceId, HasWeightCol):
    labelCol = Param("labelCol", "label column name", "label")
    predictionCol = Param(
        "predictionCol", "prediction output column", "prediction"
    )
    numTrees = Param(
        "numTrees", "ensemble size", 20,
        validator=lambda v: isinstance(v, int) and v >= 1,
    )
    maxDepth = Param(
        "maxDepth", "tree depth (complete binary trees)", 5,
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
    featureSubsetStrategy = Param(
        "featureSubsetStrategy",
        "features considered per level: auto | all | sqrt | onethird | "
        "log2 | an int n | a fraction in (0,1] (Spark's full value "
        "surface; 'auto' = sqrt for classification, onethird for "
        "regression, Spark's convention). Default 'all' — a documented "
        "deviation from Spark's 'auto' default, keeping fits "
        "deterministic-by-default",
        "all",
        validator=lambda v: _valid_subset_strategy(v),
    )
    subsamplingRate = Param(
        "subsamplingRate",
        "bootstrap rate: Poisson(rate) sample weights per tree",
        1.0,
        validator=lambda v: 0.0 < float(v) <= 1.0,
    )
    seed = Param("seed", "bootstrap/subset seed", 0,
                 validator=lambda v: isinstance(v, int))
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


def _parse_numeric_subset(v):
    """(kind, value) for numeric featureSubsetStrategy values, following
    Spark's lexical rule: an INT (or int-looking string, no decimal
    point) is a feature COUNT ≥ 1; a decimal is a FRACTION in (0, 1] —
    so "1.0" means ALL features while "1" means one feature. Returns
    None when v is not numeric."""
    if isinstance(v, bool):
        return None
    if isinstance(v, int):
        return ("count", v) if v >= 1 else None
    if isinstance(v, float):
        return ("fraction", v) if 0.0 < v <= 1.0 else None
    if isinstance(v, str):
        try:
            f = float(v)
        except ValueError:
            return None
        if "." in v or "e" in v.lower():
            return ("fraction", f) if 0.0 < f <= 1.0 else None
        return ("count", int(f)) if f >= 1 else None
    return None


def _valid_subset_strategy(v) -> bool:
    if isinstance(v, str) and v in ("auto", "all", "sqrt", "onethird",
                                    "log2"):
        return True
    return _parse_numeric_subset(v) is not None


def _subset_counts(strategy, d: int, classification: bool = False) -> int:
    """Features per level under Spark's featureSubsetStrategy surface
    (RandomForestParams doc): named strategies, an int count, or a
    fraction of d (fractions and log2 round UP, Spark's convention)."""
    if strategy == "auto":
        strategy = "sqrt" if classification else "onethird"
    if strategy == "all":
        return d
    if strategy == "sqrt":
        return max(1, int(np.sqrt(d)))
    if strategy == "onethird":
        return max(1, d // 3)
    if strategy == "log2":
        return max(1, int(np.ceil(np.log2(d))))
    kind, value = _parse_numeric_subset(strategy)
    if kind == "count":
        return min(d, value)
    return min(d, max(1, int(np.ceil(value * d))))


def _tree_batch_size(n: int, depth: int, n_channels: int,
                     budget_bytes: int, n_trees: int) -> int:
    """Trees per grow call under the memory budget.

    A tree's own residents on the card, all 8 bytes an element: its
    float64 channels and weights (n × (C + 1)), its node ids, the routing
    gathers and compares (n × 4), and its slots in a row block's node
    one-hot at the leaf pass, the widest (``ROW_CHUNK`` × 2^depth × C).
    The bin one-hot of a row block is shared by the group and does not
    count. The budget comes through the same seam as the JAX package's
    (``maxMemoryInMB``, overridable by
    SPARK_RAPIDS_ML_TPU_TREE_GROUP_BYTES)."""
    rows = min(n, _fk.ROW_CHUNK)
    per_tree = 8 * (n * (n_channels + 5) + rows * 2 ** depth * n_channels)
    return max(1, min(n_trees, budget_bytes // max(per_tree, 1)))


def _fit_labels(frame, label_col, labels, n_rows):
    if labels is not None:
        y = np.asarray(labels, dtype=np.float64).reshape(-1)
    else:
        y = np.asarray(frame.column(label_col), dtype=np.float64)
    if y.shape[0] != n_rows:
        raise ValueError(f"labels length {y.shape[0]} != rows {n_rows}")
    return y


class _ForestBase(RandomForestParams):
    _classification = False
    # single-tree subclasses (DecisionTree*) turn the Poisson bootstrap
    # off: Spark's DecisionTree trains on the full unweighted sample
    _bootstrap = True

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_params

        save_params(self, path, overwrite=overwrite)

    @classmethod
    def load(cls, path: str):
        from spark_rapids_ml_tpu_torch.io.persistence import load_params

        return load_params(cls, path)

    @observed_fit("random_forest")
    def fit(self, dataset, labels=None):
        if callable(dataset) and labels is None:
            raise NotImplementedError(STREAMED_TREES)
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
        # Spark 3.0 weightCol: user weights MULTIPLY the Poisson bootstrap
        # weights (histograms/leaves are linear in the weight channel)
        user_w = self._extract_weights(frame, x.shape[0])
        n, d = x.shape
        depth = self.getMaxDepth()
        n_bins = self.getMaxBins()
        rng = np.random.default_rng(self.getSeed())
        device = resolve_device(self.getDeviceId())
        dtype = _resolve_dtype(self.getDtype())

        with timer.phase("binning"):
            binned_np, edges = _fk.quantile_bins(x, n_bins)
        binned = torch.as_tensor(binned_np, device=device)

        if self._classification:
            classes = np.unique(y)
            y_oh = torch.zeros((n, len(classes)), dtype=dtype, device=device)
            y_oh[torch.arange(n, device=device),
                 torch.as_tensor(np.searchsorted(classes, y),
                                 device=device)] = 1.0
        else:
            y_dev = torch.as_tensor(y, dtype=dtype, device=device)

        k_feats = _subset_counts(
            self.getFeatureSubsetStrategy(), d, self._classification
        )
        n_trees = self.getNumTrees()
        rate = float(self.getSubsamplingRate())
        n_channels = len(classes) if self._classification else 3
        group = _tree_batch_size(n, depth, n_channels,
                                 tree_group_budget_bytes(self), n_trees)
        # balanced ceil-split; the tail group is simply smaller (the JAX
        # package pads it with zero-weight trees to spare XLA a compile)
        group = -(-n_trees // -(-n_trees // group))
        grown = []
        with timer.phase("grow"), TraceRange("forest grow", TraceColor.RED):
            # per-tree bootstrap weights + per-level feature masks are
            # drawn in the JAX package's rng order (poisson then level
            # choices, tree by tree), a group-sized buffer at a time. A
            # group's grow is queued on the device without a host sync,
            # so the next group's draws overlap it; the trees come back
            # to the host once, after the last group
            t_done = 0
            while t_done < n_trees:
                g_sz = min(group, n_trees - t_done)
                w_grp = np.empty((g_sz, n), dtype=np.float64)
                mask_grp = np.zeros((g_sz, depth, d), dtype=np.float64)
                for g_i in range(g_sz):
                    w_np = (rng.poisson(rate, n).astype(np.float64)
                            if self._bootstrap else np.ones(n))
                    if user_w is not None:
                        w_np *= user_w
                    w_grp[g_i] = w_np
                    for lvl in range(depth):
                        cols = rng.choice(d, size=k_feats, replace=False)
                        mask_grp[g_i, lvl, cols] = 1.0
                wb = torch.as_tensor(w_grp, dtype=dtype, device=device)
                mb = torch.as_tensor(mask_grp, dtype=dtype, device=device)
                if self._classification:
                    out = _fk.grow_trees_classification_batch(
                        binned, y_oh, wb, mb, depth, n_bins,
                        len(classes), self.getMinInstancesPerNode(),
                    )
                else:
                    out = _fk.grow_trees_regression_batch(
                        binned, y_dev, wb, mb, depth, n_bins,
                        self.getMinInstancesPerNode(),
                    )
                grown.append(out)
                del wb, mb
                t_done += g_sz
            feats, thrs, leaves, gains = (
                torch.cat(parts).cpu().numpy() for parts in zip(*grown))
        ensemble = _fk.TreeEnsemble(
            feature=feats, threshold=thrs, leaf_value=leaves)
        model = self._model_cls()(
            ensemble=ensemble,
            edges=edges,
            classes=classes if self._classification else None,
        )
        model.feature_importances_ = _fk.feature_importances(
            ensemble.feature, gains, d
        )
        model.uid = self.uid
        model.copy_values_from(self)
        model.fit_timings_ = timer.as_dict()
        model.trees_per_group_ = group
        return model

    def _model_cls(self):
        raise NotImplementedError


def _fitted_depth(ensemble) -> int:
    """Depth from the FITTED ensemble's shape (n_internal = 2**depth − 1),
    never from the mutable maxDepth param: a setter call after fit would
    otherwise silently misroute predictions."""
    return int(np.asarray(ensemble.feature).shape[1] + 1).bit_length() - 1


def _device_ensemble(ensemble, dtype, device) -> _fk.TreeEnsemble:
    return _fk.TreeEnsemble(
        feature=torch.as_tensor(np.asarray(ensemble.feature),
                                dtype=torch.int64, device=device),
        threshold=torch.as_tensor(np.asarray(ensemble.threshold),
                                  dtype=torch.int32, device=device),
        leaf_value=torch.as_tensor(np.asarray(ensemble.leaf_value),
                                   dtype=dtype, device=device),
    )


def _apply_ensemble(params, ensemble, edges, x) -> np.ndarray:
    """Bin ``x`` with the fitted edges on the host, route it through every
    tree on the params' device and dtype; the tree-mean as float64."""
    if ensemble is None:
        raise ValueError("model has no ensemble; fit first")
    x = np.asarray(x, dtype=np.float64)
    if x.shape[1] != edges.shape[0]:
        raise ValueError(
            f"query dim {x.shape[1]} != fitted dim {edges.shape[0]}"
        )
    binned = _fk.apply_bin_edges(x, edges)
    device = resolve_device(params.getDeviceId())
    dtype = _resolve_dtype(params.getDtype())
    out = _fk.forest_apply(
        torch.as_tensor(binned, device=device),
        _device_ensemble(ensemble, dtype, device),
        _fitted_depth(ensemble),
    )
    return out.cpu().numpy().astype(np.float64)


class _ForestModelBase(RandomForestParams):
    _classification = False

    def __init__(self, ensemble=None, edges=None, classes=None):
        super().__init__()
        self.ensemble_ = ensemble
        self.edges_ = edges
        self.classes_ = classes
        self.feature_importances_ = None

    def _copy_internal_state(self, other) -> None:
        other.ensemble_ = self.ensemble_
        other.edges_ = self.edges_
        other.classes_ = self.classes_
        other.feature_importances_ = self.feature_importances_

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_forest_model

        save_forest_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str):
        from spark_rapids_ml_tpu_torch.io.persistence import load_forest_model

        return load_forest_model(path)

    def _apply(self, x) -> np.ndarray:
        return _apply_ensemble(self, self.ensemble_, self.edges_, x)


class RandomForestRegressor(_ForestBase):
    """``RandomForestRegressor().setNumTrees(50).fit(df)``."""

    _classification = False

    def _model_cls(self):
        return RandomForestRegressionModel


class RandomForestRegressionModel(_ForestModelBase):
    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, self.getInputCol())
        pred = self._apply(frame.vectors_as_matrix(self.getInputCol()))
        return frame.with_column(
            self.getPredictionCol(), pred.astype(np.float64)
        )


class RandomForestClassifierParams(HasThresholds, RandomForestParams):
    """Classifier-side params: declared on estimator AND model so the
    estimator can configure them pre-fit (setProbabilityCol, grids) and
    copy_values_from carries them to the fitted model."""

    probabilityCol = Param(
        "probabilityCol", "per-class probability output column", "probability"
    )


class RandomForestClassifier(RandomForestClassifierParams, _ForestBase):
    """``RandomForestClassifier().setNumTrees(50).fit(df)``."""

    _classification = True

    def _model_cls(self):
        return RandomForestClassificationModel


class RandomForestClassificationModel(
    RandomForestClassifierParams, _ForestModelBase
):
    _classification = True

    @observed_transform
    def predict_proba(self, dataset) -> np.ndarray:
        frame = as_vector_frame(dataset, self.getInputCol())
        return self._apply(frame.vectors_as_matrix(self.getInputCol()))

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, self.getInputCol())
        proba = self._apply(frame.vectors_as_matrix(self.getInputCol()))
        pred = self.classes_[self._predict_index(proba)]
        out = frame.with_column(self.getProbabilityCol(), proba.tolist())
        return out.with_column(
            self.getPredictionCol(), pred.astype(np.float64)
        )
