"""DecisionTreeClassifier / DecisionTreeRegressor (Spark
``ml.classification.DecisionTreeClassifier`` /
``ml.regression.DecisionTreeRegressor``), on PyTorch.

Counterpart of the JAX package's ``models/decision_tree.py``. Spark's
single trees and its forests share one tree grower (``RandomForest.run``
with numTrees=1, all features, no bootstrap); the same factoring holds
here — these classes pin the forest estimator
(``models/random_forest.py``, the level-synchronous histogram grower of
``ops/forest_kernel.py``) to numTrees=1, featureSubsetStrategy='all',
and no Poisson bootstrap, so a DecisionTree fit is deterministic on the
full sample like Spark's. The fitted models add the single-tree surface:
``depth_``, ``num_nodes_``, and ``to_debug_string()``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from spark_rapids_ml_tpu_torch.models.random_forest import (
    RandomForestClassificationModel,
    RandomForestClassifier,
    RandomForestRegressionModel,
    RandomForestRegressor,
)


def _tree_debug_string(feature, threshold, leaf_value, edges,
                       classes) -> str:
    """Render the complete binary tree as Spark-style nested if/else
    text. Arrays are level-order flat (``TreeEnsemble``: node i's
    children are 2i+1 / 2i+2, ``n_internal = 2**depth − 1`` entries);
    internal node (f, b) splits at the learned quantile edge
    ``edges[f, b]``, leaf slots live in a separate 2**depth array."""
    n_internal = feature.shape[0]
    depth = (n_internal + 1).bit_length() - 1
    lines = []

    def leaf_text(idx):
        val = leaf_value[idx]
        if classes is not None:
            probs = np.asarray(val, dtype=np.float64)
            return (f"Predict: {classes[int(probs.argmax())]!r} "
                    f"(probabilities {np.round(probs, 4).tolist()})")
        return f"Predict: {float(val):.6g}"

    def recurse(node, level, indent):
        pad = "  " * indent
        if level == depth:
            lines.append(f"{pad}{leaf_text(node - n_internal)}")
            return
        f = int(feature[node])
        b = int(threshold[node])
        if b >= edges.shape[1]:
            # pass-through sentinel (threshold == n_bins): the grower
            # found no positive-gain split here and routes every row
            # LEFT — render the left chain only; an If/Else would print
            # a fabricated split with an unreachable Else branch
            recurse(2 * node + 1, level + 1, indent)
            return
        split = float(edges[f, b])
        lines.append(f"{pad}If (feature {f} <= {split:.6g})")
        recurse(2 * node + 1, level + 1, indent + 1)
        lines.append(f"{pad}Else (feature {f} > {split:.6g})")
        recurse(2 * node + 2, level + 1, indent + 1)

    recurse(0, 0, 0)
    return "\n".join(lines)


class _SingleTreeModelMixin:
    """Single-tree surface over the (trees=1) ensemble arrays."""

    @property
    def depth_(self) -> int:
        self._require_tree()
        n_internal = int(self.ensemble_.feature.shape[1])
        return (n_internal + 1).bit_length() - 1

    @property
    def num_nodes_(self) -> int:
        """Nodes of the complete binary tree (Spark's numNodes counts
        the materialized tree; the level-synchronous grower always
        materializes the complete depth)."""
        return 2 ** (self.depth_ + 1) - 1

    def _require_tree(self) -> None:
        if self.ensemble_ is None:
            raise ValueError("model has no tree; fit first or load")

    def to_debug_string(self) -> str:
        """Spark's ``toDebugString``: nested If/Else split text."""
        self._require_tree()
        return _tree_debug_string(
            np.asarray(self.ensemble_.feature)[0],
            np.asarray(self.ensemble_.threshold)[0],
            np.asarray(self.ensemble_.leaf_value)[0],
            np.asarray(self.edges_),
            self.classes_,
        )


_PINNED = {"numTrees": 1, "featureSubsetStrategy": "all",
           "subsamplingRate": 1.0}


class _SingleTreePinMixin:
    """Enforce the single-tree contract: Spark's DecisionTree has no
    numTrees/subset/bootstrap surface, so re-enabling them here would
    silently turn the estimator back into a forest while the model's
    single-tree accessors (depth_, to_debug_string) report tree [0]
    only. ``set`` rejects any value other than the pinned one."""

    def set(self, name, value):
        if name in _PINNED and value != _PINNED[name]:
            raise ValueError(
                f"{type(self).__name__} pins {name}={_PINNED[name]!r} "
                f"(single-tree contract); use RandomForest* for "
                f"ensembles")
        return super().set(name, value)


def _pin_single_tree(est) -> None:
    for name, value in _PINNED.items():
        est.set(name, value)


class DecisionTreeClassifier(_SingleTreePinMixin, RandomForestClassifier):
    """``DecisionTreeClassifier(maxDepth=5).fit(df)`` — deterministic
    single tree on the full sample."""

    _bootstrap = False

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        _pin_single_tree(self)
        for name, value in params.items():
            self.set(name, value)

    def _model_cls(self):
        return DecisionTreeClassificationModel


class DecisionTreeClassificationModel(_SingleTreeModelMixin,
                                      RandomForestClassificationModel):
    pass


class DecisionTreeRegressor(_SingleTreePinMixin, RandomForestRegressor):
    """``DecisionTreeRegressor(maxDepth=5).fit(df)``."""

    _bootstrap = False

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        _pin_single_tree(self)
        for name, value in params.items():
            self.set(name, value)

    def _model_cls(self):
        return DecisionTreeRegressionModel


class DecisionTreeRegressionModel(_SingleTreeModelMixin,
                                  RandomForestRegressionModel):
    pass
