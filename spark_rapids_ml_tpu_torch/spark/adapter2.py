"""DataFrame front-ends for the DecisionTree models.

Same generic-adapter posture as ``spark/adapter.py`` (driver-collect fit
inside the documented envelope, executor ``pandas_udf`` transform through
the shared ``_make_pair`` factory). The DecisionTree ESTIMATORS the
package exports fit on the forest statistics plane
(``spark/forest_estimator.py``); their models transform here.

The port's copy of the JAX package's ``spark/adapter2.py`` for the
DecisionTree pairs only. LDA, the LSH pairs, ALS, Word2Vec and FPGrowth
wait for their families (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

from spark_rapids_ml_tpu_torch.models.decision_tree import (
    DecisionTreeClassificationModel as _LDTC_M,
    DecisionTreeClassifier as _LDTC,
    DecisionTreeRegressionModel as _LDTR_M,
    DecisionTreeRegressor as _LDTR,
)
from spark_rapids_ml_tpu_torch.spark.adapter import _make_pair

__all__ = [
    "DecisionTreeClassifier",
    "DecisionTreeClassifierModel",
    "DecisionTreeRegressor",
    "DecisionTreeRegressorModel",
]


DecisionTreeClassifier, DecisionTreeClassifierModel = _make_pair(
    "DecisionTreeClassifier", _LDTC, _LDTC_M, needs_label=True,
    classifier=True,
    doc="Deterministic single tree (no bootstrap, all features).")
DecisionTreeRegressor, DecisionTreeRegressorModel = _make_pair(
    "DecisionTreeRegressor", _LDTR, _LDTR_M, needs_label=True)


# factory-created classes carry the factory's module by default; pin them
# here so persistence sidecars and pickling resolve them where they live
for _name in __all__:
    globals()[_name].__module__ = __name__
del _name
