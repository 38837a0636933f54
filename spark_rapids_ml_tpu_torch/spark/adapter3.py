"""DataFrame front-ends for the BisectingKMeans pair.

Same generic-adapter posture as ``spark/adapter.py`` (driver-collect fit
inside the documented envelope, executor ``pandas_udf`` transform through
the shared ``_make_pair`` factory). The BisectingKMeans ESTIMATOR the
package exports fits on the executor statistics plane
(``spark/moments_estimator.py``); its model transforms here.

The port's copy of the JAX package's ``spark/adapter3.py`` for the
BisectingKMeans pair only. The DBSCAN, factorization-machine,
AFTSurvivalRegression, IsotonicRegression, PowerIterationClustering and
PrefixSpan front ends wait for ROADMAP queue 1 item 7.
"""

from __future__ import annotations

from spark_rapids_ml_tpu_torch.models.bisecting_kmeans import (
    BisectingKMeans as _LBKM,
    BisectingKMeansModel as _LBKM_M,
)
from spark_rapids_ml_tpu_torch.spark.adapter import _make_pair

__all__ = [
    "BisectingKMeans",
    "BisectingKMeansModel",
]


BisectingKMeans, BisectingKMeansModel = _make_pair(
    "BisectingKMeans", _LBKM, _LBKM_M, needs_label=False,
    doc="Divisive hierarchy of device 2-means splits; transform assigns "
        "the nearest leaf center.")


# factory-created classes carry the factory's module by default; pin them
# here so persistence sidecars and pickling resolve them where they live
for _name in __all__:
    globals()[_name].__module__ = __name__
del _name
