"""DataFrame scaler, TruncatedSVD, LinearSVC and GLM fits on the executor
statistics plane.

These families decompose exactly like PCA's covariance (the reference's
per-partition → driver-reduce shape, ``RapidsRowMatrix.scala:168-202``):

* the three scalers share ONE per-feature moments partial
  (n, Σx, Σx², min, max) — ``aggregate.partition_moment_stats`` — and a
  few lines of driver math each;
* TruncatedSVD is the UNCENTERED Gram: the same
  ``aggregate.partition_gram_stats`` partial the PCA plane reduces,
  finalized by the local estimator's gated eigensolve (``svd._solve``) on
  the driver's card, so the DataFrame fit shares the auto-solver gate
  verbatim;
* LinearSVC and GLM run one job per Newton / IRLS iteration on the
  logreg row shape (``aggregate.partition_svc_stats``,
  ``aggregate.partition_glm_stats``), the small solve on the driver;
* RobustScaler's quantiles come from one bounded row sample that covers
  every partition (``aggregate.partition_feature_sample``);
* GaussianMixture runs one EM-statistics job per iteration
  (``aggregate.partition_gmm_stats``) through the local estimator's EM
  loop, and BisectingKMeans re-derives each row's leaf on the executors
  from the broadcast split hierarchy (``aggregate.route_rows_bisecting``):
  per split a seeding-sample job, one Lloyd job per iteration and one
  moments job;
* OneVsRest discovers the labels in one job and fits each class's binary
  sub-model on the LogisticRegression or LinearSVC plane (a relabelling
  UDF column a class), the adapter collect for any other classifier or an
  elastic-net LogisticRegression;
* Imputer reduces EXACT per-feature missing-aware (count, Σx) partials
  for the mean (``aggregate.partition_imputer_stats``), takes the median
  from the sampled-quantile pass and keeps the adapter collect for the
  mode.

The classes subclass the adapter front-ends: param surface, setters,
persistence, and pandas_udf transform are unchanged — only the fit
strategy moves off driver-collect (the same seam ``forest_estimator``
uses for RF/GBT).

The port's copy of the JAX package's ``spark/moments_estimator.py`` for
the families the port has; the partials are host NumPy float64 there and
here, each equal to the JAX package's on the same batches. Every job goes
through ``forest_estimator._collect_rows``, so ``forest_estimator.
PartitionFrame`` drives each ``_fit`` on numpy partitions without
pyarrow (but OneVsRest's plane sub-fits, which run the statistics
plane's ``mapInArrow`` jobs). The LDA front end of the JAX module comes
with its family (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import numpy as np

from spark_rapids_ml_tpu_torch.spark import adapter as _adapter
from spark_rapids_ml_tpu_torch.spark import adapter3 as _adapter3
from spark_rapids_ml_tpu_torch.spark.aggregate import (
    combine_logreg_stats,
    combine_moment_stats,
    combine_stats,
    logreg_stats_arrow_schema,
    logreg_stats_spark_ddl,
    moment_stats_arrow_schema,
    moment_stats_spark_ddl,
    partition_gram_stats,
    partition_moment_stats,
    stats_arrow_schema,
    stats_spark_ddl,
)
from spark_rapids_ml_tpu_torch.spark.forest_estimator import (
    _collect_rows,
    _num_partitions,
)
from spark_rapids_ml_tpu_torch.utils.timing import PhaseTimer


def _collect_moments(dataset, fcol, wcol=None):
    cols = [fcol] + ([wcol] if wcol else [])
    df = dataset.select(*cols)

    def job(batches):
        return partition_moment_stats(batches, fcol, weight_col=wcol)

    return combine_moment_stats(_collect_rows(
        df, job, moment_stats_arrow_schema, moment_stats_spark_ddl()))


class StandardScaler(_adapter.StandardScaler):
    """StandardScaler over one executor moments pass (Σx, Σx², n partials;
    f64 one-pass identity — the same acceptance as the local streamed
    fit, ``models/scaler.py``)."""

    def _fit(self, dataset):
        from spark_rapids_ml_tpu_torch.models.scaler import (
            StandardScalerModel,
        )

        timer = PhaseTimer()
        fcol = self._local.getInputCol()
        with timer.phase("fit_kernel"):
            count, s1, s2, _lo, _hi = _collect_moments(dataset, fcol)
            if count < 2:
                raise ValueError("StandardScaler requires at least 2 rows")
            mean = s1 / count
            var = np.maximum((s2 - count * mean * mean) / (count - 1), 0.0)
        local = StandardScalerModel(mean=mean, std=np.sqrt(var))
        local.uid = self._local.uid
        local.copy_values_from(self._local)
        local.fit_timings_ = timer.as_dict()
        return self._model_cls(local)


class MinMaxScaler(_adapter.MinMaxScaler):
    """MinMaxScaler over the shared executor moments pass (min/max)."""

    def _fit(self, dataset):
        from spark_rapids_ml_tpu_torch.models.feature_scalers import (
            MinMaxScalerModel,
        )

        if float(self._local.getMin()) >= float(self._local.getMax()):
            raise ValueError("min must be below max")
        timer = PhaseTimer()
        fcol = self._local.getInputCol()
        with timer.phase("fit"):
            _count, _s1, _s2, lo, hi = _collect_moments(dataset, fcol)
        local = MinMaxScalerModel(original_min=lo, original_max=hi)
        local.uid = self._local.uid
        local.copy_values_from(self._local)
        local.fit_timings_ = timer.as_dict()
        return self._model_cls(local)


class MaxAbsScaler(_adapter.MaxAbsScaler):
    """MaxAbsScaler over the shared executor moments pass
    (max|x| = max(|min|, |max|))."""

    def _fit(self, dataset):
        from spark_rapids_ml_tpu_torch.models.feature_scalers import (
            MaxAbsScalerModel,
        )

        timer = PhaseTimer()
        fcol = self._local.getInputCol()
        with timer.phase("fit"):
            _count, _s1, _s2, lo, hi = _collect_moments(dataset, fcol)
        local = MaxAbsScalerModel(max_abs=np.maximum(np.abs(lo), np.abs(hi)))
        local.uid = self._local.uid
        local.copy_values_from(self._local)
        local.fit_timings_ = timer.as_dict()
        return self._model_cls(local)


class TruncatedSVD(_adapter.TruncatedSVD):
    """TruncatedSVD over the executor Gram plane: partitions reduce the
    UNCENTERED (Σxxᵀ, Σx, n) — the identical partial the PCA plane uses —
    and the driver runs the local estimator's gated eigensolve
    (``models/svd.py::TruncatedSVD._solve``: ``svdSolver`` auto gate,
    σ = √λ postprocessing) on its card."""

    def _fit(self, dataset):
        from spark_rapids_ml_tpu_torch.models.svd import TruncatedSVDModel

        local_est = self._local
        k = local_est.getK()
        if k is None:
            raise ValueError("k must be set before fit()")
        timer = PhaseTimer()
        fcol = local_est.getInputCol()
        df = dataset.select(fcol)

        def job(batches):
            return partition_gram_stats(batches, fcol)

        with timer.phase("gram"):
            gram, _col_sum, count = combine_stats(_collect_rows(
                df, job, stats_arrow_schema, stats_spark_ddl()))
        n_features = gram.shape[0]
        if k > n_features:
            raise ValueError(
                f"k = {k} must be <= number of features = {n_features}"
            )
        local_est._svd_solver_used = None
        v, s = local_est._solve(gram, k, timer)
        local = TruncatedSVDModel(components=v, singular_values=s)
        local.uid = local_est.uid
        local.copy_values_from(local_est)
        local.fit_timings_ = timer.as_dict()
        local.svd_solver_used_ = local_est._svd_solver_used
        return self._model_cls(local)


class LinearSVC(_adapter.LinearSVC):
    """DataFrame LinearSVC on the executor statistics plane: the
    squared-hinge generalized Newton decomposes exactly like the LogReg
    plane — per partition (Xᵀ(aỹ), XᵀSX, XᵀS, Σaỹ, Σs, loss, Σw)
    partials at the broadcast (w, b) (``aggregate.partition_svc_stats``,
    sharing the logreg row schema/combine), one job per iteration, the
    tiny (d+1)² solve on the driver. ``standardization=True`` runs ONE
    weighted-moments pass first and optimizes in the scaled space
    (coefficients unscale at the end); the per-feature std comes from the
    f64 ONE-PASS moment identity — the same acceptance as the plane
    StandardScaler — so a pathologically ill-conditioned column
    (|mean|/sd ≳ 1e7) may standardize differently from the local fit's
    two-pass std. The Newton iterates themselves are exact f64 matches
    of the local fit. Rows never reach the driver."""

    def _fit(self, dataset):
        from spark_rapids_ml_tpu_torch.models.linear_svc import (
            LinearSVCModel as LocalSVCModel,
            _assemble_svc_newton,
        )
        from spark_rapids_ml_tpu_torch.spark.aggregate import (
            partition_svc_stats,
        )

        local_est = self._local
        timer = PhaseTimer()
        fcol = local_est.getInputCol()
        lcol = local_est.getLabelCol()
        lam = float(local_est.getRegParam())
        fit_b = bool(local_est.getFitIntercept())
        tol = float(local_est.getTol())
        max_iter = int(local_est.getMaxIter())
        wcol = local_est.get_or_default("weightCol") or None
        cols = [fcol, lcol] + ([wcol] if wcol else [])
        df = dataset.select(*cols).persist()
        try:
            scale = None
            if local_est.getStandardization():
                with timer.phase("moments"):
                    count, s1, s2, _lo, _hi = _collect_moments(
                        df, fcol, wcol=wcol
                    )
                n = s1.shape[0]
                if count > 1.0:
                    mu = s1 / count
                    var = np.maximum(
                        (s2 - count * mu * mu) / (count - 1.0), 0.0
                    )
                    sd = np.sqrt(var)
                    scale = np.where(sd > 0, sd, 1.0)
            else:
                # no standardization: only the feature WIDTH is needed —
                # one first() row, not a full moments scan
                first = df.first()
                if first is None:
                    raise ValueError("empty dataset")
                n = len(first[0])

            w = np.zeros(n)
            b = 0.0
            n_iter = 0
            with timer.phase("fit_kernel"):
                for n_iter in range(1, max_iter + 1):
                    frozen_w, frozen_b = w.copy(), b

                    def job(batches, _w=frozen_w, _b=frozen_b):
                        return partition_svc_stats(
                            batches, fcol, lcol, _w, _b,
                            scale=scale, weight_col=wcol,
                        )

                    rows = _collect_rows(df, job, logreg_stats_arrow_schema,
                                         logreg_stats_spark_ddl())
                    gx, hxx, hxb, aysum, ssum, _loss, cnt = (
                        combine_logreg_stats(rows)
                    )
                    g, h = _assemble_svc_newton(
                        gx, hxx, hxb, float(aysum), float(ssum),
                        float(cnt), w, lam, fit_b,
                    )
                    delta = np.linalg.solve(h, g)
                    w = w - delta[:n]
                    if fit_b:
                        b = b - delta[n]
                    if np.max(np.abs(delta)) <= tol:
                        break
        finally:
            df.unpersist()
        coef = w / scale if scale is not None else w
        local = LocalSVCModel(
            coefficients=np.asarray(coef, dtype=np.float64),
            intercept=float(b),
        )
        local.uid = local_est.uid
        local.copy_values_from(local_est)
        local.n_iter_ = int(n_iter)
        local.fit_timings_ = timer.as_dict()
        return self._model_cls(local)


class GeneralizedLinearRegression(_adapter.GeneralizedLinearRegression):
    """DataFrame GLM on the executor statistics plane: each IRLS
    iteration is one job emitting per-partition weighted working
    statistics (X'WX, X'Wz, sums, deviance) under the broadcast
    (coef, intercept) — ``aggregate.partition_glm_stats`` — reduced by
    the shared logreg combine; the tiny (d x d) weighted solve and the
    deviance convergence check run on the driver. Rows never reach the
    driver. The first job runs the family's mustart starting iteration
    (same math as the local fit, ``models/glm.py::_irls``)."""

    def _fit(self, dataset):
        from spark_rapids_ml_tpu_torch.models.glm import (
            GeneralizedLinearRegressionModel as LocalGLMModel,
        )
        from spark_rapids_ml_tpu_torch.ops.glm_kernel import GlmStepOut
        from spark_rapids_ml_tpu_torch.spark.aggregate import (
            partition_glm_stats,
        )

        local_est = self._local
        timer = PhaseTimer()
        family, link, var_power, link_power = (
            local_est._resolved_family_link()
        )
        fcol = local_est.getInputCol()
        lcol = local_est.getLabelCol()
        wcol = local_est.get_or_default("weightCol") or None
        ocol = local_est.get_or_default("offsetCol") or None
        cols = [fcol, lcol] + ([wcol] if wcol else []) \
            + ([ocol] if ocol else [])
        df = dataset.select(*cols).persist()
        try:
            first_row = df.first()
            if first_row is None:
                raise ValueError("empty dataset")
            n = len(first_row[0])
            w_sum_box = [0.0]

            def step(coef, intercept, first=False):
                def job(batches, _c=np.array(coef), _b=float(intercept),
                        _first=bool(first)):
                    return partition_glm_stats(
                        batches, fcol, lcol, _c, _b,
                        family=family, link=link, var_power=var_power,
                        link_power=link_power, first=_first,
                        weight_col=wcol, offset_col=ocol,
                    )

                rows = _collect_rows(df, job, logreg_stats_arrow_schema,
                                     logreg_stats_spark_ddl())
                xtz, xtx, x_sum, z_sum, wsum, dev, cnt = (
                    combine_logreg_stats(rows)
                )
                w_sum_box[0] = float(cnt)
                return GlmStepOut(xtx=np.asarray(xtx), xtz=xtz,
                                  x_sum=x_sum, z_sum=z_sum, w_sum=wsum,
                                  deviance=dev)

            # the ONE IRLS driver loop (solve, convergence rule, mustart
            # first pass, for/else final deviance) lives in models/glm.py
            coef, intercept, n_iter, dev = local_est._irls(step, n, timer)
        finally:
            df.unpersist()
        local = LocalGLMModel(
            coefficients=np.asarray(coef, dtype=np.float64),
            intercept=float(intercept),
        )
        local.uid = local_est.uid
        local.copy_values_from(local_est)
        local.num_iterations_ = int(n_iter)
        local.deviance_ = float(dev)
        local.weight_sum_ = w_sum_box[0]
        local.fit_timings_ = timer.as_dict()
        return self._model_cls(local)


def _collect_feature_sample(dataset, fcol, seed=0):
    """(sample matrix, n_total): bounded per-partition sampled rows for
    driver-side quantile statistics — every partition contributes
    (``forest_plane.quantile_sample_cap``)."""
    from spark_rapids_ml_tpu_torch.spark.aggregate import (
        feature_sample_arrow_schema,
        feature_sample_spark_ddl,
        partition_feature_sample,
    )
    from spark_rapids_ml_tpu_torch.spark.forest_plane import (
        quantile_sample_cap,
    )

    df = dataset.select(fcol)
    first = df.first()
    if first is None:
        raise ValueError("empty dataset")
    width = len(first[0])
    n_parts = _num_partitions(df)
    # every partition contributes (stride 1): a skipped partition would
    # bias the quantiles on partition-clustered data
    cap = quantile_sample_cap(width, n_parts)

    def job(batches):
        return partition_feature_sample(
            batches, fcol, seed, cap=cap, sample_stride=1
        )

    rows = _collect_rows(df, job, feature_sample_arrow_schema,
                         feature_sample_spark_ddl())
    if not rows:
        raise ValueError("empty dataset")
    d = int(rows[0]["d"])
    xs = [
        np.asarray(r["sample"], dtype=np.float64).reshape(-1, d)
        for r in rows if len(r["sample"])
    ]
    if not xs:
        raise ValueError("no sampled rows (all sampling partitions empty)")
    return np.concatenate(xs), sum(int(r["n"]) for r in rows)


class RobustScaler(_adapter.RobustScaler):
    """RobustScaler on the statistics plane: quantiles come from ONE
    bounded row sample covering EVERY partition (the approxQuantile
    posture — Spark's RobustScaler also computes approximate quantiles),
    reduced on the driver with NaN-ignoring quantiles. Rows never
    collect in full."""

    def _fit(self, dataset):
        from spark_rapids_ml_tpu_torch.models.feature_scalers import (
            RobustScalerModel,
        )

        local_est = self._local
        if float(local_est.getLower()) >= float(local_est.getUpper()):
            raise ValueError("lower must be below upper")
        timer = PhaseTimer()
        fcol = local_est.getInputCol()
        with timer.phase("fit"):
            sample, _n = _collect_feature_sample(dataset, fcol)
            if np.isnan(sample).all(axis=0).any():
                raise ValueError(
                    "a feature column is entirely NaN; impute first"
                )
            qs = np.nanquantile(
                sample,
                [float(local_est.getLower()), 0.5,
                 float(local_est.getUpper())],
                axis=0,
            )
        local = RobustScalerModel(median=qs[1], qrange=qs[2] - qs[0])
        local.uid = local_est.uid
        local.copy_values_from(local_est)
        local.fit_timings_ = timer.as_dict()
        return self._model_cls(local)


class OneVsRest(_adapter.OneVsRest):
    """DataFrame OneVsRest whose K binary sub-fits run on the statistics
    planes: classes come from one label-discovery job, each class gets a
    relabeling UDF column plus a plane LogisticRegression / LinearSVC
    fit (statistics partials, rows never on the driver). Classifier
    types without a plane front-end fall back to the adapter path."""

    def _fit(self, dataset):
        from spark_rapids_ml_tpu_torch.models.linear_svc import (
            LinearSVC as LocalSVCEst,
        )
        from spark_rapids_ml_tpu_torch.models.logistic_regression import (
            LogisticRegression as LocalLogReg,
        )
        from spark_rapids_ml_tpu_torch.models.ovr import OneVsRestModel
        from spark_rapids_ml_tpu_torch.spark.estimator import (
            LogisticRegression as PlaneLR,
        )

        local_ovr = self._local
        clf = local_ovr.classifier
        plane_kind = None
        if clf is None or isinstance(clf, (LocalLogReg, PlaneLR)):
            plane_kind = "logreg"
        elif isinstance(clf, LocalSVCEst):
            plane_kind = "svc"

        def sub_param(name, default):
            if clf is None:
                return default
            if hasattr(clf, "has_param"):          # local Params system
                if clf.has_param(name):
                    return clf.get_or_default(name)
                return default
            if hasattr(clf, name):                  # pyspark-style Params
                return clf.getOrDefault(getattr(clf, name))
            return default

        if plane_kind == "logreg" and float(
            sub_param("elasticNetParam", 0.0)
        ) > 0.0:
            # the plane LogReg has no elastic-net path; the adapter
            # collect + local proximal-Newton fit preserves the
            # configured penalty instead of silently dropping it
            plane_kind = None
        if plane_kind is None:
            return super()._fit(dataset)

        import pyarrow  # noqa: F401 - mapInArrow dependency, fail early

        from spark_rapids_ml_tpu_torch.spark._compat import pandas_udf
        from spark_rapids_ml_tpu_torch.spark.aggregate import (
            discover_label_values,
        )

        fcol = local_ovr.getInputCol()
        lcol = local_ovr.getLabelCol()
        classes = discover_label_values(dataset, lcol)
        if classes.size < 2:
            raise ValueError("OneVsRest needs at least two classes")
        if not np.allclose(classes, np.round(classes)):
            raise ValueError("labels must be integer class indices")

        # uid-suffixed temp column: a dataset column literally named
        # "ovr_label" (even the features column) must survive
        bin_col = f"ovr_label_{local_ovr.uid}"
        df = dataset.select(fcol, lcol).persist()
        try:
            models = []
            for cls in classes:

                @pandas_udf(returnType="double")
                def bin_label(s, _c=float(cls)):
                    import pandas as pd

                    return pd.Series(
                        (np.asarray(s, dtype=np.float64) == _c).astype(
                            np.float64
                        )
                    )

                df_c = df.withColumn(bin_col, bin_label(df[lcol]))
                if plane_kind == "logreg":
                    sub = PlaneLR(
                        featuresCol=fcol, labelCol=bin_col,
                        regParam=float(sub_param("regParam", 0.0)),
                        fitIntercept=bool(sub_param("fitIntercept", True)),
                        maxIter=int(sub_param("maxIter", 25)),
                        tol=float(sub_param("tol", 1e-8)),
                        # the {0,1} column was just built: skip the
                        # per-sub-fit label-discovery job
                        family="binomial",
                    )
                    models.append(sub.fit(df_c)._to_local())
                else:
                    sub = LinearSVC(
                        featuresCol=fcol, labelCol=bin_col,
                        regParam=float(sub_param("regParam", 0.0)),
                        fitIntercept=bool(sub_param("fitIntercept", True)),
                        maxIter=int(sub_param("maxIter", 100)),
                        tol=float(sub_param("tol", 1e-8)),
                        standardization=bool(
                            sub_param("standardization", True)
                        ),
                    )
                    models.append(sub.fit(df_c)._local)
        finally:
            df.unpersist()
        local_model = OneVsRestModel(
            models=models, classes=classes.astype(np.int64)
        )
        local_model.uid = local_ovr.uid
        local_model.copy_values_from(local_ovr)
        return _adapter.OneVsRestModel(local_model)


class Imputer(_adapter.Imputer):
    """Imputer on the statistics plane: strategy='mean' reduces EXACT
    per-feature non-missing (count, Σx) partials; 'median' takes the
    sampled-quantile pass (Spark's own median Imputer is approxQuantile);
    'mode' needs exact value counts and keeps the adapter collect."""

    def _fit(self, dataset):
        from spark_rapids_ml_tpu_torch.models.imputer import ImputerModel
        from spark_rapids_ml_tpu_torch.spark.aggregate import (
            imputer_stats_arrow_schema,
            imputer_stats_spark_ddl,
            partition_imputer_stats,
        )

        local_est = self._local
        strategy = local_est.getStrategy()
        if strategy == "mode":
            return super()._fit(dataset)
        timer = PhaseTimer()
        fcol = local_est.getInputCol()
        missing = float(local_est.getMissingValue())
        with timer.phase("fit"):
            if strategy == "mean":
                def job(batches):
                    return partition_imputer_stats(batches, fcol, missing)

                rows = _collect_rows(dataset.select(fcol), job,
                                     imputer_stats_arrow_schema,
                                     imputer_stats_spark_ddl())
                if not rows:
                    raise ValueError("empty dataset")
                cnt = np.zeros(len(rows[0]["count_vec"]))
                s1 = np.zeros_like(cnt)
                for r in rows:
                    cnt += np.asarray(r["count_vec"], dtype=np.float64)
                    s1 += np.asarray(r["s1"], dtype=np.float64)
                if (cnt == 0).any():
                    j = int(np.argmax(cnt == 0))
                    raise ValueError(
                        f"feature {j} has no non-missing values to "
                        f"impute from"
                    )
                surrogates = s1 / cnt
            else:  # median via the sampled-quantile pass
                sample, _n = _collect_feature_sample(dataset, fcol)
                sentinel = missing
                if not np.isnan(sentinel):
                    sample = np.where(
                        sample == sentinel, np.nan, sample
                    )
                if np.isnan(sample).all(axis=0).any():
                    raise ValueError(
                        "a feature column has no non-missing values to "
                        "impute from"
                    )
                surrogates = np.nanmedian(sample, axis=0)
        local = ImputerModel(surrogates=surrogates)
        local.uid = local_est.uid
        local.copy_values_from(local_est)
        local.fit_timings_ = timer.as_dict()
        return self._model_cls(local)


class GaussianMixture(_adapter.GaussianMixture):
    """DataFrame GaussianMixture on the executor statistics plane: init
    is one moments pass + one capped feature-sample pass (seeded means);
    each EM iteration is one job emitting per-partition
    responsibility-weighted statistics (sum r, sum r x, sum r x x^T,
    loglik) under the broadcast mixture state
    (``aggregate.partition_gmm_stats``); the k x d x d M-step and the
    mean-loglik convergence rule reuse the ONE EM driver loop in
    ``models/gaussian_mixture.py::_fit_from_stepper``. Rows never reach
    the driver."""

    def _fit(self, dataset):
        from spark_rapids_ml_tpu_torch.ops.gmm_kernel import (
            init_from_moments,
        )
        from spark_rapids_ml_tpu_torch.spark.aggregate import (
            combine_gmm_stats,
            gmm_stats_arrow_schema,
            gmm_stats_spark_ddl,
            partition_gmm_stats,
        )

        local_est = self._local
        timer = PhaseTimer()
        k = int(local_est.getK())
        fcol = local_est.getInputCol()
        wcol = local_est.get_or_default("weightCol") or None
        cols = [fcol] + ([wcol] if wcol else [])
        df = dataset.select(*cols).persist()
        try:
            with timer.phase("init"):
                count, s1, s2, _lo, _hi = _collect_moments(df, fcol,
                                                           wcol=wcol)
                d = s1.shape[0]
                sample, n_rows = _collect_feature_sample(
                    df, fcol, seed=int(local_est.getSeed()))
                # guard on the ROW count (n_rows), not the weighted mass
                # `count` — tiny weights must not mask usable rows
                if n_rows < k:
                    raise ValueError(
                        f"k={k} components need at least k rows")
                rng = np.random.default_rng(int(local_est.getSeed()))
                init = init_from_moments(count, s1, s2, sample, k, rng)

            def stepper(means, prec, log_det, log_w):
                def job(batches, _m=np.array(means), _p=np.array(prec),
                        _ld=np.array(log_det), _lw=np.array(log_w)):
                    return partition_gmm_stats(
                        batches, fcol, _m, _p, _ld, _lw, weight_col=wcol)

                rows = _collect_rows(df, job, gmm_stats_arrow_schema,
                                     gmm_stats_spark_ddl())
                return combine_gmm_stats(rows, k, d)

            # the ONE EM driver loop (M-step, mean-loglik tol) lives in
            # models/gaussian_mixture.py
            local = local_est._fit_from_stepper(stepper, init, timer)
        finally:
            df.unpersist()
        return self._model_cls(local)


def _fit_bisecting_plane(local_est, dataset):
    """BisectingKMeans as executor statistics jobs: membership is a pure
    function of the broadcast split hierarchy
    (``aggregate.route_rows_bisecting``), so each bisection runs as a
    bounded seeding-sample job + maxIter Lloyd partial jobs + one
    moments job over the grown tree — rows never reach the driver.
    Split selection (highest-SSE divisible leaf), the no-spread guard,
    and minDivisibleClusterSize mirror ``models/bisecting_kmeans.py``;
    the one documented deviation is sample-based k-means++ seeding per
    split (the KMeans plane's ``df.limit`` posture) instead of the
    local fit's full-data seeding."""
    from spark_rapids_ml_tpu_torch.models.bisecting_kmeans import (
        BisectingKMeansModel,
    )
    from spark_rapids_ml_tpu_torch.models.kmeans import _host_kmeans_pp
    from spark_rapids_ml_tpu_torch.spark.aggregate import (
        bisecting_sample_arrow_schema,
        bisecting_sample_spark_ddl,
        bisecting_stats_arrow_schema,
        bisecting_stats_spark_ddl,
        combine_bisecting_stats,
        partition_bisecting_lloyd,
        partition_bisecting_moments,
        partition_bisecting_sample,
    )

    timer = PhaseTimer()
    fcol = local_est.getInputCol()
    wcol = local_est.get_or_default("weightCol") or None
    k = int(local_est.getK())
    max_iter = int(local_est.getMaxIter())
    seed = int(local_est.getSeed())
    min_div = float(local_est.get_or_default("minDivisibleClusterSize"))
    cols = [fcol] + ([wcol] if wcol else [])
    df = dataset.select(*cols).persist()

    def stats_rows(job):
        return _collect_rows(df, job, bisecting_stats_arrow_schema,
                             bisecting_stats_spark_ddl())

    nodes = []          # internal routing nodes
    # leaves: leaf_id -> dict(center, sse, raw, divisible)
    try:
        def moments(n_leaves):
            def job(batches, _nodes=list(nodes), _L=n_leaves):
                return partition_bisecting_moments(
                    batches, fcol, _nodes, _L, weight_col=wcol)

            rows = stats_rows(job)
            if not rows:
                raise ValueError("empty dataset")
            first = rows[0]
            get = (first.get if isinstance(first, dict)
                   else first.__getitem__)
            d_local = len(get("sums")) // n_leaves
            sums, counts, extra, _cost, _seen = combine_bisecting_stats(
                rows, n_leaves, d_local, extra_per_group=3)
            raws = extra[:n_leaves]
            sqs = extra[n_leaves:2 * n_leaves]
            mins = extra[2 * n_leaves:2 * n_leaves + n_leaves * d_local]\
                .reshape(n_leaves, d_local)
            maxs = extra[2 * n_leaves + n_leaves * d_local:]\
                .reshape(n_leaves, d_local)
            out = {}
            for lf in range(n_leaves):
                if counts[lf] <= 0:
                    continue
                center = sums[lf] / counts[lf]
                # weighted SSE about the mean via the moments identity
                sse = float(max(
                    sqs[lf] - (sums[lf] @ sums[lf]) / counts[lf], 0.0))
                spread = bool((maxs[lf] - mins[lf] > 0).any())
                out[lf] = {"center": center, "sse": sse,
                           "raw": float(raws[lf]), "spread": spread,
                           "divisible": True}
            return out, d_local

        with timer.phase("init"):
            leaves, d = moments(1)
            n_total = sum(v["raw"] for v in leaves.values())
            min_size = max(
                min_div if min_div >= 1.0 else min_div * n_total, 2.0)

        n_splits = 0
        with timer.phase("fit_kernel"):
            while len(leaves) < k:
                order = sorted(leaves, key=lambda lf: leaves[lf]["sse"],
                               reverse=True)
                target = next(
                    (lf for lf in order
                     if leaves[lf]["divisible"]
                     and leaves[lf]["raw"] >= min_size
                     and leaves[lf]["spread"]),
                    None)
                if target is None:
                    break
                # bounded seeding sample of the target leaf
                def sample_job(batches, _nodes=list(nodes), _t=target):
                    return partition_bisecting_sample(
                        batches, fcol, _nodes, _t, 4096)

                srows = _collect_rows(df, sample_job,
                                      bisecting_sample_arrow_schema,
                                      bisecting_sample_spark_ddl())
                pieces = []
                for row in srows:
                    get = (row.get if isinstance(row, dict)
                           else row.__getitem__)
                    pieces.append(np.asarray(
                        get("rows"), dtype=np.float64).reshape(-1, d))
                sample = (np.concatenate(pieces) if pieces
                          else np.zeros((0, d)))
                if sample.shape[0] < 2:
                    leaves[target]["divisible"] = False
                    continue
                rng = np.random.default_rng(seed + n_splits)
                c2 = _host_kmeans_pp(sample, 2, rng)

                def lloyd_stats(centers):
                    def lloyd_job(batches, _nodes=list(nodes),
                                  _t=target, _c=np.array(centers)):
                        return partition_bisecting_lloyd(
                            batches, fcol, _nodes, _t, _c,
                            weight_col=wcol)

                    return combine_bisecting_stats(
                        stats_rows(lloyd_job), 2, d, extra_per_group=1)

                for _ in range(max_iter):
                    sums, counts, _extra, _cost, _n = lloyd_stats(c2)
                    new_c = np.where(counts[:, None] > 0,
                                     sums / np.maximum(
                                         counts[:, None], 1e-300),
                                     c2)
                    shift = float(((new_c - c2) ** 2).sum())
                    c2 = new_c
                    if shift == 0.0:
                        break
                # the degenerate-split guard must see the assignment
                # under the COMMITTED (final) centers — the loop's last
                # stats describe the pre-update ones, and a final center
                # move can empty a side (classic k-means emptying); this
                # job also covers maxIter=0 (seeded centers commit
                # directly)
                _sums, _counts, extra, _cost, _n = lloyd_stats(c2)
                raw_sides = extra[:2]
                if (raw_sides <= 0).any():
                    # a degenerate split (all rows one side): keep the
                    # leaf, mark non-divisible so selection moves on
                    leaves[target]["divisible"] = False
                    continue
                # grow the tree: target leaf becomes an internal node
                # routing to two fresh leaves
                left_id = target          # reuse the slot
                right_id = max(leaves) + 1
                nodes.append({"cl": c2[0], "cr": c2[1],
                              "l": -(left_id) - 1,
                              "r": -(right_id) - 1})
                # re-point whichever parent routed to `target` (the
                # slice excludes the node just appended, whose own left
                # child legitimately reuses the target leaf id)
                for node in nodes[:-1]:
                    if node["l"] == -(target) - 1:
                        node["l"] = len(nodes) - 1
                    if node["r"] == -(target) - 1:
                        node["r"] = len(nodes) - 1
                n_splits += 1
                # refresh every leaf's stats under the grown tree (one
                # moments job; also validates the split's membership)
                leaves_new, _d2 = moments(max(leaves) + 2)
                for lf, rec in leaves_new.items():
                    rec["divisible"] = leaves.get(
                        lf, {"divisible": True})["divisible"] \
                        if lf != left_id and lf != right_id else True
                leaves = leaves_new
    finally:
        df.unpersist()

    centers = np.stack([leaves[lf]["center"] for lf in sorted(leaves)])
    model = BisectingKMeansModel(cluster_centers=centers)
    model.uid = local_est.uid
    model.copy_values_from(local_est)
    model.training_cost_ = float(
        sum(v["sse"] for v in leaves.values()))
    model.fit_timings_ = timer.as_dict()
    return model


class BisectingKMeans(_adapter3.BisectingKMeans):
    """DataFrame BisectingKMeans on the executor statistics plane:
    membership re-derives from the broadcast split hierarchy on
    executors, each bisection = seeding-sample job + Lloyd partial jobs
    + one moments refresh — rows never reach the driver (the
    driver-collect adapter fit this replaces held the whole dataset)."""

    def _fit(self, dataset):
        return self._model_cls(_fit_bisecting_plane(self._local,
                                                    dataset))
