"""``stat.py`` and ``ChiSqSelector`` in the port against the JAX package's,
on the same seeded numpy inputs.

Pearson's in-memory path is the port's one device path: an
``ops.streaming.update_stats`` Gram, which on a CPU tensor is the hand
kernel's plain version (bfloat16_3x at float32). The JAX package picks its
dtype from x64 (on in this suite), the port from ``stat._DTYPE``, which
the float64 cases set. Bars:

* Pearson at float64 (both packages): 1e-10 absolute of JAX's and of
  numpy's ``corrcoef`` (``tests/test_stat.py``'s bar); at float32 (the
  port's default) 1e-5 absolute of float64 — the bfloat16_3x Gram errs by
  ~1e-6 of √(GᵢᵢGⱼⱼ) and the correlation divides by that scale;
* everything else is host float64 in both packages, the same operations:
  within JAX's own test bars (Spearman 1e-10, chi-square 1e-10 relative,
  Summarizer 1e-12, KS statistic 1e-12, ANOVA / FValue 1e-10 relative),
  and equal to JAX's where the two run the same numpy code;
* ``ChiSqSelector.fit`` keeps the same features as JAX's.
"""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu_torch import stat
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
from spark_rapids_ml_tpu_torch.spark import local_engine as le

PEARSON_F64_ATOL = 1e-10
PEARSON_F32_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


@pytest.fixture
def float64(monkeypatch):
    monkeypatch.setattr(stat, "_DTYPE", torch.float64)


def _jstat():
    from spark_rapids_ml_tpu import stat as jstat
    from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxFrame

    return jstat, JaxFrame


def _frames(cols, n_partitions=3):
    """The same rows as a port and a JAX local DataFrame."""
    from spark_rapids_ml_tpu.spark import local_engine as jle

    def build(module):
        n = len(next(iter(cols.values())))
        rows = [{k: (module.DenseVector(v[i]) if np.ndim(v[i]) else
                     float(v[i])) for k, v in cols.items()}
                for i in range(n)]
        return module.LocalSparkSession(n_partitions=n_partitions) \
            .createDataFrame(rows)

    return build(le), build(jle)


# -- Correlation ---------------------------------------------------------------

def test_pearson_float64_matches_jax_and_numpy(float64):
    jstat, _ = _jstat()
    rng = np.random.default_rng(42)
    x = rng.normal(size=(300, 5)) @ rng.normal(size=(5, 5))
    ours = stat.Correlation.corr(x, "features", "pearson")
    np.testing.assert_allclose(ours, jstat.Correlation.corr(x),
                               atol=PEARSON_F64_ATOL, rtol=0)
    np.testing.assert_allclose(ours, np.corrcoef(x, rowvar=False),
                               atol=PEARSON_F64_ATOL, rtol=0)


def test_pearson_float32_through_the_gram_plain_version():
    """The port's default: float32 statistics from the kernel's plain
    version (the CPU stand-in for the card's bfloat16_3x launch)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2000, 64)) * np.linspace(0.2, 3.0, 64)
    got = stat.Correlation.corr(x)
    np.testing.assert_allclose(got, np.corrcoef(x, rowvar=False),
                               atol=PEARSON_F32_ATOL, rtol=0)
    assert np.array_equal(np.diag(got), np.ones(64))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pearson_constant_column_nan_as_jax(dtype, monkeypatch):
    jstat, _ = _jstat()
    monkeypatch.setattr(stat, "_DTYPE", getattr(torch, dtype))
    x = np.random.default_rng(42).normal(size=(100, 3))
    x[:, 1] = 7.0
    ours, ref = stat.Correlation.corr(x), jstat.Correlation.corr(x)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    assert np.isnan(ours[0, 1]) and np.isnan(ours[1, 2])
    assert ours[1, 1] == 1.0


def test_spearman_matches_jax_and_scipy():
    scipy_stats = pytest.importorskip("scipy.stats")
    jstat, _ = _jstat()
    x = np.random.default_rng(42).normal(size=(200, 4)) ** 3
    x[::7, 2] = 0.0   # ties: midranks
    ours = stat.Correlation.corr(x, method="spearman")
    np.testing.assert_array_equal(
        ours, jstat.Correlation.corr(x, method="spearman"))
    np.testing.assert_allclose(ours, scipy_stats.spearmanr(x)[0], atol=1e-10)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown correlation"):
        stat.Correlation.corr(np.ones((10, 2)), method="kendall")


# -- ChiSquareTest, Summarizer --------------------------------------------------

def _categorical(seed=42, n=400):
    rng = np.random.default_rng(seed)
    x = np.column_stack([rng.integers(0, 3, size=n),
                         rng.integers(0, 4, size=n),
                         rng.integers(0, 2, size=n)]).astype(float)
    y = (x[:, 0] + rng.integers(0, 2, size=n)) % 3
    return x, y


def test_chisquare_matches_jax_and_scipy():
    scipy_stats = pytest.importorskip("scipy.stats")
    jstat, JaxFrame = _jstat()
    x, y = _categorical()
    ours = stat.ChiSquareTest.test(
        VectorFrame({"features": list(x), "label": y}))
    ref = jstat.ChiSquareTest.test(JaxFrame({"features": list(x),
                                             "label": y}))
    for key in ("statistics", "degreesOfFreedom", "pValues"):
        np.testing.assert_array_equal(ours[key], ref[key])
    assert ours["degreesOfFreedom"].dtype == np.int64
    for j in range(x.shape[1]):
        vals, vi = np.unique(x[:, j], return_inverse=True)
        labs, yi = np.unique(y, return_inverse=True)
        table = np.zeros((vals.size, labs.size))
        np.add.at(table, (vi, yi), 1.0)
        chi, p, dof, _ = scipy_stats.chi2_contingency(table, correction=False)
        assert ours["statistics"][j] == pytest.approx(chi, rel=1e-10)
        assert ours["pValues"][j] == pytest.approx(p, abs=1e-12)
        assert ours["degreesOfFreedom"][j] == dof
    assert ours["pValues"][0] < 0.01


def _summary_equal(got, want):
    assert sorted(got) == sorted(want) == sorted(stat.Summarizer.METRICS)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-12, rtol=0)


def test_summarizer_matches_jax_and_numpy():
    jstat, _ = _jstat()
    x = np.random.default_rng(42).normal(size=(150, 4))
    x[x < -1.5] = 0.0
    s = stat.Summarizer.summarize(x, "features")
    _summary_equal(s, jstat.Summarizer.summarize(x, "features"))
    np.testing.assert_allclose(s["variance"], x.var(axis=0, ddof=1),
                               atol=1e-12)
    np.testing.assert_allclose(s["normL2"], np.sqrt((x * x).sum(axis=0)),
                               atol=1e-12)
    assert s["count"] == 150.0
    np.testing.assert_array_equal(s["numNonZeros"], (x != 0).sum(axis=0))


def test_summarizer_weighted_matches_jax():
    jstat, JaxFrame = _jstat()
    rng = np.random.default_rng(42)
    x = rng.normal(size=(80, 3))
    w = rng.uniform(0.2, 2.0, size=80)
    w[:5] = 0.0
    cols = {"features": list(x), "w": w}
    s = stat.Summarizer.summarize(VectorFrame(cols), "features",
                                  weightCol="w")
    _summary_equal(s, jstat.Summarizer.summarize(JaxFrame(cols), "features",
                                                 weightCol="w"))
    keep = w > 0
    assert s["count"] == float(keep.sum())
    mean = (w[keep, None] * x[keep]).sum(axis=0) / w[keep].sum()
    np.testing.assert_allclose(s["mean"], mean, atol=1e-12)


def test_summarizer_empty_raises_as_jax():
    jstat, _ = _jstat()
    for mod in (stat, jstat):
        with pytest.raises(ValueError, match="empty"):
            mod.Summarizer.summarize(np.zeros((0, 3)), "features")


def test_stat_on_local_engine_dataframes_matches_jax():
    """DataFrame inputs: Pearson rides the Gram plane partial, Summarizer
    the extended moments partial, chi-square and Spearman the guarded
    collect — each package on its own local engine, from the same rows."""
    jstat, _ = _jstat()
    rng = np.random.default_rng(42)
    x = rng.normal(size=(200, 4))
    y = rng.integers(0, 2, size=200).astype(float)
    pdf, jdf = _frames({"features": x, "label": y})
    pearson = stat.Correlation.corr(pdf, "features")
    np.testing.assert_allclose(pearson, jstat.Correlation.corr(jdf),
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(pearson, np.corrcoef(x, rowvar=False),
                               atol=PEARSON_F64_ATOL)
    _summary_equal(stat.Summarizer.summarize(pdf, "features"),
                   jstat.Summarizer.summarize(jdf, "features"))
    ours = stat.ChiSquareTest.test(pdf, "features", "label")
    ref = jstat.ChiSquareTest.test(jdf, "features", "label")
    np.testing.assert_array_equal(ours["pValues"], ref["pValues"])
    np.testing.assert_array_equal(
        stat.Correlation.corr(pdf, "features", "spearman"),
        jstat.Correlation.corr(jdf, "features", "spearman"))


# -- KolmogorovSmirnovTest -----------------------------------------------------

def _ks(mod, frame, *args):
    out = mod.KolmogorovSmirnovTest.test(frame, "sample", *args)
    return out.column("pValue")[0], out.column("statistic")[0]


@pytest.mark.parametrize("case", ["null", "shifted", "declared shift",
                                  "callable", "perfect fit"])
def test_ks_matches_jax(case):
    scipy_stats = pytest.importorskip("scipy.stats")
    jstat, JaxFrame = _jstat()
    rng = np.random.default_rng(42)
    uniform = lambda v: min(max(v, 0.0), 1.0)  # noqa: E731
    x, args = {
        "null": (rng.normal(size=2000), ("norm",)),
        "shifted": (rng.normal(size=2000) + 0.5, ("norm",)),
        "declared shift": (rng.normal(size=2000) + 0.5,
                           ("norm", 0.5, 1.0)),
        "callable": (rng.random(1500), (uniform,)),
        "perfect fit": ((np.arange(20_000) + 0.5) / 20_000, (uniform,)),
    }[case]
    p, d = _ks(stat, VectorFrame({"sample": list(x)}), *args)
    jp, jd = _ks(jstat, JaxFrame({"sample": list(x)}), *args)
    assert abs(d - jd) <= 1e-12 and abs(p - jp) <= 1e-12
    if case == "null":
        ref = scipy_stats.kstest(x, "norm")
        assert abs(d - ref.statistic) <= 1e-12
        assert abs(p - ref.pvalue) <= 1e-4
    elif case == "shifted":
        assert p < 1e-6
    elif case == "callable":
        assert p > 0.05
    elif case == "perfect fit":
        assert d < 1e-4 and p > 0.999


def test_ks_errors_as_jax():
    jstat, JaxFrame = _jstat()
    for mod, F in ((stat, VectorFrame), (jstat, JaxFrame)):
        with pytest.raises(ValueError, match="unsupported distName"):
            mod.KolmogorovSmirnovTest.test(F({"sample": [1.0]}), "sample",
                                           "poisson")
        with pytest.raises(ValueError, match="std must be positive"):
            mod.KolmogorovSmirnovTest.test(F({"sample": [1.0]}), "sample",
                                           "norm", 0.0, 0.0)


# -- ANOVATest, FValueTest -----------------------------------------------------

def _anova_inputs():
    rng = np.random.default_rng(42)
    n = 120
    y_cat = rng.integers(0, 3, size=n).astype(np.float64)
    x = np.column_stack([rng.normal(size=n), y_cat * 2.0 + rng.normal(size=n)])
    y_cont = rng.normal(size=n)
    xc = np.column_stack([y_cont * 3 + rng.normal(size=n) * 0.1,
                          rng.normal(size=n), np.ones(n)])
    return x, y_cat, xc, y_cont


@pytest.mark.parametrize("test", ["ANOVATest", "FValueTest"])
def test_feature_tests_match_jax_and_scipy(test):
    scipy_stats = pytest.importorskip("scipy.stats")
    jstat, JaxFrame = _jstat()
    x, y_cat, xc, y_cont = _anova_inputs()
    feats, label = (x, y_cat) if test == "ANOVATest" else (xc, y_cont)
    cols = {"features": feats, "label": label}
    ours = getattr(stat, test).test(VectorFrame(cols))
    ref = getattr(jstat, test).test(JaxFrame(cols))
    for key in ("pValues", "degreesOfFreedom", "fValues"):
        np.testing.assert_allclose(ours.column(key)[0], ref.column(key)[0],
                                   rtol=1e-10, atol=0)
    p, f = ours.column("pValues")[0], ours.column("fValues")[0]
    n = feats.shape[0]
    if test == "ANOVATest":
        groups = [x[y_cat == c] for c in (0, 1, 2)]
        for j in range(2):
            want = scipy_stats.f_oneway(*(g[:, j] for g in groups))
            np.testing.assert_allclose(f[j], want.statistic, rtol=1e-10)
            np.testing.assert_allclose(p[j], want.pvalue, rtol=1e-10)
        assert ours.column("degreesOfFreedom")[0] == [n - 1, n - 1]
        assert p[1] < 1e-10 < p[0]
    else:
        r = np.corrcoef(xc[:, 0], y_cont)[0, 1]
        np.testing.assert_allclose(f[0], r * r * (n - 2) / (1 - r * r),
                                   rtol=1e-10)
        assert p[0] < 1e-10 < p[1]
        assert (p[2], f[2]) == (1.0, 0.0)   # a constant column


def test_score_functions_equal_jax():
    jstat, _ = _jstat()
    x, y_cat, xc, y_cont = _anova_inputs()
    for ours, ref in ((stat.anova_f_scores(x, y_cat),
                       jstat.anova_f_scores(x, y_cat)),
                      (stat.f_regression_scores(xc, y_cont),
                       jstat.f_regression_scores(xc, y_cont))):
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    for mod in (stat, jstat):
        with pytest.raises(ValueError, match="2 classes"):
            mod.anova_f_scores(x, np.zeros(x.shape[0]))


def test_anova_test_accepts_dataframes_as_jax():
    jstat, _ = _jstat()
    rng = np.random.default_rng(42)
    y = rng.integers(0, 2, size=40).astype(np.float64)
    x = np.column_stack([rng.normal(size=40), y * 3.0])
    pdf, jdf = _frames({"features": x, "label": y}, n_partitions=2)
    p = stat.ANOVATest.test(pdf).column("pValues")[0]
    assert p == jstat.ANOVATest.test(jdf).column("pValues")[0]
    assert p[1] < 0.001 and p[0] > 0.001


# -- ChiSqSelector ----------------------------------------------------------------

@pytest.mark.parametrize("params", [
    {"selectorType": "numTopFeatures", "numTopFeatures": 2},
    {"selectorType": "percentile", "percentile": 0.34},
    {"selectorType": "fpr", "fpr": 0.05}])
def test_chisq_selector_keeps_the_jax_features(params):
    from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxFrame
    from spark_rapids_ml_tpu.models.feature_transformers import (
        ChiSqSelector as JaxSelector,
    )
    from spark_rapids_ml_tpu_torch import ChiSqSelector, ChiSqSelectorModel

    x, y = _categorical(seed=3, n=300)
    x = np.column_stack([x, (y + (np.arange(300) % 4 == 0)) % 3])
    cols = {"features": x, "label": y}
    ours = ChiSqSelector(**params).fit(VectorFrame(cols))
    ref = JaxSelector(**params).fit(JaxFrame(cols))
    assert type(ours) is ChiSqSelectorModel
    np.testing.assert_array_equal(ours.selected_features,
                                  np.asarray(ref.selected_features))
    assert ours.fit_report_.algo == "chi_sq_selector"
    out = ours.transform(VectorFrame(cols)).column("selected")
    np.testing.assert_array_equal(out, x[:, ours.selected_features])


def test_chisq_selector_persistence_both_ways(tmp_path):
    from spark_rapids_ml_tpu.models.feature_transformers import (
        ChiSqSelector as JaxSelector,
    )
    from spark_rapids_ml_tpu_torch import ChiSqSelector
    from spark_rapids_ml_tpu_torch.io.persistence import load_model

    params = {"selectorType": "fpr", "fpr": 0.01, "labelCol": "y"}
    JaxSelector(**params).save(str(tmp_path / "jax"))
    ChiSqSelector(**params).save(str(tmp_path / "port"))
    for loaded in (ChiSqSelector.load(str(tmp_path / "jax")),
                   load_model(str(tmp_path / "jax")),
                   JaxSelector.load(str(tmp_path / "port"))):
        for name, value in params.items():
            assert loaded.get_or_default(name) == value
    assert type(load_model(str(tmp_path / "port"))) is ChiSqSelector
