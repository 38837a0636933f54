"""The feature-transformer, DBSCAN and PIC DataFrame front ends of the port
against the JAX package's, each on its own package's local engine from
the same rows: the transformer, DBSCAN and PIC cases of
``tests/test_spark_front_ends.py`` (``test_text_chain_matches_local``
through ``test_sql_transformer_and_rformula``, ``test_dbscan_front_and_
mismatch``, ``test_pic_front``) through both packages, and each front end
against its own package's local transform. Tokens, strings and indices are
exact; floats within 1e-12. The routing: every name of the JAX package's
``_TRANSFORMER_CLASSES``, and DBSCAN, DBSCANModel and PIC, resolve in the
port's ``spark`` package to the module JAX's resolve to."""

import importlib

import numpy as np
import pytest

import spark_rapids_ml_tpu.spark as J
import spark_rapids_ml_tpu_torch.spark as S
from spark_rapids_ml_tpu.obs import devmon as jax_devmon
from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu.spark import local_engine as jax_engine
from spark_rapids_ml_tpu_torch.obs import devmon, metrics
from spark_rapids_ml_tpu_torch.spark import local_engine as engine

FLOAT_ATOL = 1e-12
PACKAGES = {"port": (S, engine, "spark_rapids_ml_tpu_torch"),
            "jax": (J, jax_engine, "spark_rapids_ml_tpu")}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    monkeypatch.setattr(metrics, "_default_registry",
                        metrics.MetricsRegistry())
    monkeypatch.setattr(jax_metrics, "_default_registry",
                        jax_metrics.MetricsRegistry())
    resets = (devmon.reset_device_monitor, jax_devmon.reset_device_monitor)
    for reset in resets:
        reset()
    yield
    for reset in resets:
        reset()


def _df(package, rows, parts=3):
    """``rows`` (dicts; ``np.ndarray`` cells become vectors) as a DataFrame
    on the package's local engine."""
    _front, eng, _name = PACKAGES[package]
    cells = [{k: eng.DenseVector(v) if isinstance(v, np.ndarray) else v
              for k, v in r.items()} for r in rows]
    return eng.LocalSparkSession(n_partitions=parts).createDataFrame(cells)


def _column(df, name):
    return [r[name] for r in df.collect()]


def _vectors(df, name):
    return np.stack([r[name].toArray() for r in df.collect()])


def _frame(package, columns):
    name = PACKAGES[package][2]
    return importlib.import_module(f"{name}.data.frame").VectorFrame(columns)


def _each(run):
    """``run(spark package, local engine, "port" | "jax")`` for the port
    and JAX."""
    return [run(*PACKAGES[p][:2], p) for p in ("port", "jax")]


# -- routing ------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(J._TRANSFORMER_CLASSES)
                         + ["DBSCAN", "DBSCANModel",
                            "PowerIterationClustering"])
def test_front_ends_resolve_where_jax_resolves_them(name):
    ours, theirs = getattr(S, name), getattr(J, name)
    assert ours.__name__ == theirs.__name__ == name
    assert ours.__module__.rsplit(".", 1)[-1] == \
        theirs.__module__.rsplit(".", 1)[-1]
    assert ours.__module__.startswith("spark_rapids_ml_tpu_torch.spark.")
    assert name in S.__all__ and name not in S._UNPORTED


# -- transformers: the text chain ---------------------------------------------

TEXTS = ["Hello World hello", "foo Bar foo baz", "hello foo", "ü Ü hello"]


def test_text_chain_matches_local_and_jax():
    def run(F, eng, p):
        df = _df(p, [{"text": t} for t in TEXTS])
        tok = F.Tokenizer(inputCol="text", outputCol="toks")
        toks_df = tok.transform(df)
        tokens = _column(toks_df, "toks")
        tf = _vectors(F.HashingTF(inputCol="toks", outputCol="tf",
                                  numFeatures=64).transform(toks_df), "tf")
        cvm = F.CountVectorizer(inputCol="toks", outputCol="cnt",
                                minDF=1.0).fit(toks_df)
        counted = cvm.transform(toks_df)
        idfm = F.IDF(inputCol="cnt", outputCol="tfidf").fit(counted)
        tfidf = _vectors(idfm.transform(counted), "tfidf")
        clean = _column(F.StopWordsRemover(inputCol="toks",
                                           outputCol="clean")
                        .transform(toks_df), "clean")
        grams = _column(F.NGram(inputCol="toks", outputCol="grams", n=2)
                        .transform(toks_df), "grams")
        local = importlib.import_module(
            f"{PACKAGES[p][2]}.models.text").HashingTF(
            inputCol="toks", outputCol="tf", numFeatures=64).transform(
            _frame(p, {"toks": tokens})).column("tf")
        return tokens, tf, cvm.vocabulary, tfidf, clean, grams, local

    ours, theirs = _each(run)
    tokens, tf, vocab, tfidf, clean, grams, local = ours
    assert tokens[0] == ["hello", "world", "hello"]
    assert tokens == theirs[0]
    np.testing.assert_array_equal(tf, np.asarray(local))
    np.testing.assert_array_equal(tf, theirs[1])
    assert vocab == theirs[2] and vocab[0] == "hello"
    assert tfidf.shape == (len(TEXTS), len(vocab))
    np.testing.assert_allclose(tfidf, theirs[3], rtol=0, atol=FLOAT_ATOL)
    assert clean == theirs[4] and "hello" in clean[0]
    assert grams == theirs[5]
    assert grams[0] == ["hello world", "world hello"]


def test_regex_tokenizer_front():
    outs = _each(lambda F, eng, p: _column(F.RegexTokenizer(
        inputCol="text", outputCol="toks", pattern="-",
        minTokenLength=2).transform(_df(p, [{"text": "a-b-ccc"},
                                            {"text": "dd--e"}])), "toks"))
    assert outs[0] == outs[1] == [["ccc"], ["dd"]]


# -- transformers: indexing / encoding / bucketing ----------------------------

CATS = ["a", "b", "a", "c", "a", "b"]


def test_string_indexer_onehot_roundtrip():
    def run(F, eng, p):
        df = _df(p, [{"cat": c} for c in CATS])
        sim = F.StringIndexer(inputCol="cat", outputCol="idx").fit(df)
        dfi = sim.transform(df)
        back = _column(F.IndexToString(inputCol="idx", outputCol="back",
                                       labels=sim.labels).transform(dfi),
                       "back")
        ohm = F.OneHotEncoder(inputCol="idx", outputCol="oh").fit(dfi)
        return (_column(dfi, "idx"), back,
                _vectors(ohm.transform(dfi), "oh"))

    ours, theirs = _each(run)
    assert ours[0] == theirs[0] == [0.0, 1.0, 0.0, 2.0, 0.0, 1.0]
    assert ours[1] == theirs[1] == CATS
    assert ours[2].shape == (6, 2)
    np.testing.assert_array_equal(ours[2], theirs[2])


def test_string_indexer_skip_drops_rows():
    def run(F, eng, p):
        sim = F.StringIndexer(inputCol="cat", outputCol="idx",
                              handleInvalid="skip").fit(
            _df(p, [{"cat": c} for c in ["a", "b", "a"]]))
        out = sim.transform(_df(p, [{"cat": c} for c in ["a", "zz", "b"]]))
        return out.count(), _column(out, "cat"), _column(out, "idx")

    ours, theirs = _each(run)
    assert ours == theirs == (2, ["a", "b"], [0.0, 1.0])


def test_bucketizer_and_quantile_discretizer():
    vals = np.random.default_rng(42).normal(size=40)

    def run(F, eng, p):
        df = _df(p, [{"v": float(v)} for v in vals])
        bk = F.Bucketizer(inputCol="v", outputCol="b",
                          splits=[-np.inf, 0.0, np.inf])
        got = np.asarray(_column(bk.transform(df), "b"))
        front_bk = F.QuantileDiscretizer(inputCol="v", outputCol="b",
                                         numBuckets=4).fit(df)
        assert isinstance(front_bk, type(bk))
        return got, np.asarray(_column(front_bk.transform(df), "b"))

    ours, theirs = _each(run)
    np.testing.assert_array_equal(ours[0], (vals >= 0).astype(float))
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])
    counts = np.bincount(ours[1].astype(int))
    assert counts.size == 4 and counts.min() >= 8


def test_vector_assembler_mixed_and_skip():
    rows = [{"a": 1.0, "v": np.array([2.0, 3.0])},
            {"a": float("nan"), "v": np.array([5.0, 6.0])}]

    def run(F, eng, p):
        out = F.VectorAssembler(inputCols=["a", "v"], outputCol="feat",
                                handleInvalid="skip").transform(_df(p, rows))
        with pytest.raises(ValueError, match="NaN"):
            F.VectorAssembler(inputCols=["a", "v"], outputCol="feat",
                              handleInvalid="error").transform(
                _df(p, rows)).collect()
        return out.count(), _vectors(out, "feat")

    ours, theirs = _each(run)
    assert ours[0] == theirs[0] == 1
    np.testing.assert_array_equal(ours[1], [[1.0, 2.0, 3.0]])
    np.testing.assert_array_equal(ours[1], theirs[1])


# -- transformers: vector math against the local transforms -------------------

@pytest.mark.parametrize("front_name,local_mod,kwargs", [
    ("DCT", "feature_transformers2", {}),
    ("Normalizer", "feature_scalers", {"p": 2.0}),
    ("Binarizer", "feature_scalers", {"threshold": 0.1}),
    ("PolynomialExpansion", "feature_transformers", {"degree": 2}),
    ("VectorSlicer", "feature_transformers", {"indices": [0, 2]}),
    ("ElementwiseProduct", "feature_transformers",
     {"scalingVec": [1.0, 2.0, 0.5, -1.0]}),
])
def test_vector_transformers_match_local(front_name, local_mod, kwargs):
    x = np.random.default_rng(42).normal(size=(10, 4))

    def run(F, eng, p):
        name = PACKAGES[p][2]
        front = getattr(F, front_name)(inputCol="features", outputCol="out",
                                       **kwargs)
        got = _vectors(front.transform(_df(p, [{"features": r} for r in x])),
                       "out")
        local = getattr(importlib.import_module(
            f"{name}.models.{local_mod}"), front_name)()
        for k, v in {"inputCol": "features", "outputCol": "out",
                     **kwargs}.items():
            local.set(k, v)
        want = np.asarray(local.transform(_frame(p, {"features": x}))
                          .column("out"), dtype=np.float64)
        np.testing.assert_allclose(got, want, rtol=FLOAT_ATOL, atol=0)
        return got

    ours, theirs = _each(run)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=FLOAT_ATOL)


def test_interaction_and_feature_hasher():
    x = np.random.default_rng(42).normal(size=(6, 2))

    def run(F, eng, p):
        inter = F.Interaction(inputCols=["s", "v"], outputCol="iv")
        got = _vectors(inter.transform(_df(p, [
            {"s": float(i % 2), "v": r} for i, r in enumerate(x)])), "iv")
        fh = F.FeatureHasher(inputCols=["s", "cat"], outputCol="h",
                             numFeatures=16)
        h = _vectors(fh.transform(_df(p, [{"s": 2.0, "cat": "x"},
                                          {"s": 3.0, "cat": "y"}])), "h")
        return got, h

    ours, theirs = _each(run)
    np.testing.assert_allclose(
        ours[0], x * np.asarray([i % 2 for i in range(6)], float)[:, None])
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[1].shape == (2, 16) and (ours[1] != 0).any()
    np.testing.assert_array_equal(ours[1], theirs[1])


def test_selectors_match_local():
    rng = np.random.default_rng(42)
    x = np.concatenate([rng.normal(size=(30, 2)), np.full((30, 1), 7.0)],
                       axis=1)
    y = (x[:, 0] > 0).astype(float)
    xc = rng.integers(0, 3, size=(40, 3)).astype(float)
    yc = xc[:, 1]

    def run(F, eng, p):
        df = _df(p, [{"features": r, "label": float(v)}
                     for r, v in zip(x, y)])
        dfc = _df(p, [{"features": r, "label": float(v)}
                      for r, v in zip(xc, yc)])
        vts = F.VarianceThresholdSelector(
            inputCol="features", outputCol="sel",
            varianceThreshold=1e-9).fit(df)
        chi = F.ChiSqSelector(inputCol="features", labelCol="label",
                              outputCol="sel", numTopFeatures=1).fit(dfc)
        uni = F.UnivariateFeatureSelector(
            inputCol="features", labelCol="label", outputCol="sel",
            featureType="continuous", labelType="categorical",
            selectionMode="numTopFeatures", selectionThreshold=1).fit(df)
        return (_vectors(vts.transform(df), "sel"),
                _vectors(chi.transform(dfc), "sel"),
                _vectors(uni.transform(df), "sel"))

    ours, theirs = _each(run)
    np.testing.assert_array_equal(ours[0], x[:, :2])
    np.testing.assert_array_equal(ours[1][:, 0], xc[:, 1])
    np.testing.assert_array_equal(ours[2][:, 0], x[:, 0])
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_vector_indexer_front():
    x = np.asarray([[0.0, 10.5], [1.0, -3.2], [0.0, 7.7], [2.0, 10.5]])

    def run(F, eng, p):
        df = _df(p, [{"features": r} for r in x])
        vim = F.VectorIndexer(inputCol="features", outputCol="ix",
                              maxCategories=3).fit(df)
        return _vectors(vim.transform(df), "ix")

    ours, theirs = _each(run)
    assert ours.shape == (4, 2) and set(ours[:, 0]) == {0.0, 1.0, 2.0}
    np.testing.assert_array_equal(ours, theirs)


def test_vector_size_hint_modes():
    rows = [{"v": np.array([1.0, 2.0])}, {"v": np.array([3.0])}]

    def run(F, eng, p):
        hint = F.VectorSizeHint(inputCol="v", size=2)
        ok = hint.transform(_df(p, rows[:1])).count()
        with pytest.raises(ValueError, match="size"):
            hint.transform(_df(p, rows)).collect()
        skip = F.VectorSizeHint(inputCol="v", size=2, handleInvalid="skip")
        opt = F.VectorSizeHint(inputCol="v", size=2,
                               handleInvalid="optimistic")
        return (ok, skip.transform(_df(p, rows)).count(),
                opt.transform(_df(p, rows)).count())

    ours, theirs = _each(run)
    assert ours == theirs == (1, 1, 2)


def test_sql_transformer_and_rformula():
    rows = [{"a": 1.0, "b": 2.0, "c": "x"}, {"a": 3.0, "b": 4.0, "c": "y"},
            {"a": 5.0, "b": 1.0, "c": "x"}]

    def run(F, eng, p):
        df = _df(p, rows)
        out = F.SQLTransformer(
            statement="SELECT *, a + b AS s FROM __THIS__").transform(df)
        model = F.RFormula(formula="b ~ a + c").fit(df)
        out2 = model.transform(df)
        return (_column(out, "s"), out.columns, _vectors(out2, "features"),
                _column(out2, "label"))

    ours, theirs = _each(run)
    assert ours[0] == theirs[0] == [3.0, 7.0, 6.0]
    assert ours[1] == theirs[1]
    np.testing.assert_array_equal(ours[2], theirs[2])
    np.testing.assert_array_equal(ours[2][:, 0], [1.0, 3.0, 5.0])
    assert ours[3] == theirs[3] == [2.0, 4.0, 1.0]


# -- DBSCAN and PIC -----------------------------------------------------------

def test_dbscan_front_and_mismatch():
    from spark_rapids_ml_tpu_torch import DBSCAN

    rng = np.random.default_rng(42)
    pts = np.concatenate([rng.normal(0, 0.1, size=(15, 2)),
                          rng.normal(5, 0.1, size=(15, 2))])

    def run(F, eng, p):
        df = _df(p, [{"features": r} for r in pts])
        model = F.DBSCAN(featuresCol="features", eps=0.5, minPts=3).fit(df)
        labs = np.asarray(_column(model.transform(df), "prediction"))
        with pytest.raises(ValueError, match="fitted dataset only"):
            model.transform(_df(p, [{"features": r} for r in pts[:5]]))
        return labs

    ours, theirs = _each(run)
    assert set(ours) == {0, 1}
    assert len(set(ours[:15])) == 1 and len(set(ours[15:])) == 1
    np.testing.assert_array_equal(ours, theirs)
    local = DBSCAN().setEps(0.5).setMinPts(3).fit(pts)
    np.testing.assert_array_equal(ours, local.labels_)


EDGES = [{"src": 0, "dst": 1, "w": 1.0}, {"src": 1, "dst": 2, "w": 1.0},
         {"src": 0, "dst": 2, "w": 1.0}, {"src": 3, "dst": 4, "w": 1.0},
         {"src": 4, "dst": 5, "w": 1.0}, {"src": 3, "dst": 5, "w": 1.0}]


def test_pic_front():
    def run(F, eng, p):
        df = _df(p, EDGES)
        pic = F.PowerIterationClustering(k=2, weightCol="w", maxIter=20,
                                         seed=1, dtype="float64")
        out = pic.assignClusters(df).collect()
        with pytest.raises(TypeError, match="assignClusters"):
            pic.fit(df)
        assert pic.assign_clusters.__name__ == "assignClusters"
        return {r["id"]: r["cluster"] for r in out}

    ours, theirs = _each(run)
    assert sorted(ours) == sorted(theirs) == [0, 1, 2, 3, 4, 5]
    assert ours[0] == ours[1] == ours[2] != ours[3] == ours[4] == ours[5]
    assert (theirs[0] == theirs[3]) == (ours[0] == ours[3])


def test_pic_front_equals_assign_clusters():
    from spark_rapids_ml_tpu_torch import PowerIterationClustering
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    rng = np.random.default_rng(7)
    edges = [{"src": int(a), "dst": int(b), "w": float(c)}
             for a, b, c in zip(rng.integers(0, 40, 200),
                                rng.integers(0, 40, 200),
                                rng.uniform(0.5, 2.0, 200))]
    params = {"k": 3, "weightCol": "w", "maxIter": 15, "seed": 4}
    rows = S.PowerIterationClustering(**params).assignClusters(
        _df("port", edges)).collect()
    want = PowerIterationClustering(**params).assign_clusters(VectorFrame({
        c: [e[c] for e in edges] for c in ("src", "dst", "w")}))
    assert [r["id"] for r in rows] == list(want.column("id"))
    assert [r["cluster"] for r in rows] == list(want.column("cluster"))
