"""The text pipeline in the port against the JAX package, on the same inputs:
every case of ``tests/test_text.py`` through both packages. Tokens,
strings, hashes and vocabulary indices are exact; floats within 1e-12.

MurmurHash3 x86_32 (Spark's HashingTF and FeatureHasher hash) equals the
JAX package's and the canonical vectors bit for bit, ASCII and UTF-8
alike; CountVectorizerModel and IDFModel save in one package and load in
the other. Each test runs in metrics registries of its own, in both
packages."""

import numpy as np
import pytest

from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxFrame
from spark_rapids_ml_tpu.models import text as jtx
from spark_rapids_ml_tpu.obs import devmon as jax_devmon
from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
from spark_rapids_ml_tpu_torch.models import text as tx
from spark_rapids_ml_tpu_torch.obs import devmon, metrics

FLOAT_ATOL = 1e-12


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


def _both(cls_name, columns, **params):
    """The output frames of the port's and JAX's ``cls_name`` transform
    on the same columns."""
    ours = getattr(tx, cls_name)(**params).transform(VectorFrame(columns))
    theirs = getattr(jtx, cls_name)(**params).transform(JaxFrame(columns))
    return ours, theirs


@pytest.mark.parametrize("data,seed,want", [
    (b"", 0, 0), (b"a", 0, 1009084850), (b"abc", 0, -1277324294),
    (b"abcd", 0, 1139631978), (b"b", 42, None), (b"b", 0, None),
    ("spark hashing – ü 漢字".encode("utf-8"), 42, None),
    (bytes(range(256)), 42, None), (b"abcde" * 7, 7, None)])
def test_murmur3_equals_jax_and_the_reference_vectors(data, seed, want):
    got = tx.murmur3_x86_32(data, seed)
    assert got == jtx.murmur3_x86_32(data, seed)
    assert -2**31 <= got < 2**31
    if want is not None:
        assert got == want
    assert tx.murmur3_x86_32(b"b", 42) != tx.murmur3_x86_32(b"b", 0)


@pytest.mark.parametrize("m", [1, 64, 1 << 18, 1000003])
def test_hash_index_equals_jax(m):
    terms = ["cat", "dog", "", "ü", "a b", "x" * 33, "42", "漢字"]
    assert [tx._hash_index(t, m) for t in terms] == \
        [jtx._hash_index(t, m) for t in terms]
    assert all(0 <= tx._hash_index(t, m) < m for t in terms)


def test_tokenizer_lowercases_and_splits():
    ours, theirs = _both("Tokenizer", {"text": ["Hi There  WORLD",
                                                "one two", ""]},
                         inputCol="text")
    assert ours.column("tokens") == theirs.column("tokens") == [
        ["hi", "there", "world"], ["one", "two"], []]


@pytest.mark.parametrize("text,params,want", [
    ("a,bb,,ccc", {"pattern": ","}, ["a", "bb", "ccc"]),
    ("a,bb,,ccc", {"pattern": ",", "minTokenLength": 0},
     ["a", "bb", "", "ccc"]),
    ("a,b,,", {"pattern": ",", "minTokenLength": 0}, ["a", "b"]),
    ("a,bb,,ccc", {"pattern": ",", "minTokenLength": 2}, ["bb", "ccc"]),
    ("a,bb,,ccc", {"pattern": r"\w+", "gaps": False}, ["a", "bb", "ccc"]),
    ("A,B", {"pattern": ",", "toLowercase": False}, ["A", "B"]),
])
def test_regex_tokenizer_modes(text, params, want):
    ours, theirs = _both("RegexTokenizer", {"text": [text]},
                         inputCol="text", **params)
    assert ours.column("tokens") == theirs.column("tokens") == [want]


@pytest.mark.parametrize("params,want", [
    ({}, ["Quick", "fox", "fast"]),
    ({"caseSensitive": True, "stopWords": ["the", "is"]},
     ["Quick", "fox", "IS", "fast"]),
    ({"stopWords": ["QUICK"]}, ["the", "fox", "IS", "fast"]),
])
def test_stop_words_remover(params, want):
    ours, theirs = _both("StopWordsRemover",
                         {"tokens": [["the", "Quick", "fox", "IS", "fast"]]},
                         inputCol="tokens", **params)
    assert ours.column("filtered") == theirs.column("filtered") == [want]


def test_default_stop_words_equal_jax():
    words = tx.StopWordsRemover.loadDefaultStopWords()
    assert words == jtx.StopWordsRemover.loadDefaultStopWords()
    assert "the" in words
    for cls in (tx.StopWordsRemover, jtx.StopWordsRemover):
        with pytest.raises(ValueError, match="english"):
            cls.loadDefaultStopWords("french")


@pytest.mark.parametrize("n,want", [
    (1, [["a", "b", "c", "d"], ["x"]]),
    (2, [["a b", "b c", "c d"], []]),
    (3, [["a b c", "b c d"], []])])
def test_ngram(n, want):
    ours, theirs = _both("NGram", {"tokens": [["a", "b", "c", "d"], ["x"]]},
                         inputCol="tokens", n=n)
    assert ours.column("ngrams") == theirs.column("ngrams") == want


@pytest.mark.parametrize("binary", [False, True])
def test_hashing_tf_buckets_and_counts(binary):
    docs = {"tokens": [["cat", "dog", "cat"], ["dog"], [], ["ü", "cat"]]}
    ours, theirs = _both("HashingTF", docs, inputCol="tokens",
                         numFeatures=64, binary=binary)
    m = np.asarray(ours.column("tf"))
    np.testing.assert_array_equal(m, np.asarray(theirs.column("tf")))
    tf = tx.HashingTF(inputCol="tokens", numFeatures=64)
    cat, dog = tf.indexOf("cat"), tf.indexOf("dog")
    assert cat == jtx.HashingTF(numFeatures=64).indexOf("cat")
    assert cat == tx.murmur3_x86_32(b"cat", 42) % 64
    assert m[0, cat] == (1.0 if binary else 2.0) and m[0, dog] == 1.0
    assert m[2].sum() == 0.0


def test_hashing_tf_dense_envelope_as_jax():
    docs = {"tokens": [["a"]] * 2048}
    for cls, frame in ((tx.HashingTF, VectorFrame),
                       (jtx.HashingTF, JaxFrame)):
        with pytest.raises(ValueError, match="dense"):
            cls(inputCol="tokens").transform(frame(docs))


DOCS = [["a", "b", "a"], ["a", "c"], ["a", "b"], ["d"]]


@pytest.mark.parametrize("params,vocab", [
    ({}, ["a", "b", "c", "d"]),
    ({"minDF": 2.0}, ["a", "b"]),
    ({"minDF": 0.5}, ["a", "b"]),
    ({"vocabSize": 1}, ["a"]),
])
def test_count_vectorizer_vocabulary(params, vocab):
    ours = tx.CountVectorizer(inputCol="tokens", **params).fit(
        VectorFrame({"tokens": DOCS}))
    theirs = jtx.CountVectorizer(inputCol="tokens", **params).fit(
        JaxFrame({"tokens": DOCS}))
    assert ours.vocabulary == theirs.vocabulary == vocab
    assert ours.getInputCol() == theirs.getInputCol() == "tokens"


@pytest.mark.parametrize("copy", [{}, {"minTF": 2.0}, {"minTF": 0.5},
                                  {"binary": True}])
def test_count_vectorizer_transform(copy):
    ours = tx.CountVectorizer(inputCol="tokens").fit(
        VectorFrame({"tokens": DOCS})).copy(copy)
    theirs = jtx.CountVectorizer(inputCol="tokens").fit(
        JaxFrame({"tokens": DOCS})).copy(copy)
    got = np.asarray(ours.transform(VectorFrame({"tokens": DOCS}))
                     .column("counts"))
    want = np.asarray(theirs.transform(JaxFrame({"tokens": DOCS}))
                      .column("counts"))
    np.testing.assert_array_equal(got, want)
    if not copy:
        np.testing.assert_array_equal(got[0], [2, 1, 0, 0])
    if copy == {"minTF": 2.0}:
        np.testing.assert_array_equal(got[0], [2, 0, 0, 0])


X_TF = np.array([[1.0, 0.0, 2.0],
                 [1.0, 1.0, 0.0],
                 [0.0, 0.0, 0.0]])


@pytest.mark.parametrize("min_doc_freq", [0, 2])
def test_idf_mllib_formula(min_doc_freq):
    ours = tx.IDF(inputCol="tf", outputCol="out",
                  minDocFreq=min_doc_freq).fit(VectorFrame({"tf": list(X_TF)}))
    theirs = jtx.IDF(inputCol="tf", outputCol="out",
                     minDocFreq=min_doc_freq).fit(JaxFrame({"tf": list(X_TF)}))
    expected = np.log((3 + 1.0) / (np.array([2, 1, 1]) + 1.0))
    if min_doc_freq:
        expected[1:] = 0.0
    np.testing.assert_allclose(ours.idf, expected, rtol=0, atol=FLOAT_ATOL)
    np.testing.assert_allclose(ours.idf, theirs.idf, rtol=0, atol=FLOAT_ATOL)
    np.testing.assert_array_equal(ours.doc_freq, theirs.doc_freq)
    assert ours.num_docs == theirs.num_docs == 3
    got = np.asarray(ours.transform(VectorFrame({"tf": list(X_TF)}))
                     .column("out"))
    want = np.asarray(theirs.transform(JaxFrame({"tf": list(X_TF)}))
                      .column("out"))
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_ATOL)
    np.testing.assert_allclose(got, X_TF * expected[None, :], rtol=0,
                               atol=FLOAT_ATOL)
    for model in (tx.IDFModel(), jtx.IDFModel()):
        with pytest.raises(ValueError, match="unfitted"):
            model.transform(np.eye(3))


def test_fits_carry_a_report():
    model = tx.CountVectorizer(inputCol="tokens").fit(
        VectorFrame({"tokens": DOCS}))
    assert model.fit_report_.algo == "count_vectorizer"
    idf = tx.IDF(inputCol="tf").fit(VectorFrame({"tf": list(X_TF)}))
    assert idf.fit_report_.algo == "idf"


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
def test_count_vectorizer_and_idf_persist_both_ways(tmp_path, direction):
    from spark_rapids_ml_tpu_torch.io.persistence import load_model

    src, dst = (tx, jtx) if direction == "port->jax" else (jtx, tx)
    frame = VectorFrame if src is tx else JaxFrame
    cv = src.CountVectorizer(inputCol="tokens", minTF=2.0).fit(
        frame({"tokens": [["x", "y"], ["y"], ["z", "y", "x"]]}))
    idf = src.IDF(inputCol="tf", minDocFreq=1).fit(
        frame({"tf": list(X_TF)}))
    tok = src.RegexTokenizer(inputCol="text", pattern=",", gaps=False)
    for name, model in (("cv", cv), ("idf", idf), ("tok", tok)):
        path = str(tmp_path / name)
        model.save(path)
        loaded = getattr(dst, type(model).__name__).load(path)
        assert loaded.uid == model.uid
        assert loaded.params().keys() == model.params().keys()
        for p in model.params():
            assert loaded.get_or_default(p) == model.get_or_default(p), p
        if dst is tx:
            assert type(load_model(path)) is type(loaded)
    loaded_cv = dst.CountVectorizerModel.load(str(tmp_path / "cv"))
    assert loaded_cv.vocabulary == cv.vocabulary
    loaded_idf = dst.IDFModel.load(str(tmp_path / "idf"))
    np.testing.assert_array_equal(loaded_idf.idf, idf.idf)
    np.testing.assert_array_equal(loaded_idf.doc_freq, idf.doc_freq)
    assert loaded_idf.num_docs == 3


def test_text_pipeline_composes():
    """Tokenizer → HashingTF → NaiveBayes in the port's Pipeline, as the
    JAX file composes it in JAX's: the same predictions."""
    from spark_rapids_ml_tpu import NaiveBayes as JNB
    from spark_rapids_ml_tpu import Pipeline as JPipeline
    from spark_rapids_ml_tpu_torch import NaiveBayes, Pipeline

    texts = ["win money now", "free money win", "win win prize",
             "meeting at noon", "lunch at noon today", "project meeting"]
    y = np.array([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
    preds = []
    for mod, pipe_cls, nb, frame in ((tx, Pipeline, NaiveBayes, VectorFrame),
                                     (jtx, JPipeline, JNB, JaxFrame)):
        df = frame({"text": texts, "label": y})
        model = pipe_cls(stages=[
            mod.Tokenizer(inputCol="text", outputCol="tokens"),
            mod.HashingTF(inputCol="tokens", outputCol="features",
                          numFeatures=256),
            nb(),
        ]).fit(df)
        preds.append(np.asarray(model.transform(df).column("prediction")))
    np.testing.assert_array_equal(preds[0], y)
    np.testing.assert_array_equal(preds[0], preds[1])
