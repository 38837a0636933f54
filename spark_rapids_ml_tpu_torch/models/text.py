"""Text feature pipeline, on the host: Tokenizer, RegexTokenizer,
StopWordsRemover, NGram, HashingTF, CountVectorizer, IDF.

Counterpart of the JAX package's ``models/text.py``, with the same params,
semantics and persistence (``pyspark.ml.feature`` over string and
token-list columns). HashingTF reproduces Spark's exact bucket assignment,
MurmurHash3 x86_32 (seed 42) of the term's UTF-8 bytes modulo
numFeatures, so feature indices match a Spark pipeline and the JAX
package's bit for bit. IDF's weighting follows MLlib:
idf = log((m + 1) / (df + 1)).

These are string ops, host numpy in both packages; the downstream
estimators consume their dense output on the card. The fits carry a
``fit_report_``, as every port fit does (the JAX package's carry none).
"""

from __future__ import annotations

import re
import struct
from typing import List, Optional

import numpy as np

from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.models.params import (
    HasInputCol,
    HasOutputCol,
    Param,
    Params,
)
from spark_rapids_ml_tpu_torch.models.feature_transformers import _persistable
from spark_rapids_ml_tpu_torch.obs.report import observed_fit
from spark_rapids_ml_tpu_torch.obs.serving import observed_transform


def murmur3_x86_32(data: bytes, seed: int = 42) -> int:
    """MurmurHash3 x86_32 — Spark's term-hash function
    (``org.apache.spark.unsafe.hash.Murmur3_x86_32``; HashingTF seed 42).
    Returns a SIGNED 32-bit int like the JVM."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n_blocks = len(data) // 4
    for i in range(n_blocks):
        k = struct.unpack_from("<I", data, i * 4)[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    # tail — Spark hashes UTF-8 bytes with the standard tail mix
    tail = data[n_blocks * 4:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h - 0x100000000 if h >= 0x80000000 else h


def _hash_index(term: str, num_features: int) -> int:
    """Spark's non-negative modulo of the signed murmur3 hash."""
    return murmur3_x86_32(str(term).encode("utf-8")) % num_features


@_persistable
class Tokenizer(HasInputCol, HasOutputCol, Params):
    """Lowercase whitespace tokenizer (Spark's ``Tokenizer``)."""

    outputCol = Param("outputCol", "token-list output column", "tokens")

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, None)
        out = [str(s).lower().split()
               for s in frame.column(self.getInputCol())]
        return frame.with_column(self.getOutputCol(), out)


@_persistable
class RegexTokenizer(HasInputCol, HasOutputCol, Params):
    """Regex tokenizer: ``gaps=True`` (default) splits ON the pattern,
    ``gaps=False`` extracts matches; minTokenLength filter and
    toLowercase — Spark semantics."""

    outputCol = Param("outputCol", "token-list output column", "tokens")
    pattern = Param("pattern", "split/match regex", r"\s+")
    gaps = Param("gaps", "True: pattern splits; False: pattern matches",
                 True, validator=lambda v: isinstance(v, bool))
    minTokenLength = Param("minTokenLength", "drop shorter tokens", 1,
                           validator=lambda v: isinstance(v, int) and
                           v >= 0)
    toLowercase = Param("toLowercase", "lowercase before tokenizing",
                        True, validator=lambda v: isinstance(v, bool))

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, None)
        pattern = re.compile(self.get_or_default("pattern"))
        min_len = int(self.get_or_default("minTokenLength"))
        lower = self.get_or_default("toLowercase")
        out = []
        for s in frame.column(self.getInputCol()):
            s = str(s).lower() if lower else str(s)
            if self.get_or_default("gaps"):
                toks = pattern.split(s)
                # Java's Pattern.split (Spark) drops TRAILING empty
                # tokens; Python's re.split keeps them
                while toks and toks[-1] == "":
                    toks.pop()
            else:
                toks = pattern.findall(s)
            out.append([t for t in toks if len(t) >= min_len])
        return frame.with_column(self.getOutputCol(), out)


# the standard english stop list Spark ships (subset sufficient for the
# default behavior; Spark's full list derives from the Glasgow IR list)
_ENGLISH_STOP_WORDS = frozenset("""
a about above after again against all am an and any are aren't as at be
because been before being below between both but by can't cannot could
couldn't did didn't do does doesn't doing don't down during each few for
from further had hadn't has hasn't have haven't having he he'd he'll
he's her here here's hers herself him himself his how how's i i'd i'll
i'm i've if in into is isn't it it's its itself let's me more most
mustn't my myself no nor not of off on once only or other ought our
ours ourselves out over own same shan't she she'd she'll she's should
shouldn't so some such than that that's the their theirs them themselves
then there there's these they they'd they'll they're they've this those
through to too under until up very was wasn't we we'd we'll we're we've
were weren't what what's when when's where where's which while who who's
whom why why's with won't would wouldn't you you'd you'll you're you've
your yours yourself yourselves
""".split())


@_persistable
class StopWordsRemover(HasInputCol, HasOutputCol, Params):
    """Drops stop words from a token list (Spark's default English
    list; override via ``stopWords``; ``caseSensitive`` off by
    default)."""

    outputCol = Param("outputCol", "filtered token-list column",
                      "filtered")
    stopWords = Param("stopWords", "words to remove (None = English)",
                      None)
    caseSensitive = Param("caseSensitive", "case-sensitive matching",
                          False, validator=lambda v: isinstance(v, bool))

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @staticmethod
    def loadDefaultStopWords(language: str = "english") -> List[str]:
        if language != "english":
            raise ValueError(
                "only the english default list ships here; pass your own "
                "stopWords for other languages")
        return sorted(_ENGLISH_STOP_WORDS)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, None)
        words = self.get_or_default("stopWords")
        case = self.get_or_default("caseSensitive")
        stop = (set(words) if words is not None
                else set(_ENGLISH_STOP_WORDS))
        if not case:
            stop = {w.lower() for w in stop}
        out = []
        for toks in frame.column(self.getInputCol()):
            out.append([t for t in toks
                        if (t if case else str(t).lower()) not in stop])
        return frame.with_column(self.getOutputCol(), out)


@_persistable
class NGram(HasInputCol, HasOutputCol, Params):
    """Sliding n-grams over a token list, space-joined (Spark)."""

    outputCol = Param("outputCol", "ngram-list output column", "ngrams")
    n = Param("n", "gram size", 2,
              validator=lambda v: isinstance(v, int) and v >= 1)

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, None)
        n = int(self.getN())
        out = []
        for toks in frame.column(self.getInputCol()):
            toks = [str(t) for t in toks]
            out.append([" ".join(toks[i:i + n])
                        for i in range(len(toks) - n + 1)])
        return frame.with_column(self.getOutputCol(), out)


@_persistable
class HashingTF(HasInputCol, HasOutputCol, Params):
    """Term-frequency vector by the hashing trick — Spark's exact
    murmur3(seed 42) bucket assignment, so indices line up with a real
    Spark pipeline."""

    outputCol = Param("outputCol", "tf vector column", "tf")
    numFeatures = Param("numFeatures", "hash-space width", 1 << 18,
                        validator=lambda v: isinstance(v, int) and v >= 1)
    binary = Param("binary", "presence (1.0) instead of counts", False,
                   validator=lambda v: isinstance(v, bool))

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    def indexOf(self, term) -> int:
        return _hash_index(term, int(self.get_or_default("numFeatures")))

    # dense-output envelope: the frame's vector columns are dense
    # matrices (Spark emits SparseVectors), so cap the allocation
    _MAX_DENSE_BYTES = 2 << 30

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, None)
        m = int(self.get_or_default("numFeatures"))
        binary = self.get_or_default("binary")
        rows = frame.column(self.getInputCol())
        if len(rows) * m * 8 > self._MAX_DENSE_BYTES:
            raise ValueError(
                f"HashingTF would allocate a dense "
                f"{len(rows)}x{m} float64 matrix "
                f"(> {self._MAX_DENSE_BYTES >> 30} GiB). This "
                "framework's vector columns are dense; lower "
                "numFeatures (e.g. 2**12..2**15) or batch the corpus")
        out = np.zeros((len(rows), m))
        for i, toks in enumerate(rows):
            for t in toks:
                j = _hash_index(t, m)
                out[i, j] = 1.0 if binary else out[i, j] + 1.0
        return frame.with_column(self.getOutputCol(), out)


class CountVectorizerParams(HasInputCol, HasOutputCol):
    outputCol = Param("outputCol", "count vector column", "counts")
    vocabSize = Param("vocabSize", "max vocabulary size", 1 << 18,
                      validator=lambda v: isinstance(v, int) and v >= 1)
    minDF = Param("minDF",
                  "min documents a term must appear in (>=1: count; "
                  "<1: fraction)", 1.0, validator=lambda v: v >= 0)
    minTF = Param("minTF",
                  "per-document min term count (>=1) or fraction (<1) "
                  "to keep at transform", 1.0,
                  validator=lambda v: v >= 0)
    binary = Param("binary", "presence instead of counts", False,
                   validator=lambda v: isinstance(v, bool))


@_persistable
class CountVectorizer(CountVectorizerParams):
    """Vocabulary-learned count vectors (Spark semantics: vocabulary
    ordered by corpus term frequency descending, ties alphabetical)."""

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_fit("count_vectorizer")
    def fit(self, dataset) -> "CountVectorizerModel":
        frame = as_vector_frame(dataset, None)
        rows = frame.column(self.getInputCol())
        n_docs = len(rows)
        tf = {}
        df = {}
        for toks in rows:
            seen = set()
            for t in toks:
                t = str(t)
                tf[t] = tf.get(t, 0) + 1
                if t not in seen:
                    seen.add(t)
                    df[t] = df.get(t, 0) + 1
        min_df = float(self.get_or_default("minDF"))
        threshold = min_df if min_df >= 1.0 else min_df * n_docs
        terms = [t for t in tf if df[t] >= threshold]
        terms.sort(key=lambda t: (-tf[t], t))
        vocab = terms[:int(self.get_or_default("vocabSize"))]
        model = CountVectorizerModel(vocabulary=vocab)
        model.uid = self.uid
        model.copy_values_from(self)
        return model


class CountVectorizerModel(CountVectorizerParams):
    def __init__(self, vocabulary: Optional[List[str]] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.vocabulary = vocabulary

    def _copy_internal_state(self, other) -> None:
        other.vocabulary = self.vocabulary

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        frame = as_vector_frame(dataset, None)
        index = {t: i for i, t in enumerate(self.vocabulary)}
        rows = frame.column(self.getInputCol())
        out = np.zeros((len(rows), len(self.vocabulary)))
        min_tf = float(self.get_or_default("minTF"))
        binary = self.get_or_default("binary")
        for i, toks in enumerate(rows):
            toks = [str(t) for t in toks]
            counts = {}
            for t in toks:
                j = index.get(t)
                if j is not None:
                    counts[j] = counts.get(j, 0) + 1
            threshold = min_tf if min_tf >= 1.0 else min_tf * len(toks)
            for j, c in counts.items():
                if c >= threshold:
                    out[i, j] = 1.0 if binary else float(c)
        return frame.with_column(self.getOutputCol(), out)

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_countvec_model

        save_countvec_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "CountVectorizerModel":
        from spark_rapids_ml_tpu_torch.io.persistence import load_countvec_model

        return load_countvec_model(path)


class IDFParams(HasInputCol, HasOutputCol):
    outputCol = Param("outputCol", "tf-idf vector column", "tfidf")
    minDocFreq = Param("minDocFreq",
                       "terms in fewer docs get idf weight 0", 0,
                       validator=lambda v: isinstance(v, int) and v >= 0)


@_persistable
class IDF(IDFParams):
    """Inverse document frequency: idf = log((m+1)/(df+1)) (MLlib)."""

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(uid=uid)
        for name, value in params.items():
            self.set(name, value)

    @observed_fit("idf")
    def fit(self, dataset) -> "IDFModel":
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        m = x.shape[0]
        df = (x > 0).sum(axis=0).astype(np.float64)
        idf = np.log((m + 1.0) / (df + 1.0))
        idf[df < int(self.get_or_default("minDocFreq"))] = 0.0
        model = IDFModel(idf=idf, doc_freq=df, num_docs=m)
        model.uid = self.uid
        model.copy_values_from(self)
        return model


class IDFModel(IDFParams):
    def __init__(self, idf: Optional[np.ndarray] = None,
                 doc_freq: Optional[np.ndarray] = None,
                 num_docs: int = 0, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.idf = idf
        self.doc_freq = doc_freq
        self.num_docs = num_docs

    def _copy_internal_state(self, other) -> None:
        other.idf = self.idf
        other.doc_freq = self.doc_freq
        other.num_docs = self.num_docs

    @observed_transform
    def transform(self, dataset) -> VectorFrame:
        if self.idf is None:
            raise ValueError("IDFModel is unfitted")
        frame = as_vector_frame(dataset, self.getInputCol())
        x = frame.vectors_as_matrix(self.getInputCol())
        return frame.with_column(self.getOutputCol(),
                                 x * self.idf[None, :])

    def save(self, path: str, overwrite: bool = False) -> None:
        from spark_rapids_ml_tpu_torch.io.persistence import save_idf_model

        save_idf_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "IDFModel":
        from spark_rapids_ml_tpu_torch.io.persistence import load_idf_model

        return load_idf_model(path)
