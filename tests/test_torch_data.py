"""The port's data layer and params (data/*, models/params.py) against the
JAX package's: the same batches, the same input classification, the same
param surface, so fits see the same rows and metadata stays compatible."""

import numpy as np
import pandas as pd
import pytest

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu.data import batches as jbatches
from spark_rapids_ml_tpu.data.frame import as_vector_frame as jax_as_frame
from spark_rapids_ml_tpu_torch import PCA
from spark_rapids_ml_tpu_torch.data import batches as tbatches
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame, as_vector_frame
from spark_rapids_ml_tpu_torch.data.vector import Vectors, rows_to_matrix


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def _sources(rng):
    x = rng.normal(size=(150, 5))
    chunks = [x[:17], x[17:90], x[90:]]
    return {
        "matrix": lambda: x,
        "list": lambda: chunks,
        "factory": lambda: (lambda: iter(chunks)),
        "oneshot": lambda: iter(chunks),
    }


@pytest.mark.parametrize("kind", ["matrix", "list", "factory", "oneshot"])
def test_batch_source_yields_the_jax_batches(rng, kind):
    make = _sources(rng)[kind]
    jsrc = jbatches.BatchSource(make(), batch_rows=32)
    tsrc = tbatches.BatchSource(make(), batch_rows=32)
    assert (tsrc.n_features, tsrc.batch_rows, tsrc.reiterable) == (
        jsrc.n_features, jsrc.batch_rows, jsrc.reiterable)
    jb, tb = list(jsrc.batches()), list(tsrc.batches())
    assert len(tb) == len(jb)
    for (b1, m1), (b2, m2) in zip(jb, tb):
        np.testing.assert_array_equal(b1, b2)
        assert (m1 is None) == (m2 is None)
        if m1 is not None:
            np.testing.assert_array_equal(m1, m2)


def test_oneshot_source_refuses_a_second_pass(rng):
    src = tbatches.BatchSource(iter([rng.normal(size=(10, 4))]), batch_rows=8)
    assert not src.reiterable and src.n_features == 4
    list(src.batches())
    with pytest.raises(RuntimeError, match="already consumed"):
        list(src.batches())


def test_shared_underlying_iterator_is_detected(rng):
    shared = (rng.normal(size=(20, 4)) for _ in range(5))
    src = tbatches.BatchSource(lambda: map(np.asarray, shared), batch_rows=16)
    assert src.reiterable
    list(src.batches())
    with pytest.raises(RuntimeError, match="FRESH iterator"):
        list(src.batches())


def test_fake_factory_is_demoted_to_one_shot(rng):
    gen = (rng.normal(size=(10, 3)) for _ in range(3))
    src = tbatches.BatchSource(lambda: gen, batch_rows=8)
    assert not src.reiterable
    assert sum(b.shape[0] if m is None else int(m.sum())
               for b, m in src.batches()) == 30


def test_empty_and_malformed_sources_raise():
    with pytest.raises(ValueError, match="empty"):
        tbatches.BatchSource(iter([]))
    with pytest.raises(ValueError, match="1-D or 2-D"):
        tbatches.BatchSource(iter([np.zeros((2, 2, 2))]))
    with pytest.raises(ValueError, match="features"):
        list(tbatches.BatchSource([np.zeros((3, 4)), np.zeros((3, 5))],
                                  batch_rows=2).batches())


@pytest.mark.parametrize("n", [1, 784, 4096, 100_000])
def test_auto_batch_rows_and_threshold_match_jax(n, monkeypatch):
    assert tbatches.auto_batch_rows(n) == jbatches.auto_batch_rows(n)
    assert tbatches.stream_threshold_bytes() == jbatches.stream_threshold_bytes()
    monkeypatch.setenv("TPUML_STREAM_THRESHOLD_BYTES", "lots")
    with pytest.raises(ValueError):
        tbatches.stream_threshold_bytes()


def test_streaming_source_classifies_inputs_like_jax(rng):
    x = rng.normal(size=(12, 3))
    inputs = [lambda: x, lambda: [x[:6], x[6:]],
              lambda: pd.DataFrame({"features": list(x)}),
              lambda: (lambda: iter([x])), lambda: iter([x])]
    for make in inputs:
        got = tbatches.streaming_source(make())
        want = jbatches.streaming_source(make())
        assert (got is None) == (want is None)
    assert tbatches.streaming_source(VectorFrame({"features": x})) is None


def test_frames_densify_like_jax(rng):
    x = rng.normal(size=(9, 4))
    for data in (x, list(x), pd.DataFrame({"features": list(x)})):
        got = as_vector_frame(data, "features").vectors_as_matrix("features")
        want = jax_as_frame(data, "features").vectors_as_matrix("features")
        np.testing.assert_array_equal(got, want)
    dense = [Vectors.dense(r) for r in x]
    np.testing.assert_array_equal(
        as_vector_frame(dense, "features").vectors_as_matrix("features"), x)
    with pytest.raises(TypeError):
        as_vector_frame("not data", "features")


def test_vectors_and_ragged_rows():
    assert Vectors.sparse(4, [(3, 2.0), (0, 1.0)]) == Vectors.dense(1, 0, 0, 2)
    with pytest.raises(ValueError, match="inconsistent"):
        rows_to_matrix([[1.0, 2.0], [1.0]])
    with pytest.raises(ValueError, match="strictly increasing"):
        Vectors.sparse(3, [2, 1], [1.0, 1.0])


def test_pca_param_surface_matches_jax():
    """Same names and defaults, so saved metadata reads in either package;
    only dtype's 'auto' documents a different resolution."""
    port, ref = PCA(), JaxPCA()
    assert set(port.params()) == set(ref.params())
    assert port.param_map_for_metadata() == ref.param_map_for_metadata()
    est = PCA().setK(3).setInputCol("v")
    twin = est.copy({"k": 4})
    assert (twin.getK(), twin.getInputCol(), twin.uid) == (4, "v", est.uid)
    assert "gramPrecision" in est.explainParams()
    with pytest.raises(ValueError):
        PCA().setGramPrecision("tf32")
    with pytest.raises(AttributeError):
        PCA().setNoSuchParam(1)
