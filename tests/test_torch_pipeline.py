"""Pipeline / PipelineModel and the fused serving program in the port,
against the JAX package's.

* The JAX package's test_pipeline.py behaviours through the port.
* The fused program (one put, one run chaining every stage on the serving
  stream, one fetch) bit-equal to ``run_staged_pipeline`` (each stage its
  own put → run → fetch) at float32 and float64 over ragged batch sizes;
  the labels of a StandardScaler → PCA → KMeans chain equal to the frame
  loop (``PipelineModel.transform``) at float64, and to the JAX package's
  fused program on the same fitted model (carried across by save → load).
* Reduced precision through the stage hooks: bf16 within 0.02 and int8
  within 0.05 (max |Δ| / max |ref|) of native on a PCA-terminal chain.
* The four ways a chain declines to fuse, save / load in both directions,
  and the engine serving the fused pipeline end to end, its kill switch
  (pipeline depth 1 serves the same rows) and feature inference.

The JAX suite runs with x64, so its 'auto' dtype is float64; the port's is
float32: every comparison names its dtype.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu as jax_pkg
from spark_rapids_ml_tpu.models._serving import (
    run_staged_pipeline as jax_run_staged,
)
from spark_rapids_ml_tpu_torch import (
    KMeans,
    LinearRegression,
    LogisticRegression,
    PCA,
    PCAModel,
    Pipeline,
    PipelineModel,
    StandardScaler,
)
from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
from spark_rapids_ml_tpu_torch.data.vector import Vectors
from spark_rapids_ml_tpu_torch.models._serving import run_staged_pipeline
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
from spark_rapids_ml_tpu_torch.serve import ModelRegistry, ServeEngine
from spark_rapids_ml_tpu_torch.serve.registry import _infer_features
from torch_stage_families import FAMILY_ALGOS, stage_family

RAGGED_SIZES = (1, 3, 17, 64, 100)


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def _x(seed=42, n=512, d=16):
    return np.random.default_rng(seed).normal(size=(n, d)) \
        * np.linspace(0.5, 3.0, d) + 1.0


def _labels(x):
    """Binary labels for the classifier chain (the JAX file's
    ``_training_frame`` rule, on the centred rows)."""
    xc = x - x.mean(axis=0)
    return (xc[:, 0] + 0.3 * xc[:, 1] > 0).astype(float)


def _fit_chain(dtype="float32", terminal="kmeans", x=None):
    x = _x() if x is None else x
    stages = [
        StandardScaler().setWithMean(True).setOutputCol("scaled")
        .setDtype(dtype),
        PCA().setK(6).setInputCol("scaled").setOutputCol("reduced")
        .setDtype(dtype),
    ]
    data = x
    if terminal == "kmeans":
        stages.append(KMeans().setK(4).setInputCol("reduced").setSeed(3)
                      .setDtype(dtype))
    elif terminal == "logreg":
        stages.append(LogisticRegression().setInputCol("reduced")
                      .setLabelCol("label").setDtype(dtype))
        data = VectorFrame({"features": x, "label": list(_labels(x))})
    return Pipeline(stages=stages).fit(data), x


def make_frame(rng, n=80, d=10):
    x = rng.normal(size=(n, d))
    w = rng.normal(size=d)
    y = x @ w + 0.1 * rng.normal(size=n)
    return VectorFrame({"features": x, "label": list(y)}), x, y


# -- the JAX package's test_pipeline.py ---------------------------------------

def test_fit_chains_estimators():
    frame, x, y = make_frame(np.random.default_rng(42))
    pca = PCA().setK(6).setOutputCol("pca_features")
    lr = LinearRegression().setInputCol("pca_features").setLabelCol("label") \
        .setRegParam(0.01)
    model = Pipeline(stages=[pca, lr]).fit(frame)
    assert isinstance(model, PipelineModel)
    assert len(model.stages) == 2 and isinstance(model.stages[0], PCAModel)
    pred = np.asarray(model.transform(frame).column("prediction"))
    assert pred.shape == (len(frame),)
    resid = pred - y
    assert float((resid ** 2).mean()) < float((y ** 2).mean())


def test_transformer_stage_passthrough():
    frame, x, _ = make_frame(np.random.default_rng(42))
    pca_model = PCA().setK(4).setOutputCol("p4").fit(frame)
    lr = LinearRegression().setInputCol("p4").setLabelCol("label")
    model = Pipeline(stages=[pca_model, lr]).fit(frame)
    assert model.stages[0] is pca_model
    assert "prediction" in model.transform(frame).columns


def test_empty_pipeline_is_identity():
    frame, _, _ = make_frame(np.random.default_rng(42))
    assert Pipeline(stages=[]).fit(frame).transform(frame) is frame


def test_only_estimators_before_the_last_transform_the_running_data():
    calls = []

    class Tracker:
        def __init__(self, name):
            self.name = name

        def transform(self, dataset):
            calls.append(self.name)
            return dataset

    x = _x()
    model = Pipeline([Tracker("head"), KMeans().setK(2),
                      Tracker("tail")]).fit(x)
    assert calls == ["head"]
    assert [type(s).__name__ for s in model.stages] == \
        ["Tracker", "KMeansModel", "Tracker"]


def test_pipeline_model_persistence_roundtrip(tmp_path):
    frame, _, _ = make_frame(np.random.default_rng(42))
    pca = PCA().setK(5).setOutputCol("pca_features")
    lr = LinearRegression().setInputCol("pca_features").setLabelCol("label") \
        .setRegParam(0.02)
    model = Pipeline(stages=[pca, lr]).fit(frame)
    path = str(tmp_path / "pipe_model")
    model.save(path)
    loaded = PipelineModel.load(path)
    assert loaded.uid == model.uid
    assert [type(s).__name__ for s in loaded.stages] == [
        "PCAModel", "LinearRegressionModel"]
    np.testing.assert_array_equal(loaded.stages[0].pc, model.stages[0].pc)
    np.testing.assert_allclose(
        np.asarray(loaded.transform(frame).column("prediction")),
        np.asarray(model.transform(frame).column("prediction")), atol=1e-12)


def test_unfitted_pipeline_persistence_roundtrip(tmp_path):
    pipe = Pipeline(stages=[PCA().setK(3), LinearRegression().setRegParam(0.5)])
    path = str(tmp_path / "pipe")
    pipe.save(path)
    loaded = Pipeline.load(path)
    assert loaded.uid == pipe.uid
    stages = loaded.getStages()
    assert [type(s).__name__ for s in stages] == ["PCA", "LinearRegression"]
    assert stages[0].getK() == 3
    assert stages[1].getRegParam() == 0.5


def test_load_wrong_kind_raises(tmp_path):
    path = str(tmp_path / "pipe")
    Pipeline(stages=[PCA().setK(2)]).save(path)
    with pytest.raises(ValueError, match="expected a PipelineModel"):
        PipelineModel.load(path)


def test_vector_rows_through_pipeline():
    rows = [
        Vectors.dense(1.0, 0.0, 3.0),
        Vectors.sparse(3, [1], [2.0]),
        Vectors.dense(0.5, 1.5, -1.0),
        Vectors.sparse(3, [0, 2], [1.0, 1.0]),
    ] * 5
    frame = VectorFrame({"features": rows})
    model = Pipeline(stages=[PCA().setK(2).setOutputCol("out")]).fit(frame)
    assert np.asarray(model.transform(frame).column("out")).shape == (20, 2)


def test_fitted_chain_matches_the_jax_fit_at_float64():
    x = _x()
    model, _ = _fit_chain("float64", terminal="pca", x=x)
    jax_model = jax_pkg.Pipeline(stages=[
        jax_pkg.StandardScaler().setWithMean(True).setOutputCol("scaled"),
        jax_pkg.PCA().setK(6).setInputCol("scaled").setOutputCol("reduced"),
    ]).fit(x)
    got = np.asarray(model.transform(x).column("reduced"))
    want = np.asarray(jax_model.transform(x).column("reduced"))
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=0,
                               atol=1e-9 * np.abs(want).max())


# -- fused vs staged ----------------------------------------------------------

@pytest.mark.parametrize("terminal", ["kmeans", "pca", "logreg"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_bit_equal_staged_loop_ragged(dtype, terminal):
    model, x = _fit_chain(dtype, terminal)
    prog = model.serving_transform_program()
    assert prog is not None and prog.algo == "pipeline"
    want = np.int32 if terminal == "kmeans" else np.float64
    for n in RAGGED_SIZES:
        batch = x[:n]
        fused = prog.fetch(prog.run(prog.put(batch)))
        staged = run_staged_pipeline(model, batch)
        assert fused.dtype == staged.dtype == np.dtype(want)
        assert np.array_equal(fused, staged), f"batch size {n}"


def test_staged_reference_runs_no_counted_program():
    model, x = _fit_chain("float64")
    runs = get_registry().counter(
        "sparkml_serve_program_runs_total", "", ("algo", "precision",
                                                 "device"))
    before = {a: runs.value(algo=a, precision="native", device="cpu")
              for a in ("pipeline", "kmeans", "pca", "standard_scaler")}
    run_staged_pipeline(model, x[:10])
    prog = model.serving_transform_program()
    prog.fetch(prog.run(prog.put(x[:10])))
    after = {a: runs.value(algo=a, precision="native", device="cpu")
             for a in before}
    assert {a: after[a] - before[a] for a in before} == {
        "pipeline": 1, "kmeans": 0, "pca": 0, "standard_scaler": 0}


def test_fused_labels_equal_the_frame_loop_at_float64():
    model, x = _fit_chain("float64")
    prog = model.serving_transform_program()
    batch = x[:100]
    fused = prog.fetch(prog.run(prog.put(batch)))
    labels = np.asarray(
        model.transform(batch).column(model.getPredictionCol()))
    np.testing.assert_array_equal(fused, labels)


def _jax_twin(model, tmp_path):
    """The JAX package's PipelineModel of the same fitted stages: each stage
    saved by the port and read by the JAX class's own loader (the JAX
    ``PipelineModel.load`` would import the class the metadata records,
    which for a port-saved stage is the port's)."""
    loaders = {name: getattr(jax_pkg, name) for name in (
        "StandardScalerModel", "PCAModel", "KMeansModel",
        "LogisticRegressionModel", "MinMaxScalerModel", "MaxAbsScalerModel",
        "RobustScalerModel", "Normalizer", "Binarizer",
        "ElementwiseProduct", "VectorSlicer",
        "VarianceThresholdSelectorModel", "ChiSqSelectorModel")}
    stages = []
    for i, stage in enumerate(model.stages):
        path = str(tmp_path / f"stage{i}")
        stage.save(path)
        stages.append(loaders[type(stage).__name__].load(path))
    return jax_pkg.PipelineModel(stages=stages)


def test_fused_labels_equal_the_jax_fused_program(tmp_path):
    model, x = _fit_chain("float64")
    jax_model = _jax_twin(model, tmp_path)
    prog = model.serving_transform_program()
    jax_prog = jax_model.serving_transform_program()
    for n in RAGGED_SIZES:
        batch = x[:n]
        got = prog.fetch(prog.run(prog.put(batch)))
        want = jax_prog.fetch(jax_prog.run(jax_prog.put(batch)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(jax_run_staged(jax_model, batch), got)


@pytest.mark.parametrize("dtype,bar", [("float64", 1e-12),
                                       ("float32", 1e-5)])
def test_classifier_chain_fused_vs_staged_vs_frame_loop(dtype, bar):
    """StandardScaler → PCA → LogisticRegression: the fused program equal
    to the staged loop bit for bit, and its probabilities within ``bar``
    (max |Δ|) of ``PipelineModel.transform``, the frame loop, which scales
    in host float64 and takes σ on the host."""
    model, x = _fit_chain(dtype, "logreg")
    assert [type(s).__name__ for s in model.stages] == [
        "StandardScalerModel", "PCAModel", "LogisticRegressionModel"]
    prog = model.serving_transform_program()
    fused = prog.fetch(prog.run(prog.put(x)))
    assert fused.dtype == np.float64 and fused.shape == (x.shape[0],)
    np.testing.assert_array_equal(fused, run_staged_pipeline(model, x))
    frame = np.asarray(model.transform(x).column(model.getProbabilityCol()))
    assert float(np.max(np.abs(fused - frame))) <= bar
    # the terminal stage's answer column resolves through the pipeline
    assert model.getProbabilityCol() == "probability"


def test_classifier_chain_matches_the_jax_fused_program(tmp_path):
    """The same fitted float64 chain, carried to the JAX package by save →
    load: the JAX fused program and staged loop give the port's
    probabilities within 1e-12."""
    model, x = _fit_chain("float64", "logreg")
    jax_model = _jax_twin(model, tmp_path)
    prog = model.serving_transform_program()
    jax_prog = jax_model.serving_transform_program()
    assert jax_prog is not None and jax_prog.algo == "pipeline"
    for n in RAGGED_SIZES:
        batch = x[:n]
        got = prog.fetch(prog.run(prog.put(batch)))
        want = jax_prog.fetch(jax_prog.run(jax_prog.put(batch)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        np.testing.assert_allclose(jax_run_staged(jax_model, batch), got,
                                   rtol=0, atol=1e-12)


def test_classifier_chain_fit_matches_the_jax_fit_at_float64():
    x = _x()
    model, _ = _fit_chain("float64", "logreg", x=x)
    frame = jax_pkg.data.frame.VectorFrame(
        {"features": x, "label": list(_labels(x))})
    jax_model = jax_pkg.Pipeline(stages=[
        jax_pkg.StandardScaler().setWithMean(True).setOutputCol("scaled"),
        jax_pkg.PCA().setK(6).setInputCol("scaled").setOutputCol("reduced"),
        jax_pkg.LogisticRegression().setInputCol("reduced")
        .setLabelCol("label"),
    ]).fit(frame)
    got = np.asarray(model.transform(x).column("probability"))
    want = np.asarray(jax_model.transform(x).column("probability"))
    # PCA components carry a sign each; the classifier absorbs it
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_pca_kmeans_logreg_stage_hooks_exist():
    """The GEMM families expose the hook too, with terminal-ness matching
    their output type (the JAX file's test of the same name)."""
    x = _x()
    frame = VectorFrame({"features": x, "label": list(_labels(x))})
    pca = PCA().setK(3).fit(frame)
    km = KMeans().setK(2).fit(frame)
    lr = LogisticRegression().setLabelCol("label").fit(frame)
    assert pca.serving_stage().terminal is False
    assert km.serving_stage().terminal is True
    assert lr.serving_stage().terminal is True
    assert lr.serving_stage().fetch_dtype == np.float64


def test_engine_serves_the_classifier_chain_e2e():
    model, x = _fit_chain("float64", "logreg")
    registry = ModelRegistry()
    registry.register("clf_pipe", model)
    engine = ServeEngine(registry, max_batch_rows=128, max_wait_ms=1.0,
                         buckets=(32, 128))
    try:
        engine.warmup("clf_pipe")
        spec = engine._async_specs[("clf_pipe", 1)]
        assert spec is not None and spec.algo == "pipeline"
        sizes = [1, 7, 32, 64, 100, 13]
        expected = {n: run_staged_pipeline(model, x[:n]) for n in set(sizes)}

        def one(n):
            return n, engine.predict("clf_pipe", x[:n])

        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            for n, out in pool.map(one, sizes * 3):
                assert out.dtype == np.float64
                np.testing.assert_array_equal(out, expected[n],
                                              err_msg=f"size {n}")
    finally:
        engine.shutdown()


def test_float32_fused_labels_near_the_frame_loop():
    """The frame loop scales in host float64, the fused program in float32
    on the device: only near-tie rows may flip."""
    model, x = _fit_chain("float32")
    prog = model.serving_transform_program()
    fused = prog.fetch(prog.run(prog.put(x)))
    labels = np.asarray(model.transform(x).column("prediction"))
    assert np.mean(fused != labels) <= 1e-3


@pytest.mark.parametrize("precision,bar", [("bf16", 0.02), ("int8", 0.05)])
def test_reduced_precision_composes_through_fusion(precision, bar):
    model, x = _fit_chain("float64", terminal="pca")
    native = model.serving_transform_program()
    reduced = model.serving_transform_program(precision=precision)
    assert reduced is not None and reduced.precision == precision
    batch = x[:64]
    ref = native.fetch(native.run(native.put(batch)))
    red = reduced.fetch(reduced.run(reduced.put(batch.copy())))
    assert ref.shape == red.shape
    scale = float(np.max(np.abs(ref))) or 1.0
    assert float(np.max(np.abs(ref - red))) / scale < bar
    np.testing.assert_array_equal(
        red, run_staged_pipeline(model, batch, precision=precision))


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_reduced_precision_labels_on_blobs(precision):
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(4, 16)) * 8.0
    x = centers[rng.integers(0, 4, 400)] + rng.normal(size=(400, 16))
    model, _ = _fit_chain("float32", x=x)
    native = model.serving_transform_program()
    reduced = model.serving_transform_program(precision)
    ref = native.fetch(native.run(native.put(x)))
    red = reduced.fetch(reduced.run(reduced.put(x)))
    assert red.dtype == np.int32
    assert np.mean(ref != red) <= 0.01


# -- declining ----------------------------------------------------------------

def test_unwired_pipeline_declines_fusion():
    x = _x()
    model = Pipeline(stages=[
        StandardScaler().setWithMean(True).setOutputCol("scaled"),
        PCA().setK(4),  # reads "features": NOT the scaler output
    ]).fit(x)
    assert model.serving_transform_program() is None
    assert model.serving_stages() is None


def test_terminal_stage_mid_chain_declines():
    x = _x()
    km = KMeans().setK(2).fit(x)
    scaler = StandardScaler().fit(x)
    model = PipelineModel(stages=[km, scaler])
    assert model.serving_transform_program() is None
    with pytest.raises(ValueError, match="fusable"):
        run_staged_pipeline(model, x[:4])


def test_host_path_stage_declines():
    x = _x()
    pca = PCA().setK(4).setInputCol("scaled").setOutputCol("r") \
        .setUseXlaDot(False).fit(VectorFrame({"scaled": x}))
    scaler = StandardScaler().setWithMean(True).setOutputCol("scaled").fit(x)
    assert PipelineModel(stages=[scaler, pca]).serving_transform_program() \
        is None


def test_empty_and_unfusable_stage_pipelines_decline():
    assert PipelineModel(stages=[]).serving_transform_program() is None

    class Opaque:
        def transform(self, dataset):
            return dataset

    assert PipelineModel(stages=[Opaque()]).serving_transform_program() \
        is None


# -- persistence in both directions -------------------------------------------

def test_port_pipeline_stages_load_in_jax(tmp_path):
    model, x = _fit_chain("float64")
    path = str(tmp_path / "p")
    model.save(path)
    jax_model = _jax_twin(model, tmp_path)
    assert [type(s).__module__ for s in jax_model.stages] == [
        "spark_rapids_ml_tpu.models.scaler",
        "spark_rapids_ml_tpu.models.pca",
        "spark_rapids_ml_tpu.models.kmeans"]
    np.testing.assert_array_equal(
        np.asarray(jax_model.transform(x).column("prediction")),
        np.asarray(model.transform(x).column("prediction")))


def test_jax_pipeline_loads_in_the_port(tmp_path):
    x = _x()
    jax_model = jax_pkg.Pipeline(stages=[
        jax_pkg.StandardScaler().setWithMean(True).setOutputCol("scaled"),
        jax_pkg.PCA().setK(6).setInputCol("scaled").setOutputCol("reduced"),
        jax_pkg.KMeans().setK(4).setInputCol("reduced").setSeed(3),
    ]).fit(x)
    path = str(tmp_path / "jax")
    jax_model.save(path)
    back = PipelineModel.load(path)
    assert back.uid == jax_model.uid
    assert [type(s).__module__ for s in back.stages] == [
        "spark_rapids_ml_tpu_torch.models.scaler",
        "spark_rapids_ml_tpu_torch.models.pca",
        "spark_rapids_ml_tpu_torch.models.kmeans"]
    np.testing.assert_array_equal(back.stages[1].pc, jax_model.stages[1].pc)
    f64 = PipelineModel(stages=[s.copy({"dtype": "float64"})
                                for s in back.stages])
    np.testing.assert_array_equal(
        np.asarray(f64.transform(x).column("prediction")),
        np.asarray(jax_model.transform(x).column("prediction")))
    prog = f64.serving_transform_program()
    np.testing.assert_array_equal(
        prog.fetch(prog.run(prog.put(x[:50]))),
        np.asarray(jax_model.transform(x[:50]).column("prediction")))


def test_jax_unfitted_pipeline_loads_in_the_port(tmp_path):
    path = str(tmp_path / "pipe")
    jax_pkg.Pipeline(stages=[jax_pkg.StandardScaler().setWithMean(True),
                             jax_pkg.KMeans().setK(5)]).save(path)
    loaded = Pipeline.load(path)
    stages = loaded.getStages()
    assert [type(s) for s in stages] == [StandardScaler, KMeans]
    assert stages[0].getWithMean() is True and stages[1].getK() == 5


# -- the engine ---------------------------------------------------------------

def test_engine_serves_fused_pipeline_e2e():
    model, x = _fit_chain("float64")
    registry = ModelRegistry()
    registry.register("fused_pipe", model)
    engine = ServeEngine(registry, max_batch_rows=128, max_wait_ms=1.0,
                         buckets=(32, 128))
    try:
        report = engine.warmup("fused_pipe")
        assert sorted(report["pipeline"]["buckets"]) == [32, 128]
        spec = engine._async_specs[("fused_pipe", 1)]
        assert spec is not None and spec.algo == "pipeline"
        prog = spec.program
        direct = prog.fetch(prog.run(prog.put(x[:32])))
        assert np.array_equal(engine.predict("fused_pipe", x[:32]), direct)
        sizes = [1, 7, 32, 64, 100, 13, 2, 90]
        expected = {n: run_staged_pipeline(model, x[:n]) for n in set(sizes)}

        def one(n):
            return n, engine.predict("fused_pipe", x[:n])

        with concurrent.futures.ThreadPoolExecutor(6) as pool:
            for n, out in pool.map(one, sizes * 4):
                assert out.dtype == np.int32
                np.testing.assert_array_equal(out, expected[n],
                                              err_msg=f"size {n}")
    finally:
        engine.shutdown()


def test_engine_staged_kill_switch_serves_same_rows():
    model, x = _fit_chain("float64")
    registry = ModelRegistry()
    registry.register("staged_pipe", model)
    engine = ServeEngine(registry, max_batch_rows=128, max_wait_ms=1.0,
                         pipeline_depth=1)
    try:
        out = engine.predict("staged_pipe", x[:20])
        assert engine._async_specs[("staged_pipe", 1)] is None
        np.testing.assert_array_equal(out,
                                      run_staged_pipeline(model, x[:20]))
    finally:
        engine.shutdown()


def test_engine_serves_pipeline_kmeans_and_pca_under_their_algos():
    model, x = _fit_chain("float64")
    km = KMeans().setK(3).setDtype("float64").fit(x)
    pca = PCA().setK(4).setDtype("float64").fit(x)
    registry = ModelRegistry()
    for name, m in (("pipe", model), ("km", km), ("pca", pca)):
        registry.register(name, m)
    engine = ServeEngine(registry, max_batch_rows=64, max_wait_ms=1.0)
    runs = get_registry().counter(
        "sparkml_serve_program_runs_total", "", ("algo", "precision",
                                                 "device"))
    before = {a: runs.value(algo=a, precision="native", device="cpu")
              for a in ("pipeline", "kmeans", "pca")}
    try:
        labels = engine.predict("km", x[:9])
        assert labels.dtype == np.int32
        np.testing.assert_array_equal(
            labels, np.asarray(km.transform(x[:9]).column("prediction")))
        np.testing.assert_allclose(engine.predict("pca", x[:9]),
                                   x[:9] @ pca.pc, rtol=1e-12)
        engine.predict("pipe", x[:9])
    finally:
        engine.shutdown()
    for algo in before:
        assert runs.value(algo=algo, precision="native", device="cpu") > \
            before[algo], algo


def test_engine_precision_guard_runs_for_pipelines():
    model, x = _fit_chain("float64", terminal="pca")
    labelled, _ = _fit_chain("float64")
    registry = ModelRegistry()
    registry.register("prec_pipe", model)
    registry.register("label_pipe", labelled)
    engine = ServeEngine(registry, max_batch_rows=64, max_wait_ms=1.0,
                         precision="bf16")
    try:
        out = engine.predict("prec_pipe", x[:16])
        spec = engine._async_specs[("prec_pipe", 1)]
        assert spec is not None and spec.precision == "bf16"
        staged = run_staged_pipeline(model, x[:16])
        scale = float(np.max(np.abs(staged))) or 1.0
        assert float(np.max(np.abs(out - staged))) / scale < 0.05
        engine.predict("label_pipe", x[:16])
        check = engine.precision_checks[("label_pipe", 1, "bf16")]
        # labels are checked by their mismatch fraction
        assert check["verdict"] in ("pass", "fail")
        assert 0.0 <= check["error"] <= 1.0
        served = engine._async_specs[("label_pipe", 1)].precision
        assert served == ("bf16" if check["verdict"] == "pass" else "native")
    finally:
        engine.shutdown()


def test_registry_infers_pipeline_features(tmp_path):
    model, _ = _fit_chain()
    assert _infer_features(model) == 16
    path = str(tmp_path / "p")
    model.save(path)
    registry = ModelRegistry()
    registry.load("p", path)
    report = registry.warmup("p", buckets=(4,))
    assert list(report["buckets"]) == [4]


def test_stage_weights_share_one_device_and_dtype():
    model, _ = _fit_chain("float64")
    device, dtype, specs = model.serving_stages()
    assert dtype == torch.float64 and device == torch.device("cpu")
    assert [s.algo for s in specs] == ["standard_scaler", "pca", "kmeans"]
    prog = model.serving_transform_program()
    assert prog.weight_bytes == sum(
        w.nbytes for s in specs for w in s.weights)


# -- the other stage families (models/feature_scalers.py and
# -- models/feature_transformers.py) -------------------------------------------

@pytest.fixture
def isolated_registries(monkeypatch):
    """Metrics registries of this test's own, in both packages, with the
    singletons bound to them made anew on both sides of the swap."""
    from spark_rapids_ml_tpu.obs import devmon as jax_devmon
    from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
    from spark_rapids_ml_tpu.obs import metrics as jax_metrics
    from spark_rapids_ml_tpu_torch.obs import devmon, fitmon, metrics

    monkeypatch.setattr(metrics, "_default_registry",
                        metrics.MetricsRegistry())
    monkeypatch.setattr(jax_metrics, "_default_registry",
                        jax_metrics.MetricsRegistry())
    resets = (devmon.reset_device_monitor, jax_devmon.reset_device_monitor,
              fitmon.reset_fitmon, jax_fitmon.reset_fitmon)
    for reset in resets:
        reset()
    yield
    for reset in resets:
        reset()


def _port_body(model, x, dtype):
    spec = model.serving_stage(device=torch.device("cpu"), dtype=dtype)
    return spec.algo, spec.fn(torch.as_tensor(x, dtype=dtype),
                              *spec.weights).numpy()


def _jax_body(model, x, dtype):
    """The JAX stage body jitted on the CPU, as the JAX parity test runs
    it."""
    import jax
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.obs.xprof import tracked_jit

    spec = model.serving_stage(device=jax.devices()[0], dtype=dtype)
    kernel = tracked_jit(spec.fn, label=f"stage_test_{spec.algo}")
    return spec.algo, np.asarray(kernel(
        jax.device_put(jnp.asarray(x, dtype=dtype)), *spec.weights))


@pytest.mark.parametrize("algo", FAMILY_ALGOS)
def test_stage_family_parity_with_host_and_jax_bodies(algo, tmp_path,
                                                      isolated_registries):
    """The counterpart of the JAX file's family parity test, for each of
    its nine families: the port's body at float64 equals the port's host
    transform and the JAX body on the same state (carried across by save →
    the JAX class's load), bit for bit, Normalizer within 1e-12 relative
    (its row sums run in another order); at float32 it is within 1e-6
    relative of the JAX float32 body."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    x = rng.normal(size=(64, 8))
    x[:, 3] = 0.0  # a constant column meets every zero-spread path
    model = stage_family(algo, x)
    twin = _jax_twin(PipelineModel(stages=[model]), tmp_path).stages[0]
    name, got = _port_body(model, x, torch.float64)
    jax_name, want = _jax_body(twin, x, jnp.float64)
    assert name == jax_name == algo
    host = np.asarray(model.transform(x).column(model.getOutputCol()))
    if algo == "normalizer":
        np.testing.assert_allclose(got, host, rtol=1e-12, atol=0)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(got, host)
        np.testing.assert_array_equal(got, want)
    _, got32 = _port_body(model, x, torch.float32)
    _, want32 = _jax_body(twin, x, jnp.float32)
    assert got32.dtype == np.float32
    assert float(np.abs(got32 - want32).max()) <= \
        1e-6 * float(np.abs(want32).max())


def _stage_chain_rows(seed=17, n=512, d=16):
    x = _x(seed, n, d)
    x[:, 5] = 2.5   # constant columns, planted
    x[:, 12] = 2.5
    return x


def _fit_stage_chain(kind, dtype="float32"):
    """The two chains at small size: ``classifier`` is MinMaxScaler →
    ElementwiseProduct → VectorSlicer(15) → PCA(4) → LogisticRegression,
    ``clustering`` is RobustScaler(withCentering) → MaxAbsScaler →
    Normalizer → VarianceThresholdSelector → PCA(4) → KMeans(3)."""
    import spark_rapids_ml_tpu_torch as port

    x = _stage_chain_rows()
    d = x.shape[1]
    rng = np.random.default_rng(23)
    pca = PCA().setK(4).setOutputCol("reduced").setDtype(dtype)
    if kind == "classifier":
        stages = [
            port.MinMaxScaler().setOutputCol("boxed"),
            port.ElementwiseProduct(scalingVec=rng.normal(size=d).tolist())
            .setInputCol("boxed").setOutputCol("weighted"),
            port.VectorSlicer(
                indices=[int(i) for i in rng.permutation(d)[:d - 1]])
            .setInputCol("weighted").setOutputCol("sliced"),
            pca.setInputCol("sliced"),
            LogisticRegression().setInputCol("reduced").setLabelCol("label")
            .setDtype(dtype),
        ]
        data = VectorFrame({"features": x, "label": list(_labels(x))})
    else:
        stages = [
            port.RobustScaler().setWithCentering(True).setOutputCol("robust"),
            port.MaxAbsScaler().setInputCol("robust").setOutputCol("boxed"),
            port.Normalizer().setInputCol("boxed").setOutputCol("normed"),
            port.VarianceThresholdSelector().setInputCol("normed")
            .setOutputCol("selected"),
            pca.setInputCol("selected"),
            KMeans().setK(3).setInputCol("reduced").setSeed(3)
            .setDtype(dtype),
        ]
        data = x
    return Pipeline(stages=stages).fit(data), x


STAGE_CHAINS = ("classifier", "clustering")


@pytest.mark.parametrize("kind", STAGE_CHAINS)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_stage_chains_fused_bit_equal_staged(kind, dtype,
                                             isolated_registries):
    model, x = _fit_stage_chain(kind, dtype)
    if kind == "clustering":
        # the selector drops exactly the two planted constant columns
        assert model.stages[3].selected_features.tolist() == [
            j for j in range(16) if j not in (5, 12)]
    prog = model.serving_transform_program()
    assert prog is not None and prog.algo == "pipeline"
    want = np.int32 if kind == "clustering" else np.float64
    for n in RAGGED_SIZES:
        batch = x[:n]
        fused = prog.fetch(prog.run(prog.put(batch)))
        staged = run_staged_pipeline(model, batch)
        assert fused.dtype == staged.dtype == np.dtype(want)
        assert np.array_equal(fused, staged), f"batch size {n}"


@pytest.mark.parametrize("kind", STAGE_CHAINS)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_stage_chains_near_the_frame_loop(kind, dtype, isolated_registries):
    """Within the bars of the StandardScaler chains against
    ``PipelineModel.transform``, which scales in host float64: classifier
    probabilities 1e-12 (float64) and 1e-5 (float32) max |Δ|; KMeans
    labels equal at float64 and mismatched on at most 1e-3 of the rows at
    float32."""
    model, x = _fit_stage_chain(kind, dtype)
    prog = model.serving_transform_program()
    fused = prog.fetch(prog.run(prog.put(x)))
    if kind == "classifier":
        frame = np.asarray(model.transform(x).column("probability"))
        bar = 1e-12 if dtype == "float64" else 1e-5
        assert float(np.max(np.abs(fused - frame))) <= bar
    else:
        frame = np.asarray(model.transform(x).column("prediction"))
        assert np.mean(fused != frame) <= (0.0 if dtype == "float64"
                                           else 1e-3)


@pytest.mark.parametrize("kind", STAGE_CHAINS)
def test_stage_chains_match_the_jax_fused_program(kind, tmp_path,
                                                  isolated_registries):
    model, x = _fit_stage_chain(kind, "float64")
    jax_model = _jax_twin(model, tmp_path)
    assert [type(s).__name__ for s in jax_model.stages] == [
        type(s).__name__ for s in model.stages]
    prog = model.serving_transform_program()
    jax_prog = jax_model.serving_transform_program()
    assert jax_prog is not None and jax_prog.algo == "pipeline"
    for n in RAGGED_SIZES:
        batch = x[:n]
        got = prog.fetch(prog.run(prog.put(batch)))
        want = jax_prog.fetch(jax_prog.run(jax_prog.put(batch)))
        if kind == "clustering":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", STAGE_CHAINS)
def test_engine_serves_the_stage_chains_e2e(kind, isolated_registries):
    model, x = _fit_stage_chain(kind, "float64")
    registry = ModelRegistry()
    registry.register("chain", model)
    engine = ServeEngine(registry, max_batch_rows=128, max_wait_ms=1.0,
                         buckets=(32, 128))
    try:
        report = engine.warmup("chain")  # infers 16 features from the head
        assert sorted(report["pipeline"]["buckets"]) == [32, 128]
        spec = engine._async_specs[("chain", 1)]
        assert spec is not None and spec.algo == "pipeline"
        sizes = [1, 7, 32, 100, 13]
        expected = {n: run_staged_pipeline(model, x[:n]) for n in sizes}

        def one(n):
            return n, engine.predict("chain", x[:n])

        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            for n, out in pool.map(one, sizes * 2):
                np.testing.assert_array_equal(out, expected[n],
                                              err_msg=f"size {n}")
    finally:
        engine.shutdown()


@pytest.mark.parametrize("algo,width", [
    ("min_max_scaler", 8), ("max_abs_scaler", 8), ("robust_scaler", 8),
    ("normalizer", 8), ("binarizer", 8), ("elementwise_product", None),
    ("vector_slicer", None), ("feature_selector", None)])
def test_infer_features_on_a_pipeline_headed_by_each_family(
        algo, width, tmp_path, isolated_registries):
    """MinMax, MaxAbs and Robust give their width; a Normalizer or
    Binarizer head is looked past to the stage behind it; any other
    stateless head gives None — as the JAX ``_infer_features`` does on the
    same pipeline."""
    from spark_rapids_ml_tpu.serve.registry import (
        _infer_features as jax_infer,
    )

    x = np.random.default_rng(13).normal(size=(64, 8))
    head = stage_family(algo, x)
    model = PipelineModel(stages=[
        head, StandardScaler().setInputCol(head.getOutputCol()).fit(
            VectorFrame({head.getOutputCol(): x}))])
    assert _infer_features(model) == width
    assert jax_infer(_jax_twin(model, tmp_path)) == width


@pytest.mark.parametrize("head", ["vector_slicer", "feature_selector"])
def test_a_narrow_request_to_a_gather_head_fails_alone(head,
                                                       isolated_registries):
    """A request narrower than a gather head's largest index gets an error
    answer before the gather runs (on a CUDA tensor an out-of-range index
    would fire a device-side assert that poisons the process's CUDA
    context), and the next good request still serves."""
    import spark_rapids_ml_tpu_torch as port

    x = _stage_chain_rows()
    head_stage = (stage_family(head, x) if head == "vector_slicer"
                  else port.VarianceThresholdSelector())
    model = Pipeline(stages=[
        head_stage,
        PCA().setK(3).setInputCol(head_stage.getOutputCol())
        .setDtype("float64"),
    ]).fit(VectorFrame({"features": x}))
    gather = model.stages[0]
    widest = int(max(gather.get_or_default("indices")
                     if head == "vector_slicer"
                     else gather.selected_features))
    assert widest >= 3
    registry = ModelRegistry()
    registry.register("chain", model)
    engine = ServeEngine(registry, max_batch_rows=128, max_wait_ms=1.0,
                         buckets=(32, 128))
    try:
        engine.warmup("chain", n_features=x.shape[1])
        with pytest.raises(ValueError, match=f"has no column {widest}"):
            engine.predict("chain", x[:4, :widest])
        np.testing.assert_array_equal(engine.predict("chain", x[:7]),
                                      run_staged_pipeline(model, x[:7]))
    finally:
        engine.shutdown()
