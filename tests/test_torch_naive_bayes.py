"""NaiveBayes in the port against the JAX package's, on the same seeded
numpy inputs.

``models/naive_bayes.py``, ``parallel/distributed_nb.py``, the Spark front
end (``spark/estimator.py::NaiveBayes``, ``spark/adapter.py::
NaiveBayesModel``) and the NaiveBayes writer of ``io/persistence.py``.
Bars:

* the local fit, every model type, weighted and not: float64 within
  1e-12 of the JAX fit at float64; float32 (products taken in float64 and
  rounded once) within 1e-5 of the JAX float32 fit with predictions
  equal; the host route (``useXlaDot=False``) within 1e-12;
* ``distributed_nb_fit`` in gloo worlds of 1, 2 and 4 ranks: float64
  within 1e-12 of the port's local fit and of JAX's ``distributed_nb_fit``
  on its 8-device CPU mesh (as ``tests/test_distributed.py`` runs it);
  float32 within 1e-5; every rank equal to rank 0;
* the Spark front ends in both local engines: equal, predictions too;
* persistence both ways, ``load_model``, ``ModelRegistry.load`` →
  ``ServeEngine.predict``.

This file is also the worker script of the gloo worlds (``__main__`` at
the bottom): the JAX package is imported only inside the tests, never at
module level, so a worker imports the port alone.
"""

import functools
import os
import signal
import subprocess
import sys
import tempfile

import numpy as np
import pytest

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("multinomial", "complement", "bernoulli", "gaussian")
WORLDS = (1, 2, 4)
WORLD_TIMEOUT_S = 120
ROWS, D, K = 301, 10, 3
F64_TOL = 1e-12
F32_TOL = 1e-5


def _data(kind, seed=0, rows=ROWS, d=D, k=K):
    """(x, y, w): features valid for ``kind`` with class-dependent
    profiles, labels in 0..k-1 (uneven rows over every world), positive
    weights."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, size=rows).astype(np.float64)
    profile = rng.uniform(0.5, 4.0, size=(k, d))[y.astype(int)]
    if kind == "bernoulli":
        x = (rng.random(size=(rows, d)) < profile / 5.0).astype(np.float64)
    elif kind == "gaussian":
        x = rng.normal(size=(rows, d)) + profile
    else:
        x = rng.poisson(profile).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=rows)
    return x, y, w


# -- the worker: one rank of a world (imports only the port) ------------------

def _worker_cases():
    """name → (model type, weighted, numpy dtype)."""
    cases = {f"{kind}/f64": (kind, False, np.float64) for kind in KINDS}
    cases.update({f"{kind}/f32": (kind, False, np.float32)
                  for kind in KINDS})
    cases["multinomial/weighted"] = ("multinomial", True, np.float64)
    return cases


def _worker(out_dir):
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.obs import fitmon
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        device_count,
        distributed_nb_fit,
        initialize_multihost,
    )

    out = {}
    initialize_multihost()
    out["backend"] = np.asarray(dist.get_backend())
    mesh = data_mesh(device_count())
    monitor = fitmon.get_fit_monitor()
    for case, (kind, weighted, dtype) in _worker_cases().items():
        x, y, w = _data(kind)
        model = distributed_nb_fit(x, y, mesh, model_type=kind,
                                   weights=w if weighted else None,
                                   dtype=dtype)
        out[f"{case}/pi"] = model.pi
        out[f"{case}/theta"] = model.theta
        out[f"{case}/sigma"] = (model.sigma if model.sigma is not None
                                else np.zeros(0))
        out[f"{case}/classes"] = model.classes_
        report = model.fit_report_
        out[f"{case}/phases"] = np.asarray(sorted(report.phases))
        out[f"{case}/collectives"] = np.asarray([
            (c["count"], c["bytes"])
            for _kind, c in sorted(report.collectives.items())])
        run = monitor.recent_runs()[0]
        out[f"{case}/run"] = np.asarray([run.algo, run.status])
        out[f"{case}/steps"] = np.asarray(
            [(s["step"], s["rows"]) for s in run.steps])
    out["jax_imported"] = np.asarray(sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "spark_rapids_ml_tpu" or m.startswith("spark_rapids_ml_tpu.")))
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def _launch(nprocs, out_dir, log):
    """The port's launcher in a process group of its own (so a timeout can
    kill every rank)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_DIR + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "spark_rapids_ml_tpu_torch.launch",
           "--nprocs", str(nprocs),
           "--env", "SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu",
           "--env", "OMP_NUM_THREADS=1",
           os.path.abspath(__file__), out_dir]
    return subprocess.Popen(cmd, cwd=REPO_DIR, env=env, stdout=log,
                            stderr=subprocess.STDOUT, start_new_session=True)


def _wait(proc, timeout):
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        return None


@pytest.fixture(scope="module")
def worlds():
    """{world size: [rank 0's results, rank 1's, ...]} from the three
    worlds, started together."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for w in WORLDS:
            out_dir = os.path.join(tmp, f"world{w}")
            os.makedirs(out_dir)
            log = open(os.path.join(tmp, f"world{w}.log"), "w")
            procs[w] = (log, _launch(w, out_dir, log))
        results = {}
        for w, (log, proc) in procs.items():
            rc = _wait(proc, WORLD_TIMEOUT_S)
            log.close()
            with open(log.name) as f:
                text = f.read()
            assert rc == 0, f"world of {w}: exit {rc}\n{text[-4000:]}"
            results[w] = []
            for rank in range(w):
                path = os.path.join(tmp, f"world{w}", f"rank{rank}.npz")
                with np.load(path) as z:
                    results[w].append({k: z[k] for k in z.files})
    return results


# -- the test process ------------------------------------------------------------

@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """The CPU requested, and metrics registries of this test's own in both
    packages (the fits' ``observed_fit`` and the transforms'
    ``observed_transform`` write into them)."""
    from spark_rapids_ml_tpu.obs import devmon as jax_devmon
    from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
    from spark_rapids_ml_tpu.obs import metrics as jax_metrics
    from spark_rapids_ml_tpu_torch.obs import devmon, fitmon, metrics

    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
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


def _frame(pkg, x, y, w=None):
    if pkg == "port":
        from spark_rapids_ml_tpu_torch.data.frame import as_vector_frame
    else:
        from spark_rapids_ml_tpu.data.frame import as_vector_frame
    frame = as_vector_frame(x, "features").with_column("label", y.tolist())
    return frame if w is None else frame.with_column("wt", w.tolist())


def _fit(pkg, kind, x, y, w=None, dtype="float64", host=False,
         smoothing=1.0):
    if pkg == "port":
        from spark_rapids_ml_tpu_torch import NaiveBayes
    else:
        from spark_rapids_ml_tpu import NaiveBayes
    est = NaiveBayes().setModelType(kind).setDtype(dtype) \
        .setSmoothing(smoothing)
    if host:
        est = est.setUseXlaDot(False)
    if w is not None:
        est = est.setWeightCol("wt")
    return est.fit(_frame(pkg, x, y, w))


def _assert_model_close(got, want, atol):
    np.testing.assert_array_equal(got.classes_, want.classes_)
    np.testing.assert_allclose(got.pi, want.pi, atol=atol, rtol=0)
    np.testing.assert_allclose(got.theta, want.theta, atol=atol, rtol=0)
    assert (got.sigma is None) == (want.sigma is None)
    if want.sigma is not None:
        np.testing.assert_allclose(got.sigma, want.sigma, atol=atol,
                                   rtol=atol)


def _prediction(model, x):
    return np.asarray(model.transform(x).column("prediction"))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_local_fit_float64_matches_jax(kind, weighted):
    x, y, w = _data(kind)
    w = w if weighted else None
    got = _fit("port", kind, x, y, w)
    want = _fit("jax", kind, x, y, w)
    _assert_model_close(got, want, F64_TOL)
    np.testing.assert_allclose(got.predict_proba(x), want.predict_proba(x),
                               atol=F64_TOL, rtol=0)
    assert np.array_equal(_prediction(got, x), _prediction(want, x))
    assert got.fit_report_ is not None
    assert set(got.fit_timings_) >= {"densify", "fit"}


@pytest.mark.parametrize("kind", KINDS)
def test_local_fit_float32_matches_jax(kind):
    x, y, _w = _data(kind, seed=1)
    got = _fit("port", kind, x, y, dtype="float32")
    want = _fit("jax", kind, x, y, dtype="float32")
    _assert_model_close(got, want, F32_TOL)
    assert np.array_equal(_prediction(got, x), _prediction(want, x))
    # the float32 statistics are float64 products rounded once: the
    # float64 fit of the rounded inputs, within float32 rounding
    exact = _fit("port", kind, x.astype(np.float32).astype(np.float64), y)
    _assert_model_close(got, exact, F32_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_host_route_matches_jax(kind):
    x, y, w = _data(kind, seed=2)
    got = _fit("port", kind, x, y, w, host=True)
    want = _fit("jax", kind, x, y, w, host=True)
    _assert_model_close(got, want, F64_TOL)


def test_weight_col_equals_duplication():
    from spark_rapids_ml_tpu_torch import NaiveBayes

    x, y, _w = _data("multinomial", rows=120)
    w = np.random.default_rng(3).integers(1, 4, size=120).astype(float)
    weighted = _fit("port", "multinomial", x, y, w)
    reps = np.repeat(np.arange(120), w.astype(int))
    dup = NaiveBayes().setDtype("float64").fit(x[reps], labels=y[reps])
    _assert_model_close(weighted, dup, F64_TOL)


@pytest.mark.parametrize("case", ["negative", "bernoulli", "weights",
                                  "labels", "model_type"])
def test_invalid_inputs_raise_as_jax_does(case):
    from spark_rapids_ml_tpu.models import naive_bayes as jax_nb
    from spark_rapids_ml_tpu_torch.models import naive_bayes as port_nb

    x, y, w = _data("gaussian", rows=40)
    args = {"negative": (x - 10.0, y, None, "multinomial"),
            "bernoulli": (x, y, None, "bernoulli"),
            "weights": (np.abs(x), y, -w, "multinomial"),
            "labels": (np.abs(x), y[:-1], None, "complement"),
            "model_type": (np.abs(x), y, None, "poisson")}[case]
    messages = []
    for mod in (port_nb, jax_nb):
        with pytest.raises(ValueError) as err:
            mod._prepare_nb_inputs(*args)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_class_products_take_float32_in_float64_rounded_once():
    import torch

    from spark_rapids_ml_tpu_torch.models.naive_bayes import class_products

    x, y, _w = _data("gaussian")
    oh = np.eye(K)[y.astype(int)]
    xt = torch.as_tensor(x, dtype=torch.float32)
    ot = torch.as_tensor(oh, dtype=torch.float32)
    counts, sums, sq = class_products(xt, ot, need_sq=True)
    assert counts.dtype == sums.dtype == sq.dtype == torch.float32
    x32 = xt.double()
    assert torch.equal(sums, (ot.double().T @ x32).float())
    assert torch.equal(sq, (ot.double().T @ (xt * xt).double()).float())
    assert torch.equal(counts, ot.sum(dim=0))
    assert class_products(xt, ot, need_sq=False)[2] is None


# -- across ranks --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_distributed(case):
    """(pi, theta, sigma, collective (count, bytes), step names) of the
    JAX ``distributed_nb_fit`` on its 8-device CPU mesh."""
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.parallel import data_mesh, distributed_nb_fit

    kind, weighted, dtype = _worker_cases()[case]
    x, y, w = _data(kind)
    model = distributed_nb_fit(
        x, y, data_mesh(8), model_type=kind,
        weights=w if weighted else None,
        dtype=jnp.float64 if dtype == np.float64 else jnp.float32)
    reduce = model.fit_report_.collectives["all_reduce"]
    return (model.pi, model.theta, model.sigma,
            (reduce["count"], reduce["bytes"]))


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_equals_rank_0_and_imports_only_the_port(worlds, world):
    ranks = worlds[world]
    assert len(ranks) == world
    for results in ranks:
        assert results["jax_imported"].size == 0, results["jax_imported"]
        assert str(results["backend"]) == "gloo"
        assert set(results) == set(ranks[0])
        for key, value in results.items():
            assert np.array_equal(value, ranks[0][key]), key


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(_worker_cases()))
def test_distributed_fit_matches_local_and_jax(worlds, world, case):
    from spark_rapids_ml_tpu_torch.models.naive_bayes import NaiveBayesModel

    kind, weighted, dtype = _worker_cases()[case]
    results = worlds[world][0]
    sigma = results[f"{case}/sigma"]
    got = NaiveBayesModel(pi=results[f"{case}/pi"],
                          theta=results[f"{case}/theta"],
                          sigma=sigma if sigma.size else None,
                          classes=results[f"{case}/classes"])
    x, y, w = _data(kind)
    tol = F64_TOL if dtype == np.float64 else F32_TOL
    local = _fit("port", kind, x, y, w if weighted else None,
                 dtype="float64" if dtype == np.float64 else "float32")
    _assert_model_close(got, local, tol)
    if world == 1 and dtype == np.float32:
        # one rank reduces nothing: the local float32 fit, bit for bit
        assert np.array_equal(got.theta, local.theta)
    pi, theta, jsigma, (count, nbytes) = _jax_distributed(case)
    want = NaiveBayesModel(pi=np.asarray(pi), theta=np.asarray(theta),
                           sigma=None if jsigma is None
                           else np.asarray(jsigma),
                           classes=local.classes_)
    _assert_model_close(got, want, tol)
    (got_count, got_bytes), = results[f"{case}/collectives"].tolist()
    assert (int(got_count), int(got_bytes)) == (count, nbytes)
    assert {"execute", "total"} <= set(results[f"{case}/phases"].tolist())
    assert results[f"{case}/run"].tolist() == ["distributed_nb", "done"]
    assert results[f"{case}/steps"].tolist() == [["class_stats", str(ROWS)]]


# -- the Spark front end --------------------------------------------------------

def _frames(x, y, w, n_partitions=3):
    from spark_rapids_ml_tpu.spark import local_engine as jle
    from spark_rapids_ml_tpu_torch.spark import local_engine as le

    def rows(dense):
        return [{"features": dense(r), "label": float(v), "wt": float(wi)}
                for r, v, wi in zip(x, y, w)]

    return (le.LocalSparkSession(n_partitions=n_partitions)
            .createDataFrame(rows(le.DenseVector)),
            jle.LocalSparkSession(n_partitions=n_partitions)
            .createDataFrame(rows(jle.DenseVector)))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_spark_front_end_matches_jax(kind, weighted):
    import spark_rapids_ml_tpu.spark as jax_spark
    import spark_rapids_ml_tpu_torch.spark as port_spark
    from spark_rapids_ml_tpu_torch.spark import adapter

    x, y, w = _data(kind, rows=180)
    order = np.argsort(y, kind="stable")  # partitions see class subsets
    x, y, w = x[order], y[order], w[order]
    pdf, jdf = _frames(x, y, w)
    kw = {"modelType": kind, "smoothing": 0.5}
    if weighted:
        kw["weightCol"] = "wt"
    got = port_spark.NaiveBayes(**kw).fit(pdf)
    want = jax_spark.NaiveBayes(**kw).fit(jdf)
    assert type(got) is adapter.NaiveBayesModel
    _assert_model_close(got._local, want._local, F64_TOL)
    local = _fit("port", kind, x, y, w if weighted else None, smoothing=0.5)
    _assert_model_close(got._local, local, F64_TOL)
    out = got.transform(pdf).collect()
    ref = want.transform(jdf).collect()
    assert [r["prediction"] for r in out] == [r["prediction"] for r in ref]
    np.testing.assert_allclose(
        np.stack([r["probability"].toArray() for r in out]),
        np.stack([r["probability"].toArray() for r in ref]),
        atol=F64_TOL, rtol=0)


def test_spark_front_end_on_a_partition_frame_equals_the_local_engine():
    import spark_rapids_ml_tpu_torch.spark as port_spark
    from spark_rapids_ml_tpu_torch.spark import forest_estimator as fe

    x, y, w = _data("gaussian", rows=180)
    pdf, _jdf = _frames(x, y, w)
    parts = fe.PartitionFrame([[(x[i:i + 60], y[i:i + 60])]
                               for i in range(0, 180, 60)])
    got = port_spark.NaiveBayes(modelType="gaussian").fit(parts)._local
    want = port_spark.NaiveBayes(modelType="gaussian").fit(pdf)._local
    for attr in ("pi", "theta", "sigma", "classes_"):
        assert np.array_equal(getattr(got, attr), getattr(want, attr))


def test_spark_front_end_refuses_negative_multinomial_features():
    import spark_rapids_ml_tpu_torch.spark as port_spark

    x, y, w = _data("gaussian", rows=40)
    pdf, _jdf = _frames(x - 10.0, y, w)
    with pytest.raises(ValueError, match="non-negative"):
        port_spark.NaiveBayes(modelType="multinomial").fit(pdf)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_spark_estimator_params_cross_packages(tmp_path, writer):
    import spark_rapids_ml_tpu.spark as jax_spark
    import spark_rapids_ml_tpu_torch.spark as port_spark

    pkgs = {"port": port_spark, "jax": jax_spark}
    reader = "jax" if writer == "port" else "port"
    est = pkgs[writer].NaiveBayes(modelType="gaussian", smoothing=0.5,
                                  weightCol="wt")
    path = str(tmp_path / "nb_est")
    est.save(path)
    loaded = pkgs[reader].NaiveBayes.load(path)
    for name in ("modelType", "smoothing", "weightCol"):
        assert loaded.getOrDefault(name) == est.getOrDefault(name)
    assert loaded.uid == est.uid


# -- persistence and serving ------------------------------------------------------

@pytest.mark.parametrize("kind", ["multinomial", "gaussian"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_load_both_ways(tmp_path, writer, kind):
    from spark_rapids_ml_tpu.models.naive_bayes import (
        NaiveBayesModel as JaxModel,
    )
    from spark_rapids_ml_tpu_torch.io.persistence import load_model
    from spark_rapids_ml_tpu_torch.models.naive_bayes import NaiveBayesModel

    x, y, _w = _data(kind)
    model = _fit(writer, kind, x, y)
    path = str(tmp_path / "nb")
    model.save(path)
    for reader in (NaiveBayesModel.load, JaxModel.load, load_model):
        loaded = reader(path)
        _assert_model_close(loaded, model, 0.0)
        assert loaded.uid == model.uid
        assert loaded.getModelType() == kind
        np.testing.assert_allclose(loaded.predict_proba(x),
                                   model.predict_proba(x), atol=F64_TOL,
                                   rtol=0)
        assert np.array_equal(_prediction(loaded, x), _prediction(model, x))
    assert type(load_model(path)) is NaiveBayesModel


def test_adapter_model_save_load(tmp_path):
    import spark_rapids_ml_tpu_torch.spark as port_spark
    from spark_rapids_ml_tpu_torch.spark import adapter

    x, y, w = _data("multinomial", rows=90)
    pdf, _jdf = _frames(x, y, w)
    model = port_spark.NaiveBayes().fit(pdf)
    path = str(tmp_path / "nb_adapter")
    model.save(path)
    loaded = port_spark.NaiveBayesModel.load(path)
    assert type(loaded) is adapter.NaiveBayesModel
    _assert_model_close(loaded._local, model._local, 0.0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_registry_load_serves_the_models_labels(tmp_path, writer):
    from spark_rapids_ml_tpu_torch.io.persistence import load_model
    from spark_rapids_ml_tpu_torch.models.naive_bayes import NaiveBayesModel
    from spark_rapids_ml_tpu_torch.serve import ModelRegistry, ServeEngine

    x, y, _w = _data("gaussian")
    model = _fit(writer, "gaussian", x, y)
    path = str(tmp_path / "nb")
    model.save(path)
    registry = ModelRegistry(manifest_path=str(tmp_path / "manifest.json"))
    version = registry.load("nb", path)
    loaded = registry.resolve("nb", version)
    assert type(loaded) is NaiveBayesModel
    assert type(load_model(path)) is NaiveBayesModel
    engine = ServeEngine(registry, max_wait_ms=1)
    try:
        served = np.asarray(engine.predict("nb", x[:64]))
    finally:
        engine.shutdown()
    proba = loaded.predict_proba(x[:64])
    np.testing.assert_allclose(served, proba, atol=F64_TOL, rtol=0)
    labels = loaded.classes_[np.argmax(served, axis=1)]
    assert np.array_equal(labels, _prediction(model, x[:64]))


if __name__ == "__main__":
    _worker(sys.argv[1])
