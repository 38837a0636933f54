"""GeneralizedLinearRegression across ranks: the port's
``distributed_glm_fit`` against the JAX package's, on the same numpy inputs.

The JAX side runs in this process on a one-device CPU mesh
(``data_mesh(1)``). The port side runs in worlds of 1, 2 and 4 gloo ranks
on the CPU (``OMP_NUM_THREADS=1``), started through the port's launcher:
this file is also the worker script (``__main__`` at the bottom), which
imports only the port, runs every case of its world and writes one
``.npz`` per rank. The three worlds start together once per module, each
in a process group of its own under a timeout; the tests wait on the
launchers' exits, so a hang fails the tests instead of stalling the suite.

Data: numpy from a seed, 301 rows (uneven over every world: padding rows
carry weight 0 and y = 1) × 4 features, the cases of
tests/test_distributed.py's ``test_distributed_glm_matches_local``:
Poisson counts, and binomial labels with weights and an offset; plus a
gamma / log fit and a Poisson fit at float32.

Bars: float64 in both packages, coefficients and intercept within 1e-10
of the JAX fit and 1e-9 of the port's single-device fit (same rows and
weights through a frame), the same iteration count, the deviance within
1e-10 relative; every rank bit-identical to rank 0. float32 (the Gram
kernel's plain version at highest) within 1e-4 of the float64 JAX fit.
The report and the fit monitor run as the JAX function's: one
``irls_pass`` step and one all-reduce of d² + d + 6 elements per pass.
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
WORLDS = (1, 2, 4)
WORLD_TIMEOUT_S = 120
ROWS, N = 301, 4

# name → keyword arguments of distributed_glm_fit, less the labels
CASES = {
    "poisson": {"family": "poisson", "dtype": np.float64},
    "binomial": {"family": "binomial", "weights": "w", "offset": "off",
                 "dtype": np.float64},
    "gamma_log": {"family": "gamma", "link": "log", "reg_param": 0.05,
                  "dtype": np.float64},
    "f32": {"family": "poisson"},
}
F64_TOL = 1e-10
SINGLE_TOL = 1e-9
F32_TOL = 1e-4


def _data():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(ROWS, N))
    labels = {
        "poisson": rng.poisson(np.exp(x @ [0.5, -0.3, 0.2, 0.0] + 1.0)
                               ).astype(float),
        "binomial": (rng.random(ROWS) < 1.0 / (1.0 + np.exp(
            -(x @ [1.0, -1.0, 0.0, 0.5])))).astype(float),
        "gamma": rng.gamma(5.0, np.exp(0.2 * x @ [1.0, 0.5, -0.5, 0.0]
                                       + 0.3) / 5.0),
    }
    extra = {"w": rng.uniform(0.5, 2.0, size=ROWS),
             "off": rng.normal(scale=0.1, size=ROWS)}
    return x, labels, extra


def _arguments(case):
    """(x, y, keyword arguments) of ``case`` for either package's
    ``distributed_glm_fit``."""
    x, labels, extra = _data()
    kwargs = dict(CASES[case])
    y = labels[kwargs["family"]]
    for key in ("weights", "offset"):
        if key in kwargs:
            kwargs[key] = extra[kwargs[key]]
    return x, y, kwargs


# -- the worker: one rank of a world (imports only the port) ------------------

def _worker(out_dir):
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.obs import fitmon
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        device_count,
        distributed_glm_fit,
        initialize_multihost,
    )

    out = {}

    def put(key, value):
        out[key] = np.asarray(value)

    initialize_multihost()
    put("backend", dist.get_backend())
    mesh = data_mesh(device_count())
    monitor = fitmon.get_fit_monitor()
    for case in CASES:
        x, y, kwargs = _arguments(case)
        model = distributed_glm_fit(x, y, mesh, **kwargs)
        put(f"{case}/coefficients", model.coefficients)
        put(f"{case}/intercept", model.intercept)
        put(f"{case}/n_iter", model.num_iterations_)
        put(f"{case}/deviance", model.deviance_)
        put(f"{case}/weight_sum", model.weight_sum_)
        put(f"{case}/offset_col", model.get_or_default("offsetCol"))
        report = model.fit_report_
        put(f"{case}/rows", report.rows)
        put(f"{case}/collectives", [
            (kind, c["count"], c["bytes"])
            for kind, c in sorted(report.collectives.items())])
        run = monitor.recent_runs()[0]
        put(f"{case}/run", [run.algo, run.status])
        put(f"{case}/steps", [(s["step"], s["rows"]) for s in run.steps])
    # the domain and weight checks raise before any collective
    x, y, _ = _arguments("poisson")
    raised = []
    for kwargs in ({"labels": y - 100.0},
                   {"labels": y, "weights": -np.ones(ROWS)}):
        try:
            distributed_glm_fit(x, kwargs.pop("labels"), mesh,
                                family="poisson", **kwargs)
        except ValueError as exc:
            raised.append(str(exc))
    put("raised", raised)
    put("jax_imported", sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "spark_rapids_ml_tpu" or m.startswith("spark_rapids_ml_tpu.")))
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


# -- running worlds ------------------------------------------------------------

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
    """The launcher's exit code, or None after killing its process group
    when ``timeout`` runs out."""
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


# -- the JAX side (cached per case) ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fit(case):
    """(coefficients, intercept, iterations, deviance, weight sum, offset
    column, all-reduce (count, bytes), the fit monitor run's (algo,
    status) and its steps) of the JAX function on a one-device mesh; the
    float32 case is compared with the float64 Poisson fit."""
    from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
    from spark_rapids_ml_tpu.parallel import data_mesh
    from spark_rapids_ml_tpu.parallel.distributed_glm import (
        distributed_glm_fit,
    )

    x, y, kwargs = _arguments(case)
    model = distributed_glm_fit(x, y, data_mesh(1), **kwargs)
    report = model.fit_report_
    run = next(r for r in jax_fitmon.get_fit_monitor().recent_runs()
               if r.algo == "distributed_glm")
    reduce = report.collectives["all_reduce"]
    return (np.asarray(model.coefficients), float(model.intercept),
            model.num_iterations_, model.deviance_, model.weight_sum_,
            model.get_or_default("offsetCol"),
            (reduce["count"], reduce["bytes"]), (run.algo, run.status),
            [(s["step"], s["rows"]) for s in run.steps])


def _single(case):
    """The port's in-memory float64 fit of the same rows, weights and
    offset through a frame."""
    from spark_rapids_ml_tpu_torch import GeneralizedLinearRegression
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    x, y, kwargs = _arguments(case)
    cols = {"features": x, "label": y}
    est = GeneralizedLinearRegression(family=kwargs["family"]).setDtype(
        "float64").setRegParam(kwargs.get("reg_param", 0.0))
    if "link" in kwargs:
        est.setLink(kwargs["link"])
    if "weights" in kwargs:
        cols["w"] = kwargs["weights"]
        est.setWeightCol("w")
    if "offset" in kwargs:
        cols["offset"] = kwargs["offset"]
        est.setOffsetCol("offset")
    return est.fit(VectorFrame(cols))


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


# -- tests ---------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_is_bit_identical_to_rank_0(worlds, world):
    ranks = worlds[world]
    assert len(ranks) == world
    for rank, results in enumerate(ranks[1:], start=1):
        assert set(results) == set(ranks[0])
        for key, value in results.items():
            assert value.dtype == ranks[0][key].dtype, key
            assert np.array_equal(value, ranks[0][key]), (rank, key)


@pytest.mark.parametrize("world", WORLDS)
def test_worker_imports_only_the_port_and_joins_over_gloo(worlds, world):
    for results in worlds[world]:
        assert results["jax_imported"].size == 0, results["jax_imported"]
        assert str(results["backend"]) == "gloo"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["poisson", "binomial", "gamma_log"])
def test_float64_fit_matches_jax_and_the_single_device_fit(worlds, world,
                                                           case):
    results = worlds[world][0]
    coef = results[f"{case}/coefficients"]
    intercept = float(results[f"{case}/intercept"])
    assert coef.dtype == np.float64 and coef.shape == (N,)
    (jax_coef, jax_intercept, jax_iter, jax_dev, jax_wsum,
     jax_offset) = _jax_fit(case)[:6]
    np.testing.assert_allclose(coef, jax_coef, atol=F64_TOL, rtol=0)
    assert intercept == pytest.approx(jax_intercept, abs=F64_TOL)
    assert int(results[f"{case}/n_iter"]) == jax_iter
    assert float(results[f"{case}/deviance"]) == pytest.approx(jax_dev,
                                                               rel=1e-10)
    assert float(results[f"{case}/weight_sum"]) == pytest.approx(
        jax_wsum, rel=1e-15)
    assert str(results[f"{case}/offset_col"]) == jax_offset
    single = _single(case)
    np.testing.assert_allclose(coef, single.coefficients, atol=SINGLE_TOL,
                               rtol=0)
    assert intercept == pytest.approx(single.intercept, abs=SINGLE_TOL)
    assert single.num_iterations_ == jax_iter


@pytest.mark.parametrize("world", WORLDS)
def test_float32_fit_meets_its_bar(worlds, world):
    results = worlds[world][0]
    jax_coef, jax_intercept = _jax_fit("poisson")[:2]
    np.testing.assert_allclose(results["f32/coefficients"], jax_coef,
                               atol=F32_TOL, rtol=0)
    assert float(results["f32/intercept"]) == pytest.approx(jax_intercept,
                                                            abs=F32_TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_report_and_run_match_the_jax_fit(worlds, world, case):
    results = worlds[world][0]
    (count, nbytes), run, steps = _jax_fit(case)[6:]
    got_steps = [(str(s), int(r)) for s, r in results[f"{case}/steps"]]
    passes = len(got_steps)
    # the passes: the iterations, and one more when maxIter is reached
    n_iter = int(results[f"{case}/n_iter"])
    assert passes == n_iter + (n_iter == 25)
    itemsize = 4 if case == "f32" else 8
    ((kind, got_count, got_bytes),) = results[f"{case}/collectives"].tolist()
    # one packed all-reduce of d² + d + 6 elements per IRLS pass
    assert (kind, int(got_count)) == ("all_reduce", passes)
    assert int(got_bytes) == (N * N + N + 6) * itemsize * passes
    assert int(results[f"{case}/rows"]) == ROWS
    assert tuple(results[f"{case}/run"].tolist()) == run
    assert got_steps == [("irls_pass", ROWS)] * len(got_steps)
    if case != "f32":   # JAX's default dtype is float32, ours float64 here
        assert (int(got_count), int(got_bytes)) == (count, nbytes)
        assert got_steps == steps


@pytest.mark.parametrize("world", WORLDS)
def test_domain_and_weight_checks_raise_on_every_rank(worlds, world):
    for results in worlds[world]:
        raised = [str(m) for m in results["raised"]]
        assert len(raised) == 2
        assert "non-negative" in raised[0]
        assert "weights must be finite and non-negative" in raised[1]


if __name__ == "__main__":
    _worker(sys.argv[1])
