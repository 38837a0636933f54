"""LinearSVC across ranks: the port's ``distributed_svc_fit`` against the
JAX package's, on the same numpy inputs.

The JAX side runs in this process on a one-device CPU mesh
(``data_mesh(1)``). The port side runs in worlds of 1, 2 and 4 gloo ranks
on the CPU (``OMP_NUM_THREADS=1``), started through the port's launcher:
this file is also the worker script (``__main__`` at the bottom), which
imports only the port, runs every case of its world and writes one
``.npz`` per rank. The three worlds start together once per module, each
in a process group of its own under a timeout; the tests wait on the launchers'
exits, so a hang fails the tests instead of stalling the suite.

Data: numpy from a seed, 203 rows (uneven over every world: padding rows
carry mask 0) × 6 features, binary labels from a noisy linear margin.

Bars: float64 in both packages, coefficients and intercept within 1e-10
of the JAX fit and of the port's single-device fit, the same iteration
count and convergence; every rank bit-identical to rank 0. float32 (the
Gram kernel's plain version at highest) within 1e-4 of the float64 fit.
The report and the fit monitor run as the JAX function's: the phases, one
``newton`` step noted with ``n_iter`` and ``converged``, and the
all-reduce accounted as JAX accounts it (d² + d elements, once per
iteration).
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
ROWS, N = 203, 6

# name → keyword arguments of distributed_svc_fit
CASES = {
    "ridge": {"reg_param": 0.02},
    "plain": {},
    "no_intercept": {"reg_param": 0.02, "fit_intercept": False},
    "f32": {"reg_param": 0.02, "dtype": np.float32},
}
F64_TOL = 1e-10
F32_TOL = 1e-4


def _data():
    rng = np.random.default_rng(42)
    x = rng.normal(size=(ROWS, N))
    z = x @ rng.normal(size=N) + 0.4 + rng.normal(size=ROWS)
    y = (z > 0).astype(np.float64)
    return x, y


# -- the worker: one rank of a world (imports only the port) ------------------

def _worker(out_dir):
    import torch
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.obs import fitmon
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        device_count,
        distributed_svc_fit,
        initialize_multihost,
    )

    out = {}

    def put(key, value):
        if torch.is_tensor(value):
            value = value.cpu().numpy()
        out[key] = np.asarray(value)

    initialize_multihost()
    put("backend", dist.get_backend())
    mesh = data_mesh(device_count())
    x, y = _data()
    monitor = fitmon.get_fit_monitor()
    for case, kwargs in CASES.items():
        result = distributed_svc_fit(x, y, mesh, **kwargs)
        put(f"{case}/coefficients", result.coefficients)
        put(f"{case}/intercept", result.intercept)
        put(f"{case}/n_iter", result.n_iter)
        put(f"{case}/converged", result.converged)
        report = result.fit_report_
        put(f"{case}/phases", sorted(report.phases))
        put(f"{case}/rows", report.rows)
        put(f"{case}/collectives", [
            (kind, c["count"], c["bytes"])
            for kind, c in sorted(report.collectives.items())])
        run = monitor.recent_runs()[0]
        put(f"{case}/run", [run.algo, run.status])
        put(f"{case}/steps", [(s["step"], s["rows"], s["scalars"]["n_iter"],
                               s["scalars"]["converged"]) for s in run.steps])
    put("jax_imported", sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "spark_rapids_ml_tpu" or m.startswith("spark_rapids_ml_tpu.")))
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


# -- running worlds ------------------------------------------------------------

def _launch(nprocs, out_dir, log):
    """The port's launcher in a process group of its own (so a timeout can kill
    every rank)."""
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
    """The launcher's exit code, or None after killing its process group when
    ``timeout`` runs out."""
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        return None


@pytest.fixture(scope="module")
def worlds():
    """{world size: [rank 0's results, rank 1's, ...]} from the three worlds,
    started together."""
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
    """(coefficients, intercept, n_iter, converged, report phases,
    all-reduce (count, bytes), the fit monitor run's (algo, status) and
    its steps) of the JAX function on a one-device mesh."""
    from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
    from spark_rapids_ml_tpu.parallel import data_mesh
    from spark_rapids_ml_tpu.parallel.distributed_svc import (
        distributed_svc_fit,
    )

    x, y = _data()
    result = distributed_svc_fit(x, y, data_mesh(1), **CASES[case])
    report = result.fit_report_
    run = next(r for r in jax_fitmon.get_fit_monitor().recent_runs()
               if r.algo == "distributed_svc")
    reduce = report.collectives["all_reduce"]
    return (np.asarray(result.coefficients), float(result.intercept),
            int(result.n_iter), bool(result.converged), sorted(report.phases),
            (reduce["count"], reduce["bytes"]), (run.algo, run.status),
            [(s["step"], s["rows"], s["scalars"]["n_iter"],
              s["scalars"]["converged"]) for s in run.steps])


def _single(case):
    from spark_rapids_ml_tpu_torch import LinearSVC

    kwargs = CASES[case]
    x, y = _data()
    return (LinearSVC().setRegParam(kwargs.get("reg_param", 0.0))
            .setFitIntercept(kwargs.get("fit_intercept", True))
            .setStandardization(False).setDtype("float64").fit(x, y))


def _rank0(worlds, world):
    return worlds[world][0]


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
@pytest.mark.parametrize("case", ["ridge", "plain", "no_intercept"])
def test_float64_fit_matches_jax_and_the_single_device_fit(worlds, world,
                                                           case):
    results = _rank0(worlds, world)
    coef = results[f"{case}/coefficients"]
    intercept = float(results[f"{case}/intercept"])
    assert coef.dtype == np.float64 and coef.shape == (N,)
    jax_coef, jax_intercept, jax_iter, jax_conv = _jax_fit(case)[:4]
    np.testing.assert_allclose(coef, jax_coef, atol=F64_TOL, rtol=0)
    assert intercept == pytest.approx(jax_intercept, abs=F64_TOL)
    assert int(results[f"{case}/n_iter"]) == jax_iter
    assert bool(results[f"{case}/converged"]) == jax_conv is True
    single = _single(case)
    np.testing.assert_allclose(coef, single.coefficients, atol=F64_TOL,
                               rtol=0)
    assert intercept == pytest.approx(single.intercept, abs=F64_TOL)
    assert single.n_iter_ == jax_iter
    if not CASES[case].get("fit_intercept", True):
        assert intercept == 0.0


@pytest.mark.parametrize("world", WORLDS)
def test_float32_fit_meets_its_bar(worlds, world):
    results = _rank0(worlds, world)
    coef = results["f32/coefficients"]
    assert coef.dtype == np.float32
    jax_coef, jax_intercept = _jax_fit("ridge")[:2]
    np.testing.assert_allclose(coef, jax_coef, atol=F32_TOL, rtol=0)
    assert float(results["f32/intercept"]) == pytest.approx(jax_intercept,
                                                            abs=F32_TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_report_and_run_match_the_jax_fit(worlds, world, case):
    results = _rank0(worlds, world)
    (_c, _i, jax_iter, _v, phases, (count, nbytes), run,
     steps) = _jax_fit(case)
    n_iter = int(results[f"{case}/n_iter"])
    converged = bool(results[f"{case}/converged"])
    assert list(results[f"{case}/phases"]) == phases
    assert {"prepare", "placement", "execute", "total"} <= set(phases)
    assert int(results[f"{case}/rows"]) == ROWS
    itemsize = 4 if case == "f32" else 8
    d = N + (1 if CASES[case].get("fit_intercept", True) else 0)
    ((kind, got_count, got_bytes),) = results[f"{case}/collectives"].tolist()
    assert (kind, int(got_count)) == ("all_reduce", max(n_iter, 1))
    # the report sums the payload over the iterations
    assert int(got_bytes) == (d * d + d) * itemsize * max(n_iter, 1)
    if case != "f32":   # the JAX fit is float64 in every case
        assert (int(got_count), int(got_bytes)) == (count, nbytes)
    assert tuple(results[f"{case}/run"].tolist()) == run
    got_steps = [(str(s), int(r), float(i), float(c))
                 for s, r, i, c in results[f"{case}/steps"].tolist()]
    assert got_steps == [("newton", ROWS, float(n_iter), float(converged))]
    assert [(s, r) for s, r, _, _ in steps] == [("newton", ROWS)]
    if case != "f32":
        assert got_steps == steps and n_iter == jax_iter


if __name__ == "__main__":
    _worker(sys.argv[1])
