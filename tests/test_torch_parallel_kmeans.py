"""KMeans across ranks: the port's ``distributed_kmeans_fit`` against the
one-process Lloyd and the JAX package's driver, on the same numpy inputs.

The port side runs in worlds of 1, 2 and 4 gloo ranks on the CPU
(``OMP_NUM_THREADS=1``), started through the port's launcher: this file is
also the worker script (``__main__`` at the bottom), which imports only the
port, runs every case of its world and writes one ``.npz`` per rank. The
three worlds start together once per module, each in a session of its own
under a timeout; the tests wait on the launchers' exits, so a hang fails
the tests instead of stalling the suite.

Cases: three 2-D blobs of 201 rows each (603 rows, uneven over every
world: padding rows carry mask 0), as tests/test_kmeans.py's
``test_distributed_kmeans_matches_single_device``; and its adversarially
skewed shards, eight 3-D clusters of 100 rows kept SORTED by cluster, so
each rank of a world of 4 holds exactly two clusters and a rank-local
seeding would miss clusters; the blobs again in float32.

Bars: every rank bit-identical to rank 0; the global seeding (Gumbel-max
across ranks) draws differ from ``jax.random``'s, so the fits are held to
the JAX tests' bars (blobs recovered within 0.2, every skewed cluster
within 1.0, cost equal to the host cost of the centres within 1e-5) and,
at float64, to the one-process ``lloyd_iterations`` run from the same
initial centres (centres and cost within 1e-10 relative, equal iteration
count) and to the JAX driver's converged centres within 1e-9. float32
within 1e-4 of the float64 centres. The report and the fit monitor run:
the JAX phases, run and step, and the collectives at their true byte
counts (the JAX accounting leaves out the final cost's reduction).
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

# name → (data, keyword arguments of distributed_kmeans_fit)
CASES = {
    "blobs": ("blobs", {"n_clusters": 3, "max_iter": 50, "seed": 5}),
    "skewed": ("skewed", {"n_clusters": 8, "max_iter": 30, "seed": 2}),
    "f32": ("blobs", {"n_clusters": 3, "max_iter": 50, "seed": 5,
                      "dtype": np.float32}),
}
LLOYD_REL = 1e-10
JAX_TOL = 1e-9
F32_TOL = 1e-4


def _data(name):
    rng = np.random.default_rng(42)
    if name == "blobs":
        centers = np.array([[0.0, 0.0], [10.0, 10.0], [-10.0, 8.0]])
        x = np.concatenate([c + rng.normal(scale=0.5, size=(201, 2))
                            for c in centers])
        rng.shuffle(x)
        return x, centers
    centers = np.array(
        [[i * 20.0, (i % 2) * 20.0, (i % 3) * 20.0] for i in range(8)])
    x = np.concatenate([c + 0.5 * rng.normal(size=(100, 3)) for c in centers])
    return x, centers


def _match_centers(got, want):
    got = np.asarray(got, dtype=np.float64)
    used = set()
    err = 0.0
    for w in want:
        d = np.linalg.norm(got - w, axis=1)
        for i in np.argsort(d):
            if i not in used:
                used.add(i)
                err = max(err, d[i])
                break
    return err


# -- the worker: one rank of a world (imports only the port) ------------------

def _worker(out_dir):
    import torch
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.obs import fitmon
    from spark_rapids_ml_tpu_torch.parallel import (
        DATA_AXIS,
        data_mesh,
        device_count,
        distributed_kmeans_fit,
        initialize_multihost,
        pad_rows_to_multiple,
    )
    from spark_rapids_ml_tpu_torch.parallel.distributed_kmeans import (
        _global_kmeans_pp,
    )

    out = {}

    def put(key, value):
        if torch.is_tensor(value):
            value = value.cpu().numpy()
        out[key] = np.asarray(value)

    initialize_multihost()
    put("backend", dist.get_backend())
    mesh = data_mesh(device_count())
    world = dist.get_world_size()
    monitor = fitmon.get_fit_monitor()
    for case, (data, kwargs) in CASES.items():
        x, _ = _data(data)
        result = distributed_kmeans_fit(x, mesh=mesh, **kwargs)
        put(f"{case}/centers", result.centers)
        put(f"{case}/cost", result.cost)
        put(f"{case}/n_iter", result.n_iter)
        put(f"{case}/converged", result.converged)
        # the initial centres the fit drew (the draws are seeded: the same
        # calls draw them again)
        padded, mask = pad_rows_to_multiple(x, world)
        per = padded.shape[0] // world
        rank = dist.get_rank()
        rows = slice(rank * per, (rank + 1) * per)
        dt = kwargs.get("dtype", x.dtype)
        init = _global_kmeans_pp(
            torch.as_tensor(padded[rows].astype(dt)),
            torch.as_tensor(mask[rows].astype(dt)), kwargs["seed"],
            kwargs["n_clusters"], mesh.get_group(DATA_AXIS))
        put(f"{case}/init", init)
        report = result.fit_report_
        put(f"{case}/phases", sorted(report.phases))
        put(f"{case}/rows", report.rows)
        put(f"{case}/collectives", [
            (kind, c["count"], c["bytes"])
            for kind, c in sorted(report.collectives.items())])
        run = monitor.recent_runs()[0]  # newest first
        put(f"{case}/run", [run.algo, run.status])
        put(f"{case}/steps", [(s["step"], s["rows"]) for s in run.steps])
        scalars = run.steps[-1]["scalars"]
        put(f"{case}/scalars", [scalars["n_iter"], scalars["cost"],
                                scalars["converged"]])
    put("jax_imported", sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "spark_rapids_ml_tpu" or m.startswith("spark_rapids_ml_tpu.")))
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


# -- running worlds ------------------------------------------------------------

def _launch(nprocs, out_dir, log):
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


@functools.lru_cache(maxsize=None)
def _jax_fit(case):
    """(centers, cost, report phases, the fit monitor run's (algo, status)
    and steps) of the JAX driver on its 8-virtual-device mesh."""
    from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
    from spark_rapids_ml_tpu.parallel import data_mesh
    from spark_rapids_ml_tpu.parallel.distributed_kmeans import (
        distributed_kmeans_fit,
    )

    data, kwargs = CASES[case]
    x, _ = _data(data)
    kwargs = {k: v for k, v in kwargs.items() if k != "dtype"}
    result = distributed_kmeans_fit(x, mesh=data_mesh(8), **kwargs)
    run = next(r for r in jax_fitmon.get_fit_monitor().recent_runs()
               if r.algo == "distributed_kmeans")  # newest first
    return (np.asarray(result.centers), float(result.cost),
            sorted(result.fit_report_.phases), (run.algo, run.status),
            [(s["step"], s["rows"]) for s in run.steps])


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
@pytest.mark.parametrize("case", ["blobs", "skewed"])
def test_float64_fit_meets_the_jax_bars(worlds, world, case):
    from spark_rapids_ml_tpu_torch import KMeansModel

    results = worlds[world][0]
    centers = results[f"{case}/centers"]
    x, true_centers = _data(CASES[case][0])
    assert centers.dtype == np.float64
    if case == "blobs":
        assert _match_centers(centers, true_centers) < 0.2
    else:
        for c in true_centers:
            assert np.min(np.linalg.norm(centers - c, axis=1)) < 1.0, c
    host_cost = KMeansModel(cluster_centers=centers).compute_cost(x)
    assert host_cost == pytest.approx(float(results[f"{case}/cost"]),
                                      rel=1e-5)
    jax_centers, jax_cost = _jax_fit(case)[:2]
    assert _match_centers(centers, jax_centers) <= JAX_TOL * np.abs(
        jax_centers).max()
    assert float(results[f"{case}/cost"]) == pytest.approx(jax_cost,
                                                           rel=1e-9)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["blobs", "skewed"])
def test_fit_equals_the_one_process_lloyd_from_its_initial_centres(
        worlds, world, case):
    import torch

    from spark_rapids_ml_tpu_torch.ops.kmeans_kernel import lloyd_iterations

    results = worlds[world][0]
    data, kwargs = CASES[case]
    x, _ = _data(data)
    init = results[f"{case}/init"]
    # every initial centre is a data row
    for row in init:
        assert (np.abs(x - row).sum(axis=1) == 0).any()
    one = lloyd_iterations(torch.as_tensor(x), torch.as_tensor(init), None,
                           kwargs["max_iter"], 1e-4)
    centers = results[f"{case}/centers"]
    scale = np.abs(one.centers.numpy()).max()
    np.testing.assert_allclose(centers, one.centers.numpy(), rtol=0,
                               atol=LLOYD_REL * scale)
    assert float(results[f"{case}/cost"]) == pytest.approx(
        float(one.cost), rel=LLOYD_REL)
    assert int(results[f"{case}/n_iter"]) == int(one.n_iter)
    assert bool(results[f"{case}/converged"]) == bool(one.converged)


@pytest.mark.parametrize("world", WORLDS)
def test_float32_fit_meets_its_bar(worlds, world):
    results = worlds[world][0]
    centers = results["f32/centers"]
    assert centers.dtype == np.float32
    want = results["blobs/centers"]
    assert _match_centers(centers, want) <= F32_TOL * np.abs(want).max()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_report_and_run_match_the_jax_driver(worlds, world, case):
    results = worlds[world][0]
    data, kwargs = CASES[case]
    x, _ = _data(data)
    n = x.shape[1]
    k = kwargs["n_clusters"]
    itemsize = 4 if case == "f32" else 8
    _c, _cost, jax_phases, jax_run, jax_steps = _jax_fit(
        "blobs" if case == "f32" else case)
    phases = list(results[f"{case}/phases"])
    assert phases == jax_phases
    assert {"prepare", "placement", "execute", "total"} <= set(phases)
    assert int(results[f"{case}/rows"]) == x.shape[0]
    n_iter = int(results[f"{case}/n_iter"])
    got = {kind: (int(c), int(b))
           for kind, c, b in results[f"{case}/collectives"].tolist()}
    # seeding: per centre one MAX of a scalar and one SUM of (flag, row);
    # Lloyd: one packed SUM per iteration and one for the final cost
    assert got == {
        "all_max": (k, k * itemsize),
        "all_reduce": (k + n_iter + 1,
                       k * (n + 1) * itemsize
                       + (n_iter + 1) * (k * n + k + 1) * itemsize),
    }
    assert tuple(results[f"{case}/run"].tolist()) == jax_run
    assert [(str(s), int(r)) for s, r in results[f"{case}/steps"].tolist()] \
        == jax_steps == [("lloyd", x.shape[0])]
    n_note, cost_note, converged_note = results[f"{case}/scalars"].tolist()
    assert int(n_note) == n_iter
    assert cost_note == pytest.approx(float(results[f"{case}/cost"]))
    assert int(converged_note) == int(results[f"{case}/converged"])


if __name__ == "__main__":
    _worker(sys.argv[1])
