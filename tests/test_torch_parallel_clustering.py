"""GaussianMixture and BisectingKMeans across ranks: the port's
``distributed_gmm_fit`` and ``distributed_bisecting_kmeans_fit`` against
the one-process fits and the JAX package's drivers, on the same numpy
inputs.

The port side runs in worlds of 1 and 2 gloo ranks on the CPU
(``OMP_NUM_THREADS=1``), started through the port's launcher: this file is
also the worker script (``__main__`` at the bottom), which imports only the
port, runs every case of its world and writes one ``.npz`` per rank. The
worlds start together once per module, each in a session of its own under
a timeout.

Cases: ``tests/test_distributed.py``'s data — three 2-D blobs of 60 rows
for GMM, 101 weighted 3-D rows (uneven over 2 ranks: a padding row at
weight 0), four 2-D blobs of 40 rows for BisectingKMeans, 32 identical
rows and 67 uneven normal rows — at float64, and the blobs at float32.

Bars: every rank bit-identical to rank 0; ``distributed_gmm_fit`` at
float64 within 1e-10 relative of the port's local fit and of the JAX
driver on its 8-device CPU mesh (means, weights, covariances,
log-likelihood), equal iteration counts; float32 means within 1e-4
relative of float64; the bisecting fits meet ``tests/test_distributed.py``
's bars (each blob one label, every centre within 0.5 of a blob, one leaf
for identical rows); each split's Lloyd, run by the JAX
``lloyd_iterations`` from the split's initial pair, within 1e-9 of the
port's split centres. Reports and fit-monitor runs: the JAX steps, and the
collectives at their true counts and sizes.
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
WORLDS = (1, 2)
WORLD_TIMEOUT_S = 120
FIT_RTOL = 1e-10
LLOYD_TOL = 1e-9
F32_RTOL = 1e-4

# name → (data, keyword arguments of distributed_gmm_fit)
GMM_CASES = {
    "gmm/f64": ("gmm_blobs", {"k": 3, "seed": 2, "dtype": np.float64}),
    "gmm/weighted": ("gmm_weighted", {"k": 2, "seed": 1,
                                      "dtype": np.float64}),
    "gmm/f32": ("gmm_blobs", {"k": 3, "seed": 2}),
}
# name → (data, keyword arguments of distributed_bisecting_kmeans_fit)
BKM_CASES = {
    "bkm/blobs": ("bkm_blobs", {"k": 4, "seed": 3}),
    "bkm/f32": ("bkm_blobs", {"k": 4, "seed": 3, "dtype": np.float32}),
    "bkm/degenerate": ("ones", {"k": 4, "seed": 0}),
    "bkm/uneven": ("uneven", {"k": 3, "seed": 1}),
}
BKM_BLOBS = np.asarray([[0.0, 0.0], [8.0, 8.0], [-8.0, 8.0], [0.0, -9.0]])
GMM_BLOBS = np.asarray([[0.0, 0.0], [6.0, 6.0], [-6.0, 6.0]])


def _data(name):
    """(x, weights or None)."""
    rng = np.random.default_rng(11)
    if name == "gmm_blobs":
        return np.concatenate([m + rng.normal(scale=0.5, size=(60, 2))
                               for m in GMM_BLOBS]), None
    if name == "gmm_weighted":
        x = np.concatenate([rng.normal(0, 0.5, size=(50, 3)),
                            rng.normal(5, 0.5, size=(51, 3))])
        return x, np.linspace(0.5, 2.0, 101)
    if name == "bkm_blobs":
        return np.concatenate([c + rng.normal(scale=0.4, size=(40, 2))
                               for c in BKM_BLOBS]), None
    if name == "ones":
        return np.ones((32, 3)), None
    return rng.normal(size=(67, 3)), None


# -- the worker: one rank of a world (imports only the port) ------------------

def _worker(out_dir):
    import torch
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.obs import fitmon
    from spark_rapids_ml_tpu_torch.parallel import (
        DATA_AXIS,
        data_mesh,
        device_count,
        distributed_bisecting_kmeans_fit,
        distributed_gmm_fit,
        initialize_multihost,
        pad_rows_to_multiple,
    )
    from spark_rapids_ml_tpu_torch.parallel.distributed_bisecting import (
        _bisect_split,
    )
    from spark_rapids_ml_tpu_torch.parallel.distributed_kmeans import (
        _global_kmeans_pp,
    )
    from spark_rapids_ml_tpu_torch.parallel.mesh import all_gather_rows

    out = {}

    def put(key, value):
        if torch.is_tensor(value):
            value = value.cpu().numpy()
        out[key] = np.asarray(value)

    def put_run(case, result_report):
        put(f"{case}/collectives", [
            (kind, c["count"], c["bytes"])
            for kind, c in sorted(result_report.collectives.items())])
        run = fitmon.get_fit_monitor().recent_runs()[0]  # newest first
        put(f"{case}/run", [run.algo, run.status])
        put(f"{case}/steps", [(s["step"], s["rows"]) for s in run.steps])

    initialize_multihost()
    put("backend", dist.get_backend())
    mesh = data_mesh(device_count())
    group = mesh.get_group(DATA_AXIS)
    world = dist.get_world_size()
    rank = dist.get_rank()
    for case, (data, kwargs) in GMM_CASES.items():
        x, w = _data(data)
        model = distributed_gmm_fit(x, mesh=mesh, weights=w, **kwargs)
        for attr in ("means", "weights", "covs"):
            put(f"{case}/{attr}", getattr(model, attr))
        put(f"{case}/ll", model.log_likelihood_)
        put(f"{case}/n_iter", model.num_iterations_)
        put_run(case, model.fit_report_)
    for case, (data, kwargs) in BKM_CASES.items():
        x, _w = _data(data)
        result = distributed_bisecting_kmeans_fit(x, mesh=mesh, **kwargs)
        put(f"{case}/centers", result.centers)
        put(f"{case}/cost", result.cost)
        put(f"{case}/labels", result.labels)
        put_run(case, result.fit_report_)
    # the blobs' first two splits again, one at a time (the draws are
    # seeded: the same calls draw the same pairs): each split's initial
    # pair, its centres and the rows' leaves after it
    x, _w = _data("bkm_blobs")
    padded, mask = pad_rows_to_multiple(x, world)
    per = padded.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    xs = torch.as_tensor(padded[rows])
    ms = torch.as_tensor(mask[rows], dtype=xs.dtype)
    leaf = torch.zeros(per, dtype=torch.int32)
    for split, (target, new_id) in enumerate(((0, 1), (0, 2))):
        seed = 3 + split
        m2 = ms * (leaf == target).to(xs.dtype)
        put(f"split{split}/init", _global_kmeans_pp(xs, m2, seed, 2, group))
        put(f"split{split}/mask", all_gather_rows(m2, group))
        centers, _n, leaf, _c, _s, _q = _bisect_split(
            xs, ms, leaf, seed, target, new_id, group=group)
        put(f"split{split}/centers", centers)
    put("jax_imported", sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "spark_rapids_ml_tpu" or m.startswith("spark_rapids_ml_tpu.")))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
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
    """{world size: [rank 0's results, rank 1's, ...]} from the worlds,
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


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


@functools.lru_cache(maxsize=None)
def _jax_gmm(case):
    """(model, the fit monitor run's steps) of the JAX driver on its
    8-virtual-device mesh at the case's dtype."""
    from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
    from spark_rapids_ml_tpu.parallel import data_mesh, distributed_gmm_fit

    data, kwargs = GMM_CASES[case]
    x, w = _data(data)
    model = distributed_gmm_fit(x, mesh=data_mesh(8), weights=w, **kwargs)
    run = next(r for r in jax_fitmon.get_fit_monitor().recent_runs()
               if r.algo == "distributed_gmm")  # newest first
    return model, [(s["step"], s["rows"]) for s in run.steps]


def _rel(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


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
@pytest.mark.parametrize("case", ["gmm/f64", "gmm/weighted"])
def test_float64_gmm_equals_the_local_fit_and_the_jax_driver(worlds, world,
                                                            case):
    from spark_rapids_ml_tpu_torch import GaussianMixture
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    results = worlds[world][0]
    data, kwargs = GMM_CASES[case]
    x, w = _data(data)
    est = GaussianMixture(k=kwargs["k"], seed=kwargs["seed"], maxIter=100,
                          tol=1e-3, regParam=1e-6, dtype="float64")
    if w is None:
        local = est.fit(x)
    else:
        local = est.setWeightCol("w").fit(
            VectorFrame({"features": list(x), "w": w}))
    jax_model, _steps = _jax_gmm(case)
    for want in (local, jax_model):
        for attr in ("means", "weights", "covs"):
            got = results[f"{case}/{attr}"]
            assert got.dtype == np.float64
            assert _rel(got, getattr(want, attr)) <= FIT_RTOL, attr
        assert float(results[f"{case}/ll"]) == pytest.approx(
            want.log_likelihood_, rel=FIT_RTOL)
        assert int(results[f"{case}/n_iter"]) == want.num_iterations_
    if case == "gmm/f64":
        means = results[f"{case}/means"]
        for m in GMM_BLOBS:
            assert np.abs(means - m[None, :]).sum(axis=1).min() < 0.3


@pytest.mark.parametrize("world", WORLDS)
def test_float32_gmm_meets_its_bar(worlds, world):
    results = worlds[world][0]
    want = results["gmm/f64/means"]
    got = results["gmm/f32/means"]
    order = [int(np.argmin(np.linalg.norm(got - m, axis=1))) for m in want]
    assert _rel(got[order], want) <= F32_RTOL
    assert abs(float(results["gmm/f32/weights"].sum()) - 1.0) < 1e-6


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["bkm/blobs", "bkm/f32"])
def test_bisecting_fit_meets_the_jax_bars(worlds, world, case):
    results = worlds[world][0]
    centers = results[f"{case}/centers"]
    labels = results[f"{case}/labels"]
    assert centers.shape == (4, 2)
    for g in range(4):
        assert len(set(labels[g * 40:(g + 1) * 40])) == 1
    assert float(results[f"{case}/cost"]) > 0
    for c in BKM_BLOBS:
        assert np.abs(centers - c[None, :]).sum(axis=1).min() < 0.5
    x, _w = _data("bkm_blobs")
    # the cost is every leaf's SSE about its mean, the labels its leaves
    sse = sum(((x[labels == i] - x[labels == i].mean(axis=0)) ** 2).sum()
              for i in range(4))
    assert float(results[f"{case}/cost"]) == pytest.approx(sse, rel=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_bisecting_degenerate_and_uneven_inputs(worlds, world):
    results = worlds[world][0]
    assert results["bkm/degenerate/centers"].shape[0] == 1
    assert set(results["bkm/degenerate/labels"].tolist()) == {0}
    assert results["bkm/uneven/labels"].shape == (67,)
    assert results["bkm/uneven/centers"].shape == (3, 3)
    assert np.isfinite(results["bkm/uneven/centers"]).all()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("split", [0, 1])
def test_each_split_lloyd_matches_jax_from_its_initial_pair(worlds, world,
                                                            split):
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.ops.kmeans_kernel import lloyd_iterations

    results = worlds[world][0]
    x, _w = _data("bkm_blobs")
    mask = results[f"split{split}/mask"][:x.shape[0]]
    init = results[f"split{split}/init"]
    for row in init:   # every initial centre is a row of the split's leaf
        assert (np.abs(x[mask > 0] - row).sum(axis=1) == 0).any()
    want = lloyd_iterations(jnp.asarray(x), jnp.asarray(init),
                            jnp.asarray(mask), 20, 1e-4)
    got = results[f"split{split}/centers"]
    scale = np.abs(np.asarray(want.centers)).max()
    np.testing.assert_allclose(got, np.asarray(want.centers), rtol=0,
                               atol=LLOYD_TOL * scale)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(GMM_CASES))
def test_gmm_report_and_run_match_the_jax_driver(worlds, world, case):
    results = worlds[world][0]
    data, kwargs = GMM_CASES[case]
    x, _w = _data(data)
    k, d = kwargs["k"], x.shape[1]
    itemsize = 4 if case == "gmm/f32" else 8
    n_iter = int(results[f"{case}/n_iter"])
    got = {kind: (int(c), int(b))
           for kind, c, b in results[f"{case}/collectives"].tolist()}
    assert got == {"all_reduce": (
        n_iter, n_iter * (k + k * d + k * d * d + 2) * itemsize)}
    assert results[f"{case}/run"].tolist() == ["distributed_gmm", "done"]
    steps = [(str(s), int(r)) for s, r in results[f"{case}/steps"].tolist()]
    assert steps == [("em_pass", x.shape[0])] * n_iter
    if case != "gmm/f32":
        assert steps == _jax_gmm(case)[1]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["bkm/blobs", "bkm/degenerate"])
def test_bisecting_report_and_run(worlds, world, case):
    results = worlds[world][0]
    x, _w = _data(BKM_CASES[case][0])
    steps = [(str(s), int(r)) for s, r in results[f"{case}/steps"].tolist()]
    n_splits = len(steps)
    assert steps == [("bisect_split", x.shape[0])] * n_splits
    assert n_splits == (3 if case == "bkm/blobs" else 1)
    assert results[f"{case}/run"].tolist() == ["distributed_bisecting", "done"]
    got = {kind: int(c)
           for kind, c, _b in results[f"{case}/collectives"].tolist()}
    assert got["all_max"] == 2 * n_splits
    assert got["all_gather"] == 1
    # seeding's two SUMs, at least one Lloyd SUM and its final-cost SUM,
    # and the children's moments, per split
    assert got["all_reduce"] >= 5 * n_splits


if __name__ == "__main__":
    _worker(sys.argv[1])
