"""Sharded nearest-neighbour searches and DBSCAN across ranks: the port's
``distributed_kneighbors``, ``distributed_ivf_search`` and
``distributed_dbscan_labels`` against the JAX package's functions, on the
same numpy inputs.

The port side runs in worlds of 1, 2 and 4 gloo ranks on the CPU
(``OMP_NUM_THREADS=1``), started through the port's launcher: this file is
also the worker script (``__main__`` at the bottom), which imports only the
port, runs every case of its world and writes one ``.npz`` per rank. The
three worlds start together once per module, each in a process group of
its own under a timeout.

Cases: brute force on 203 uneven rows and on 9 rows for k = 6 (the skewed
tiny shards: fewer rows than k per rank); the four cases of
``tests/test_distributed_ivf.py`` on the port's own index (exact at full
probe, recall not below one device, ivfpq quality, brute refused); the
sharded IVF-Flat and IVF-PQ searches on the JAX model's index arrays,
written by the test process and read by every rank; DBSCAN on the two
blob sets of ``tests/test_distributed_dbscan.py``.

Bars: every rank bit-identical to rank 0; at float64 the port's world of w
ranks equal to the JAX function on a w-device mesh (squared distances 1e-12
relative, indices and labels equal): both shard the same way, so
per-shard probing probes the same lists; float32 within 1e-3 of the
oracle (the JAX test's bar); the IVF contracts as the JAX tests state
them.
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
F64_REL = 1e-12
BRUTE = {"uneven": (203, 12, 17), "tiny": (9, 5, 4)}   # items, dim, queries
BRUTE_K = 6
IVF_K = 8
SHARED = {"ivfflat": {"nlist": 16, "nprobe": 2},
          "ivfpq": {"nlist": 16, "nprobe": 4, "pqBits": 8,
                    "refineRatio": 0.0}}
DBSCAN_SETS = {"even": (40, 5), "uneven": (41, 3)}     # per blob, noise


def _brute_data(name):
    n, d, q = BRUTE[name]
    rng = np.random.default_rng(11 + n)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(q, d)).astype(np.float32))


def _clustered():
    """tests/test_distributed_ivf.py's fixture: 16 blobs of 64 rows in 12
    dimensions, 32 of the rows as queries."""
    rng = np.random.default_rng(5)
    centers = rng.normal(scale=8, size=(16, 12))
    items = np.concatenate(
        [rng.normal(loc=c, size=(64, 12)) for c in centers]
    ).astype(np.float32)
    return items, items[rng.choice(len(items), 32, replace=False)]


def _dbscan_data(name):
    per, noise = DBSCAN_SETS[name]
    rng = np.random.default_rng(3 + per)
    centers = np.array([[0, 8], [8, 0], [-8, -8]], dtype=float)
    pts = [c + 0.6 * rng.normal(size=(per, 2)) for c in centers]
    pts.append(rng.uniform(-30, 30, size=(noise, 2)))
    return np.concatenate(pts)


def _recall(ai, ei, k):
    return np.mean([len(set(ai[i]) & set(ei[i])) / k
                    for i in range(len(ai))])


def _oracle(queries, items, k):
    q = queries.astype(np.float64)
    x = items.astype(np.float64)
    d2 = (q * q).sum(1)[:, None] - 2 * q @ x.T + (x * x).sum(1)[None, :]
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.sqrt(np.maximum(np.take_along_axis(d2, order, 1), 0)), order


# -- the worker: one rank of a world (imports only the port) ------------------

def _worker(out_dir):
    import torch
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch import NearestNeighbors
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        device_count,
        distributed_dbscan_labels,
        distributed_ivf_search,
        distributed_kneighbors,
        initialize_multihost,
    )

    out = {}

    def put(key, value):
        if torch.is_tensor(value):
            value = value.cpu().numpy()
        out[key] = np.asarray(value)

    def put_result(key, result):
        put(f"{key}/d", result[0])
        put(f"{key}/i", result[1])
        report = getattr(result, "fit_report_", None)
        if report is not None:
            put(f"{key}/collectives", [
                (kind, c["count"], c["bytes"])
                for kind, c in sorted(report.collectives.items())])

    initialize_multihost()
    put("backend", dist.get_backend())
    mesh = data_mesh(device_count())
    cpu = torch.device("cpu")
    for name in BRUTE:
        items, queries = _brute_data(name)
        put_result(f"brute/{name}/f32", distributed_kneighbors(
            queries, items, BRUTE_K, mesh))
        put_result(f"brute/{name}/f64", distributed_kneighbors(
            queries, items, BRUTE_K, mesh, dtype=np.float64))

    items, queries = _clustered()

    def model(algorithm, **params):
        m = NearestNeighbors().setK(IVF_K).setAlgorithm(algorithm)
        for key, value in params.items():
            m.set(key, value)
        return m.fit(items)

    full = model("ivfflat", nlist=16, nprobe=16)
    put_result("ivf/full", distributed_ivf_search(full, queries, mesh,
                                                  dtype=np.float64))
    for key, m in (("ivf/partial", model("ivfflat", nlist=16, nprobe=2)),
                   ("ivf/pq", model("ivfpq", nlist=16, nprobe=4, pqBits=8,
                                    refineRatio=0.0))):
        put_result(key, distributed_ivf_search(m, queries, mesh))
        put_result(f"{key}/single", m.kneighbors(queries))
    try:
        distributed_ivf_search(model("brute"), queries, mesh)
        put("ivf/brute_refused", "")
    except ValueError as e:
        put("ivf/brute_refused", str(e))

    shared = np.load(os.path.join(out_dir, "..", "jax_index.npz"))
    for algorithm, params in SHARED.items():
        m = model(algorithm, **params)
        arrays = [torch.as_tensor(shared[f"{algorithm}/{j}"])
                  for j in range(4 if algorithm == "ivfflat" else 5)]
        nlist = params["nlist"]
        if algorithm == "ivfflat":
            m._ivf_index_cache = ((cpu, torch.float64, nlist),
                                  (*arrays, nlist))
        else:
            m._ivfpq_index_cache = ((cpu, torch.float64, nlist,
                                     arrays[1].shape[0],
                                     arrays[1].shape[1]), (*arrays, nlist))
        put_result(f"shared/{algorithm}", distributed_ivf_search(
            m, queries, mesh, dtype=np.float64))

    for name in DBSCAN_SETS:
        x = _dbscan_data(name)
        for label, dt in (("f64", np.float64), ("f32", np.float32)):
            put_result(f"dbscan/{name}/{label}", distributed_dbscan_labels(
                x, 1.5, 5, mesh, dtype=dt))
    put("jax_imported", sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "spark_rapids_ml_tpu"
        or m.startswith("spark_rapids_ml_tpu.")))
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


# -- running worlds ------------------------------------------------------------

def _jax_index_arrays():
    """The JAX models' own indexes (float64) for the shared cases, as
    {"<algorithm>/<j>": array}."""
    import jax
    import jax.numpy as jnp

    out = {}
    for algorithm in SHARED:
        model = _jax_model(algorithm)
        dev = jax.local_devices()[0]
        index = (model._ivf_index(dev, jnp.float64)
                 if algorithm == "ivfflat"
                 else model._ivfpq_index(dev, jnp.float64))
        for j, a in enumerate(index[:-1]):
            out[f"{algorithm}/{j}"] = np.asarray(a)
    return out


@functools.lru_cache(maxsize=None)
def _jax_model(algorithm):
    from spark_rapids_ml_tpu import NearestNeighbors as JaxNN

    m = JaxNN().setK(IVF_K).setAlgorithm(algorithm)
    for key, value in SHARED[algorithm].items():
        m.set(key, value)
    return m.fit(_clustered()[0])


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
    """{world size: [rank 0's results, rank 1's, ...]} from the three
    worlds, started together once the JAX index arrays are written."""
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "jax_index.npz"), **_jax_index_arrays())
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


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _rel_d(got, want):
    """``_rel`` of squared distances: the square root magnifies a self
    match's rounding residue (~1e-13 in d²) past any relative bar."""
    return _rel(np.square(got), np.square(want))


def _collectives(results, key):
    return {kind: (int(c), int(b))
            for kind, c, b in results[f"{key}/collectives"].tolist()}


# -- tests ---------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_is_bit_identical_to_rank_0(worlds, world):
    ranks = worlds[world]
    assert len(ranks) == world
    for rank, results in enumerate(ranks[1:], start=1):
        assert set(results) == set(ranks[0])
        for key, value in results.items():
            assert np.array_equal(value, ranks[0][key]), (rank, key)


@pytest.mark.parametrize("world", WORLDS)
def test_worker_imports_only_the_port_and_joins_over_gloo(worlds, world):
    for results in worlds[world]:
        assert results["jax_imported"].size == 0, results["jax_imported"]
        assert str(results["backend"]) == "gloo"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(BRUTE))
def test_brute_equals_the_jax_search_and_the_oracle(worlds, world, name):
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.parallel import data_mesh, distributed_kneighbors

    results = worlds[world][0]
    items, queries = _brute_data(name)
    jd, ji = distributed_kneighbors(queries, items, BRUTE_K,
                                    data_mesh(world), dtype=jnp.float64)
    assert _rel_d(results[f"brute/{name}/f64/d"], jd) <= F64_REL
    np.testing.assert_array_equal(results[f"brute/{name}/f64/i"], ji)
    od, oi = _oracle(queries, items, BRUTE_K)
    d32, i32 = results[f"brute/{name}/f32/d"], results[f"brute/{name}/f32/i"]
    assert d32.shape == (len(queries), BRUTE_K) and int(i32.max()) < len(items)
    np.testing.assert_allclose(d32, od, atol=1e-3)
    d_of_idx = np.linalg.norm(queries[:, None, :].astype(np.float64)
                              - items[i32].astype(np.float64), axis=2)
    np.testing.assert_allclose(d_of_idx, od, atol=1e-3)
    # two all_gathers of (q, k_local·world): distances and int32 indices
    per = -(-len(items) // world)
    k_local = min(BRUTE_K, per)
    cells = len(queries) * k_local * world
    assert _collectives(results, f"brute/{name}/f32") == {
        "all_gather": (2, cells * 4 + cells * 4)}


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_ivfflat_exact_at_full_probe(worlds, world):
    from spark_rapids_ml_tpu_torch import NearestNeighbors

    results = worlds[world][0]
    items, queries = _clustered()
    ed, ei = NearestNeighbors().setK(IVF_K).setDtype("float64").fit(
        items).kneighbors(queries)
    np.testing.assert_allclose(results["ivf/full/d"], ed, atol=1e-3)
    np.testing.assert_array_equal(results["ivf/full/i"], ei)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_ivfflat_recall_not_below_single_device(worlds, world):
    results = worlds[world][0]
    items, queries = _clustered()
    _, ei = _oracle(queries, items, IVF_K)
    assert _recall(results["ivf/partial/i"], ei, IVF_K) >= _recall(
        results["ivf/partial/single/i"], ei, IVF_K) - 1e-9


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_ivfpq_matches_single_device_quality(worlds, world):
    results = worlds[world][0]
    items, queries = _clustered()
    _, ei = _oracle(queries, items, IVF_K)
    di = results["ivf/pq/i"]
    assert _recall(di, ei, IVF_K) >= _recall(
        results["ivf/pq/single/i"], ei, IVF_K) - 0.05
    assert results["ivf/pq/d"].shape == (32, IVF_K) and (di >= 0).all()


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_ivf_rejects_brute(worlds, world):
    assert "ivfflat/ivfpq" in str(worlds[world][0]["ivf/brute_refused"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("algorithm", list(SHARED))
def test_sharded_search_on_the_jax_index_equals_the_jax_search(
        worlds, world, algorithm):
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.parallel import data_mesh, distributed_ivf_search

    results = worlds[world][0]
    _, queries = _clustered()
    jd, ji = distributed_ivf_search(_jax_model(algorithm), queries,
                                    data_mesh(world), dtype=jnp.float64)
    assert _rel_d(results[f"shared/{algorithm}/d"], jd) <= F64_REL
    np.testing.assert_array_equal(results[f"shared/{algorithm}/i"], ji)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(DBSCAN_SETS))
def test_distributed_dbscan_equals_the_jax_labels(worlds, world, name):
    from spark_rapids_ml_tpu.parallel import (
        data_mesh,
        distributed_dbscan_labels,
    )

    results = worlds[world][0]
    x = _dbscan_data(name)
    jl, jc = distributed_dbscan_labels(x, 1.5, 5, data_mesh(world),
                                       dtype=np.float64)
    for label in ("f64", "f32"):
        np.testing.assert_array_equal(results[f"dbscan/{name}/{label}/d"],
                                      jl)
        np.testing.assert_array_equal(results[f"dbscan/{name}/{label}/i"],
                                      jc)


if __name__ == "__main__":
    _worker(sys.argv[1])
