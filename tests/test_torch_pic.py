"""PowerIterationClustering in the port against the JAX package, on the same
numpy inputs, and its distributed form across gloo ranks.

Local cases: ``build_affinity`` bit-equal to JAX's (float32 and float64,
with and without padding rows, weights and a self-loop) and raising JAX's
errors; the power iteration against JAX's at float64 (≤ 1e-12, relative
L1) and float32 (≤ 1e-5, the phase 27 bar); ``assign_clusters`` giving
JAX's partition on the graphs of ``tests/test_decision_tree.py`` and
``tests/test_distributed.py`` (co-membership of every pair equal; labels
cannot match draw for draw, since the port seeds k-means++ from a
``torch.Generator``), and JAX's labels exactly when its k-means starts
from JAX's initial centres; persistence both ways.

The distributed cases run in worlds of 1, 2 and 4 gloo ranks on the CPU
(``OMP_NUM_THREADS=1``), started through the port's launcher: this file is
also the worker script (``__main__`` at the bottom), which imports only
the port, runs every case and writes one ``.npz`` per rank. Bars: every
rank bit-identical to rank 0; the iterate within 1e-12 of the local one at
float64 (1e-5 at float32); the partition equal to the local fit's and to
the JAX driver's on its 8-device mesh; the collectives as JAX accounts
them, ``max_iter`` all_gathers of the padded iterate.
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
F64_RTOL = 1e-12
F32_RTOL = 1e-5


def _two_cliques():
    """``tests/test_decision_tree.py``'s graph: clique {0, 1, 2}, the larger
    clique {10, 11, 12, 13}, one weak bridge."""
    edges = [(0, 1, 1.0), (1, 2, 1.0), (0, 2, 1.0),
             (10, 11, 1.0), (11, 12, 1.0), (10, 12, 1.0),
             (10, 13, 1.0), (11, 13, 1.0), (12, 13, 1.0),
             (2, 10, 0.01)]
    src, dst, w = zip(*edges)
    return np.asarray(src, float), np.asarray(dst, float), np.asarray(w)


def _triangles():
    """``tests/test_distributed.py``'s two triangles, unit weights."""
    return (np.asarray([0, 1, 0, 3, 4, 3], float),
            np.asarray([1, 2, 2, 4, 5, 5], float), None)


def _rings():
    """``tests/test_distributed.py``'s three 40-node rings with 7-step
    chords, unit weights."""
    src, dst = [], []
    for c in range(3):
        base = c * 40
        for i in range(40):
            src += [base + i, base + i]
            dst += [base + (i + 1) % 40, base + (i + 7) % 40]
    return np.asarray(src, float), np.asarray(dst, float), None


def _weighted():
    """A seeded graph with uneven weights, a self-loop and repeated edges:
    two 9-node communities joined by two light edges."""
    rng = np.random.default_rng(28)
    src = np.concatenate([rng.integers(0, 9, 30), rng.integers(9, 18, 30),
                          [4, 3, 7]])
    dst = np.concatenate([rng.integers(0, 9, 30), rng.integers(9, 18, 30),
                          [4, 12, 15]])
    for lo in (0, 9):  # a ring inside each community: no isolated vertex
        src = np.concatenate([src, np.arange(lo, lo + 9)])
        dst = np.concatenate([dst, lo + (np.arange(9) + 1) % 9])
    w = rng.uniform(0.5, 2.0, src.shape[0])
    w[-20:-18] = 0.01
    return src.astype(float), dst.astype(float), w


GRAPHS = {"cliques": _two_cliques, "triangles": _triangles,
          "rings": _rings, "weighted": _weighted}

# name → (graph, keyword arguments of distributed_pic_assign)
DIST_CASES = {
    "triangles": ("triangles", {"k": 2, "max_iter": 20, "seed": 1,
                                "dtype": np.float64}),
    "rings": ("rings", {"k": 3, "max_iter": 30, "seed": 4,
                        "dtype": np.float64}),
    "rings/f32": ("rings", {"k": 3, "max_iter": 30, "seed": 4}),
    "weighted/degree": ("weighted", {"k": 2, "max_iter": 20, "seed": 2,
                                     "init_mode": "degree",
                                     "dtype": np.float64}),
}


def _edges(name):
    src, dst, w = GRAPHS[name]()
    return src, dst, w


# -- the worker: one rank of a world (imports only the port) ------------------

def _worker(out_dir):
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.obs import fitmon
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        device_count,
        distributed_pic,
        distributed_pic_assign,
        initialize_multihost,
    )

    out = {}
    initialize_multihost()
    out["backend"] = np.asarray(dist.get_backend())
    mesh = data_mesh(device_count())
    rank = dist.get_rank()
    real = distributed_pic.distributed_power_iterate_kernel
    for case, (graph, kwargs) in DIST_CASES.items():
        src, dst, w = _edges(graph)
        seen = {}

        def kernel(*args, **kw):
            seen["v"] = real(*args, **kw)
            return seen["v"]

        distributed_pic.distributed_power_iterate_kernel = kernel
        try:
            result = distributed_pic_assign(src, dst, w, mesh=mesh, **kwargs)
        finally:
            distributed_pic.distributed_power_iterate_kernel = real
        ids, labels = result
        out[f"{case}/ids"] = ids
        out[f"{case}/labels"] = labels
        out[f"{case}/v"] = seen["v"].numpy()
        out[f"{case}/collectives"] = np.asarray([
            (kind, c["count"], c["bytes"])
            for kind, c in sorted(result.fit_report_.collectives.items())])
        run = fitmon.get_fit_monitor().recent_runs()[0]  # newest first
        out[f"{case}/run"] = np.asarray([run.algo, run.status])
    out["jax_imported"] = np.asarray(sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "spark_rapids_ml_tpu" or m.startswith("spark_rapids_ml_tpu.")))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


# -- running worlds -----------------------------------------------------------

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


def _frame(package, src, dst, w):
    if package == "jax":
        from spark_rapids_ml_tpu.data.frame import VectorFrame
    else:
        from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
    cols = {"src": list(src), "dst": list(dst)}
    if w is not None:
        cols["w"] = list(w)
    return VectorFrame(cols)


def _estimators(w, **params):
    """(the port's, JAX's) PowerIterationClustering with ``params``."""
    from spark_rapids_ml_tpu.models.pic import PowerIterationClustering as J

    from spark_rapids_ml_tpu_torch import PowerIterationClustering as P

    if w is not None:
        params["weightCol"] = "w"
    return P(**params), J(**params)


def _same_partition(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return bool(np.array_equal(a[:, None] == a[None, :],
                               b[:, None] == b[None, :]))


def _rel_l1(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).sum() / np.abs(want).sum())


def _jax_iterate(w, v0, max_iter, dtype):
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.models.pic import _power_iterate

    return np.asarray(_power_iterate(jnp.asarray(w, dtype=dtype),
                                     jnp.asarray(v0, dtype=dtype), max_iter))


def _port_iterate(w, v0, max_iter, dtype):
    import torch

    from spark_rapids_ml_tpu_torch.models.pic import _power_iterate

    return _power_iterate(torch.as_tensor(w, dtype=dtype),
                          torch.as_tensor(v0, dtype=dtype), max_iter).numpy()


# -- build_affinity -----------------------------------------------------------

@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pad", [0, 3])
def test_build_affinity_is_bit_equal_to_jax(graph, np_dtype, pad):
    from spark_rapids_ml_tpu.models.pic import build_affinity as jax_build

    from spark_rapids_ml_tpu_torch.models.pic import build_affinity

    src, dst, w = _edges(graph)
    w = np.ones(src.shape[0]) if w is None else w
    got = build_affinity(src, dst, w, 1000, np_dtype, pad_rows=pad)
    want = jax_build(src, dst, w, 1000, np_dtype, pad_rows=pad)
    for g, e in zip(got, want):
        assert g.dtype == e.dtype and np.array_equal(g, e)
    ids, a, deg = got
    assert a.shape == (len(ids) + pad,) * 2 and a.dtype == np_dtype
    assert not a[len(ids):].any() and not a[:, len(ids):].any()
    np.testing.assert_allclose(a[:len(ids)].sum(axis=1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("case,edges,max_nodes,match", [
    ("negative", ([0.0], [1.0], [-1.0]), 10, "nonnegative"),
    ("empty", ([], [], []), 10, "empty edge frame"),
    ("fractional src", ([0.5], [1.0], [1.0]), 10, "srcCol must hold"),
    ("huge dst", ([0.0], [2.0**53], [1.0]), 10, "dstCol must hold"),
    ("envelope", ([0.0, 1.0, 2.0], [1.0, 2.0, 0.0], [1.0] * 3), 2,
     "maxDenseNodes=2"),
    ("isolated", ([0.0, 1.0], [1.0, 2.0], [1.0, 0.0]), 10,
     "isolated vertex"),
])
def test_build_affinity_raises_as_jax(case, edges, max_nodes, match):
    from spark_rapids_ml_tpu.models.pic import build_affinity as jax_build

    from spark_rapids_ml_tpu_torch.models.pic import build_affinity

    messages = []
    for build in (build_affinity, jax_build):
        with pytest.raises(ValueError, match=match) as info:
            build(*edges, max_nodes, np.float64)
        messages.append(str(info.value))
    assert messages[0] == messages[1], case


# -- the power iteration ------------------------------------------------------

@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("init", ["random", "degree"])
def test_power_iteration_matches_jax(graph, init):
    """float64 within 1e-12 of JAX's iterate; float32 within 1e-5 of JAX's
    float32 iterate and of float64, from the same numpy start."""
    import torch

    from spark_rapids_ml_tpu.models.pic import build_affinity as jax_build

    from spark_rapids_ml_tpu_torch.models.pic import initial_vector

    src, dst, w = _edges(graph)
    w = np.ones(src.shape[0]) if w is None else w
    ids, a64, deg = jax_build(src, dst, w, 1000, np.float64)
    v0 = initial_vector(deg, len(ids), 0, init, 5)
    want = _jax_iterate(a64, v0, 25, "float64")
    got = _port_iterate(a64, v0, 25, torch.float64)
    assert _rel_l1(got, want) <= F64_RTOL
    _ids, a32, _deg = jax_build(src, dst, w, 1000, np.float32)
    got32 = _port_iterate(a32, v0, 25, torch.float32)
    assert got32.dtype == np.float32
    assert _rel_l1(got32, _jax_iterate(a32, v0, 25, "float32")) <= F32_RTOL
    assert _rel_l1(got32, want) <= F32_RTOL


def test_initial_vector_is_the_jax_start():
    """The 'random' start is ``default_rng(seed).random(n)`` normalised, as
    both JAX paths draw it; padding entries are zero."""
    from spark_rapids_ml_tpu_torch.models.pic import initial_vector

    deg = np.arange(1.0, 6.0)
    v0 = np.random.default_rng(3).random(5)
    np.testing.assert_array_equal(initial_vector(deg, 5, 2, "random", 3),
                                  np.concatenate([v0 / v0.sum(), [0, 0]]))
    np.testing.assert_array_equal(initial_vector(deg, 5, 0, "degree", 3),
                                  deg / deg.sum())
    with pytest.raises(ValueError, match="initMode"):
        initial_vector(deg, 5, 0, "eigen", 3)


# -- assign_clusters ----------------------------------------------------------

# (the rings are regular: from their degrees the iteration has no
# transient to cluster, so they run from the random start only)
@pytest.mark.parametrize("graph,k,max_iter,seed,init", [
    ("cliques", 2, 30, 3, "random"), ("cliques", 2, 30, 3, "degree"),
    ("triangles", 2, 20, 1, "random"), ("triangles", 2, 20, 1, "degree"),
    ("rings", 3, 30, 4, "random"), ("weighted", 2, 20, 2, "random"),
    ("weighted", 2, 20, 2, "degree")])
def test_assign_clusters_partitions_as_jax(graph, k, max_iter, seed, init):
    src, dst, w = _edges(graph)
    ours, theirs = _estimators(w, k=k, maxIter=max_iter, seed=seed,
                               initMode=init, dtype="float64")
    got = ours.assign_clusters(_frame("port", src, dst, w))
    want = theirs.assign_clusters(_frame("jax", src, dst, w))
    assert list(got.column("id")) == list(want.column("id"))
    assert all(isinstance(i, int) for i in got.column("id"))
    assert all(isinstance(c, int) for c in got.column("cluster"))
    assert _same_partition(got.column("cluster"), want.column("cluster"))
    assert set(ours.assign_timings_) == set(theirs.assign_timings_) == {
        "affinity", "power_iteration", "kmeans"}
    if graph == "cliques":
        by_id = dict(zip(got.column("id"), got.column("cluster")))
        assert len({by_id[i] for i in (0, 1, 2)}) == 1
        assert len({by_id[i] for i in (10, 11, 12, 13)}) == 1
        assert by_id[0] != by_id[10]


def test_kmeans_from_jax_initial_centres_gives_jax_labels():
    """The final k-means on JAX's iterate, started from the centres JAX's
    k-means++ drew, gives JAX's labels exactly."""
    import jax
    import jax.numpy as jnp
    import torch

    from spark_rapids_ml_tpu.models.pic import build_affinity as jax_build
    from spark_rapids_ml_tpu.ops import kmeans_kernel as jkm

    from spark_rapids_ml_tpu_torch.models import pic
    from spark_rapids_ml_tpu_torch.ops import kmeans_kernel as km

    src, dst, _w = _edges("rings")
    ids, a, deg = jax_build(src, dst, np.ones(src.shape[0]), 1000,
                            np.float64)
    n = len(ids)
    v = _jax_iterate(a, pic.initial_vector(deg, n, 0, "random", 4), 30,
                     "float64")
    emb = jnp.asarray(v[:, None] * n)
    init = jkm.kmeans_plus_plus_init(emb, 3, jax.random.PRNGKey(4))
    res = jkm.kmeans_fit_kernel(emb, init, max_iter=pic.KMEANS_MAX_ITER,
                                tol=pic.KMEANS_TOL)
    want = np.asarray(jkm.assign_clusters(emb, res.centers))
    emb_t = torch.as_tensor(v[:, None] * n)
    ours = km.kmeans_fit_kernel(emb_t, torch.tensor(np.asarray(init)),
                                max_iter=pic.KMEANS_MAX_ITER,
                                tol=pic.KMEANS_TOL)
    got = km.assign_clusters(emb_t, ours.centers).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(ours.centers.numpy(), np.asarray(res.centers),
                               rtol=0, atol=1e-12)


def test_self_loop_counts_once_and_ids_stay_ints():
    ours, theirs = _estimators([2.0, 1.0], k=2, dtype="float64")
    got = ours.assign_clusters(_frame("port", [0, 0], [0, 1], [2.0, 1.0]))
    want = theirs.assign_clusters(_frame("jax", [0, 0], [0, 1], [2.0, 1.0]))
    assert got.column("id") == want.column("id") == [0, 1]
    assert all(isinstance(i, int) for i in got.column("id"))


@pytest.mark.parametrize("edges,params,match", [
    ({"src": [], "dst": []}, {}, "empty"),
    ({"src": [0], "dst": [1], "w": [-1.0]}, {"weightCol": "w"},
     "nonnegative"),
    ({"src": [0, 1, 2], "dst": [1, 2, 0]}, {"maxDenseNodes": 2},
     "maxDenseNodes"),
])
def test_assign_clusters_raises_as_jax(edges, params, match):
    from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxFrame
    from spark_rapids_ml_tpu.models.pic import PowerIterationClustering as J

    from spark_rapids_ml_tpu_torch import PowerIterationClustering
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    for cls, frame in ((PowerIterationClustering, VectorFrame),
                       (J, JaxFrame)):
        with pytest.raises(ValueError, match=match):
            cls(k=2, **params).assign_clusters(frame(edges))


def test_params_and_validators_as_jax():
    from spark_rapids_ml_tpu.models.pic import PowerIterationClustering as J

    from spark_rapids_ml_tpu_torch import PowerIterationClustering

    ours, theirs = PowerIterationClustering(), J()
    names = sorted(ours.params())
    assert names == sorted(theirs.params())
    for name in names:
        if name != "dtype":
            assert ours.get_or_default(name) == theirs.get_or_default(name)
    for name, bad in (("k", 1), ("maxIter", 0), ("initMode", "eigen"),
                      ("maxDenseNodes", 1), ("dtype", "float16")):
        for est in (ours, theirs):
            with pytest.raises(ValueError):
                est.set(name, bad)


def test_no_cuda_and_no_cpu_request_raises(monkeypatch):
    import torch

    from spark_rapids_ml_tpu_torch import PowerIterationClustering
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PowerIterationClustering(k=2).assign_clusters(
            VectorFrame({"src": [0, 1], "dst": [1, 2]}))


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
def test_persistence_both_ways(tmp_path, direction):
    from spark_rapids_ml_tpu.models.pic import PowerIterationClustering as J

    from spark_rapids_ml_tpu_torch import PowerIterationClustering
    from spark_rapids_ml_tpu_torch.io.persistence import load_model

    params = {"k": 3, "maxIter": 7, "initMode": "degree", "srcCol": "a",
              "dstCol": "b", "weightCol": "c", "seed": 9,
              "maxDenseNodes": 512, "dtype": "float64"}
    path = str(tmp_path / "pic")
    if direction == "port->jax":
        PowerIterationClustering(**params).save(path)
        loaded = [J.load(path)]
    else:
        J(**params).save(path)
        loaded = [PowerIterationClustering.load(path), load_model(path)]
        assert type(loaded[1]) is PowerIterationClustering
    for est in loaded:
        for name, value in params.items():
            assert est.get_or_default(name) == value, name


# -- across gloo ranks --------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_is_bit_identical_to_rank_0(worlds, world):
    ranks = worlds[world]
    assert len(ranks) == world
    for results in ranks[1:]:
        assert set(results) == set(ranks[0])
        for key, value in results.items():
            assert np.array_equal(value, ranks[0][key]), key
    for results in ranks:
        assert results["jax_imported"].size == 0, results["jax_imported"]
        assert str(results["backend"]) == "gloo"


@functools.lru_cache(maxsize=None)
def _local_fit(case):
    """(ids, labels, float64 iterate of the unpadded affinity) of the
    port's local path for a distributed case."""
    import torch

    from spark_rapids_ml_tpu_torch.models import pic

    graph, kwargs = DIST_CASES[case]
    src, dst, w = _edges(graph)
    ids, a, deg = pic.build_affinity(
        src, dst, np.ones(src.shape[0]) if w is None else w, 10_000,
        np.float64)
    v0 = pic.initial_vector(deg, len(ids), 0,
                            kwargs.get("init_mode", "random"),
                            kwargs["seed"])
    v = _port_iterate(a, v0, kwargs["max_iter"], torch.float64)
    ours, _theirs = _estimators(
        w, k=kwargs["k"], maxIter=kwargs["max_iter"], seed=kwargs["seed"],
        initMode=kwargs.get("init_mode", "random"),
        dtype="float64" if kwargs.get("dtype") == np.float64 else "float32")
    out = ours.assign_clusters(_frame("port", src, dst, w))
    return (np.asarray(out.column("id")), np.asarray(out.column("cluster")),
            v)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(DIST_CASES))
def test_distributed_fit_agrees_with_the_local_fit(worlds, world, case):
    results = worlds[world][0]
    ids, labels, v64 = _local_fit(case)
    n = ids.shape[0]
    pad = (-n) % world
    v = results[f"{case}/v"]
    assert v.shape == (n + pad,)
    assert not v[n:].any()
    bar = F32_RTOL if case.endswith("f32") else F64_RTOL
    assert v.dtype == (np.float32 if case.endswith("f32") else np.float64)
    assert _rel_l1(v[:n], v64) <= bar
    np.testing.assert_array_equal(results[f"{case}/ids"], ids)
    assert results[f"{case}/labels"].dtype == np.int64
    assert _same_partition(results[f"{case}/labels"], labels)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(DIST_CASES))
def test_distributed_accounting_as_jax(worlds, world, case):
    results = worlds[world][0]
    _graph, kwargs = DIST_CASES[case]
    n = results[f"{case}/ids"].shape[0]
    itemsize = 4 if case.endswith("f32") else 8
    padded = n + (-n) % world
    got = {kind: (int(c), int(b))
           for kind, c, b in results[f"{case}/collectives"].tolist()}
    assert got == {"all_gather": (kwargs["max_iter"],
                                  kwargs["max_iter"] * padded * itemsize)}
    assert results[f"{case}/run"].tolist() == ["distributed_pic", "done"]


@pytest.mark.parametrize("case", ["triangles", "rings", "weighted/degree"])
def test_jax_driver_gives_the_same_partition(worlds, case):
    """The JAX driver on its 8-device CPU mesh, against the port's ranks."""
    from spark_rapids_ml_tpu.parallel import data_mesh, distributed_pic_assign

    graph, kwargs = DIST_CASES[case]
    src, dst, w = _edges(graph)
    kwargs = dict(kwargs)
    kwargs["dtype"] = "float64"
    ids, labels = distributed_pic_assign(src, dst, w, mesh=data_mesh(8),
                                         **kwargs)
    for world in WORLDS:
        results = worlds[world][0]
        np.testing.assert_array_equal(results[f"{case}/ids"], ids)
        assert _same_partition(results[f"{case}/labels"], labels)


if __name__ == "__main__":
    _worker(sys.argv[1])
