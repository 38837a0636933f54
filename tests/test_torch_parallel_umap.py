"""The sharded UMAP optimizer across ranks: the port's
``distributed_umap_optimize`` against the tiled optimizer of both
packages, on the same numpy inputs.

The port side runs in worlds of 1, 2 and 4 gloo ranks on the CPU
(``OMP_NUM_THREADS=1``), started through the port's launcher: this file is
also the worker script (``__main__`` at the bottom), which imports only the
port, runs every case of its world and writes one ``.npz`` per rank. The
three worlds start together once per module, each in a process group of
its own under a timeout.

Inputs: ``tests/test_distributed_umap.py``'s edge list and PCA init (96
rows, 2 blobs), made in the test process and read by every rank;
repulsion 0.5; 5 epochs at float64, 1 at float32.

Bars: every rank bit-identical to rank 0; at float64 each world within
1e-9 of the port's tiled optimizer (the JAX test's bar between meshes)
and, as max |Δ| / max |y|, of the JAX package's tiled optimizer
(``tests/test_torch_umap.py`` says why the packages differ by more than
the meshes); the float32 epoch within 1e-4 of the float64 epoch (max |Δ|
/ max |y|, the first-epoch bar of ``chip_smoke.py`` phase 24: 9.7e-6 on
these inputs; later epochs amplify it ~1000× an epoch); the collectives
as the JAX package accounts them.
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
EPOCHS = 5
REPULSION = 0.5
BLOCK = 48
F64_ATOL = 1e-9
F32_REL = 1e-4


# -- the worker: one rank of a world (imports only the port) ------------------

def _worker(out_dir):
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.ops.umap_kernel import fit_ab
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        device_count,
        distributed_umap_optimize,
        initialize_multihost,
    )

    shared = np.load(os.path.join(out_dir, "..", "inputs.npz"))
    a, b = fit_ab(0.1)
    out = {}
    initialize_multihost()
    out["backend"] = np.asarray(dist.get_backend())
    mesh = data_mesh(device_count())
    for label, dtype, epochs in (("f64", np.float64, EPOCHS),
                                 ("f32", np.float32, 1)):
        emb = distributed_umap_optimize(
            shared["ei"], shared["ej"], shared["ep"], shared["emb0"], mesh,
            a, b, learning_rate=1.0, repulsion_strength=REPULSION,
            n_epochs=epochs, dtype=dtype, block_rows=BLOCK // 2)
        out[label] = np.asarray(emb)
        out[f"{label}/collectives"] = np.asarray([
            (kind, c["count"], c["bytes"])
            for kind, c in sorted(emb.fit_report_.collectives.items())])
    out["jax_imported"] = np.asarray(sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "spark_rapids_ml_tpu"
        or m.startswith("spark_rapids_ml_tpu.")))
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


# -- running worlds ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inputs():
    """tests/test_distributed_umap.py's ``_graph_and_init`` (its rng is
    tests/conftest.py's, seed 42), made with the port's operations at
    float64 (``tests/test_torch_umap.py`` holds each to the JAX
    package's), so the worlds start before any JAX program compiles."""
    import torch

    from spark_rapids_ml_tpu_torch.models.umap import knn_without_self
    from spark_rapids_ml_tpu_torch.ops.umap_kernel import (
        memberships,
        pca_init,
        symmetric_edge_list,
    )

    rng = np.random.default_rng(42)
    n, d, k = 96, 6, 8
    centers = np.array([np.eye(d)[i] * 8 for i in range(2)])
    y = rng.integers(0, 2, size=n)
    x = torch.as_tensor(rng.normal(size=(n, d)) * 0.4 + centers[y])
    dists, idx = knn_without_self(x, x, k)
    ei, ej, ep = symmetric_edge_list(memberships(dists).numpy(),
                                     idx.numpy(), n)
    return {"ei": ei, "ej": ej, "ep": ep, "emb0": pca_init(x, 2).numpy()}


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
    worlds, started together once the inputs are written."""
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "inputs.npz"), **_inputs())
        procs = {}
        for w in WORLDS:
            out_dir = os.path.join(tmp, f"world{w}")
            os.makedirs(out_dir)
            log = open(os.path.join(tmp, f"world{w}.log"), "w")
            procs[w] = (log, _launch(w, out_dir, log))
        # the one-device references, while the worlds start
        for package in ("port", "jax"):
            _tiled(package)
        _tiled("port", 1)
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


@functools.lru_cache(maxsize=None)
def _tiled(package, epochs=EPOCHS):
    """``epochs`` of ``package``'s tiled optimizer at float64, one
    device."""
    inputs = _inputs()
    n = len(inputs["emb0"])
    if package == "jax":
        import jax.numpy as jnp

        from spark_rapids_ml_tpu.ops.umap_kernel import (
            fit_ab,
            optimize_embedding_blocked,
        )

        a, b = fit_ab(0.1)
        return np.asarray(optimize_embedding_blocked(
            jnp.asarray(inputs["ei"]), jnp.asarray(inputs["ej"]),
            jnp.asarray(inputs["ep"]), jnp.asarray(inputs["emb0"]),
            jnp.asarray(np.ones(n, dtype=bool)), jnp.asarray(a),
            jnp.asarray(b), jnp.asarray(1.0), jnp.asarray(REPULSION),
            epochs, BLOCK))
    import torch

    from spark_rapids_ml_tpu_torch.ops.umap_kernel import (
        fit_ab,
        optimize_embedding_blocked,
    )

    a, b = fit_ab(0.1)
    return optimize_embedding_blocked(
        inputs["ei"], inputs["ej"], torch.as_tensor(inputs["ep"]),
        torch.as_tensor(inputs["emb0"]), None, a, b, 1.0, REPULSION, epochs,
        BLOCK).numpy()


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
def test_sharded_equals_the_tiled_optimizer(worlds, world):
    got = worlds[world][0]["f64"]
    assert got.shape == _inputs()["emb0"].shape
    assert np.abs(got - _tiled("port")).max() <= F64_ATOL
    assert _rel(got, _tiled("jax")) <= F64_ATOL


@pytest.mark.parametrize("world", WORLDS)
def test_float32_epoch_follows_float64(worlds, world):
    assert _rel(worlds[world][0]["f32"], _tiled("port", 1)) <= F32_REL


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_as_the_jax_package_accounts_them(worlds, world):
    n_pad = -(-len(_inputs()["emb0"]) // world) * world
    for label, itemsize, epochs in (("f64", 8, EPOCHS), ("f32", 4, 1)):
        got = {kind: (int(c), int(b)) for kind, c, b
               in worlds[world][0][f"{label}/collectives"].tolist()}
        # per epoch one collective of the padded embedding's bytes each
        payload = epochs * n_pad * 2 * itemsize
        assert got == {"all_gather": (epochs, payload),
                       "all_reduce": (epochs, payload)}


if __name__ == "__main__":
    _worker(sys.argv[1])
