"""PCA across ranks: the port's ``parallel`` package against the JAX
package's, on the same numpy inputs.

The JAX side runs in this process on its 8-virtual-device mesh
(``data_mesh(n)`` / ``grid_mesh(d, f)``). The port side runs in worlds of 1,
2 and 4 gloo ranks on the CPU, started through the port's launcher: this
file is also the worker script (``__main__`` at the bottom), which imports
only the port, runs every case of its world and writes one ``.npz`` per
rank. The three worlds start together once per module, each under a
timeout, so a hang fails the tests instead of stalling the suite.

Data: numpy from a seed, at most 512 rows and 32 features, column variances
1/(1+j), except where a case needs another spectrum (the randomized
solver's low-rank and exponentially decaying ones, as the JAX tests use).

Bars, float64: components within 1e-9 after sign alignment, EVR and mean
within 1e-10, every rank bit-identical to rank 0, ring equal to all-gather
within 1e-12. The randomized solver is held as the JAX tests hold it
(``jax.random`` and ``torch.Generator`` draw different starts from one
seed): exact on a low-rank spectrum, close on a decaying one, and the
sharded solve equal to the replicated one. float32 (the card's dtype, which
takes the Gram kernel's plain version here) at PERF.md's fit bar against
the float64 oracle: |cos| ≥ 0.999 per component, EVR within 1e-4, mean
within 1e-5.
"""

import functools
import os
import signal
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (1, 2, 4)
# the feature-sharded grids each world runs, (data, feature)
GRIDS = {1: ((1, 1),), 2: ((2, 1), (1, 2)), 4: ((2, 2), (4, 1), (1, 4))}
GRID_CASES = [(w, g) for w in WORLDS for g in GRIDS[w]]
WORLD_TIMEOUT_S = 120
PROBE_ENV = "PARALLEL_PARITY_PROBE"

COMP_TOL, EVR_TOL, MEAN_TOL = 1e-9, 1e-10, 1e-10


# -- data (numpy only: shared by the worker and the JAX side) -----------------

def _columns(seed, rows, n, loc=0.0, scale=1.0):
    """Rows with column variances scale²/(1+j), shifted by ``loc``."""
    rng = np.random.default_rng(seed)
    return scale * rng.normal(size=(rows, n)) / np.sqrt(1.0 + np.arange(n)) + loc


def _spectrum(seed, rows, n, scales):
    rng = np.random.default_rng(seed)
    basis, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return rng.normal(size=(rows, n)) @ (basis * scales)


def _low_rank(seed, rows, n, rank):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, n)) @ rng.normal(size=(n, rank))
            @ rng.normal(size=(rank, n)))


DATA = {
    "uneven": lambda: _columns(1, 203, 12),
    "offset": lambda: _columns(2, 160, 10, loc=5.0),
    "nocenter": lambda: _columns(3, 96, 6, loc=2.0),
    "multihost": lambda: _columns(4, 509, 32),
    "stream": lambda: _columns(5, 512, 24, loc=1.5),
    "stream_decay": lambda: _spectrum(6, 256, 24, 2.0 ** -np.arange(24)),
    "fs_cov": lambda: _columns(7, 57, 12, scale=3.0,
                               loc=np.linspace(-2.0, 2.0, 12)),
    "fs_nocenter": lambda: _columns(8, 40, 8, loc=5.0),
    "fs_ring_ag": lambda: _columns(9, 33, 20),
    "fs_fit": lambda: _columns(10, 61, 10),
    "fs_low_rank": lambda: _low_rank(11, 80, 16, 5),
    "fs_general": lambda: _spectrum(12, 300, 24, np.exp(-0.8 * np.arange(24))),
    "fs_replicated": lambda: _spectrum(13, 200, 16,
                                       np.exp(-0.7 * np.arange(16))),
}

# data-parallel fits: name → (data, k, keyword arguments)
DP_CASES = {
    "two_pass": ("uneven", 5, {}),
    "one_pass": ("offset", 3, {"one_pass": True}),
    "one_pass_ref": ("offset", 3, {}),
    "no_centering": ("nocenter", 2, {"mean_centering": False}),
    "no_flip": ("uneven", 5, {"flip_signs": False}),
}
# float32 fits (the kernel's path): name → (data, k, keyword arguments)
F32_CASES = {
    "two_pass": ("uneven", 5, {}),
    "one_pass": ("uneven", 5, {"one_pass": True}),
}
STREAM_BATCH_ROWS = 64
# randomized feature-sharded fits: name → (data, k, oversample, n_iter)
RANDOMIZED_CASES = {
    "low_rank": ("fs_low_rank", 5, 8, 6),
    "general": ("fs_general", 3, 10, 6),
    "replicated": ("fs_replicated", 3, 10, 6),
}
REPLICATED_SEED = 7


# -- the worker: one rank of a world (imports only the port) ------------------

def _worker(out_dir):
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.data.batches import BatchSource
    from spark_rapids_ml_tpu_torch.ops.randomized import (
        randomized_pca_from_covariance,
    )
    from spark_rapids_ml_tpu_torch.parallel import (
        DistributedStreamingPCA,
        data_mesh,
        device_count,
        distributed_pca_fit,
        distributed_pca_fit_kernel,
        distributed_streaming_pca_fit,
        feature_sharded_covariance_kernel,
        feature_sharded_pca_fit,
        global_data_mesh,
        grid_mesh,
        host_local_shard,
        initialize_multihost,
        make_global_array,
        process_info,
    )
    from spark_rapids_ml_tpu_torch.parallel.feature_sharded import local_tile
    from spark_rapids_ml_tpu_torch.parallel.mesh import (
        FEATURE_AXIS,
        all_gather_rows,
    )
    from spark_rapids_ml_tpu_torch.parallel.multihost import _ENV_COORD
    from spark_rapids_ml_tpu_torch.utils.resources import PLATFORM_ENV

    out = {}

    def put(key, value):
        if torch.is_tensor(value):
            value = value.cpu().numpy()
        out[key] = np.asarray(value)

    def put_fit(key, result):
        for field, value in result._asdict().items():
            put(f"{key}/{field}", value)

    def put_error(key, fn):
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 - the message is the result
            put(key, f"{type(exc).__name__}: {exc}")
        else:
            put(key, "")

    put("joined", initialize_multihost())
    world = device_count()
    for key, value in process_info().items():
        put(f"local/{key}", value)
    put("local/local_rank", int(os.environ["LOCAL_RANK"]))
    put("local/probe", os.environ.get(PROBE_ENV, ""))
    put("backend", dist.get_backend())
    put_error("coordinator_mismatch",
              lambda: initialize_multihost(coordinator_address="hostB:9999"))
    put("coordinator_same", initialize_multihost(
        coordinator_address=os.environ[_ENV_COORD]))

    mesh = data_mesh(world)
    put("mesh/data_size", mesh.mesh.numel())
    put_error("mesh/data_too_many", lambda: data_mesh(99))
    put_error("mesh/grid_too_many", lambda: grid_mesh(8, 2))
    for case, (data, k, kwargs) in DP_CASES.items():
        put_fit(f"dp/{case}", distributed_pca_fit(DATA[data](), k, mesh,
                                                  **kwargs))
    for case, (data, k, kwargs) in F32_CASES.items():
        put_fit(f"f32/{case}", distributed_pca_fit(
            DATA[data](), k, mesh, dtype=np.float32, **kwargs))

    # multihost: each rank loads only its rows, fit on the local shards
    x = DATA["multihost"]()
    rows = host_local_shard(x.shape[0])
    put("local/mh_rows", [rows.start, rows.stop])
    global_mesh = global_data_mesh()
    put("mh/mesh_size", global_mesh.mesh.numel())
    shard = make_global_array(x[rows], global_mesh, x.shape[0])
    put("local/mh_shard_rows", shard.x.shape[0])
    put_fit("mh/fit", distributed_pca_fit_kernel(
        shard.x, shard.mask, mesh=global_mesh, k=4))
    put_error("mh/wrong_total",
              lambda: make_global_array(x[rows], global_mesh, x.shape[0] + 1))

    # streaming
    x = DATA["stream"]()
    put_fit("stream/matrix", distributed_streaming_pca_fit(
        BatchSource(x, batch_rows=STREAM_BATCH_ROWS), 4, mesh,
        dtype=torch.float64))
    put_fit("stream/generator", distributed_streaming_pca_fit(
        BatchSource(lambda: (x[i:i + 50] for i in range(0, len(x), 50)),
                    batch_rows=STREAM_BATCH_ROWS), 3, mesh,
        dtype=torch.float64))
    put_fit("stream/f32", distributed_streaming_pca_fit(
        BatchSource(x, batch_rows=STREAM_BATCH_ROWS), 4, mesh))
    acc = DistributedStreamingPCA(24, mesh, dtype=torch.float64)
    for i in range(0, len(x), 128):
        acc.partial_fit(x[i:i + 128])
    put("stream/rows_seen", acc.rows_seen)
    put_fit("stream/accumulator", acc.finalize(3))
    put_error("stream/uneven_batch", lambda: acc.partial_fit(x[:101]))
    put_error("stream/uneven_source", lambda: distributed_streaming_pca_fit(
        BatchSource(x, batch_rows=101), 2, mesh))
    x = DATA["stream_decay"]()
    for solver in ("eigh", "randomized"):
        put_fit(f"stream/decay_{solver}", distributed_streaming_pca_fit(
            BatchSource(x, batch_rows=STREAM_BATCH_ROWS), 4, mesh,
            dtype=torch.float64, solver=solver))

    # feature-sharded, on each grid of this world
    for d, f in GRIDS[world]:
        grid = grid_mesh(d, f)
        key = f"fs/{d}x{f}"
        put(f"{key}/shape", tuple(grid.mesh.shape))
        put(f"{key}/names", list(grid.mesh_dim_names))

        def full_cov(data, schedule, mean_centering=True):
            tile, mask = local_tile(DATA[data](), grid)
            g_row, mean_loc = feature_sharded_covariance_kernel(
                tile, mask, mesh=grid, mean_centering=mean_centering,
                schedule=schedule)
            group = grid.get_group(FEATURE_AXIS)
            n = DATA[data]().shape[1]
            return (all_gather_rows(g_row, group)[:n, :n],
                    all_gather_rows(mean_loc, group)[:n])

        for schedule in ("ring", "allgather"):
            cov, mean = full_cov("fs_cov", schedule)
            put(f"{key}/cov_{schedule}", cov)
            put(f"{key}/cov_mean_{schedule}", mean)
            put(f"{key}/ring_ag_{schedule}", full_cov("fs_ring_ag", schedule)[0])
            put_fit(f"{key}/fit_{schedule}", feature_sharded_pca_fit(
                DATA["fs_fit"](), 4, grid, schedule=schedule))
            put_fit(f"{key}/fit_no_flip_{schedule}", feature_sharded_pca_fit(
                DATA["fs_fit"](), 4, grid, schedule=schedule,
                flip_signs=False))
            put_fit(f"{key}/f32_{schedule}", feature_sharded_pca_fit(
                DATA["uneven"](), 5, grid, schedule=schedule,
                dtype=np.float32))
        cov, mean = full_cov("fs_nocenter", "ring", mean_centering=False)
        put(f"{key}/nocenter_cov", cov)
        put(f"{key}/nocenter_mean", mean)
        for case, (data, k, oversample, n_iter) in RANDOMIZED_CASES.items():
            put_fit(f"{key}/randomized_{case}", feature_sharded_pca_fit(
                DATA[data](), k, grid, solver="randomized",
                oversample=oversample, n_iter=n_iter,
                seed=REPLICATED_SEED if case == "replicated" else 0))
        data, k, oversample, n_iter = RANDOMIZED_CASES["replicated"]
        cov = full_cov(data, "ring")[0]
        put(f"{key}/replicated", randomized_pca_from_covariance(
            cov, k, torch.trace(cov), oversample=oversample, n_iter=n_iter,
            seed=REPLICATED_SEED)[0])
        if (d, f) == GRIDS[world][0]:
            x = np.random.default_rng(0).normal(size=(10, 4))
            put_error("fs_invalid/k", lambda: feature_sharded_pca_fit(x, 9, grid))
            put_error("fs_invalid/schedule", lambda: feature_sharded_pca_fit(
                x, 2, grid, schedule="bogus"))
            put_error("fs_invalid/solver", lambda: feature_sharded_pca_fit(
                x, 2, grid, solver="bogus"))
            put_error("fs_invalid/axes",
                      lambda: feature_sharded_pca_fit(x, 2, mesh))

    # without a card and without the CPU request, nothing carries on
    platform = os.environ.pop(PLATFORM_ENV)
    available, torch.cuda.is_available = torch.cuda.is_available, lambda: False
    try:
        put_error("no_card/initialize", initialize_multihost)
        put_error("no_card/data_mesh", data_mesh)
        put_error("no_card/fit",
                  lambda: distributed_pca_fit(DATA["uneven"](), 2, mesh))
    finally:
        os.environ[PLATFORM_ENV] = platform
        torch.cuda.is_available = available

    put("jax_imported", sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "spark_rapids_ml_tpu" or m.startswith("spark_rapids_ml_tpu.")))
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


# -- running worlds ------------------------------------------------------------

def _launch(nprocs, script, *args, env_extra=(), log=None):
    """Start the port's launcher in a session of its own (so a timeout can
    kill every rank)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_DIR + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "spark_rapids_ml_tpu_torch.launch",
           "--nprocs", str(nprocs)]
    for kv in env_extra:
        cmd += ["--env", kv]
    return subprocess.Popen(cmd + [script, *args], cwd=REPO_DIR, env=env,
                            stdout=log, stderr=subprocess.STDOUT,
                            start_new_session=True)


def _wait(proc, timeout):
    """The launcher's exit code, or None after killing its session when
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
            procs[w] = (log, _launch(
                w, os.path.abspath(__file__), out_dir, log=log,
                env_extra=("SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu",
                           "OMP_NUM_THREADS=1", f"{PROBE_ENV}=launched")))
        results = {}
        for w, (log, proc) in procs.items():
            rc = _wait(proc, WORLD_TIMEOUT_S)
            log.close()
            with open(log.name) as f:
                text = f.read()
            assert rc == 0, f"world of {w}: exit {rc}\n{text[-4000:]}"
            results[w] = []
            for rank in range(w):
                with np.load(os.path.join(tmp, f"world{w}", f"rank{rank}.npz")) as z:
                    results[w].append({k: z[k] for k in z.files})
    return results


def _rank0(worlds, world):
    return worlds[world][0]


def _fit(results, key):
    return tuple(results[f"{key}/{f}"]
                 for f in ("components", "explained_variance", "mean"))


def _aligned(a, ref):
    signs = np.sign(np.sum(a * ref, axis=0))
    signs[signs == 0] = 1.0
    return a * signs


def _sign_flipped(pc):
    """Each column's sign set so its max-|·| entry is positive (the fits'
    flip_signs rule)."""
    idx = np.argmax(np.abs(pc), axis=0)
    return pc * np.where(pc[idx, np.arange(pc.shape[1])] < 0, -1.0, 1.0)


def _assert_fit(got, want, comp_tol=COMP_TOL, evr_tol=EVR_TOL,
                mean_tol=MEAN_TOL):
    pc, evr, mean = (np.asarray(a, dtype=np.float64) for a in got)
    pc_w, evr_w, mean_w = (np.asarray(a, dtype=np.float64) for a in want)
    assert pc.shape == pc_w.shape
    np.testing.assert_allclose(_aligned(pc, pc_w), pc_w, atol=comp_tol, rtol=0)
    np.testing.assert_allclose(evr, evr_w, atol=evr_tol, rtol=0)
    np.testing.assert_allclose(mean, mean_w, atol=mean_tol, rtol=0)


def _oracle(data, k, mean_centering=True):
    from conftest import numpy_pca_oracle

    return numpy_pca_oracle(DATA[data](), k, mean_centering=mean_centering)


def _assert_f32_fit(got, data, k, mean_centering=True):
    """PERF.md's fit bar against the float64 oracle."""
    pc, evr, mean = (np.asarray(a, dtype=np.float64) for a in got)
    pc_w, evr_w, mean_w = _oracle(data, k, mean_centering)
    assert got[0].dtype == np.float32
    cos = np.abs(np.sum(pc * pc_w, axis=0))
    assert cos.min() >= 0.999, cos
    np.testing.assert_allclose(evr, evr_w, atol=1e-4, rtol=0)
    np.testing.assert_allclose(mean, mean_w, atol=1e-5, rtol=0)


# -- the JAX side (cached per case and mesh) ----------------------------------

def _np(result):
    return tuple(np.asarray(a) for a in result)


@functools.lru_cache(maxsize=None)
def _jax_dp(case, n_dev):
    from spark_rapids_ml_tpu.parallel import data_mesh, distributed_pca_fit

    data, k, kwargs = DP_CASES[case]
    return _np(distributed_pca_fit(DATA[data](), k, data_mesh(n_dev), **kwargs))


@functools.lru_cache(maxsize=None)
def _jax_stream(case, n_dev):
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.data.batches import BatchSource
    from spark_rapids_ml_tpu.parallel import data_mesh
    from spark_rapids_ml_tpu.parallel.streaming import (
        DistributedStreamingPCA,
        distributed_streaming_pca_fit,
    )

    mesh = data_mesh(n_dev)
    if case == "accumulator":
        x = DATA["stream"]()
        acc = DistributedStreamingPCA(24, mesh, dtype=jnp.float64)
        for i in range(0, len(x), 128):
            acc.partial_fit(x[i:i + 128])
        return _np(acc.finalize(3))
    if case == "matrix":
        x = DATA["stream"]()
        source, k = BatchSource(x, batch_rows=STREAM_BATCH_ROWS), 4
    else:
        x = DATA["stream"]()
        source = BatchSource(
            lambda: (x[i:i + 50] for i in range(0, len(x), 50)),
            batch_rows=STREAM_BATCH_ROWS)
        k = 3
    return _np(distributed_streaming_pca_fit(source, k, mesh,
                                             dtype=jnp.float64))


@functools.lru_cache(maxsize=None)
def _jax_fs_cov(data, grid, schedule, mean_centering=True):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from spark_rapids_ml_tpu.parallel.feature_sharded import (
        feature_sharded_covariance_kernel,
        pad_cols_to_multiple,
    )
    from spark_rapids_ml_tpu.parallel.mesh import (
        DATA_AXIS,
        FEATURE_AXIS,
        grid_mesh,
        pad_rows_to_multiple,
    )

    x = DATA[data]()
    mesh = grid_mesh(*grid)
    xp, mask = pad_rows_to_multiple(x, grid[0])
    xp = pad_cols_to_multiple(xp, grid[1])
    g, mean = feature_sharded_covariance_kernel(
        jax.device_put(xp, NamedSharding(mesh, P(DATA_AXIS, FEATURE_AXIS))),
        jax.device_put(mask, NamedSharding(mesh, P(DATA_AXIS))),
        mesh=mesh, mean_centering=mean_centering, schedule=schedule)
    n = x.shape[1]
    return np.asarray(g)[:n, :n], np.asarray(mean)[:n]


@functools.lru_cache(maxsize=None)
def _jax_fs_fit(data, k, grid, **kwargs):
    from spark_rapids_ml_tpu.parallel.feature_sharded import (
        feature_sharded_pca_fit,
    )
    from spark_rapids_ml_tpu.parallel.mesh import grid_mesh

    return _np(feature_sharded_pca_fit(DATA[data](), k, grid_mesh(*grid),
                                       **kwargs))


# -- every world: ranks agree, the launcher's environment, the runtime --------

@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_is_bit_identical_to_rank_0(worlds, world):
    ranks = worlds[world]
    assert len(ranks) == world
    for rank, results in enumerate(ranks[1:], start=1):
        assert set(results) == set(ranks[0])
        for key, value in results.items():
            if not key.startswith("local/"):
                assert value.dtype == ranks[0][key].dtype, key
                assert np.array_equal(value, ranks[0][key]), (rank, key)


@pytest.mark.parametrize("world", WORLDS)
def test_worker_imports_only_the_port(worlds, world):
    for results in worlds[world]:
        assert results["jax_imported"].size == 0, results["jax_imported"]


@pytest.mark.parametrize("world", WORLDS)
def test_launcher_sets_the_rank_environment(worlds, world):
    for rank, results in enumerate(worlds[world]):
        assert int(results["local/process_id"]) == rank
        assert int(results["local/process_count"]) == world
        assert int(results["local/global_devices"]) == world
        assert int(results["local/local_devices"]) == 1
        assert int(results["local/local_rank"]) == rank
        assert str(results["local/probe"]) == "launched"


@pytest.mark.parametrize("world", WORLDS)
def test_cpu_ranks_join_over_gloo(worlds, world):
    results = _rank0(worlds, world)
    assert str(results["backend"]) == "gloo"
    # initialize_multihost returns whether the job has several ranks
    assert bool(results["joined"]) == (world > 1)


@pytest.mark.parametrize("world", WORLDS)
def test_initialize_rejects_coordinator_mismatch(worlds, world):
    results = _rank0(worlds, world)
    assert "already initialized" in str(results["coordinator_mismatch"])
    assert "hostB:9999" in str(results["coordinator_mismatch"])
    # the same coordinator again is idempotent reuse
    assert bool(results["coordinator_same"]) == (world > 1)


@pytest.mark.parametrize("world", WORLDS)
def test_no_path_falls_back_without_a_card(worlds, world):
    results = _rank0(worlds, world)
    assert "no CUDA device" in str(results["no_card/initialize"])
    assert "no CUDA device" in str(results["no_card/data_mesh"])
    assert "SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu" in str(results["no_card/fit"])


# -- data-parallel fit (tests/test_distributed.py) -----------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_distributed_matches_jax_and_oracle(worlds, world):
    got = _fit(_rank0(worlds, world), "dp/two_pass")
    _assert_fit(got, _jax_dp("two_pass", world))
    _assert_fit(got, _oracle("uneven", 5))


@pytest.mark.parametrize("world", WORLDS)
def test_one_pass_matches_jax_and_two_pass(worlds, world):
    results = _rank0(worlds, world)
    got = _fit(results, "dp/one_pass")
    _assert_fit(got, _jax_dp("one_pass", world))
    _assert_fit(got, _fit(results, "dp/one_pass_ref"))
    _assert_fit(_fit(results, "dp/one_pass_ref"), _jax_dp("one_pass_ref", world))


@pytest.mark.parametrize("world", WORLDS)
def test_no_mean_centering_matches_jax(worlds, world):
    got = _fit(_rank0(worlds, world), "dp/no_centering")
    _assert_fit(got, _jax_dp("no_centering", world))
    _assert_fit(got, _oracle("nocenter", 2, mean_centering=False))
    assert not got[2].any()


@pytest.mark.parametrize("world", WORLDS)
def test_unflipped_signs_match_jax(worlds, world):
    """flip_signs=False keeps eigh's own column signs. Which sign a LAPACK
    eigh returns differs between the two packages, so the columns are held
    to the JAX package's up to sign, and flipping them gives the fit."""
    results = _rank0(worlds, world)
    got = _fit(results, "dp/no_flip")
    _assert_fit(got, _jax_dp("no_flip", world))
    np.testing.assert_array_equal(_sign_flipped(got[0]),
                                  results["dp/two_pass/components"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(F32_CASES))
def test_float32_fit_meets_the_fit_bar(worlds, world, case):
    data, k, _ = F32_CASES[case]
    _assert_f32_fit(_fit(_rank0(worlds, world), f"f32/{case}"), data, k)


@pytest.mark.parametrize("rows,multiple", [(5, 4), (5, 5), (203, 8), (1, 3)])
def test_pad_rows_to_multiple_matches_jax(rows, multiple):
    from spark_rapids_ml_tpu.parallel.mesh import pad_rows_to_multiple as jax_pad

    from spark_rapids_ml_tpu_torch.parallel import pad_rows_to_multiple

    x = np.arange(rows * 3, dtype=np.float64).reshape(rows, 3)
    got, want = pad_rows_to_multiple(x, multiple), jax_pad(x, multiple)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[0].shape[0] % multiple == 0 and got[1].sum() == rows


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_validation(worlds, world):
    results = _rank0(worlds, world)
    assert int(results["mesh/data_size"]) == world
    for key in ("mesh/data_too_many", "mesh/grid_too_many"):
        assert str(results[key]).startswith("ValueError: requested")
        assert "devices" in str(results[key])


@pytest.mark.parametrize("world,grid", GRID_CASES)
def test_grid_mesh_shape(worlds, world, grid):
    results = _rank0(worlds, world)
    key = f"fs/{grid[0]}x{grid[1]}"
    assert tuple(results[f"{key}/shape"]) == grid
    assert list(results[f"{key}/names"]) == ["data", "feature"]


# -- streamed fit (tests/test_distributed_streaming.py) ------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case,k", [("matrix", 4), ("generator", 3)])
def test_distributed_streaming_matches_jax(worlds, world, case, k):
    got = _fit(_rank0(worlds, world), f"stream/{case}")
    _assert_fit(got, _jax_stream(case, world))
    _assert_fit(got, _oracle("stream", k))


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_streaming_accumulator_api(worlds, world):
    results = _rank0(worlds, world)
    assert int(results["stream/rows_seen"]) == 512
    got = _fit(results, "stream/accumulator")
    assert got[0].shape == (24, 3)
    _assert_fit(got, _jax_stream("accumulator", world))


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_streaming_float32_meets_the_fit_bar(worlds, world):
    _assert_f32_fit(_fit(_rank0(worlds, world), "stream/f32"), "stream", 4)


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_streaming_batch_divisibility(worlds, world):
    results = _rank0(worlds, world)
    assert "divide evenly" in str(results["stream/uneven_batch"])
    assert "multiple of" in str(results["stream/uneven_source"])


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_streaming_randomized_finalize(worlds, world):
    results = _rank0(worlds, world)
    eigh = _fit(results, "stream/decay_eigh")
    _assert_fit(eigh, _oracle("stream_decay", 4))
    # the JAX test's bar for the randomized finalize against eigh
    np.testing.assert_allclose(
        np.abs(results["stream/decay_randomized/components"]),
        np.abs(eigh[0]), atol=2e-3)


# -- feature-sharded fit (tests/test_feature_sharded.py) -----------------------

@pytest.mark.parametrize("world,grid", GRID_CASES)
@pytest.mark.parametrize("schedule", ["ring", "allgather"])
def test_sharded_covariance_matches_jax(worlds, world, grid, schedule):
    results = _rank0(worlds, world)
    key = f"fs/{grid[0]}x{grid[1]}"
    cov_want, mean_want = _jax_fs_cov("fs_cov", grid, schedule)
    np.testing.assert_allclose(results[f"{key}/cov_{schedule}"], cov_want,
                               atol=1e-10, rtol=0)
    np.testing.assert_allclose(results[f"{key}/cov_mean_{schedule}"],
                               mean_want, atol=MEAN_TOL, rtol=0)


@pytest.mark.parametrize("world,grid", GRID_CASES)
def test_sharded_covariance_no_centering(worlds, world, grid):
    results = _rank0(worlds, world)
    key = f"fs/{grid[0]}x{grid[1]}"
    cov_want, _ = _jax_fs_cov("fs_nocenter", grid, "ring", mean_centering=False)
    assert not results[f"{key}/nocenter_mean"].any()
    np.testing.assert_allclose(results[f"{key}/nocenter_cov"], cov_want,
                               atol=1e-10, rtol=0)


@pytest.mark.parametrize("world,grid", GRID_CASES)
def test_ring_equals_allgather(worlds, world, grid):
    results = _rank0(worlds, world)
    key = f"fs/{grid[0]}x{grid[1]}"
    np.testing.assert_allclose(results[f"{key}/ring_ag_ring"],
                               results[f"{key}/ring_ag_allgather"],
                               atol=1e-12, rtol=0)
    _assert_fit(_fit(results, f"{key}/fit_ring"),
                _fit(results, f"{key}/fit_allgather"))


@pytest.mark.parametrize("world,grid", GRID_CASES)
@pytest.mark.parametrize("schedule", ["ring", "allgather"])
def test_sharded_fit_eigh_matches_jax_and_oracle(worlds, world, grid, schedule):
    got = _fit(_rank0(worlds, world), f"fs/{grid[0]}x{grid[1]}/fit_{schedule}")
    _assert_fit(got, _jax_fs_fit("fs_fit", 4, grid, schedule=schedule))
    _assert_fit(got, _oracle("fs_fit", 4))


@pytest.mark.parametrize("world,grid", GRID_CASES)
@pytest.mark.parametrize("schedule", ["ring", "allgather"])
def test_sharded_fit_unflipped_signs_match_jax(worlds, world, grid, schedule):
    results = _rank0(worlds, world)
    key = f"fs/{grid[0]}x{grid[1]}"
    got = _fit(results, f"{key}/fit_no_flip_{schedule}")
    _assert_fit(got, _jax_fs_fit("fs_fit", 4, grid, schedule=schedule,
                                 flip_signs=False))
    np.testing.assert_array_equal(_sign_flipped(got[0]),
                                  results[f"{key}/fit_{schedule}/components"])


@pytest.mark.parametrize("world,grid", GRID_CASES)
@pytest.mark.parametrize("schedule", ["ring", "allgather"])
def test_sharded_float32_fit_meets_the_fit_bar(worlds, world, grid, schedule):
    _assert_f32_fit(
        _fit(_rank0(worlds, world), f"fs/{grid[0]}x{grid[1]}/f32_{schedule}"),
        "uneven", 5)


@pytest.mark.parametrize("world,grid", GRID_CASES)
def test_randomized_solver_exact_on_low_rank(worlds, world, grid):
    got = _fit(_rank0(worlds, world),
               f"fs/{grid[0]}x{grid[1]}/randomized_low_rank")
    data, k, oversample, n_iter = RANDOMIZED_CASES["low_rank"]
    # the JAX test's bars; the JAX solver is exact here too
    for want in (_oracle(data, k),
                 _jax_fs_fit(data, k, grid, solver="randomized",
                             oversample=oversample, n_iter=n_iter)):
        _assert_fit(got, want, comp_tol=1e-6, evr_tol=1e-8)


@pytest.mark.parametrize("world,grid", GRID_CASES)
def test_randomized_solver_general_spectrum(worlds, world, grid):
    got = _fit(_rank0(worlds, world), f"fs/{grid[0]}x{grid[1]}/randomized_general")
    data, k, _, _ = RANDOMIZED_CASES["general"]
    want = _oracle(data, k)
    _assert_fit(got, want, comp_tol=1e-6, evr_tol=1e-7)


@pytest.mark.parametrize("world,grid", GRID_CASES)
def test_randomized_replicated_matches_sharded(worlds, world, grid):
    results = _rank0(worlds, world)
    key = f"fs/{grid[0]}x{grid[1]}"
    np.testing.assert_allclose(results[f"{key}/randomized_replicated/components"],
                               results[f"{key}/replicated"],
                               atol=COMP_TOL, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_feature_sharded_validations(worlds, world):
    results = _rank0(worlds, world)
    assert "k = 9" in str(results["fs_invalid/k"])
    assert "schedule" in str(results["fs_invalid/schedule"])
    assert "solver" in str(results["fs_invalid/solver"])
    assert "axes" in str(results["fs_invalid/axes"])


# -- multi-host runtime (tests/test_multihost.py, tests/test_multiprocess.py) --

@pytest.fixture
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    for name in ("SPARK_RAPIDS_ML_TORCH_COORDINATOR",
                 "SPARK_RAPIDS_ML_TORCH_NUM_PROCESSES",
                 "SPARK_RAPIDS_ML_TORCH_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)


def test_initialize_single_host_is_noop(_cpu_requested):
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.parallel import (
        device_count,
        initialize_multihost,
        process_info,
    )

    assert initialize_multihost() is False
    assert not dist.is_initialized()
    assert process_info() == {"process_id": 0, "process_count": 1,
                              "local_devices": 1, "global_devices": 1}
    assert device_count() == 1


def test_a_card_joins_over_nccl(monkeypatch):
    """On a card the backend is NCCL, and the rank's device is made current
    before the group is joined."""
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.parallel import multihost

    calls = []
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", raising=False)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(multihost, "_initialized_coordinator", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda device: calls.append(("set_device", device)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append(("init", a, kw)))
    assert multihost.initialize_multihost("127.0.0.1:1234", 2, 1) is True
    assert calls == [
        ("set_device", torch.device("cuda", 1)),
        ("init", ("nccl",), {"init_method": "tcp://127.0.0.1:1234",
                             "world_size": 2, "rank": 1}),
    ]


@pytest.mark.parametrize("n_rows,pcount", [(10, 4), (103, 1), (509, 2),
                                           (509, 4), (3, 4)])
def test_host_local_shard_matches_jax(n_rows, pcount):
    from spark_rapids_ml_tpu.parallel.multihost import (
        host_local_shard as jax_shard,
    )

    from spark_rapids_ml_tpu_torch.parallel import host_local_shard

    slices = [host_local_shard(n_rows, p, pcount) for p in range(pcount)]
    assert slices == [jax_shard(n_rows, p, pcount) for p in range(pcount)]
    assert slices[0].start == 0 and slices[-1].stop == n_rows
    for a, b in zip(slices, slices[1:]):
        assert a.stop == b.start


def test_host_local_shard_single_process_takes_every_row(_cpu_requested):
    from spark_rapids_ml_tpu_torch.parallel import host_local_shard

    assert host_local_shard(103) == slice(0, 103)


@pytest.mark.parametrize("world", WORLDS)
def test_global_mesh_and_local_shards_fit_like_jax(worlds, world):
    """Each rank loads only ``host_local_shard`` of the rows (uneven at 509
    rows), places them with ``make_global_array`` and runs the sharded fit
    on them: the JAX package's multi-process fit, held to its kernel on the
    whole array over as many devices."""
    from spark_rapids_ml_tpu.parallel import (
        data_mesh,
        distributed_pca_fit_kernel,
    )
    from spark_rapids_ml_tpu.parallel.mesh import pad_rows_to_multiple

    from spark_rapids_ml_tpu_torch.parallel import host_local_shard

    ranks = worlds[world]
    n_rows = DATA["multihost"]().shape[0]
    for rank, results in enumerate(ranks):
        want = host_local_shard(n_rows, rank, world)
        assert list(results["local/mh_rows"]) == [want.start, want.stop]
        assert int(results["local/mh_shard_rows"]) == want.stop - want.start
    assert int(ranks[0]["mh/mesh_size"]) == world
    assert "not 510" in str(ranks[0]["mh/wrong_total"])
    x, mask = pad_rows_to_multiple(DATA["multihost"](), world)
    want = _np(distributed_pca_fit_kernel(x, mask, mesh=data_mesh(world), k=4))
    got = _fit(ranks[0], "mh/fit")
    _assert_fit(got, want)
    _assert_fit(got, _oracle("multihost", 4))


def _script(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_launcher_fails_fast_on_child_crash(tmp_path):
    """Rank 1 exits with 3 at once; rank 0 would wait for ever. The launcher
    stops rank 0 and returns 3."""
    script = _script(tmp_path, "crasher.py", (
        "import os, sys, threading\n"
        "if os.environ['SPARK_RAPIDS_ML_TORCH_PROCESS_ID'] == '1':\n"
        "    sys.exit(3)\n"
        "threading.Event().wait()\n"))
    assert _wait(_launch(2, script), 60) == 3


def test_launcher_node_rank_requires_coordinator(tmp_path):
    script = _script(tmp_path, "noop.py", "pass\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_DIR + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "spark_rapids_ml_tpu_torch.launch",
         "--nprocs", "2", "--node-rank", "1", script],
        capture_output=True, text=True, env=env, cwd=REPO_DIR, timeout=60)
    assert out.returncode == 2
    assert "--node-rank requires --coordinator" in out.stderr


def test_launcher_runs_one_rank_of_a_job_spread_over_hosts(tmp_path):
    """With ``--node-rank`` only that process starts, on its host's card 0,
    and the job's coordinator and size are passed on."""
    out_file = tmp_path / "env.txt"
    script = _script(tmp_path, "env.py", (
        "import os\n"
        f"open({str(out_file)!r}, 'w').write(' '.join(os.environ[k] for k in "
        "('SPARK_RAPIDS_ML_TORCH_COORDINATOR', "
        "'SPARK_RAPIDS_ML_TORCH_NUM_PROCESSES', "
        "'SPARK_RAPIDS_ML_TORCH_PROCESS_ID', 'LOCAL_RANK')))\n"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_rapids_ml_tpu_torch.launch",
         "--nprocs", "3", "--node-rank", "2", "--coordinator", "host0:29500",
         script],
        cwd=REPO_DIR,
        env=dict(os.environ, PYTHONPATH=REPO_DIR + os.pathsep
                 + os.environ.get("PYTHONPATH", "")),
        start_new_session=True)
    assert _wait(proc, 60) == 0
    assert out_file.read_text() == "host0:29500 3 2 0"


if __name__ == "__main__":
    _worker(sys.argv[1])
