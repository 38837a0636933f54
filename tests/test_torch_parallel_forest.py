"""The sharded tree fits across ranks: the port's ``distributed_forest_fit``
and ``distributed_gbt_fit`` against the JAX package's, on the same numpy
inputs.

The port side runs in worlds of 1, 2 and 4 gloo ranks on the CPU
(``OMP_NUM_THREADS=1``), started through the port's launcher: this file is
also the worker script (``__main__`` at the bottom), which imports only the
port, runs every case of its world and writes one ``.npz`` per rank. The
three worlds start together once per module, each in a process group of
its own under a timeout, and the JAX meshes of 1, 2 and 4 devices
(tests/conftest.py's virtual CPU devices) fit the same cases meanwhile.

Cases, on 1001 rows (uneven, so 2 and 4 ranks pad, and the bootstrap is
drawn over the padded rows as the JAX package draws it): a RandomForest
regressor and a 3-class classifier at float64 (and the classifier at
float32), a binary GBT classifier and a GBT regressor with subsampling.

Bars: every rank bit-identical to rank 0; at float64 the world of w ranks
equal to the JAX function on a w-device mesh (features and thresholds
equal, leaves, gains and the init margin within 1e-12); the float32
classifier's trees equal to the float64 ones (exact class counts); the
fit reports' collectives as the port counts them (the JAX package's
histogram all_reduces at 8 bytes an element, and GBT's leaf-id gather).
Regression trees (the forest's and every GBT round's) keep ``min_leaf`` 8
against near-ties (see tests/test_torch_forest.py).
"""

import functools
import os
import signal
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (1, 2, 4)
WORLD_TIMEOUT_S = 120
F64_ATOL = 1e-12
N, D, BINS = 1001, 5, 16
FOREST = dict(n_trees=3, max_depth=3, n_bins=BINS, seed=4)
GBT = dict(max_iter=4, max_depth=3, n_bins=BINS, step_size=0.3, min_leaf=8)
CASES = {
    "forest_reg": ("forest", dict(FOREST, min_leaf=8)),
    "forest_cls": ("forest", dict(FOREST, classification=True)),
    "gbt_cls": ("gbt", dict(GBT, classification=True)),
    "gbt_reg": ("gbt", dict(GBT, subsampling_rate=0.8, seed=6)),
}


def _data(case):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(N, D))
    if case == "forest_cls":
        score = x[:, 0] + x[:, 1] ** 2
        return x, np.searchsorted(np.quantile(score, [1 / 3, 2 / 3]),
                                  score).astype(np.float64)
    if case == "gbt_cls":
        return x, ((x[:, 0] + x[:, 1] ** 2) > 0.8).astype(np.float64)
    return x, (2.0 * x[:, 0] - x[:, 1] + np.sin(2.0 * x[:, 2])
               + 0.1 * rng.normal(size=N))


# -- the worker: one rank of a world (imports only the port) ------------------

def _worker(out_dir):
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        device_count,
        distributed_forest_fit,
        distributed_gbt_fit,
        initialize_multihost,
    )

    out = {}
    initialize_multihost()
    out["backend"] = np.asarray(dist.get_backend())
    mesh = data_mesh(device_count())
    fits = {"forest": distributed_forest_fit, "gbt": distributed_gbt_fit}
    runs = [(case, case, np.float64) for case in CASES]
    runs.append(("forest_cls_f32", "forest_cls", np.float32))
    for key, case, dtype in runs:
        kind, params = CASES[case]
        x, y = _data(case)
        result = fits[kind](x, y, mesh, dtype=dtype, **params)
        ens, edges, third, gains = result
        out[f"{key}/feature"] = ens.feature
        out[f"{key}/threshold"] = ens.threshold
        out[f"{key}/leaf"] = ens.leaf_value
        out[f"{key}/gains"] = gains
        out[f"{key}/edges"] = edges
        out[f"{key}/third"] = np.asarray(
            [] if third is None else third, dtype=np.float64)
        report = result.fit_report_
        out[f"{key}/collectives"] = np.asarray([
            (kind_, c["count"], c["bytes"])
            for kind_, c in sorted(report.collectives.items())],
            dtype=object)
    out["jax_imported"] = np.asarray(sorted(
        m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "spark_rapids_ml_tpu"
        or m.startswith("spark_rapids_ml_tpu.")))
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


@functools.lru_cache(maxsize=None)
def _jax_fit(case, world):
    """The JAX package's fit of ``case`` on a mesh of ``world`` devices."""
    from spark_rapids_ml_tpu.parallel import (
        data_mesh,
        distributed_forest_fit,
        distributed_gbt_fit,
    )

    kind, params = CASES[case]
    fit = distributed_forest_fit if kind == "forest" else distributed_gbt_fit
    x, y = _data(case)
    return fit(x, y, data_mesh(world), dtype=np.float64, **params)


@pytest.fixture(scope="module")
def worlds():
    """{world size: [rank 0's results, rank 1's, ...]} from the three
    worlds, started together; the JAX fits run while they do."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for w in WORLDS:
            out_dir = os.path.join(tmp, f"world{w}")
            os.makedirs(out_dir)
            log = open(os.path.join(tmp, f"world{w}.log"), "w")
            procs[w] = (log, _launch(w, out_dir, log))
        try:
            # one thread a mesh size: XLA compiles outside the GIL
            with ThreadPoolExecutor(len(WORLDS)) as pool:
                for done in [pool.submit(lambda w=w: [_jax_fit(c, w)
                                                      for c in CASES])
                             for w in WORLDS]:
                    done.result()
        finally:
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
                    with np.load(path, allow_pickle=True) as z:
                        results[w].append({k: z[k] for k in z.files})
    return results


# -- tests ---------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_is_bit_identical_to_rank_0(worlds, world):
    ranks = worlds[world]
    assert len(ranks) == world
    for rank, results in enumerate(ranks[1:], start=1):
        assert set(results) == set(ranks[0])
        for key, value in results.items():
            if value.dtype == object:
                assert value.tolist() == ranks[0][key].tolist(), (rank, key)
            else:
                assert np.array_equal(value, ranks[0][key]), (rank, key)


@pytest.mark.parametrize("world", WORLDS)
def test_worker_imports_only_the_port_and_joins_over_gloo(worlds, world):
    for results in worlds[world]:
        assert results["jax_imported"].size == 0, results["jax_imported"]
        assert str(results["backend"]) == "gloo"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_world_equals_the_jax_mesh_of_its_size(worlds, world, case):
    results = worlds[world][0]
    ens, edges, third, gains = _jax_fit(case, world)
    np.testing.assert_array_equal(results[f"{case}/feature"],
                                  np.asarray(ens.feature))
    np.testing.assert_array_equal(results[f"{case}/threshold"],
                                  np.asarray(ens.threshold))
    np.testing.assert_allclose(results[f"{case}/leaf"],
                               np.asarray(ens.leaf_value), rtol=0,
                               atol=F64_ATOL)
    np.testing.assert_allclose(results[f"{case}/gains"], np.asarray(gains),
                               rtol=1e-12)
    np.testing.assert_array_equal(results[f"{case}/edges"], edges)
    if third is None:
        assert results[f"{case}/third"].size == 0
    else:
        np.testing.assert_allclose(results[f"{case}/third"], third, rtol=0,
                                   atol=F64_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_float32_classifier_grows_the_float64_trees(worlds, world):
    results = worlds[world][0]
    for field in ("feature", "threshold"):
        np.testing.assert_array_equal(results[f"forest_cls_f32/{field}"],
                                      results[f"forest_cls/{field}"])
    assert results["forest_cls_f32/leaf"].dtype == np.float32
    np.testing.assert_allclose(results["forest_cls_f32/leaf"],
                               results["forest_cls/leaf"], atol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_are_accounted(worlds, world):
    """Per tree the JAX package's count: max_depth all_reduces of a
    (channels, 2^max_depth, d, n_bins) operand with len(classes) + 1
    channels for classification, 3 for regression — at 8 bytes an
    element, the float64 the port reduces, whatever the fit's dtype.
    GBT adds one all_gather a round of the padded rows' int64 leaf ids."""
    results = worlds[world][0]
    padded = -(-N // world) * world

    def table(key):
        return {kind: (int(c), int(b))
                for kind, c, b in results[f"{key}/collectives"].tolist()}

    cells = 2 ** 3 * D * BINS
    for key, channels in (("forest_reg", 3), ("forest_cls", 4),
                          ("forest_cls_f32", 4)):
        count = 3 * 3  # trees × levels
        assert table(key) == {
            "all_reduce": (count, count * channels * cells * 8)}
    for key in ("gbt_cls", "gbt_reg"):
        rounds = 4
        assert table(key) == {
            "all_reduce": (rounds * 3, rounds * 3 * 3 * cells * 8),
            "all_gather": (rounds, rounds * padded * 8)}


if __name__ == "__main__":
    _worker(sys.argv[1])
