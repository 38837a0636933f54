"""``parallel/distributed_optim.py``: the MLP fit across gloo ranks against
the port's local fit, on the same seeded numpy inputs.

The worlds are 1, 2 and 4 gloo ranks on the CPU (``OMP_NUM_THREADS=1``),
started together through the port's launcher: this file is also the
worker script (``__main__`` at the bottom), which imports only the port,
runs every case and writes one ``.npz`` per rank. Bars:

* every rank bit-identical to rank 0 (every rank reads the same
  all-reduced value and gradient, so the host line search takes the same
  steps everywhere);
* float64: the parameters within 1e-12 (max |Δ| / max |p|) of the port's
  local fit on all the rows, the same ``n_iter``, the loss within 1e-12
  of the starting loss (a converged loss of 7e-7 is a mean of row terms
  rounded at the objective's scale, not at its own) — the rows' sums are
  taken in another order, nothing else differs;
* float32, on ``tests/test_distributed.py::test_distributed_mlp_fit``'s
  own data (seed 42, [4, 8, 3], seed 1, maxIter 200): a finite loss and
  accuracy > 0.9, that test's specification, in every world (the JAX
  reference's float32 fit ends on NaN there; ``tests/test_torch_mlp.py``
  shows why);
* the collectives recorded at their true counts: as many all-reduces of
  (P + 2) elements as the objective was evaluated, line-search trials
  included, counted against the all-reduces the worker saw issued and
  the objective evaluations it saw made (the report's bytes are their
  total).
"""

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


def _distributed_test_data():
    """``tests/test_distributed.py::test_distributed_mlp_fit``'s rows."""
    rng = np.random.default_rng(42)
    centers = np.asarray([[0, 0, 0, 0], [4, 4, 0, 0], [0, 4, 4, 0]],
                         dtype=np.float64)
    y = rng.integers(0, 3, size=301).astype(float)
    x = rng.normal(size=(301, 4)) + centers[y.astype(int)]
    return x, y


def _overlap_data():
    """Two overlapping 3-D blobs of 203 rows with weights U(0.5, 2)."""
    rng = np.random.default_rng(29)
    y = rng.integers(0, 2, size=203).astype(float)
    x = rng.normal(size=(203, 3)) + 0.8 * y[:, None]
    w = rng.uniform(0.5, 2.0, size=203)
    return x, y, w


# name → (data, keyword arguments of distributed_mlp_fit)
CASES = {
    "dist/f64": ("dist", dict(layers=[4, 8, 3], max_iter=200, seed=1,
                              dtype=np.float64)),
    "dist/f32": ("dist", dict(layers=[4, 8, 3], max_iter=200, seed=1)),
    "overlap/weighted/f64": ("overlap", dict(layers=[3, 5, 2], max_iter=15,
                                             seed=4, dtype=np.float64)),
    "overlap/gd/f64": ("overlap", dict(layers=[3, 5, 2], max_iter=25,
                                       seed=4, solver="gd", step_size=0.3,
                                       dtype=np.float64)),
}


def _case_data(name):
    data, kwargs = CASES[name]
    if data == "dist":
        x, y = _distributed_test_data()
        return x, y, None, dict(kwargs)
    x, y, w = _overlap_data()
    return x, y, (w if "weighted" in name else None), dict(kwargs)


# -- the worker: one rank of a world (imports only the port) ------------------

def _worker(out_dir):
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.ops.mlp_kernel import flatten_weights
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        device_count,
        distributed_mlp_fit,
        distributed_optim,
        initialize_multihost,
    )

    out = {}
    initialize_multihost()
    out["backend"] = np.asarray(dist.get_backend())
    mesh = data_mesh(device_count())
    rank = dist.get_rank()
    issued = [0]
    real_all_reduce = dist.all_reduce

    def counting_all_reduce(*args, **kwargs):
        issued[0] += 1
        return real_all_reduce(*args, **kwargs)

    evals = [0]
    real_vg = distributed_optim.weighted_mean_value_and_grad

    def counting_vg(*args, **kwargs):
        vg = real_vg(*args, **kwargs)

        def counted(flat):
            evals[0] += 1
            return vg(flat)

        return counted

    dist.all_reduce = counting_all_reduce
    distributed_optim.weighted_mean_value_and_grad = counting_vg
    try:
        for case in CASES:
            x, y, w, kwargs = _case_data(case)
            layers = kwargs.pop("layers")
            issued[0] = evals[0] = 0
            result = distributed_mlp_fit(x, y, layers, mesh, weights=w,
                                         **kwargs)
            params, n_iter, loss = result
            out[f"{case}/flat"] = flatten_weights(params)
            out[f"{case}/n_iter"] = np.asarray(n_iter)
            out[f"{case}/loss"] = np.asarray(loss)
            out[f"{case}/issued"] = np.asarray(issued[0])
            out[f"{case}/evaluations"] = np.asarray(evals[0])
            out[f"{case}/collectives"] = np.asarray([
                (kind, c["count"], c["bytes"]) for kind, c in
                sorted(result.fit_report_.collectives.items())])
    finally:
        dist.all_reduce = real_all_reduce
        distributed_optim.weighted_mean_value_and_grad = real_vg
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


@pytest.fixture(scope="module")
def local_fits():
    """The port's local fit of every float64 case on all the rows."""
    import torch

    from spark_rapids_ml_tpu_torch.ops.mlp_kernel import (
        SigmoidMLP,
        flatten_weights,
        init_weights,
        mlp_params_from_jax,
        mlp_params_to_numpy,
        mlp_train_kernel,
        validate_and_onehot,
    )

    out = {}
    for case in CASES:
        x, y, w, kwargs = _case_data(case)
        if kwargs.get("dtype") is not np.float64:
            continue
        layers = kwargs["layers"]
        oh = validate_and_onehot(x, y, layers)
        w = np.ones(x.shape[0]) if w is None else w
        net = mlp_params_from_jax(init_weights(layers, kwargs["seed"]),
                                  device="cpu", dtype=torch.float64)
        weights, n_iter, loss = mlp_train_kernel(
            list(net.weights), torch.as_tensor(x), torch.as_tensor(oh),
            torch.as_tensor(w), solver=kwargs.get("solver", "l-bfgs"),
            max_iter=kwargs["max_iter"], tol=1e-6,
            step_size=kwargs.get("step_size", 0.03))
        _, _, start = mlp_train_kernel(
            list(net.weights), torch.as_tensor(x), torch.as_tensor(oh),
            torch.as_tensor(w), solver="gd", max_iter=1, tol=0.0,
            step_size=0.0)
        out[case] = (flatten_weights(mlp_params_to_numpy(SigmoidMLP(weights))),
                     n_iter, loss, start)
    return out


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_equals_rank_zero_and_imports_only_the_port(worlds,
                                                               world):
    ranks = worlds[world]
    assert len(ranks) == world
    for r in ranks:
        assert str(r["backend"]) == "gloo"
        assert r["jax_imported"].size == 0
        for case in CASES:
            np.testing.assert_array_equal(r[f"{case}/flat"],
                                          ranks[0][f"{case}/flat"])
            assert r[f"{case}/loss"] == ranks[0][f"{case}/loss"]


@pytest.mark.parametrize("case", [c for c in CASES if c.endswith("f64")])
@pytest.mark.parametrize("world", WORLDS)
def test_float64_fit_matches_the_local_fit(worlds, local_fits, world, case):
    got = worlds[world][0]
    want_flat, want_iter, want_loss, start_loss = local_fits[case]
    assert int(got[f"{case}/n_iter"]) == want_iter
    assert _rel(got[f"{case}/flat"], want_flat) <= F64_RTOL
    assert abs(float(got[f"{case}/loss"]) - want_loss) <= \
        F64_RTOL * start_loss


@pytest.mark.parametrize("world", WORLDS)
def test_float32_fit_meets_the_jax_tests_specification(worlds, world):
    import torch

    from spark_rapids_ml_tpu_torch.ops.mlp_kernel import (
        forward_logits,
        unflatten_weights,
    )

    got = worlds[world][0]
    assert np.isfinite(float(got["dist/f32/loss"]))
    assert int(got["dist/f32/n_iter"]) >= 1
    params = unflatten_weights(got["dist/f32/flat"], [4, 8, 3])
    x, y = _distributed_test_data()
    weights = [torch.as_tensor(layer[k], dtype=torch.float32)
               for layer in params for k in ("w", "b")]
    logits = forward_logits(weights, torch.as_tensor(x, dtype=torch.float32))
    assert (logits.argmax(dim=1).numpy() == y).mean() > 0.9


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_are_recorded_at_their_true_counts(worlds, world):
    got = worlds[world][0]
    for case in CASES:
        x, _y, _w, kwargs = _case_data(case)
        layers = kwargs["layers"]
        p = sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))
        itemsize = np.dtype(kwargs.get("dtype", np.float32)).itemsize
        (kind, count, nbytes), = got[f"{case}/collectives"].tolist()
        issued = int(got[f"{case}/issued"])
        assert kind == "all_reduce"
        assert int(count) == issued == int(got[f"{case}/evaluations"])
        assert int(nbytes) == (p + 2) * itemsize * issued
        n_iter = int(got[f"{case}/n_iter"])
        if kwargs.get("solver") == "gd":
            assert issued == n_iter
        else:
            # the first evaluation, then at least one trial a step
            assert issued >= n_iter + 1


def test_validation_raises_before_any_collective():
    """The label check runs on the host before a rank joins a collective
    (no process group is needed to see it)."""
    from spark_rapids_ml_tpu_torch.parallel import distributed_mlp_fit

    x, y = _distributed_test_data()
    with pytest.raises(ValueError, match="class indices"):
        distributed_mlp_fit(x, y + 0.5, [4, 8, 3], mesh=None)
    with pytest.raises(ValueError, match="feature width"):
        distributed_mlp_fit(x, y, [5, 8, 3], mesh=None)


if __name__ == "__main__":
    _worker(sys.argv[1])
