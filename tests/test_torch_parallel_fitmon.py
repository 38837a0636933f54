"""The data-parallel PCA fits under the fit-path monitor: the port's
instrumented ``distributed_pca_fit`` (two pass and one pass) and
``distributed_streaming_pca_fit`` against the JAX package's on the same
numpy input, float32 named in both.

The port runs in a one-rank gloo world in this process, the JAX package on
a one-device mesh. Held equal: the report's phases, rows and collective
counts, the monitor run's step names, per-step rows and scalars, and the
report joined to the run. Two things differ by design. The collective
bytes: the port sends the row count as two floats (``mesh.pack_count``,
exact past 2²⁴ rows), so each collective that carries it moves one element
more than the JAX program's. The FLOPs: the port counts each Gram
analytically (``rows·n·(n+1)`` over the rows handed to it), where the JAX
package reports XLA's cost analysis of whole programs; so the port's are
held to the Gram formula. ``make_global_array`` notes ``host0`` and a
``placement`` collective in the current run, as the JAX seam does. The
instrumented ``distributed_svc_fit`` and ``distributed_glm_fit`` give the
JAX functions' run, steps, scalars and collective counts and bytes exactly
(float64 in both; their collectives carry no row count).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from spark_rapids_ml_tpu.data.batches import BatchSource as JaxBatchSource
from spark_rapids_ml_tpu.obs import devmon as jax_devmon
from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu.parallel.distributed_pca import (
    distributed_pca_fit as jax_distributed_pca_fit,
)
from spark_rapids_ml_tpu.parallel.mesh import data_mesh as jax_data_mesh
from spark_rapids_ml_tpu.parallel.multihost import (
    make_global_array as jax_place,
)
from spark_rapids_ml_tpu.parallel.streaming import (
    distributed_streaming_pca_fit as jax_streaming_fit,
)
from spark_rapids_ml_tpu_torch.data.batches import BatchSource
from spark_rapids_ml_tpu_torch.obs import devmon, fitmon, metrics, spans
from spark_rapids_ml_tpu_torch.ops.covariance import gram_cost
from spark_rapids_ml_tpu_torch.parallel import (
    data_mesh,
    distributed_pca_fit,
    distributed_streaming_pca_fit,
    make_global_array,
)

ROWS, N, K = 203, 12, 4
BATCH_ROWS = 64
ITEMSIZE = 4  # float32
# name → (fit kind, keyword arguments)
CASES = {
    "two_pass": ("dp", {}),
    "one_pass": ("dp", {"one_pass": True}),
    "streamed": ("stream", {}),
}


def _data():
    rng = np.random.default_rng(21)
    return rng.normal(size=(ROWS, N)) / np.sqrt(1.0 + np.arange(N)) + 0.5


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    assert not dist.is_initialized()
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=0, world_size=1)
    try:
        yield data_mesh(1)
    finally:
        dist.destroy_process_group()
        mp.undo()


@pytest.fixture
def monitors(monkeypatch):
    """A fresh registry and fit monitor in each package."""
    monkeypatch.setattr(metrics, "_default_registry",
                        metrics.MetricsRegistry())
    monkeypatch.setattr(jax_metrics, "_default_registry",
                        jax_metrics.MetricsRegistry())
    # each package's device monitor binds its counters to the registry
    # current when it is made: drop both on each side of the swap
    devmon.reset_device_monitor()
    jax_devmon.reset_device_monitor()
    mons = {"torch": fitmon.FitMonitor(enabled=True),
            "jax": jax_fitmon.FitMonitor(enabled=True)}
    monkeypatch.setattr(fitmon, "_monitor", mons["torch"])
    monkeypatch.setattr(jax_fitmon, "_monitor", mons["jax"])
    yield mons
    devmon.reset_device_monitor()
    jax_devmon.reset_device_monitor()


def _fit(pkg, case, x, mesh):
    kind, kw = CASES[case]
    if pkg == "torch":
        if kind == "dp":
            return distributed_pca_fit(x, K, mesh, dtype=np.float32, **kw)
        return distributed_streaming_pca_fit(
            BatchSource(x, batch_rows=BATCH_ROWS), K, mesh,
            dtype=torch.float32)
    import jax.numpy as jnp

    jmesh = jax_data_mesh(1)
    if kind == "dp":
        return jax_distributed_pca_fit(x, K, jmesh, dtype=np.float32, **kw)
    return jax_streaming_fit(JaxBatchSource(x, batch_rows=BATCH_ROWS), K,
                             jmesh, dtype=jnp.float32)


def _steps(run):
    return [(s["step"], s["rows"], s["scalars"], s["failed"])
            for s in run.steps]


@pytest.mark.parametrize("case", list(CASES))
def test_instrumented_fit_matches_the_jax_driver(case, mesh, monitors):
    x = _data()
    results = {pkg: _fit(pkg, case, x, mesh) for pkg in ("torch", "jax")}
    runs = {}
    for pkg, mon in monitors.items():
        assert mon.active_runs() == []
        (runs[pkg],) = mon.recent_runs()
    ours, theirs = (results[p].fit_report_ for p in ("torch", "jax"))
    algo = ("distributed_pca" if CASES[case][0] == "dp"
            else "distributed_streaming_pca")
    assert ours.algo == theirs.algo == algo
    assert set(ours.phases) == set(theirs.phases)
    assert ours.rows == theirs.rows == ROWS
    assert ours.n_iter == theirs.n_iter
    assert ours.extra == theirs.extra
    assert set(ours.collectives) == set(theirs.collectives) == \
        {"all_reduce"}
    mine = ours.collectives["all_reduce"]
    ref = theirs.collectives["all_reduce"]
    assert mine["count"] == ref["count"]
    # one packed count element more per collective that carries the count
    assert mine["bytes"] - ref["bytes"] == ITEMSIZE

    # the monitor runs: the same steps, rows and scalars
    run, jrun = runs["torch"], runs["jax"]
    assert (run.algo, run.status) == (jrun.algo, jrun.status)
    assert _steps(run) == _steps(jrun)
    assert run.rows_total == jrun.rows_total
    assert set(run.report) == set(jrun.report)
    assert run.report["rows"] == jrun.report["rows"] == ROWS
    assert run.report["collective_bytes"] == mine["bytes"]
    assert run.collectives["all_reduce"]["count"] == mine["count"]
    assert run.collectives["all_reduce"]["bytes"] == mine["bytes"]
    assert all(s["device_seconds"] > 0 for s in run.steps)

    # the port's FLOPs: the Gram formula, in the step that ran each Gram
    gram_rows = [ROWS] if CASES[case][0] == "dp" else \
        [BATCH_ROWS] * (-(-ROWS // BATCH_ROWS))
    flops, nbytes = zip(*(gram_cost(r, N, ITEMSIZE, ITEMSIZE)
                          for r in gram_rows))
    assert [s["flops"] for s in run.steps if s["flops"]] == list(flops)
    assert run.flops_total == ours.analytic_flops == sum(flops)
    assert run.bytes_total == ours.analytic_bytes == sum(nbytes)
    phase = "execute" if CASES[case][0] == "dp" else "stream"
    assert ours.flops_by_phase == {phase: sum(flops)}
    # no peak on the CPU: MFU absent, never made up
    assert ours.analytic_mfu is None
    assert ours.phase_mfu() == {phase: None}
    assert all(s["mfu"] is None and s["bound"] is None for s in run.steps)

    # the instrumented fits still give what the JAX ones give
    np.testing.assert_allclose(
        results["torch"].explained_variance.numpy(),
        np.asarray(results["jax"].explained_variance), rtol=1e-4)


def test_make_global_array_notes_host0_and_a_placement(mesh, monitors):
    x = _data().astype(np.float32)
    runs = {}
    with fitmon.fit_run("multihost_probe") as run:
        shard = make_global_array(x, mesh, ROWS)
    runs["torch"] = run
    with jax_fitmon.fit_run("multihost_probe") as jrun:
        jax_place(x, jax_data_mesh(1), ROWS)
    runs["jax"] = jrun
    assert shard.x.shape == (ROWS, N)
    for r in runs.values():
        assert list(r.host_seconds) == ["host0"]
        assert len(r.host_seconds["host0"]) == 1
        assert r.collectives["placement"]["count"] == 1
        assert r.collectives["placement"]["bytes"] == x.nbytes
    assert run.skew()["hosts"].keys() == jrun.skew()["hosts"].keys()
    assert any(e.name == "multihost:placement"
               for e in spans.get_recorder().events())


# -- the LinearSVC and GLM fits under the fit monitor -------------------------

def _linear_fit(pkg, algo, x, y, mesh):
    """``distributed_svc_fit`` (ridge 0.02) or ``distributed_glm_fit``
    (Poisson), float64, by ``pkg`` on a one-rank mesh."""
    if pkg == "torch":
        from spark_rapids_ml_tpu_torch.parallel import (
            distributed_glm_fit,
            distributed_svc_fit,
        )
    else:
        from spark_rapids_ml_tpu.parallel import (
            distributed_glm_fit,
            distributed_svc_fit,
        )

        mesh = jax_data_mesh(1)
    if algo == "distributed_svc":
        return distributed_svc_fit(x, (y > np.median(y)).astype(np.float64),
                                   mesh, reg_param=0.02)
    return distributed_glm_fit(x, np.floor(np.abs(y)), mesh,
                               family="poisson", dtype=np.float64)


@pytest.mark.parametrize("algo", ["distributed_svc", "distributed_glm"])
def test_instrumented_linear_fit_matches_the_jax_function(algo, mesh,
                                                        monitors):
    """The LinearSVC fit's one ``newton`` step noted with ``n_iter`` and
    ``converged`` and its (d² + d)-element all-reduce per iteration; the
    GLM fit's ``irls_pass`` step and (d² + d + 6)-element all-reduce
    per pass: the same run, steps, rows, scalars and collective count and
    bytes as the JAX functions', and the same fit."""
    x = _data()
    y = x @ np.linspace(-1.0, 1.0, N) * 2.0 + 1.0
    results = {pkg: _linear_fit(pkg, algo, x, y, mesh)
               for pkg in ("torch", "jax")}
    runs = {}
    for pkg, mon in monitors.items():
        assert mon.active_runs() == []
        (runs[pkg],) = mon.recent_runs()
    ours, theirs = (results[p].fit_report_ for p in ("torch", "jax"))
    assert ours.algo == theirs.algo == algo
    assert set(ours.phases) == set(theirs.phases)
    assert ours.rows == theirs.rows == ROWS
    assert ours.n_iter == theirs.n_iter
    assert ours.collectives == theirs.collectives
    run, jrun = runs["torch"], runs["jax"]
    assert (run.algo, run.status) == (jrun.algo, jrun.status) == \
        (algo, "done")
    assert _steps(run) == _steps(jrun)
    assert run.rows_total == jrun.rows_total
    for key in ("count", "bytes"):
        assert run.collectives["all_reduce"][key] == \
            jrun.collectives["all_reduce"][key] == \
            ours.collectives["all_reduce"][key]
    assert run.report["collective_bytes"] == \
        jrun.report["collective_bytes"]
    d = N + 1
    per = d * d + d if algo == "distributed_svc" else N * N + N + 6
    reduce = ours.collectives["all_reduce"]
    assert reduce["bytes"] == per * 8 * reduce["count"]
    if algo == "distributed_svc":
        assert [s["step"] for s in run.steps] == ["newton"]
        np.testing.assert_allclose(results["torch"].coefficients.numpy(),
                                   np.asarray(results["jax"].coefficients),
                                   rtol=1e-9, atol=1e-12)
    else:
        assert {s["step"] for s in run.steps} == {"irls_pass"}
        assert reduce["count"] == len(run.steps)
        np.testing.assert_allclose(results["torch"].coefficients,
                                   results["jax"].coefficients,
                                   rtol=1e-9, atol=1e-12)
