"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points compute on the card unless the CPU is asked for."""

import ast
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu_torch
from spark_rapids_ml_tpu_torch import PCA
from spark_rapids_ml_tpu_torch.utils import resources

PORT_DIR = os.path.dirname(spark_rapids_ml_tpu_torch.__file__)
REPO_DIR = os.path.dirname(PORT_DIR)


def _port_modules():
    for root, _, files in os.walk(PORT_DIR):
        for name in sorted(files):
            if name.endswith(".py"):
                path = os.path.join(root, name)
                rel = os.path.relpath(path, REPO_DIR)[:-3].replace(os.sep, ".")
                yield path, rel[:-len(".__init__")] if rel.endswith(
                    ".__init__") else rel


def _is_forbidden(module: str) -> bool:
    return (module == "jax" or module.startswith("jax.")
            or module == "spark_rapids_ml_tpu"
            or module.startswith("spark_rapids_ml_tpu."))


# modules ported from JAX package code that imports nothing of JAX at the
# top (the reports, the watermark, the probe, the fit monitor, xprof's peak
# and the peak tables reach JAX only inside their functions; the dashboard
# is a string constant), which the port must still not import from there
STANDALONE = ("obs.tracectx", "obs.spans", "obs.slo", "obs.tsdb",
              "obs.logging", "obs.retention", "obs.flight", "obs.profiler",
              "obs.accounting", "obs.robust", "obs.anomaly",
              "obs.incidents", "obs.metrics", "obs.memory", "obs.report",
              "obs.serving", "utils.health", "serve.admission",
              "serve.scheduler", "serve.wire", "serve.breaker",
              "serve.tiering", "serve.dashboard", "obs.fitmon",
              "obs.xprof", "utils.platform", "models.kmeans",
              "models.scaler", "models.pipeline")


def test_importing_every_port_module_leaves_jax_out():
    mods = [m for _, m in _port_modules()]
    assert "spark_rapids_ml_tpu_torch.serve" in mods
    assert {f"spark_rapids_ml_tpu_torch.{m}" for m in STANDALONE} <= set(mods)
    code = (
        "import importlib, sys\n"
        "import spark_rapids_ml_tpu_torch.serve\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'spark_rapids_ml_tpu' or "
        "k.startswith('spark_rapids_ml_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_DIR,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_serving_stack_runs_without_jax():
    """A model served end to end (engine with admission and the fair
    queue, HTTP server, binary wire, a tenant's quota charged) in a
    process that never imports jax."""
    code = (
        "import json, sys, urllib.request\n"
        "import numpy as np\n"
        "from spark_rapids_ml_tpu_torch import PCAModel\n"
        "from spark_rapids_ml_tpu_torch.serve import (ModelRegistry, "
        "ServeEngine, start_serve_server, wire)\n"
        "m = PCAModel.from_numpy(np.eye(4)[:, :2], [0.6, 0.4])\n"
        "reg = ModelRegistry(); reg.register('m', m)\n"
        "eng = ServeEngine(reg, max_wait_ms=1, precision='int8', "
        "tenant_quotas={'t': (1e-6, 10.0)})\n"
        "srv = start_serve_server(eng)\n"
        "try:\n"
        "    req = urllib.request.Request("
        "f'http://127.0.0.1:{srv.server_address[1]}/predict', "
        "data=wire.encode_request('m', np.ones((3, 4))), "
        "headers={'Content-Type': wire.BINARY_CONTENT_TYPE, "
        "'X-Tenant': 't', 'X-Priority': 'batch'})\n"
        "    out = wire.decode_response(urllib.request.urlopen("
        "req, timeout=60).read())\n"
        "    assert eng.overload_state()['tenants']['t']['tokens'] < 10\n"
        "finally:\n"
        "    srv.shutdown(); srv.server_close(); eng.shutdown()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'spark_rapids_ml_tpu' or "
        "k.startswith('spark_rapids_ml_tpu.'))\n"
        "print(out.shape, bad)\n"
        "sys.exit(1 if bad or out.shape != (3, 2) else 0)\n"
    )
    env = dict(os.environ, SPARK_RAPIDS_ML_TORCH_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_DIR,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the modules of the RowMatrix / TruncatedSVD / LinearRegression slice
GRAM_CALLERS = ("linalg", "linalg.row_matrix", "models.svd",
                "models.linear_regression", "ops.linreg_kernel",
                "parallel.distributed_linreg")


def test_gram_callers_run_without_jax():
    """RowMatrix, TruncatedSVD and LinearRegression fitted, transformed,
    saved and loaded, and ``distributed_linreg_fit`` in a one-rank gloo
    world, in a process that never imports jax."""
    mods = {m for _, m in _port_modules()}
    assert {f"spark_rapids_ml_tpu_torch.{m}" for m in GRAM_CALLERS} <= mods
    code = (
        "import os, sys, tempfile\n"
        "import numpy as np\n"
        "import torch.distributed as dist\n"
        "from spark_rapids_ml_tpu_torch import (LinearRegression, "
        "LinearRegressionModel, RowMatrix, TruncatedSVD, TruncatedSVDModel)\n"
        "from spark_rapids_ml_tpu_torch.parallel import (data_mesh, "
        "distributed_linreg_fit)\n"
        "x = np.random.default_rng(0).normal(size=(40, 5))\n"
        "y = x @ np.arange(5.0) + 1.0\n"
        "pc, _ = RowMatrix(x, num_partitions=2)"
        ".compute_principal_components_and_explained_variance(2)\n"
        "out = RowMatrix(x).multiply(pc).to_numpy()\n"
        "svd = TruncatedSVD().setK(2).fit(x)\n"
        "lr = LinearRegression().fit(x, labels=y)\n"
        "d = tempfile.mkdtemp()\n"
        "svd.save(d + '/svd'); lr.save(d + '/lr')\n"
        "TruncatedSVDModel.load(d + '/svd').transform(x)\n"
        "LinearRegressionModel.load(d + '/lr').transform(x)\n"
        "dist.init_process_group('gloo', init_method='file://' + d + "
        "'/store', rank=0, world_size=1)\n"
        "res = distributed_linreg_fit(x, y, data_mesh(1))\n"
        "dist.destroy_process_group()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'spark_rapids_ml_tpu' or "
        "k.startswith('spark_rapids_ml_tpu.'))\n"
        "print(out.shape, res.coefficients, bad)\n"
        "sys.exit(1 if bad or out.shape != (40, 2) else 0)\n"
    )
    env = dict(os.environ, SPARK_RAPIDS_ML_TORCH_PLATFORM="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_DIR,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the modules of the KMeans / StandardScaler / Pipeline slice
KMEANS_SLICE = ("ops.kmeans_kernel", "models.kmeans", "models.scaler",
                "models.pipeline", "models._serving",
                "parallel.distributed_kmeans", "io.persistence")


def test_kmeans_slice_runs_without_jax(tmp_path):
    """A KMeans, a StandardScaler and a StandardScaler → PCA → KMeans
    pipeline that the JAX package saved, loaded by the port (directly and
    through the registry) and served; the port's own fits, saves and fused
    program; and ``distributed_kmeans_fit`` in a one-rank gloo world — in a
    process that never imports jax. The JAX models are saved here, in the
    test process."""
    import spark_rapids_ml_tpu as jax_pkg

    mods = {m for _, m in _port_modules()}
    assert {f"spark_rapids_ml_tpu_torch.{m}" for m in KMEANS_SLICE} <= mods
    x = np.random.default_rng(0).normal(size=(60, 6))
    jax_pkg.KMeans().setK(3).fit(x).save(str(tmp_path / "km"))
    jax_pkg.StandardScaler().setWithMean(True).fit(x).save(
        str(tmp_path / "sc"))
    jax_pkg.Pipeline([
        jax_pkg.StandardScaler().setWithMean(True).setOutputCol("s"),
        jax_pkg.PCA().setK(3).setInputCol("s").setOutputCol("r"),
        jax_pkg.KMeans().setK(2).setInputCol("r"),
    ]).fit(x).save(str(tmp_path / "pipe"))
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch.distributed as dist\n"
        "from spark_rapids_ml_tpu_torch import (KMeans, KMeansModel, PCA, "
        "Pipeline, PipelineModel, StandardScaler, StandardScalerModel)\n"
        "from spark_rapids_ml_tpu_torch.io.persistence import load_model\n"
        "from spark_rapids_ml_tpu_torch.models._serving import "
        "run_staged_pipeline\n"
        "from spark_rapids_ml_tpu_torch.parallel import (data_mesh, "
        "distributed_kmeans_fit)\n"
        "from spark_rapids_ml_tpu_torch.serve import (ModelRegistry, "
        "ServeEngine)\n"
        "d = sys.argv[1]\n"
        "x = np.load(d + '/x.npy')\n"
        "km = KMeansModel.load(d + '/km')\n"
        "sc = load_model(d + '/sc')\n"
        "pipe = PipelineModel.load(d + '/pipe')\n"
        "assert type(sc) is StandardScalerModel\n"
        "assert [type(s).__name__ for s in pipe.stages] == "
        "['StandardScalerModel', 'PCAModel', 'KMeansModel']\n"
        "labels = np.asarray(pipe.transform(x).column('prediction'))\n"
        "reg = ModelRegistry()\n"
        "for name in ('km', 'sc', 'pipe'):\n"
        "    reg.load(name, d + '/' + name)\n"
        "eng = ServeEngine(reg, max_wait_ms=1)\n"
        "try:\n"
        "    served = eng.predict('pipe', x)\n"
        "    assert served.dtype == np.int32 and served.shape == (60,)\n"
        "    assert np.array_equal(served, run_staged_pipeline(pipe, x))\n"
        "    assert eng.predict('km', x).shape == (60,)\n"
        "finally:\n"
        "    eng.shutdown()\n"
        "own = Pipeline([StandardScaler().setOutputCol('s'), "
        "PCA().setK(2).setInputCol('s').setOutputCol('r'), "
        "KMeans().setK(2).setInputCol('r')]).fit(x)\n"
        "own.save(d + '/own')\n"
        "prog = PipelineModel.load(d + '/own').serving_transform_program()\n"
        "out = prog.fetch(prog.run(prog.put(x)))\n"
        "dist.init_process_group('gloo', init_method='file://' + d + "
        "'/store', rank=0, world_size=1)\n"
        "res = distributed_kmeans_fit(x, 3, data_mesh(1))\n"
        "dist.destroy_process_group()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'spark_rapids_ml_tpu' or "
        "k.startswith('spark_rapids_ml_tpu.'))\n"
        "print(labels.shape, out.shape, tuple(res.centers.shape), bad)\n"
        "sys.exit(1 if bad or out.shape != (60,) else 0)\n"
    )
    env = dict(os.environ, SPARK_RAPIDS_ML_TORCH_PLATFORM="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO_DIR, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the modules of the LogisticRegression slice
LOGREG_SLICE = ("utils.numeric", "models.params", "ops.logreg_kernel",
                "models.logistic_regression", "parallel.distributed_logreg",
                "io.persistence")


def test_logreg_slice_runs_without_jax(tmp_path):
    """A binary and a multinomial LogisticRegression and a StandardScaler →
    PCA → LogisticRegression pipeline that the JAX package saved, loaded by
    the port and served through the registry and engine; the port's own
    fits (one-shot, streamed, elastic net, multinomial), saves and fused
    program; and ``distributed_logreg_fit`` in a one-rank gloo world — in
    a process that never imports jax. The JAX models are saved here, in the
    test process."""
    import spark_rapids_ml_tpu as jax_pkg

    mods = {m for _, m in _port_modules()}
    assert {f"spark_rapids_ml_tpu_torch.{m}" for m in LOGREG_SLICE} <= mods
    rng = np.random.default_rng(0)
    x = rng.normal(size=(90, 6))
    y = (x[:, 0] + 0.5 * rng.normal(size=90) > 0).astype(float)
    y3 = np.digitize(x[:, 1], [-0.4, 0.4]).astype(float)
    jax_pkg.LogisticRegression().setRegParam(0.1).fit(x, y).save(
        str(tmp_path / "bin"))
    jax_pkg.LogisticRegression().setRegParam(0.1).fit(x, y3).save(
        str(tmp_path / "mn"))
    frame = jax_pkg.data.frame.VectorFrame({"features": x, "label": list(y)})
    jax_pkg.Pipeline([
        jax_pkg.StandardScaler().setWithMean(True).setOutputCol("s"),
        jax_pkg.PCA().setK(3).setInputCol("s").setOutputCol("r"),
        jax_pkg.LogisticRegression().setInputCol("r"),
    ]).fit(frame).save(str(tmp_path / "pipe"))
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", y)
    np.save(tmp_path / "y3.npy", y3)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch.distributed as dist\n"
        "from spark_rapids_ml_tpu_torch import (LogisticRegression, "
        "LogisticRegressionModel, PCA, Pipeline, PipelineModel, "
        "StandardScaler)\n"
        "from spark_rapids_ml_tpu_torch.data import batches\n"
        "from spark_rapids_ml_tpu_torch.data.frame import VectorFrame\n"
        "from spark_rapids_ml_tpu_torch.io.persistence import load_model\n"
        "from spark_rapids_ml_tpu_torch.models._serving import "
        "run_staged_pipeline\n"
        "from spark_rapids_ml_tpu_torch.parallel import (data_mesh, "
        "distributed_logreg_fit)\n"
        "from spark_rapids_ml_tpu_torch.serve import (ModelRegistry, "
        "ServeEngine)\n"
        "d = sys.argv[1]\n"
        "# streamed buckets of 64 rows, not 128 MiB of zero padding\n"
        "batches.auto_batch_rows = lambda *a, **k: 64\n"
        "x, y, y3 = (np.load(d + f'/{n}.npy') for n in ('x', 'y', 'y3'))\n"
        "b = LogisticRegressionModel.load(d + '/bin')\n"
        "mn = load_model(d + '/mn')\n"
        "pipe = PipelineModel.load(d + '/pipe')\n"
        "assert mn.num_classes == 3 and b.num_classes == 2\n"
        "assert [type(s).__name__ for s in pipe.stages] == "
        "['StandardScalerModel', 'PCAModel', 'LogisticRegressionModel']\n"
        "reg = ModelRegistry()\n"
        "for name in ('bin', 'pipe'):\n"
        "    reg.load(name, d + '/' + name)\n"
        "eng = ServeEngine(reg, max_wait_ms=1)\n"
        "try:\n"
        "    served = eng.predict('pipe', x)\n"
        "    assert served.dtype == np.float64 and served.shape == (90,)\n"
        "    assert np.array_equal(served, run_staged_pipeline(pipe, x))\n"
        "    assert eng.predict('bin', x).shape == (90,)\n"
        "finally:\n"
        "    eng.shutdown()\n"
        "fits = [LogisticRegression().fit(x, y), "
        "LogisticRegression().fit(lambda: iter([(x[:50], y[:50]), "
        "(x[50:], y[50:])])), "
        "LogisticRegression().setRegParam(0.1).setElasticNetParam(0.5)"
        ".fit(x, y), LogisticRegression().fit(x, y3)]\n"
        "fits[3].save(d + '/own_mn')\n"
        "own = Pipeline([StandardScaler().setOutputCol('s'), "
        "PCA().setK(2).setInputCol('s').setOutputCol('r'), "
        "LogisticRegression().setInputCol('r')]).fit("
        "VectorFrame({'features': x, 'label': list(y)}))\n"
        "own.save(d + '/own')\n"
        "prog = PipelineModel.load(d + '/own').serving_transform_program()\n"
        "out = prog.fetch(prog.run(prog.put(x)))\n"
        "dist.init_process_group('gloo', init_method='file://' + d + "
        "'/store', rank=0, world_size=1)\n"
        "res = distributed_logreg_fit(x, y, data_mesh(1))\n"
        "dist.destroy_process_group()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'spark_rapids_ml_tpu' or "
        "k.startswith('spark_rapids_ml_tpu.'))\n"
        "print(out.shape, tuple(res.coefficients.shape), "
        "[f.n_iter_ for f in fits], bad)\n"
        "sys.exit(1 if bad or out.shape != (90,) else 0)\n"
    )
    env = dict(os.environ, SPARK_RAPIDS_ML_TORCH_PLATFORM="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO_DIR, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the modules of the LinearSVC and GeneralizedLinearRegression slice
SVC_GLM_SLICE = ("ops.svm_kernel", "models.linear_svc",
                 "parallel.distributed_svc", "ops.glm_kernel", "models.glm",
                 "parallel.distributed_glm", "io.persistence")


def test_svc_glm_slice_runs_without_jax(tmp_path):
    """A LinearSVC and a GLM model that the JAX package saved, loaded by
    the port and served through the registry and engine; the port's own
    fits (one-shot, streamed, host, every family of the GLM grid's
    canonical links) and saves; and ``distributed_svc_fit`` and
    ``distributed_glm_fit`` in a one-rank gloo world — in a process that
    never imports jax. The JAX models are saved here, in the test
    process."""
    import spark_rapids_ml_tpu as jax_pkg

    mods = {m for _, m in _port_modules()}
    assert {f"spark_rapids_ml_tpu_torch.{m}" for m in SVC_GLM_SLICE} <= mods
    rng = np.random.default_rng(0)
    x = rng.normal(size=(90, 6))
    y = (x[:, 0] + 0.5 * rng.normal(size=90) > 0).astype(float)
    counts = rng.poisson(np.exp(0.3 * x[:, 1] + 0.2)).astype(float)
    # binomial labels far from separable: a float32 fit on (nearly)
    # separable labels saturates μ at the clip bound, which rounds to 1.0
    # at float32, and gives NaN coefficients in both packages
    yb = (rng.random(90) < 1.0 / (1.0 + np.exp(-0.5 * x[:, 0]))).astype(
        float)
    np.save(tmp_path / "yb.npy", yb)
    jax_pkg.LinearSVC().setRegParam(0.1).fit(x, y).save(str(tmp_path / "svc"))
    jax_pkg.GeneralizedLinearRegression(family="poisson").fit(
        x, labels=counts).save(str(tmp_path / "glm"))
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", y)
    np.save(tmp_path / "c.npy", counts)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch.distributed as dist\n"
        "from spark_rapids_ml_tpu_torch import (GeneralizedLinearRegression "
        "as GLR, LinearSVC)\n"
        "from spark_rapids_ml_tpu_torch.data import batches\n"
        "from spark_rapids_ml_tpu_torch.io.persistence import load_model\n"
        "from spark_rapids_ml_tpu_torch.parallel import (data_mesh, "
        "distributed_glm_fit, distributed_svc_fit)\n"
        "from spark_rapids_ml_tpu_torch.serve import (ModelRegistry, "
        "ServeEngine)\n"
        "d = sys.argv[1]\n"
        "batches.auto_batch_rows = lambda *a, **k: 64\n"
        "x, y, c, yb = (np.load(d + f'/{n}.npy') for n in ('x', 'y', "
        "'c', 'yb'))\n"
        "reg = ModelRegistry()\n"
        "for name in ('svc', 'glm'):\n"
        "    reg.load(name, d + '/' + name)\n"
        "eng = ServeEngine(reg, max_wait_ms=1)\n"
        "try:\n"
        "    labels = eng.predict('svc', x)\n"
        "    mu = eng.predict('glm', x)\n"
        "finally:\n"
        "    eng.shutdown()\n"
        "assert set(np.unique(labels)) <= {0.0, 1.0}\n"
        "assert mu.shape == (90,) and (mu > 0).all()\n"
        "chunks = lambda: iter([(x[:50], y[:50]), (x[50:], y[50:])])\n"
        "fits = [LinearSVC().fit(x, y), LinearSVC().setStandardization("
        "False).fit(chunks), LinearSVC().setUseXlaDot(False).fit(x, y)]\n"
        "fits[0].save(d + '/own_svc')\n"
        "glms = [GLR(family=f).fit(x, labels=l) for f, l in ("
        "('gaussian', c), ('binomial', yb), ('poisson', c), "
        "('gamma', c + 0.5), ('tweedie', c))]\n"
        "glms.append(GLR(family='poisson').fit(lambda: iter([(x[:50], "
        "c[:50]), (x[50:], c[50:])])))\n"
        "glms[2].save(d + '/own_glm')\n"
        "assert type(load_model(d + '/own_svc')).__name__ == "
        "'LinearSVCModel'\n"
        "assert type(load_model(d + '/own_glm')).__name__ == "
        "'GeneralizedLinearRegressionModel'\n"
        "dist.init_process_group('gloo', init_method='file://' + d + "
        "'/store', rank=0, world_size=1)\n"
        "res = distributed_svc_fit(x, y, data_mesh(1))\n"
        "gm = distributed_glm_fit(x, c, data_mesh(1), family='poisson')\n"
        "dist.destroy_process_group()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'spark_rapids_ml_tpu' or "
        "k.startswith('spark_rapids_ml_tpu.'))\n"
        "ok = all(np.isfinite(m.coefficients).all() for m in fits + glms "
        "+ [gm])\n"
        "print(tuple(res.coefficients.shape), [f.n_iter_ for f in fits], "
        "[g.num_iterations_ for g in glms], bad)\n"
        "sys.exit(1 if bad or not ok else 0)\n"
    )
    env = dict(os.environ, SPARK_RAPIDS_ML_TORCH_PLATFORM="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO_DIR, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the modules of the NearestNeighbors / DBSCAN slice
KNN_SLICE = ("ops.knn_kernel", "models.nearest_neighbors",
             "parallel.distributed_knn", "parallel.distributed_ivf",
             "ops.dbscan_kernel", "models.dbscan",
             "parallel.distributed_dbscan")


def test_knn_dbscan_slice_runs_without_jax(tmp_path):
    """A NearestNeighbors model that the JAX package saved, loaded by the
    port and searched brute, ivfflat and ivfpq; DBSCAN dense, tiled and on
    the host; the three sharded searches and DBSCAN in a one-rank gloo
    world — in a process that never imports jax. The JAX model is saved
    here, in the test process."""
    import spark_rapids_ml_tpu as jax_pkg

    mods = {m for _, m in _port_modules()}
    assert {f"spark_rapids_ml_tpu_torch.{m}" for m in KNN_SLICE} <= mods
    rng = np.random.default_rng(0)
    x = np.concatenate([c + rng.normal(size=(40, 8))
                        for c in rng.normal(scale=8, size=(4, 8))])
    jax_pkg.NearestNeighbors().setK(3).fit(x).save(str(tmp_path / "knn"))
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch.distributed as dist\n"
        "from spark_rapids_ml_tpu_torch import DBSCAN\n"
        "from spark_rapids_ml_tpu_torch.io.persistence import load_model\n"
        "from spark_rapids_ml_tpu_torch.parallel import (data_mesh, "
        "distributed_dbscan_labels, distributed_ivf_search, "
        "distributed_kneighbors)\n"
        "d = sys.argv[1]\n"
        "x = np.load(d + '/x.npy')\n"
        "m = load_model(d + '/knn')\n"
        "out = [m.setAlgorithm(a).kneighbors(x[:9])[1] for a in "
        "('brute', 'ivfflat', 'ivfpq')]\n"
        "labels = [DBSCAN().setEps(4.0).setMinPts(4).setBlockRows(b)"
        ".fit(x).labels_ for b in (0, 48)]\n"
        "labels.append(DBSCAN().setEps(4.0).setMinPts(4)"
        ".setUseXlaDot(False).fit(x).labels_)\n"
        "dist.init_process_group('gloo', init_method='file://' + d + "
        "'/store', rank=0, world_size=1)\n"
        "mesh = data_mesh(1)\n"
        "bd, bi = distributed_kneighbors(x[:9], x, 3, mesh)\n"
        "vd, vi = distributed_ivf_search(m.setAlgorithm('ivfflat'), x[:9], "
        "mesh)\n"
        "dl, dc = distributed_dbscan_labels(x, 4.0, 4, mesh)\n"
        "dist.destroy_process_group()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'spark_rapids_ml_tpu' or "
        "k.startswith('spark_rapids_ml_tpu.'))\n"
        "ok = (all((o[:, 0] == np.arange(9)).all() for o in out) and "
        "(bi[:, 0] == np.arange(9)).all() and "
        "all((l == labels[0]).all() for l in labels))\n"
        "print([o.shape for o in out], int(labels[0].max()) + 1, bad)\n"
        "sys.exit(1 if bad or not ok else 0)\n"
    )
    env = dict(os.environ, SPARK_RAPIDS_ML_TORCH_PLATFORM="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO_DIR, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the modules of the UMAP slice
UMAP_SLICE = ("ops.umap_kernel", "models.umap", "parallel.distributed_umap")


def test_umap_slice_runs_without_jax(tmp_path):
    """UMAP's dense and tiled fits, the transform and the sharded
    optimizer in a one-rank gloo world, in a process that never imports
    jax."""
    mods = {m for _, m in _port_modules()}
    assert {f"spark_rapids_ml_tpu_torch.{m}" for m in UMAP_SLICE} <= mods
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch\n"
        "import torch.distributed as dist\n"
        "from spark_rapids_ml_tpu_torch import UMAP\n"
        "from spark_rapids_ml_tpu_torch.models.umap import knn_without_self\n"
        "from spark_rapids_ml_tpu_torch.ops.umap_kernel import (fit_ab, "
        "memberships, pca_init, symmetric_edge_list)\n"
        "from spark_rapids_ml_tpu_torch.parallel import (data_mesh, "
        "distributed_umap_optimize)\n"
        "rng = np.random.default_rng(0)\n"
        "x = np.concatenate([c + rng.normal(size=(40, 5)) for c in "
        "rng.normal(scale=8, size=(3, 5))])\n"
        "fits = [UMAP().setNNeighbors(6).setNEpochs(10).setBlockRows(b)"
        ".fit(x) for b in (0, 48)]\n"
        "placed = fits[1].transform(x[:7]).column('embedding')\n"
        "xt = torch.as_tensor(x)\n"
        "d, i = knn_without_self(xt, xt, 6)\n"
        "e = symmetric_edge_list(memberships(d).numpy(), i.numpy(), len(x))\n"
        "a, b = fit_ab(0.1)\n"
        "dist.init_process_group('gloo', init_method='file://' + "
        "sys.argv[1] + '/store', rank=0, world_size=1)\n"
        "emb = distributed_umap_optimize(*e, pca_init(xt, 2).numpy(), "
        "data_mesh(1), a, b, n_epochs=3)\n"
        "dist.destroy_process_group()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'spark_rapids_ml_tpu' or "
        "k.startswith('spark_rapids_ml_tpu.'))\n"
        "ok = (all(np.isfinite(f.embedding_).all() for f in fits) and "
        "np.isfinite(placed).all() and emb.shape == (120, 2) and "
        "np.isfinite(emb).all())\n"
        "print(len(placed), emb.shape, bad)\n"
        "sys.exit(1 if bad or not ok else 0)\n"
    )
    env = dict(os.environ, SPARK_RAPIDS_ML_TORCH_PLATFORM="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO_DIR, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the modules of the tree slice
TREE_SLICE = ("ops.forest_kernel", "models.random_forest",
              "models.decision_tree", "models.gbt",
              "parallel.distributed_forest", "parallel.distributed_gbt",
              "utils.resources")


def test_tree_slice_runs_without_jax(tmp_path):
    """A RandomForest classifier, a DecisionTree regressor and a GBT
    classifier that the JAX package saved, loaded by the port and
    transformed; the port's own fits of every family, saves and loads;
    and ``distributed_forest_fit`` and ``distributed_gbt_fit`` in a
    one-rank gloo world — in a process that never imports jax. The JAX
    models are saved here, in the test process."""
    import spark_rapids_ml_tpu as jax_pkg

    mods = {m for _, m in _port_modules()}
    assert {f"spark_rapids_ml_tpu_torch.{m}" for m in TREE_SLICE} <= mods
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 4))
    y = (x[:, 0] + x[:, 1] ** 2 > 1.0).astype(np.float64)
    jax_pkg.RandomForestClassifier().setNumTrees(3).setMaxDepth(3).fit(
        x, y).save(str(tmp_path / "rf"))
    jax_pkg.DecisionTreeRegressor(maxDepth=3).fit(x, x[:, 0]).save(
        str(tmp_path / "dt"))
    jax_pkg.GBTClassifier().setMaxIter(3).setMaxDepth(2).fit(x, y).save(
        str(tmp_path / "gbt"))
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", y)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch.distributed as dist\n"
        "from spark_rapids_ml_tpu_torch import (DecisionTreeClassifier, "
        "GBTRegressor, RandomForestRegressor)\n"
        "from spark_rapids_ml_tpu_torch.io.persistence import load_model\n"
        "from spark_rapids_ml_tpu_torch.parallel import (data_mesh, "
        "distributed_forest_fit, distributed_gbt_fit)\n"
        "d = sys.argv[1]\n"
        "x, y = np.load(d + '/x.npy'), np.load(d + '/y.npy')\n"
        "loaded = [load_model(d + '/' + k) for k in ('rf', 'dt', 'gbt')]\n"
        "preds = [np.asarray(m.transform(x).column('prediction')) "
        "for m in loaded]\n"
        "fits = [RandomForestRegressor().setNumTrees(2).fit(x, x[:, 0]), "
        "DecisionTreeClassifier(maxDepth=2).fit(x, y), "
        "GBTRegressor().setMaxIter(2).fit(x, x[:, 1])]\n"
        "for i, m in enumerate(fits):\n"
        "    m.save(d + f'/port{i}')\n"
        "    load_model(d + f'/port{i}').transform(x)\n"
        "dist.init_process_group('gloo', init_method='file://' + d + "
        "'/store', rank=0, world_size=1)\n"
        "mesh = data_mesh(1)\n"
        "ens = distributed_forest_fit(x, y, mesh, n_trees=2, max_depth=2, "
        "classification=True)[0]\n"
        "gbt = distributed_gbt_fit(x, y, mesh, max_iter=2, max_depth=2, "
        "classification=True)[0]\n"
        "dist.destroy_process_group()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'spark_rapids_ml_tpu' or "
        "k.startswith('spark_rapids_ml_tpu.'))\n"
        "ok = ((preds[0] == y).mean() > 0.8 and "
        "ens.feature.shape == (2, 3) and gbt.feature.shape == (2, 3))\n"
        "print([type(m).__name__ for m in loaded], bad)\n"
        "sys.exit(1 if bad or not ok else 0)\n"
    )
    env = dict(os.environ, SPARK_RAPIDS_ML_TORCH_PLATFORM="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO_DIR, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


SPARK_PLANE = ("spark", "spark._compat", "spark.local_engine",
               "spark.aggregate", "spark.device_aggregate", "spark.estimator",
               "spark.forest_plane", "spark.forest_estimator",
               "spark.adapter", "spark.adapter2", "spark.moments_estimator")


def test_spark_plane_imports_and_runs_without_jax_pandas_or_pyarrow():
    """``spark_rapids_ml_tpu_torch.spark`` and its submodules import, and
    its executor partials and driver finalizers run on numpy batches (the
    non-Arrow branch, as ``chip_smoke.py`` phase 21 drives them), in a
    process where pandas and pyarrow cannot be imported (the card's
    machine has neither) and that never imports jax or the JAX package."""
    mods = {m for _, m in _port_modules()}
    assert {f"spark_rapids_ml_tpu_torch.{m}" for m in SPARK_PLANE} <= mods
    code = (
        "import importlib, sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['pyarrow'] = None\n"
        "import numpy as np\n"
        f"for m in {SPARK_PLANE!r}:\n"
        "    importlib.import_module('spark_rapids_ml_tpu_torch.' + m)\n"
        "from spark_rapids_ml_tpu_torch.spark import aggregate as agg\n"
        "from spark_rapids_ml_tpu_torch.spark import device_aggregate as dev\n"
        "from spark_rapids_ml_tpu_torch.spark import estimator as est\n"
        "x = np.random.default_rng(0).normal(size=(200, 6))\n"
        "y = (x[:, 0] > 0).astype(float)\n"
        "parts = [x[:120], x[120:]]\n"
        "rows = [r for p in parts for r in "
        "dev.partition_gram_stats_device([p], 'f')]\n"
        "pc, evr, mean = agg.finalize_pca_from_stats("
        "*agg.combine_stats(rows), 3)\n"
        "g = agg.combine_logreg_stats([r for p in (0, 1) for r in "
        "dev.partition_logreg_stats_device([(parts[p], y[:120] if p == 0 "
        "else y[120:])], 'f', 'l', np.zeros(6), 0.0)])\n"
        "w, b, step = agg.logreg_newton_step_from_stats(*g[:5], g[6], "
        "np.zeros(6), 0.0)\n"
        "proj = est._project_pca(x, pc, True)\n"
        "bad = sorted(k for k in sys.modules if sys.modules[k] is not None "
        "and (k in ('jax', 'spark_rapids_ml_tpu', 'pandas', 'pyarrow') or "
        "k.split('.')[0] in ('jax', 'spark_rapids_ml_tpu', 'pandas', "
        "'pyarrow')))\n"
        "ok = pc.shape == (6, 3) and np.isfinite(w).all() and "
        "proj.shape == (200, 3)\n"
        "print(bad, ok)\n"
        "sys.exit(1 if bad or not ok else 0)\n"
    )
    env = dict(os.environ, SPARK_RAPIDS_ML_TORCH_PLATFORM="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_DIR,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_streamed_tree_fits_run_without_jax_pandas_or_pyarrow():
    """A streamed RandomForest and a streamed GBT fit (the forest plane's
    driver loop over numpy chunks, its level jobs on the device partials
    under the CPU request), a DecisionTree front end resolved from
    ``spark``, and an adapter body on numpy rows, in a process where
    pandas and pyarrow cannot be imported and that never imports jax or
    the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['pyarrow'] = None\n"
        "import numpy as np\n"
        "from spark_rapids_ml_tpu_torch import GBTClassifier, "
        "RandomForestClassifier\n"
        "from spark_rapids_ml_tpu_torch import spark\n"
        "from spark_rapids_ml_tpu_torch.spark import adapter\n"
        "x = np.random.default_rng(0).normal(size=(400, 5))\n"
        "y = (x[:, 0] + x[:, 1] > 0).astype(float)\n"
        "chunks = lambda: iter([(x[:150], y[:150]), (x[150:], y[150:])])\n"
        "rf = RandomForestClassifier().setNumTrees(3).setMaxDepth(3)"
        ".setExecutorDevice('on').fit(chunks)\n"
        "gbt = GBTClassifier().setMaxIter(3).setMaxDepth(2).fit(chunks)\n"
        "adapter._host_fitted_state(rf)\n"
        "p = adapter._classifier_probability(rf, x, 'probability', False)\n"
        "pred = adapter._classifier_prediction(rf, p, rf.classes_)\n"
        "assert spark.DecisionTreeClassifier.__name__ == "
        "'DecisionTreeClassifier'\n"
        "bad = sorted(k for k in sys.modules if sys.modules[k] is not None "
        "and k.split('.')[0] in ('jax', 'spark_rapids_ml_tpu', 'pandas', "
        "'pyarrow'))\n"
        "ok = ((pred == y).mean() > 0.8 and gbt.ensemble_.feature.shape "
        "== (3, 3) and rf.trees_per_group_ == 3)\n"
        "print(bad, ok)\n"
        "sys.exit(1 if bad or not ok else 0)\n"
    )
    env = dict(os.environ, SPARK_RAPIDS_ML_TORCH_PLATFORM="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_DIR,
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


MOMENTS_AND_NB = ("StandardScaler", "MinMaxScaler", "MaxAbsScaler",
                  "RobustScaler", "TruncatedSVD", "LinearSVC",
                  "GeneralizedLinearRegression", "NaiveBayes",
                  "NaiveBayesModel")


def test_moments_plane_and_naive_bayes_run_without_jax_pandas_or_pyarrow(
        tmp_path):
    """The nine front ends resolved from ``spark``, each estimator's
    ``_fit`` on numpy partitions (``forest_estimator.PartitionFrame``),
    the local NaiveBayes fit, ``distributed_nb_fit`` in a one-rank gloo
    world and a NaiveBayes model saved and loaded (the JSON payload), in a
    process where pandas and pyarrow cannot be imported and that never
    imports jax or the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['pyarrow'] = None\n"
        "import numpy as np\n"
        "import torch.distributed as dist\n"
        "from spark_rapids_ml_tpu_torch import NaiveBayes\n"
        "from spark_rapids_ml_tpu_torch import spark\n"
        "from spark_rapids_ml_tpu_torch.io.persistence import load_model\n"
        "from spark_rapids_ml_tpu_torch.parallel import data_mesh, "
        "distributed_nb_fit\n"
        "from spark_rapids_ml_tpu_torch.spark.forest_estimator import "
        "PartitionFrame\n"
        f"classes = [getattr(spark, n) for n in {MOMENTS_AND_NB!r}]\n"
        "rng = np.random.default_rng(0)\n"
        "x = np.abs(rng.normal(size=(300, 5)))\n"
        "y = (x[:, 0] > x[:, 1]).astype(float)\n"
        "frame = PartitionFrame([[(x[:150], y[:150])], [(x[150:], y[150:])]])\n"
        "models = [spark.StandardScaler().fit(frame), "
        "spark.MinMaxScaler().fit(frame), spark.MaxAbsScaler().fit(frame), "
        "spark.RobustScaler().fit(frame), spark.TruncatedSVD(k=2).fit(frame), "
        "spark.LinearSVC().fit(frame), "
        "spark.GeneralizedLinearRegression().fit(frame), "
        "spark.NaiveBayes(modelType='gaussian').fit(frame)]\n"
        "local = NaiveBayes().setModelType('gaussian').fit(x, labels=y)\n"
        "d = sys.argv[1]\n"
        "dist.init_process_group('gloo', init_method='file://' + d + "
        "'/store', rank=0, world_size=1)\n"
        "ranked = distributed_nb_fit(x, y, data_mesh(1), "
        "model_type='gaussian')\n"
        "dist.destroy_process_group()\n"
        "local.save(d + '/nb')\n"
        "loaded = load_model(d + '/nb')\n"
        "bad = sorted(k for k in sys.modules if sys.modules[k] is not None "
        "and k.split('.')[0] in ('jax', 'spark_rapids_ml_tpu', 'pandas', "
        "'pyarrow'))\n"
        "ok = (np.array_equal(ranked.theta, local.theta) and "
        "np.array_equal(loaded.theta, local.theta) and "
        "np.allclose(models[-1]._local.theta, local.theta, atol=1e-6) and "
        "type(models[0]).__name__ == 'StandardScalerModel')\n"
        "print([c.__module__ for c in classes], bad, ok)\n"
        "sys.exit(1 if bad or not ok else 0)\n"
    )
    env = dict(os.environ, SPARK_RAPIDS_ML_TORCH_PLATFORM="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO_DIR, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "spark_rapids_ml_tpu_torch.spark.moments_estimator" in proc.stdout


def test_port_sources_import_no_jax():
    found = []
    smoke = os.path.join(REPO_DIR, "chip_smoke.py")
    for path, mod in [*_port_modules(), (smoke, "chip_smoke")]:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(mod, n) for n in names if _is_forbidden(n)]
    assert found == []


def test_no_cuda_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.delenv(resources.PLATFORM_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=resources.PLATFORM_ENV):
        resources.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PCA().setK(2).fit(np.random.default_rng(0).normal(size=(20, 4)))


def test_host_only_fit_needs_no_device(monkeypatch):
    monkeypatch.delenv(resources.PLATFORM_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = (PCA().setK(2).setUseXlaDot(False).setUseXlaSvd(False)
             .fit(np.random.default_rng(0).normal(size=(20, 4))))
    assert model.pc.shape == (4, 2)


def test_cpu_request_resolves_cpu(monkeypatch):
    monkeypatch.setenv(resources.PLATFORM_ENV, "cpu")
    assert resources.resolve_device(3) == torch.device("cpu")
    monkeypatch.setenv(resources.PLATFORM_ENV, "tpu")
    with pytest.raises(ValueError, match=resources.PLATFORM_ENV):
        resources.resolve_device()


def test_device_ordinal_precedence():
    resolve = resources.resolve_device_ordinal
    assert resolve(2, {"gpu": ["5"]}, {"SPARK_RAPIDS_ML_TORCH_DEVICE": "7"}) == 2
    assert resolve(-1, {"gpu": ["5"]}, {"SPARK_RAPIDS_ML_TORCH_DEVICE": "7"}) == 5
    assert resolve(-1, {"gpu": []}, {"SPARK_RAPIDS_ML_TORCH_DEVICE": "7"}) == 7
    assert resolve(-1, None, {}) == 0


@pytest.mark.parametrize("ordinal,count,visible,expected,warns", [
    (1, 2, "", 1, False),
    (3, 1, "3", 0, False),   # a pinned executor's one card
    (3, 1, "", 0, True),     # unpinned: a misrouted task, warned about
])
def test_ordinal_maps_to_a_cuda_device(monkeypatch, ordinal, count, visible,
                                       expected, warns):
    monkeypatch.delenv(resources.PLATFORM_ENV, raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        device = resources.resolve_device(ordinal)
    assert device == torch.device("cuda", expected)
    assert bool(caught) == warns


def test_ordinal_past_several_devices_raises(monkeypatch):
    monkeypatch.delenv(resources.PLATFORM_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="deviceId 4"):
        resources.resolve_device(4)


def test_kernel_source_ships_with_the_package():
    from spark_rapids_ml_tpu_torch.utils import cuda_build

    path = cuda_build.library_path("fused_gram")
    assert path.startswith(cuda_build.BUILD_DIR) and path.endswith(".so")
    with pytest.raises(FileNotFoundError):
        cuda_build.library_path("no_such_kernel")
