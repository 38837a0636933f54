"""The Spark statistics plane in the port against the JAX package's, on the
same seeded numpy rows.

``spark_rapids_ml_tpu_torch.spark`` (``aggregate``, ``device_aggregate``,
``estimator``, ``local_engine``, ``_compat``) against the JAX package's
``spark`` modules of the same names. Without pyspark both bind their front
ends to their own local engine, so a front end is fitted in a JAX
``LocalSparkSession`` and in the port's on the same rows. The suite runs
JAX with x64 (tests/conftest.py), so the JAX device plane's 'auto' dtype is
float64; the port's 'auto' is float32. Every comparison names its dtype:

* the host plane (NumPy float64, the same operations in the same order):
  equal, or ≤ 1e-12 relative where the host eigensolve intervenes (numpy's
  LAPACK in the port, the JAX package's native ``dsyevd`` where built);
* device partials at float64 in both: ≤ 1e-10 relative; the port's
  float32 (the Gram kernel's plain version on the CPU) ≤ 1e-5 relative;
* front ends at executorDevice 'off' (host plane): equal fits, but the
  float32 eigensolve of ``useXlaSvd`` (≤ 1e-5); at 'on' (the device plane
  on CPU torch, float32 in the port): ≤ 1e-4 on coefficients.

The spawned-process cases (an ``executors="process"`` fit and a
``'collective'`` fit over a 2-rank gloo world with one empty partition)
are one parametrised test, as they cost seconds each.
"""

import json

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.obs import devmon as jax_devmon
from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
from spark_rapids_ml_tpu.obs import metrics as jax_metrics
from spark_rapids_ml_tpu.spark import aggregate as jagg
from spark_rapids_ml_tpu.spark import device_aggregate as jdev
from spark_rapids_ml_tpu.spark import estimator as jest
from spark_rapids_ml_tpu.spark import local_engine as jle
from spark_rapids_ml_tpu_torch.obs import devmon, fitmon, metrics
from spark_rapids_ml_tpu_torch.spark import aggregate as agg
from spark_rapids_ml_tpu_torch.spark import device_aggregate as dev
from spark_rapids_ml_tpu_torch.spark import estimator as est
from spark_rapids_ml_tpu_torch.spark import local_engine as le

F64_RTOL = 1e-10
F32_RTOL = 1e-5
FIT_F32_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """The CPU requested, and metrics registries of this test's own in both
    packages (the front ends' ``observed_transform`` write into them)."""
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    monkeypatch.setattr(metrics, "_default_registry",
                        metrics.MetricsRegistry())
    monkeypatch.setattr(jax_metrics, "_default_registry",
                        jax_metrics.MetricsRegistry())
    resets = (devmon.reset_device_monitor, jax_devmon.reset_device_monitor,
              fitmon.reset_fitmon, jax_fitmon.reset_fitmon)
    for reset in resets:
        reset()
    yield
    for reset in resets:
        reset()


def _rel(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _arrow_batch(x, extra=()):
    """One Arrow batch of VectorUDT structs (dense rows) and scalar
    columns, the mapInArrow wire shape."""
    import pyarrow as pa

    rows = []
    for i, r in enumerate(x):
        row = {"features": {"type": 1, "size": None, "indices": None,
                            "values": r.tolist()}}
        for name, values in extra:
            row[name] = float(values[i])
        rows.append(row)
    return pa.RecordBatch.from_pylist(rows)


def _rows(x, extra=()):
    out = []
    for i, r in enumerate(x):
        row = {"features": r}
        for name, values in extra:
            row[name] = values[i]
        out.append(row)
    return out


def _frames(x, extra=(), n_partitions=3):
    """The same rows as a JAX and a port local DataFrame."""
    def build(module):
        rows = [{**r, "features": module.DenseVector(r["features"])}
                for r in _rows(x, extra)]
        return module.LocalSparkSession(n_partitions=n_partitions) \
            .createDataFrame(rows)

    return build(jle), build(le)


def _design(seed=0, n=240, d=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * np.linspace(0.5, 2.0, d) + 0.3
    w = rng.normal(size=d)
    y_reg = x @ w + 0.7 + 0.1 * rng.normal(size=n)
    y_bin = ((x @ w + 0.5 * rng.normal(size=n)) > 0.3).astype(float)
    y_mc = np.argmax(x[:, :3] + rng.gumbel(size=(n, 3)), axis=1).astype(float)
    wt = rng.uniform(0.5, 2.0, size=n)
    return x, y_reg, y_bin, y_mc, wt


# -- the host plane: equal to the JAX package's ------------------------------

def _host_cases():
    x, y_reg, y_bin, y_mc, wt = _design()
    xn = np.abs(x)
    xb = (x > 0.3).astype(float)
    w0 = np.linspace(-0.3, 0.3, x.shape[1])
    wb0 = np.random.default_rng(1).normal(size=(3, x.shape[1] + 1)) * 0.1
    centers = x[:4].copy()
    classes = np.array([0.0, 1.0, 2.0])
    b_lab = _arrow_batch(x, [("label", y_bin), ("wt", wt)])
    b_reg = _arrow_batch(x, [("label", y_reg), ("wt", wt)])
    b_mc = _arrow_batch(x, [("label", y_mc), ("wt", wt)])
    b_nb = _arrow_batch(xn, [("label", y_mc), ("wt", wt)])
    b_bern = _arrow_batch(xb, [("label", y_mc)])
    halves = [x[:100], x[100:]]
    return {
        "gram arrow": ("partition_gram_stats", ([_arrow_batch(x)], "features"),
                       {}),
        "gram ndarrays": ("partition_gram_stats", (halves, "features"), {}),
        "xy": ("partition_xy_stats",
               ([(x[:100], y_reg[:100]), (x[100:], y_reg[100:])],
                "features", "label"), {}),
        "xy weighted": ("partition_xy_stats", ([b_reg], "features", "label"),
                        {"weight_col": "wt"}),
        "logreg": ("partition_logreg_stats",
                   ([(x, y_bin)], "features", "label", w0, 0.1), {}),
        "logreg weighted": ("partition_logreg_stats",
                            ([b_lab], "features", "label", w0, 0.1),
                            {"weight_col": "wt"}),
        "labels": ("partition_label_values", ([b_mc], "label"), {}),
        "multinomial": ("partition_multinomial_stats",
                        ([(x, y_mc)], "features", "label", classes, wb0), {}),
        "multinomial weighted": ("partition_multinomial_stats",
                                 ([b_mc], "features", "label", classes, wb0),
                                 {"weight_col": "wt"}),
        "kmeans": ("partition_kmeans_stats", (halves, "features", centers),
                   {}),
        "kmeans weighted": ("partition_kmeans_stats",
                            ([b_reg], "features", centers),
                            {"weight_col": "wt"}),
        "nb multinomial": ("partition_nb_stats",
                           ([b_nb], "features", "label", "multinomial"),
                           {"weight_col": "wt"}),
        "nb gaussian": ("partition_nb_stats",
                        ([(x, y_mc)], "features", "label", "gaussian"), {}),
        "nb bernoulli": ("partition_nb_stats",
                         ([b_bern], "features", "label", "bernoulli"), {}),
    }


HOST_CASES = _host_cases()


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_partials_equal_jax(case):
    name, args, kwargs = HOST_CASES[case]
    ours = list(getattr(agg, name)(*args, **kwargs))
    ref = list(getattr(jagg, name)(*args, **kwargs))
    assert len(ours) == len(ref) == 1
    assert ours[0].keys() == ref[0].keys()
    for key in ref[0]:
        np.testing.assert_array_equal(np.asarray(ours[0][key]),
                                      np.asarray(ref[0][key]), err_msg=key)


def _partition_rows(module, seed=3):
    """Three partitions' rows of every family, through one package's host
    partials."""
    rng = np.random.default_rng(seed)
    parts = [rng.normal(size=(m, 4)) for m in (50, 1, 70)]
    ys = [(p[:, 0] > 0).astype(float) for p in parts]
    classes = np.array([0.0, 1.0])
    wb = rng.normal(size=(2, 5)) * 0.1
    centers = parts[0][:3]
    out = {"gram": [], "logreg": [], "multinomial": [], "kmeans": [],
           "nb": []}
    for p, y in zip(parts, ys):
        out["gram"] += list(module.partition_gram_stats([p], "f"))
        out["logreg"] += list(module.partition_logreg_stats(
            [(p, y)], "f", "l", np.full(4, 0.1), -0.2))
        out["multinomial"] += list(module.partition_multinomial_stats(
            [(p, y)], "f", "l", classes, wb))
        out["kmeans"] += list(module.partition_kmeans_stats([p], "f",
                                                            centers))
        out["nb"] += list(module.partition_nb_stats([(np.abs(p), y)], "f",
                                                    "l", "gaussian"))
    return out


@pytest.mark.parametrize("combine", ["stats", "logreg", "multinomial",
                                     "kmeans", "nb"])
def test_combines_equal_jax(combine):
    ours, ref = _partition_rows(agg), _partition_rows(jagg)
    if combine == "stats":
        got, want = agg.combine_stats(ours["gram"]), \
            jagg.combine_stats(ref["gram"])
    elif combine == "logreg":
        got, want = agg.combine_logreg_stats(ours["logreg"]), \
            jagg.combine_logreg_stats(ref["logreg"])
    elif combine == "multinomial":
        got = agg.combine_multinomial_stats(ours["multinomial"], 2, 5)
        want = jagg.combine_multinomial_stats(ref["multinomial"], 2, 5)
    elif combine == "kmeans":
        got = agg.combine_kmeans_stats(ours["kmeans"], 3, 4)
        want = jagg.combine_kmeans_stats(ref["kmeans"], 3, 4)
    else:
        got, want = agg.combine_nb_stats(ours["nb"]), \
            jagg.combine_nb_stats(ref["nb"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("model_type", ["multinomial", "complement",
                                        "bernoulli", "gaussian"])
def test_finalize_nb_equals_jax(model_type):
    x, _, _, y_mc, wt = _design(seed=4)
    x = (x > 0.3).astype(float) if model_type == "bernoulli" else np.abs(x)
    rows = list(agg.partition_nb_stats([(x, y_mc)], "f", "l", model_type))
    stats = agg.combine_nb_stats(rows)
    got = agg.finalize_nb_from_stats(*stats, model_type, 0.5)
    want = jagg.finalize_nb_from_stats(*stats, model_type, 0.5)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)


def test_finalizers_and_solves_equal_jax():
    """LinearRegression's solve and one Newton step bit-equal; the PCA
    finalize equal on the host eigensolve and, on the device eigensolve,
    the port's float32 within 1e-5 of JAX's float64."""
    x, y_reg, y_bin, _, _ = _design(seed=5, d=6)
    g, s, c = agg.combine_stats(agg.partition_xy_stats([(x, y_reg)], "f",
                                                       "l"))
    for lam, fit_b in ((0.0, True), (0.1, False)):
        got = agg.solve_linreg_from_stats(g, s, c, lam, fit_b)
        want = jagg.solve_linreg_from_stats(g, s, c, lam, fit_b)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    w = np.full(6, 0.05)
    stats = agg.combine_logreg_stats(agg.partition_logreg_stats(
        [(x, y_bin)], "f", "l", w, 0.1))
    gx, hxx, hxb, rsum, ssum, _, count = stats
    for lam, fit_b in ((0.01, True), (0.0, False)):
        got = agg.logreg_newton_step_from_stats(
            gx, hxx, hxb, rsum, ssum, count, w, 0.1, lam, fit_b)
        want = jagg.logreg_newton_step_from_stats(
            gx, hxx, hxb, rsum, ssum, count, w, 0.1, lam, fit_b)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    g, s, c = agg.combine_stats(agg.partition_gram_stats([x], "f"))
    for centering in (True, False):
        # host eigensolve: numpy's LAPACK here, the JAX package's native
        # dsyevd where built (ROADMAP: the native layer is not ported)
        got = agg.finalize_pca_from_stats(g, s, c, 3, centering,
                                          use_xla_svd=False)
        want = jagg.finalize_pca_from_stats(g, s, c, 3, centering,
                                            use_xla_svd=False)
        assert _rel(got[0], want[0]) <= 1e-12
        assert _rel(got[1], want[1]) <= 1e-12
        np.testing.assert_array_equal(got[2], want[2])
        got = agg.finalize_pca_from_stats(g, s, c, 3, centering)
        want = jagg.finalize_pca_from_stats(g, s, c, 3, centering)
        assert _rel(got[0], want[0]) <= F32_RTOL
        assert _rel(got[1], want[1]) <= F32_RTOL
        np.testing.assert_array_equal(got[2], want[2])


def test_vector_columns_and_label_discovery_equal_jax():
    import pyarrow as pa

    structs = [
        {"type": 1, "size": None, "indices": None, "values": [1.0, 2.0, 0.0]},
        {"type": 0, "size": 3, "indices": [2], "values": [5.0]},
        {"type": None, "size": None, "indices": None, "values": [0.5, 0, 1]},
    ]
    column = pa.array(structs)
    np.testing.assert_array_equal(agg.vector_column_to_matrix(column),
                                  jagg.vector_column_to_matrix(column))
    np.testing.assert_array_equal(
        agg.vector_column_to_matrix([[1.0, 2.0], np.array([3.0, 4.0])]),
        jagg.vector_column_to_matrix([[1.0, 2.0], np.array([3.0, 4.0])]))
    x, _, _, y_mc, _ = _design(seed=6)
    jdf, pdf = _frames(x, [("label", y_mc)])
    np.testing.assert_array_equal(agg.discover_label_values(pdf, "label"),
                                  jagg.discover_label_values(jdf, "label"))


def _vector_column(case):
    import pyarrow as pa

    rows = np.random.default_rng(9).normal(size=(6, 4))
    dense = [le.DenseVector(r) for r in rows]
    if case == "mixed":
        dense[2] = le.SparseVector(4, [1, 3], [2.0, -1.0])
    if case == "ragged":
        dense[3] = le.DenseVector(rows[3, :3])
    column = le._record_batch(["f"], [dense]).column(0)
    if case == "sliced":
        return column.slice(1, 4)
    if case == "chunked":
        return pa.chunked_array([column, column.slice(2)])
    if case == "null type":
        return pa.array([{"type": None, "size": None, "indices": None,
                          "values": r.tolist()} for r in rows])
    if case == "null element":
        return pa.array([{"type": 1, "size": None, "indices": None,
                          "values": [1.0, None]}])
    return column


@pytest.mark.parametrize("case", ["dense", "sliced", "chunked", "mixed",
                                  "ragged", "null type", "null element"])
def test_vector_column_buffer_path_equals_jax(case):
    """Dense columns are read from the Arrow buffers, every other column
    row by row: the matrix (or the error) is JAX's either way, and the
    local engine builds the struct column JAX's engine builds."""
    column = _vector_column(case)
    if case == "ragged":
        with pytest.raises(ValueError, match="inconsistent vector sizes"):
            jagg.vector_column_to_matrix(column)
        with pytest.raises(ValueError, match="inconsistent vector sizes"):
            agg.vector_column_to_matrix(column)
        return
    got = agg.vector_column_to_matrix(column)
    want = jagg.vector_column_to_matrix(column)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and got.flags.writeable
    if case in ("dense", "mixed"):
        values = [le.DenseVector(r) for r in want] if case == "dense" \
            else None
        if values is not None:
            jvalues = [jle.DenseVector(r) for r in want]
            assert le._record_batch(["f"], [values]).equals(
                jle._record_batch(["f"], [jvalues]))


def test_batch_rows_equal_to_pylist():
    """The engine reads float list columns through numpy: the rows equal
    ``to_pylist``'s, nulls, float32 lists and slices included."""
    import pyarrow as pa

    batch = pa.RecordBatch.from_pydict({
        "gram": [[1.0, 2.5], [], [3.0]],
        "n": [1, 2, 3],
        "f32": pa.array([[1.5], [2.0], [0.1]], pa.list_(pa.float32())),
        "name": ["a", None, "c"],
        "holes": [[1.0, None], None, [2.0]]})
    for view in (batch, batch.slice(1, 2), batch.slice(0, 0)):
        assert le._batch_pylist(view) == view.to_pylist()


# -- the device plane on CPU torch against JAX's device plane -----------------

def _device_call(module, name, batches, *args, dtype):
    return list(getattr(module, name)(batches, *args, dtype=dtype))[0]


def _device_cases():
    x, y_reg, y_bin, y_mc, _ = _design(seed=7, n=300, d=6)
    w0 = np.linspace(-0.2, 0.2, 6)
    wb0 = np.random.default_rng(2).normal(size=(3, 7)) * 0.1
    # ragged batches: JAX pads each to a 256/512-row bucket, the port not
    return {
        "gram": ("partition_gram_stats_device",
                 [x[:37], x[37:]], ("f",)),
        "xy": ("partition_xy_stats_device",
               [(x[:37], y_reg[:37]), (x[37:], y_reg[37:])], ("f", "l")),
        "logreg": ("partition_logreg_stats_device",
                   [(x[:37], y_bin[:37]), (x[37:], y_bin[37:])],
                   ("f", "l", w0, 0.1)),
        "multinomial": ("partition_multinomial_stats_device",
                        [(x[:37], y_mc[:37]), (x[37:], y_mc[37:])],
                        ("f", "l", np.array([0.0, 1.0, 2.0]), wb0)),
        "kmeans": ("partition_kmeans_stats_device", [x[:37], x[37:]],
                   ("f", x[:5] + 0.01)),
    }


DEVICE_CASES = _device_cases()


@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_device_partials_match_jax(case):
    """float64 in both packages ≤ 1e-10 — the JAX partial pads every ragged
    batch to its row bucket, the port's does not, so this also pins padded
    against unpadded partials; the port's float32 ≤ 1e-5."""
    name, batches, args = DEVICE_CASES[case]
    ref = _device_call(jdev, name, batches, *args, dtype="float64")
    ours64 = _device_call(dev, name, batches, *args, dtype="float64")
    ours32 = _device_call(dev, name, batches, *args, dtype="auto")
    assert ours64.keys() == ref.keys() == ours32.keys()
    for key in ref:
        if key == "count":
            assert ours64[key] == ours32[key] == ref[key]
            continue
        assert _rel(ours64[key], ref[key]) <= F64_RTOL, key
        assert _rel(ours32[key], ref[key]) <= F32_RTOL, key


def test_device_partials_equal_the_host_plane():
    """The port's float64 device partials against its own host plane
    (the executor's two planes on one partition)."""
    for name, batches, args in DEVICE_CASES.values():
        host = list(getattr(agg, name.replace("_device", ""))(batches,
                                                             *args))[0]
        ours = _device_call(dev, name, batches, *args, dtype="float64")
        for key in host:
            assert _rel(ours[key], host[key]) <= F64_RTOL, (name, key)


def test_padded_bucket_equals_the_unpadded_partial():
    """A ragged batch padded to its power-of-two bucket with a mask (the
    JAX package's layout) gives the partial the port takes unpadded, at
    float32 on the plain Gram."""
    from spark_rapids_ml_tpu_torch.ops.streaming import (
        init_stats,
        update_stats,
    )

    x = np.random.default_rng(8).normal(size=(300, 9))
    row = _device_call(dev, "partition_gram_stats_device", [x], "f",
                       dtype="auto")
    padded = np.zeros((512, 9))
    padded[:300] = x
    mask = np.zeros(512)
    mask[:300] = 1.0
    stats = update_stats(init_stats(9, device="cpu"), padded, mask)
    np.testing.assert_allclose(np.asarray(row["gram"]).reshape(9, 9),
                               stats.gram.double().numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(row["col_sum"],
                                  stats.col_sum.double().numpy())
    assert row["count"] == int(stats.count) == 300


def test_executor_device_selection(monkeypatch):
    """'auto' takes the host plane when the CPU is requested (as JAX on a
    CPU-only executor), the card when there is one, and raises with
    neither; 'on' always takes the device function."""
    calls = []
    stats = est._select_stats_plane("auto", lambda b: calls.append("dev"),
                                    lambda b: calls.append("host"))
    stats([])
    assert calls == ["host"] and not dev.executor_device_available()
    est._select_stats_plane("on", lambda b: calls.append("dev"),
                            lambda b: calls.append("host"))([])
    assert calls[-1] == "dev"
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    stats([])
    assert calls[-1] == "dev"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="SPARK_RAPIDS_ML_TORCH_PLATFORM"):
        stats([])
    with pytest.raises(ValueError, match="executorDevice"):
        est._select_stats_plane("sometimes", None, None)


# -- the four front ends, fitted in both packages' local sessions -------------

@pytest.mark.parametrize("executor_device", ["off", "on"])
def test_pca_front_end_matches_jax(executor_device, tmp_path):
    x, _, _, _, _ = _design(seed=9, n=200, d=8)
    jdf, pdf = _frames(x)
    for svd in (False, True):
        ref = jest.PCA(k=3, inputCol="features", useXlaSvd=svd,
                       executorDevice=executor_device).fit(jdf)
        ours = est.PCA(k=3, inputCol="features", useXlaSvd=svd,
                       executorDevice=executor_device).fit(pdf)
        # the host plane and the host eigensolve: ≤ 1e-12 (numpy's LAPACK
        # against the JAX package's native dsyevd)
        bar = 1e-12 if executor_device == "off" and not svd else F32_RTOL
        for a, b in ((ours.pc, ref.pc), (ours.explainedVariance,
                                         ref.explainedVariance),
                     (ours.mean, ref.mean)):
            assert _rel(a.toArray(), b.toArray()) <= bar
    got = np.stack([r["pca_features"].toArray()
                    for r in ours.transform(pdf).collect()])
    want = np.stack([r["pca_features"].toArray()
                     for r in ref.transform(jdf).collect()])
    assert _rel(got, want) <= F32_RTOL
    # persistence both ways, the same files
    ours.save(str(tmp_path / "ours"))
    back = jest.PCAModel.load(str(tmp_path / "ours"))
    np.testing.assert_array_equal(back.pc.toArray(), ours.pc.toArray())
    assert back.getK() == 3 and back.uid == ours.uid
    ref.save(str(tmp_path / "ref"))
    mine = est.PCAModel.load(str(tmp_path / "ref"))
    np.testing.assert_array_equal(mine.pc.toArray(), ref.pc.toArray())
    np.testing.assert_array_equal(mine.mean.toArray(), ref.mean.toArray())
    assert mine.getInputCol() == "features"


@pytest.mark.parametrize("executor_device", ["off", "on"])
def test_linreg_front_end_matches_jax(executor_device, tmp_path):
    x, y_reg, _, _, wt = _design(seed=10)
    jdf, pdf = _frames(x, [("label", y_reg), ("wt", wt)])
    for kwargs in ({}, {"regParam": 0.1, "fitIntercept": False},
                   {"weightCol": "wt"}):
        ref = jest.LinearRegression(executorDevice=executor_device,
                                    **kwargs).fit(jdf)
        ours = est.LinearRegression(executorDevice=executor_device,
                                    **kwargs).fit(pdf)
        got = np.append(ours.coefficients.toArray(), ours.intercept)
        want = np.append(ref.coefficients.toArray(), ref.intercept)
        # weighted least squares always runs the host plane
        if executor_device == "off" or "weightCol" in kwargs:
            np.testing.assert_array_equal(got, want)
        else:
            assert _rel(got, want) <= FIT_F32_RTOL
    preds = [np.asarray([r["prediction"] for r in m.transform(d).collect()])
             for m, d in ((ours, pdf), (ref, jdf))]
    assert _rel(*preds) <= FIT_F32_RTOL
    ours.save(str(tmp_path / "ours"))
    back = jest.LinearRegressionModel.load(str(tmp_path / "ours"))
    np.testing.assert_array_equal(back.coefficients.toArray(),
                                  ours.coefficients.toArray())
    assert back.getOrDefault(back.featuresCol) == "features"
    ref.save(str(tmp_path / "ref"))
    mine = est.LinearRegressionModel.load(str(tmp_path / "ref"))
    assert mine.intercept == ref.intercept


def _probabilities(model, df):
    out = model.transform(df).collect()
    return out, np.asarray([r["prediction"] for r in out])


@pytest.mark.parametrize("executor_device", ["off", "on"])
def test_logreg_front_end_matches_jax(executor_device, tmp_path):
    """Binary: coefficients, ``n_iter_``, the objective history, the
    summary, ``thresholds`` and ``weightCol``; transforms and persistence
    both ways."""
    x, _, y_bin, _, wt = _design(seed=11)
    jdf, pdf = _frames(x, [("label", y_bin), ("wt", wt)])
    exact = executor_device == "off"
    for kwargs in ({"regParam": 0.02}, {"regParam": 0.02, "weightCol": "wt"},
                   {"regParam": 0.0, "fitIntercept": False, "tol": 1e-6}):
        ref = jest.LogisticRegression(executorDevice=executor_device,
                                      **kwargs).fit(jdf)
        ours = est.LogisticRegression(executorDevice=executor_device,
                                      **kwargs).fit(pdf)
        got = np.append(ours.coefficients.toArray(), ours.intercept)
        want = np.append(ref.coefficients.toArray(), ref.intercept)
        host = exact or "weightCol" in kwargs   # weighted: the host plane
        if host:
            np.testing.assert_array_equal(got, want)
            assert ours.n_iter_ == ref.n_iter_
            assert ours.summary.objectiveHistory == \
                ref.summary.objectiveHistory
        else:
            assert _rel(got, want) <= FIT_F32_RTOL
            m = min(ours.n_iter_, ref.n_iter_)
            assert _rel(ours.summary.objectiveHistory[:m],
                        ref.summary.objectiveHistory[:m]) <= F32_RTOL
        assert ours.summary.totalIterations == ours.n_iter_
    for thresholds in (None, [1e-6, 1.0], [0.0, 1.0], [1.0, 0.0]):
        for model in (ours, ref):
            if thresholds is not None:
                model.setThresholds(thresholds)
        rows, pred = _probabilities(ours, pdf)
        rows_ref, pred_ref = _probabilities(ref, jdf)
        np.testing.assert_array_equal(pred, pred_ref)
        assert _rel([r["probability"] for r in rows],
                    [r["probability"] for r in rows_ref]) <= FIT_F32_RTOL
    ours.save(str(tmp_path / "ours"))
    back = jest.LogisticRegressionModel.load(str(tmp_path / "ours"))
    np.testing.assert_array_equal(back.coefficients.toArray(),
                                  ours.coefficients.toArray())
    assert back.getOrDefault(back.thresholds) == [1.0, 0.0]
    assert not back.hasSummary
    ref.save(str(tmp_path / "ref"))
    mine = est.LogisticRegressionModel.load(str(tmp_path / "ref"))
    np.testing.assert_array_equal(_probabilities(mine, pdf)[1],
                                  _probabilities(ref, jdf)[1])


@pytest.mark.parametrize("executor_device", ["off", "on"])
def test_multinomial_front_end_matches_jax(executor_device, tmp_path):
    """family='auto' over three classes takes the softmax plane in both;
    weighted and thresholded; persistence both ways."""
    x, _, _, y_mc, wt = _design(seed=12)
    jdf, pdf = _frames(x, [("label", y_mc), ("wt", wt)])
    for kwargs in ({"regParam": 0.05}, {"regParam": 0.05, "weightCol": "wt"}):
        ref = jest.LogisticRegression(executorDevice=executor_device,
                                      **kwargs).fit(jdf)
        ours = est.LogisticRegression(executorDevice=executor_device,
                                      **kwargs).fit(pdf)
        got = np.column_stack([ours.coefficientMatrix.toArray(),
                               ours.interceptVector.toArray()])
        want = np.column_stack([ref.coefficientMatrix.toArray(),
                                ref.interceptVector.toArray()])
        if executor_device == "off" or "weightCol" in kwargs:
            assert _rel(got, want) <= 1e-12
            assert ours.n_iter_ == ref.n_iter_
        else:
            # the softmax is invariant to one shift of every intercept,
            # pinned only by a ridge far below float32 rounding: compare
            # modulo that gauge (intercepts less their class mean)
            for m in (got, want):
                m[:, -1] -= m[:, -1].mean()
            assert _rel(got, want) <= FIT_F32_RTOL
        np.testing.assert_array_equal(ours.classes_.toArray(),
                                      ref.classes_.toArray())
    ours.setThresholds([1.0, 1.0, 1e-3])
    ref.setThresholds([1.0, 1.0, 1e-3])
    rows, pred = _probabilities(ours, pdf)
    rows_ref, pred_ref = _probabilities(ref, jdf)
    np.testing.assert_array_equal(pred, pred_ref)
    assert _rel(np.stack([r["probability"].toArray() for r in rows]),
                np.stack([r["probability"].toArray() for r in rows_ref])) \
        <= FIT_F32_RTOL
    ours.save(str(tmp_path / "ours"))
    back = jest.LogisticRegressionModel.load(str(tmp_path / "ours"))
    np.testing.assert_array_equal(back.coefficientMatrix.toArray(),
                                  ours.coefficientMatrix.toArray())
    ref.save(str(tmp_path / "ref"))
    mine = est.LogisticRegressionModel.load(str(tmp_path / "ref"))
    np.testing.assert_array_equal(mine.classes_.toArray(),
                                  ref.classes_.toArray())


@pytest.mark.parametrize("executor_device", ["off", "on"])
def test_kmeans_front_end_matches_jax(executor_device, tmp_path):
    rng = np.random.default_rng(13)
    centres = np.array([[0.0, 6.0, 1.0], [6.0, 0.0, -1.0], [-6.0, -6.0, 0.0]])
    x = np.concatenate([c + 0.5 * rng.normal(size=(60, 3)) for c in centres])
    wt = rng.uniform(0.5, 2.0, size=x.shape[0])
    jdf, pdf = _frames(x, [("wt", wt)])
    for kwargs in ({}, {"weightCol": "wt"}):
        ref = jest.KMeans(k=3, seed=7, executorDevice=executor_device,
                          **kwargs).fit(jdf)
        ours = est.KMeans(k=3, seed=7, executorDevice=executor_device,
                          **kwargs).fit(pdf)
        got, want = np.asarray(ours.clusterCenters()), \
            np.asarray(ref.clusterCenters())
        if executor_device == "off" or "weightCol" in kwargs:
            np.testing.assert_array_equal(got, want)
            assert ours.summary.trainingCost == ref.summary.trainingCost
        else:
            assert _rel(got, want) <= F32_RTOL
            assert abs(ours.summary.trainingCost / ref.summary.trainingCost
                       - 1.0) <= F32_RTOL
        assert ours.summary.k == 3
    labels = [np.asarray([r["prediction"] for r in m.transform(d).collect()])
              for m, d in ((ours, pdf), (ref, jdf))]
    np.testing.assert_array_equal(*labels)
    ours.save(str(tmp_path / "ours"))
    back = jest.KMeansModel.load(str(tmp_path / "ours"))
    np.testing.assert_array_equal(np.asarray(back.clusterCenters()),
                                  np.asarray(ours.clusterCenters()))
    ref.save(str(tmp_path / "ref"))
    mine = est.KMeansModel.load(str(tmp_path / "ref"))
    assert mine.getOrDefault(mine.k) == 3


@pytest.mark.parametrize("name", ["PCA", "LinearRegression",
                                  "LogisticRegression", "KMeans"])
def test_estimator_params_persist_both_ways(name, tmp_path):
    kwargs = {"PCA": {"k": 5, "inputCol": "feats", "executorDevice": "off"},
              "LinearRegression": {"regParam": 0.25, "weightCol": "w"},
              "LogisticRegression": {"maxIter": 7, "family": "binomial"},
              "KMeans": {"k": 4, "seed": 3, "tol": 0.5}}[name]
    ours = getattr(est, name)(**kwargs)
    ours.save(str(tmp_path / "ours"))
    back = getattr(jest, name).load(str(tmp_path / "ours"))
    ref = getattr(jest, name)(**kwargs)
    ref.save(str(tmp_path / "ref"))
    mine = getattr(est, name).load(str(tmp_path / "ref"))
    for key, value in kwargs.items():
        assert back.getOrDefault(getattr(back, key)) == value
        assert mine.getOrDefault(getattr(mine, key)) == value
    assert back.uid == ours.uid and mine.uid == ref.uid
    meta = json.load(open(tmp_path / "ours" / "metadata" / "part-00000"))
    assert meta["pythonClass"].endswith(f".{name}") or \
        meta["pythonClass"].endswith(".PCA")


# -- partition layouts and degenerate inputs (tests/test_plane_edge_cases.py)

def _skewed(x, extra=()):
    """[all but one], [one], [] partitions in both packages."""
    frames = _frames(x, extra)
    for df in frames:
        flat = [row for part in df._partitions for row in part]
        df._partitions = [flat[:-1], flat[-1:], []]
    return frames


@pytest.mark.parametrize("family", ["PCA", "LinearRegression",
                                    "LogisticRegression", "KMeans"])
def test_planes_tolerate_skewed_partitions(family):
    x, y_reg, y_bin, _, _ = _design(seed=14, n=90, d=4)
    extra = {"PCA": (), "KMeans": (), "LinearRegression": [("label", y_reg)],
             "LogisticRegression": [("label", y_bin)]}[family]
    kwargs = {"PCA": {"k": 2, "inputCol": "features"},
              "KMeans": {"k": 2, "seed": 0},
              "LinearRegression": {}, "LogisticRegression": {"regParam": 0.05}
              }[family]
    jdf, pdf = _skewed(x, extra)
    for executor_device in ("off", "on"):
        ref = getattr(jest, family)(executorDevice=executor_device,
                                    **kwargs).fit(jdf)
        ours = getattr(est, family)(executorDevice=executor_device,
                                    **kwargs).fit(pdf)
        if family == "PCA":
            got, want = ours.pc.toArray(), ref.pc.toArray()
        elif family == "KMeans":
            got, want = ours.clusterCenters(), ref.clusterCenters()
            assert ours.trainingCost >= 0
        else:
            got, want = ours.coefficients.toArray(), \
                ref.coefficients.toArray()
        assert _rel(got, want) <= FIT_F32_RTOL


def test_single_row_and_single_class_errors():
    """Degenerate inputs get the JAX front ends' driver-side errors."""
    x1 = np.random.default_rng(15).normal(size=(1, 3))
    for module in (jest, est):
        jdf, pdf = _skewed(x1, [("label", [1.0])])
        df = pdf if module is est else jdf
        with pytest.raises(ValueError, match="at least 2"):
            module.LogisticRegression().fit(df)
        with pytest.raises(ValueError, match="more than one row"):
            module.PCA(k=1, inputCol="features",
                       executorDevice="off").fit(df)
    x, _, _, _, _ = _design(seed=16, n=20, d=3)
    _, pdf = _frames(x, [("label", np.full(20, 7.0))])
    with pytest.raises(ValueError, match="at least 2 distinct"):
        est.LogisticRegression().fit(pdf)
    with pytest.raises(ValueError, match="family"):
        est.LogisticRegression(family="bogus").fit(pdf)
    with pytest.raises(ValueError, match="k must be set"):
        est.PCA(inputCol="features").fit(pdf)


def test_pca_transform_raises_where_jax_falls_back(monkeypatch):
    """A device failure in the PCA transform raises in the port; the JAX
    front end catches it and projects on the host (``estimator.py:299-316``
    of the JAX package)."""
    import spark_rapids_ml_tpu.ops.pca_kernel as jax_pca_kernel
    import spark_rapids_ml_tpu_torch.ops.pca_kernel as pca_kernel

    x, _, _, _, _ = _design(seed=17, n=30, d=4)
    jdf, pdf = _frames(x)
    ours = est.PCA(k=2, inputCol="features").fit(pdf)
    ref = jest.PCA(k=2, inputCol="features").fit(jdf)

    def broken(*args, **kwargs):
        raise RuntimeError("device lost")

    monkeypatch.setattr(pca_kernel, "pca_transform_kernel", broken)
    monkeypatch.setattr(jax_pca_kernel, "pca_transform_kernel", broken)
    with pytest.raises(RuntimeError, match="device lost"):
        ours.transform(pdf)
    assert len(ref.transform(jdf).collect()) == 30


def test_unported_front_ends_name_their_roadmap_item():
    import spark_rapids_ml_tpu_torch.spark as spark

    for name, item in (("MinHashLSH", "item 7"), ("ALS", "item 7"),
                       ("LDA", "item 7"), ("Word2Vec", "item 7"),
                       ("PrefixSpan", "item 7"),
                       ("FMClassifier", "item 7")):
        with pytest.raises(AttributeError, match=item):
            getattr(spark, name)
    # the forest plane (ROADMAP queue 1 item 5b), the moments plane (5c),
    # NaiveBayes (6), UMAP (10), GaussianMixture and BisectingKMeans (7),
    # evaluation and tuning (7a), PIC and the transformers (7c, 7d) route
    # their front ends
    assert spark.Tokenizer.__module__.endswith(".spark.transformers")
    assert spark.ChiSqSelector.__module__.endswith(".spark.transformers")
    assert spark.PowerIterationClustering.__module__.endswith(".adapter3")
    assert spark.RegressionEvaluator.__module__.endswith(
        ".models.evaluation")
    assert spark.CrossValidator.__module__.endswith(".spark.tuning_front")
    assert spark.UMAP.__module__.endswith(".adapter")
    assert spark.GaussianMixture.__module__.endswith(".moments_estimator")
    assert spark.BisectingKMeansModel.__module__.endswith(".adapter3")
    # Imputer, OneVsRest and the MLP (7d (ii), 7e) route their front ends
    assert spark.Imputer.__module__.endswith(".moments_estimator")
    assert spark.OneVsRest.__module__.endswith(".moments_estimator")
    assert spark.MultilayerPerceptronClassifier.__module__.endswith(
        ".adapter")
    assert spark.GBTClassifier.__module__.endswith(".forest_estimator")
    assert spark.StandardScaler.__module__.endswith(".moments_estimator")
    assert spark.NaiveBayes is est.NaiveBayes
    assert spark.RandomForestClassificationModel is \
        spark.RandomForestClassifierModel
    with pytest.raises(AttributeError):
        spark.NotAFrontEnd
    assert spark.PCA is est.PCA
    assert spark.combine_stats is agg.combine_stats
    for name in ("combine_stats", "finalize_pca_from_stats",
                 "partition_gram_stats", "vector_column_to_matrix"):
        assert name in spark.__all__


def test_udf_bodies_equal_jax_arithmetic():
    """The factored transform bodies on numpy rows: the host ones equal the
    JAX front ends' inline arithmetic, the PCA device body (float32) within
    1e-5."""
    from spark_rapids_ml_tpu.utils.numeric import sigmoid

    rng = np.random.default_rng(18)
    x = rng.normal(size=(64, 6))
    pc = np.linalg.qr(rng.normal(size=(6, 3)))[0]
    np.testing.assert_array_equal(est._project_pca(x, pc, False), x @ pc)
    assert _rel(est._project_pca(x, pc, True), x @ pc) <= F32_RTOL
    coef, b = rng.normal(size=6), 0.3
    np.testing.assert_array_equal(est._linreg_predict(x, coef, b),
                                  x @ coef + b)
    np.testing.assert_array_equal(est._logreg_probability(x, coef, b),
                                  sigmoid(x @ coef + b))
    cm, iv = rng.normal(size=(3, 6)), rng.normal(size=3)
    proba = est._multinomial_probability(x, cm, iv)
    z = x @ cm.T + iv
    z = z - z.max(axis=1, keepdims=True)
    np.testing.assert_array_equal(
        proba, np.exp(z) / np.exp(z).sum(axis=1, keepdims=True))
    classes = np.array([2.0, 5.0, 9.0])
    assert est._multinomial_prediction(proba, classes, None) == \
        [float(classes[i]) for i in proba.argmax(axis=1)]
    centers = x[:4]
    np.testing.assert_array_equal(est._kmeans_assign(x[:4], centers),
                                  np.arange(4, dtype=np.int32))


# -- spawned executors --------------------------------------------------------

@pytest.mark.parametrize("mode", ["process", "collective"])
def test_spawned_executors(mode):
    """``executors="process"`` at 'on': each partition's Gram in a spawned
    worker on CPU torch; 'collective': a barrier stage whose two workers
    join a 2-rank gloo world, one partition empty (it joins with zeros),
    partition 0 emitting the reduced row. Both against the host-plane
    fit, at the float32 bar."""
    x, _, _, _, _ = _design(seed=19, n=120, d=6)
    _, pdf = _frames(x, n_partitions=2)
    session = le.LocalSparkSession(
        n_partitions=2, executors="process",
        executor_env={"SPARK_RAPIDS_ML_TORCH_PLATFORM": "cpu",
                      "OMP_NUM_THREADS": "1"})
    pdf._session = session
    if mode == "collective":
        flat = [row for part in pdf._partitions for row in part]
        pdf._partitions = [flat, []]
        executor_device = "collective"
    else:
        executor_device = "on"
    host = est.PCA(k=3, inputCol="features", executorDevice="off").fit(
        _frames(x)[1])
    model = est.PCA(k=3, inputCol="features",
                    executorDevice=executor_device).fit(pdf)
    assert _rel(model.pc.toArray(), host.pc.toArray()) <= F32_RTOL
    assert _rel(model.mean.toArray(), host.mean.toArray()) <= F32_RTOL
