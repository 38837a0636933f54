"""MultilayerPerceptron in the port against the JAX package's, on the same
seeded numpy inputs.

``ops/mlp_kernel.py``, ``models/mlp.py``, the MLP writer of
``io/persistence.py`` and the Spark pair (``spark/adapter.py``). Bars:

* ``init_weights`` bit-equal to JAX's; ``forward_logits`` within 1e-13
  (max |Δ| / max |ref|) at float64; the float32 product (float64, rounded
  once, in forward and backward) equal to the float64 product rounded;
* the cases of ``tests/test_mlp.py`` (XOR, blobs, weighted rows, L-BFGS
  against GD, the transform columns, validation) through both packages at
  float64: flat weights within 1e-8 relative, the same ``n_iter``,
  predictions equal. XOR is compared at 30 iterations and the weighted
  overlap at 50 (2.4e-10 and 1.1e-9 there): along their L-BFGS paths
  the two libraries' rounding differences (the sigmoid's derivative
  among them: σ(1 − σ) here, the quotient rule in JAX) grow ~1.2–1.3× an
  iteration
  (5.5e-9 at 50 on XOR, 4e-3 at 100), in either package alone — JAX's
  own XOR fit from a start one ulp away is more than 1e-3 off its fit at
  200 iterations — so at the JAX test's 200 iterations the port is held
  to that test's own accuracy bar;
* persistence both ways, bit-equal flat weights; ``load_model``;
* the Spark pair against its model's ``transform``: equal;
* the float32 NaN of ``tests/test_distributed.py::test_distributed_mlp_
  fit`` (seed 42, [4, 8, 3], seed 1, maxIter 200): the port's float32 fit
  finite with accuracy > 0.9, the test's own specification; JAX's float32
  ``mlp_train_kernel`` ending on NaN there, and why: at its 26th iterate
  the loss is finite and the smallest hidden pre-activation below −88.7,
  where exp(−z) overflows float32 and the quotient-rule derivative of
  1/(1 + exp(−z)) is inf/inf; the port's gradient at that same iterate
  (carried by ``mlp_params_from_jax``) is finite.

The JAX suite runs with x64 on (tests/conftest.py), so its ``'auto'`` is
float64; the port's is float32, so each port fit names its dtype.
"""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu_torch import (
    MultilayerPerceptronClassifier,
    MultilayerPerceptronModel,
)
from spark_rapids_ml_tpu_torch.ops import mlp_kernel

F64_RTOL = 1e-8
FORWARD_RTOL = 1e-13


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """The CPU requested, and metrics registries of this test's own in both
    packages."""
    from spark_rapids_ml_tpu.obs import devmon as jax_devmon
    from spark_rapids_ml_tpu.obs import fitmon as jax_fitmon
    from spark_rapids_ml_tpu.obs import metrics as jax_metrics
    from spark_rapids_ml_tpu_torch.obs import devmon, fitmon, metrics

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
    return float(np.abs(got - want).max() / np.abs(want).max())


def xor_data(seed=0, n=400):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, 2))
    y = ((x[:, 0] > 0) ^ (x[:, 1] > 0)).astype(float)
    return x, y


def _jax_cls():
    from spark_rapids_ml_tpu import MultilayerPerceptronClassifier as J

    return J


def _both(x, labels=None, frame=None, **params):
    """(port model at float64, JAX model) from the same params and rows."""
    J = _jax_cls()
    port = MultilayerPerceptronClassifier(dtype="float64", **params)
    jax_est = J(**params)
    if frame is not None:
        return port.fit(frame[0]), jax_est.fit(frame[1])
    return port.fit(x, labels=labels), jax_est.fit(x, labels=labels)


def _assert_same_fit(port, jax_model, x):
    assert port.num_iterations_ == jax_model.num_iterations_
    assert _rel(port.flat_weights, jax_model.flat_weights) <= F64_RTOL
    np.testing.assert_array_equal(
        np.argmax(port.predict_proba(x), axis=1),
        np.argmax(jax_model.predict_proba(x), axis=1))


@pytest.fixture(scope="module")
def xor_fits():
    """The XOR case of tests/test_mlp.py through both packages: L-BFGS at
    maxIter 30, tol 0, and GD at the same iterations."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
        x, y = xor_data()
        params = dict(layers=[2, 8, 2], seed=1, maxIter=30, tol=0.0)
        lbfgs = _both(x, labels=y, **params)
        gd = _both(x, labels=y, solver="gd", **params)
    return x, y, lbfgs, gd


# -- the kernel functions -----------------------------------------------------

def test_init_weights_bit_equal_to_jax():
    from spark_rapids_ml_tpu.ops import mlp_kernel as jax_mlp

    for layers, seed in (([4, 8, 3], 1), ([784, 256, 128, 10], 0)):
        got = mlp_kernel.init_weights(layers, seed)
        want = jax_mlp.init_weights(layers, seed)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["w"], w["w"])
            np.testing.assert_array_equal(g["b"], w["b"])


def test_forward_logits_matches_jax_at_float64():
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.ops import mlp_kernel as jax_mlp

    rng = np.random.default_rng(3)
    layers = [7, 12, 9, 4]
    params = jax_mlp.init_weights(layers, 5)
    for layer in params:
        layer["b"] = rng.normal(size=layer["b"].shape)
    x = rng.normal(size=(33, 7)) * 3.0
    want = np.asarray(jax_mlp.forward_logits(
        [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params],
        jnp.asarray(x)))
    net = mlp_kernel.mlp_params_from_jax(params, device="cpu",
                                         dtype=torch.float64)
    got = net(torch.as_tensor(x)).detach().numpy()
    assert _rel(got, want) <= FORWARD_RTOL
    # the carry round-trips bit for bit
    back = mlp_kernel.mlp_params_to_numpy(net)
    np.testing.assert_array_equal(mlp_kernel.flatten_weights(back),
                                  jax_mlp.flatten_weights(params))


def test_float32_products_are_float64_rounded_once_both_ways():
    rng = np.random.default_rng(4)
    a = torch.as_tensor(rng.normal(size=(50, 30)), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=(30, 7)), dtype=torch.float32)
    g = torch.as_tensor(rng.normal(size=(50, 7)), dtype=torch.float32)
    a.requires_grad_(True)
    b.requires_grad_(True)
    out = mlp_kernel.matmul(a, b)
    out.backward(g)
    a64, b64, g64 = a.detach().double(), b.detach().double(), g.double()
    assert out.dtype == torch.float32
    assert torch.equal(out, (a64 @ b64).float())
    assert torch.equal(a.grad, (g64 @ b64.T).float())
    assert torch.equal(b.grad, (a64.T @ g64).float())


# -- tests/test_mlp.py's cases through both packages ------------------------

def test_learns_xor_as_jax_does(xor_fits):
    x, y, (port, jax_model), _gd = xor_fits
    _assert_same_fit(port, jax_model, x)
    assert np.mean(np.argmax(port.predict_proba(x), axis=1) == y) > 0.9
    assert abs(port.final_loss_ - jax_model.final_loss_) <= \
        F64_RTOL * abs(jax_model.final_loss_)


def test_learns_xor_at_the_jax_tests_iterations():
    """tests/test_mlp.py's own XOR specification (maxIter 200, tol 1e-9:
    accuracy > 0.95, more than one iteration, a finite loss) for the port.
    At 200 iterations the path is rounding-sensitive in JAX alone: its fit
    from a start one ulp away differs from its own fit by more than 1e-3,
    so the two packages are compared at 30 iterations above."""
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.ops import mlp_kernel as jax_mlp

    x, y = xor_data()
    params = dict(layers=[2, 8, 2], seed=1, maxIter=200, tol=1e-9)
    port = MultilayerPerceptronClassifier(dtype="float64", **params).fit(
        x, labels=y)
    jax_model = _jax_cls()(**params).fit(x, labels=y)
    for model in (port, jax_model):
        pred = np.argmax(model.predict_proba(x), axis=1)
        assert np.mean(pred == y) > 0.95
        assert model.num_iterations_ > 1 and np.isfinite(model.final_loss_)
    oh = jax_mlp.validate_and_onehot(x, y, [2, 8, 2])
    start = [{k: jnp.asarray(np.nextafter(v, np.inf) if k == "w" else v)
              for k, v in layer.items()}
             for layer in jax_mlp.init_weights([2, 8, 2], 1)]
    nudged, _, _ = jax_mlp.mlp_train_kernel(
        start, jnp.asarray(x), jnp.asarray(oh), jnp.ones(x.shape[0]),
        solver="l-bfgs", max_iter=200, tol=1e-9, step_size=0.03)
    assert _rel(jax_mlp.flatten_weights(nudged),
                jax_model.flat_weights) > 1e-3


def test_lbfgs_beats_gd_at_equal_iterations_as_jax(xor_fits):
    x, _y, (lb, _), (gd, jax_gd) = xor_fits
    _assert_same_fit(gd, jax_gd, x)
    assert lb.final_loss_ < gd.final_loss_


def test_multiclass_blobs_as_jax():
    rng = np.random.default_rng(1)
    centers = np.array([[6.0, 0], [0, 6.0], [-6.0, -6.0]])
    labels = rng.integers(0, 3, size=450)
    x = centers[labels] + rng.normal(size=(450, 2))
    port, jax_model = _both(x, labels=labels, layers=[2, 6, 3], seed=0,
                            maxIter=150)
    _assert_same_fit(port, jax_model, x)
    assert np.mean(np.argmax(port.predict_proba(x), axis=1) == labels) > 0.97


def test_weighted_rows_shift_decision_as_jax():
    from spark_rapids_ml_tpu.data.frame import VectorFrame as JaxFrame

    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    rng = np.random.default_rng(2)
    x = np.vstack([rng.normal(size=(100, 2)) - 0.5,
                   rng.normal(size=(100, 2)) + 0.5])
    y = np.repeat([0.0, 1.0], 100)
    w_hi = np.where(y == 1, 10.0, 1.0)
    cols = {"features": list(x), "label": y, "w": w_hi}
    port, jax_model = _both(
        None, frame=(VectorFrame(dict(cols)), JaxFrame(dict(cols))),
        layers=[2, 4, 2], seed=0, maxIter=50, weightCol="w")
    _assert_same_fit(port, jax_model, x)
    assert np.argmax(port.predict_proba(x), axis=1).mean() > 0.55


def test_transform_columns_as_jax(xor_fits):
    x, _y, (port, jax_model), _gd = xor_fits
    out, ref = port.transform(x[:100]), jax_model.transform(x[:100])
    raw = np.stack([np.asarray(v) for v in out.column("rawPrediction")])
    proba = np.stack([np.asarray(v) for v in out.column("probability")])
    pred = np.asarray(out.column("prediction"))
    assert raw.shape == proba.shape == (100, 2)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-12)
    np.testing.assert_array_equal(pred, np.argmax(raw, axis=1))
    want = np.stack([np.asarray(v) for v in ref.column("rawPrediction")])
    assert _rel(raw, want) <= F64_RTOL
    np.testing.assert_array_equal(pred, np.asarray(ref.column("prediction")))
    # '' disables a column, as Spark does
    port.setRawPredictionCol("")
    try:
        assert "rawPrediction" not in port.transform(x[:5]).columns
    finally:
        port.setRawPredictionCol("rawPrediction")


@pytest.mark.parametrize("case,match", [
    ("no_layers", "layers must be set"),
    ("width", "feature width"),
    ("fraction", "class indices"),
    ("range", "class indices"),
    ("length", "labels length"),
])
def test_validation_raises_as_jax(case, match):
    J = _jax_cls()
    x, y = xor_data(n=50)
    layers, labels = [2, 4, 2], y
    if case == "no_layers":
        layers = None
    elif case == "width":
        layers = [3, 4, 2]
    elif case == "fraction":
        labels = y + 0.5
    elif case == "range":
        labels = y + 5
    else:
        labels = y[:-1]
    kw = {} if layers is None else {"layers": layers}
    for cls in (MultilayerPerceptronClassifier, J):
        with pytest.raises(ValueError, match=match):
            cls(**kw).fit(x, labels=labels)


# -- persistence ---------------------------------------------------------------

def test_models_saved_by_either_package_load_in_the_other(xor_fits,
                                                          tmp_path):
    from spark_rapids_ml_tpu import MultilayerPerceptronModel as JaxModel

    from spark_rapids_ml_tpu_torch.io.persistence import load_model

    x, _y, (port, jax_model), _gd = xor_fits
    port.save(str(tmp_path / "port"))
    jax_model.save(str(tmp_path / "jax"))
    from_jax = load_model(str(tmp_path / "jax"))
    assert type(from_jax) is MultilayerPerceptronModel
    np.testing.assert_array_equal(from_jax.flat_weights,
                                  jax_model.flat_weights)
    assert from_jax.layers_ == [2, 8, 2]
    assert from_jax.num_iterations_ == jax_model.num_iterations_
    from_port = JaxModel.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(from_port.flat_weights, port.flat_weights)
    from_jax.setDtype("float64")
    np.testing.assert_allclose(from_jax.predict_proba(x[:20]),
                               jax_model.predict_proba(x[:20]),
                               rtol=0, atol=1e-12)
    # the flat layout round-trips through Spark's vector shape
    from spark_rapids_ml_tpu_torch.models.mlp import weights_from_flat

    for a, b in zip(weights_from_flat(port.flat_weights, [2, 8, 2]),
                    port.weights_):
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["b"], b["b"])


def test_estimator_params_round_trip(tmp_path):
    est = MultilayerPerceptronClassifier(layers=[3, 5, 2], maxIter=17,
                                         solver="gd", blockSize=64)
    est.save(str(tmp_path / "est"))
    back = MultilayerPerceptronClassifier.load(str(tmp_path / "est"))
    assert back.get_or_default("layers") == [3, 5, 2]
    assert back.getMaxIter() == 17 and back.getSolver() == "gd"
    assert back.getBlockSize() == 64


# -- the Spark pair ------------------------------------------------------------

def test_spark_pair_equals_its_model_transform():
    import spark_rapids_ml_tpu_torch.spark as port_spark
    from spark_rapids_ml_tpu_torch.spark.local_engine import (
        DenseVector,
        LocalSparkSession,
    )

    x, y = xor_data(seed=5, n=200)
    spark = LocalSparkSession(n_partitions=2)
    df = spark.createDataFrame([
        {"features": DenseVector(r), "label": float(lab)}
        for r, lab in zip(x, y)])
    est = port_spark.MultilayerPerceptronClassifier(
        layers=[2, 8, 2], seed=1, maxIter=150, dtype="float64")
    model = est.fit(df)
    assert type(model).__name__ == "MultilayerPerceptronClassifierModel"
    rows = model.transform(df).collect()
    proba = np.stack([r["probability"].toArray() for r in rows])
    pred = np.asarray([r["prediction"] for r in rows])
    local = MultilayerPerceptronClassifier(
        layers=[2, 8, 2], seed=1, maxIter=150, dtype="float64").fit(
            x, labels=y)
    np.testing.assert_allclose(proba, local.predict_proba(x), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(pred,
                                  np.argmax(local.predict_proba(x), axis=1))
    assert np.mean(pred == y) > 0.95


# -- the float32 NaN of the JAX reference ---------------------------------------

def _distributed_test_data():
    """``tests/test_distributed.py::test_distributed_mlp_fit``'s rows."""
    rng = np.random.default_rng(42)
    centers = np.asarray([[0, 0, 0, 0], [4, 4, 0, 0], [0, 4, 4, 0]],
                         dtype=np.float64)
    y = rng.integers(0, 3, size=301).astype(float)
    x = rng.normal(size=(301, 4)) + centers[y.astype(int)]
    return x, y


def test_float32_fit_is_finite_where_the_reference_goes_nan():
    """The port's float32 L-BFGS fit on the JAX test's data meets the
    JAX test's own specification: a finite loss, accuracy > 0.9."""
    x, y = _distributed_test_data()
    model = MultilayerPerceptronClassifier(
        layers=[4, 8, 3], maxIter=200, seed=1).fit(x, labels=y)
    assert model.getDtype() == "auto"      # float32 in the port
    assert np.isfinite(model.final_loss_)
    assert np.isfinite(model.flat_weights).all()
    pred = np.argmax(model.predict_proba(x), axis=1)
    assert (pred == y).mean() > 0.9


def test_reference_float32_lbfgs_goes_nan_from_the_sigmoid_derivative():
    """Pins the JAX reference's behaviour (not the port's): its float32
    ``mlp_train_kernel`` on the same data ends on a NaN loss with one
    class predicted, because at its 26th iterate the loss is finite but a
    hidden pre-activation sits below −88.7, where exp(−z) overflows float32
    and JAX's derivative of 1/(1 + exp(−z)) is inf/inf = NaN. The port's
    gradient at that very iterate is finite (``torch.sigmoid``'s
    σ(1 − σ)). ROADMAP queue 3 item 5."""
    import jax
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.ops import mlp_kernel as jax_mlp

    x, y = _distributed_test_data()
    layers = [4, 8, 3]
    oh = jax_mlp.validate_and_onehot(x, y, layers)
    f32 = jnp.float32
    data = (jnp.asarray(x, f32), jnp.asarray(oh, f32), jnp.ones(301, f32))
    p0 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, f32),
                                jax_mlp.init_weights(layers, 1))
    _p, n_iter, loss = jax_mlp.mlp_train_kernel(
        p0, *data, solver="l-bfgs", max_iter=200, tol=1e-6, step_size=0.03)
    assert np.isnan(float(loss)) and int(n_iter) == 28
    # the 26th iterate, from the same compiled loop: the loss changes by
    # 4.6e-5 over iteration 25 and by 2.0e-5 over iteration 26, so at tol
    # 3e-5 the loop stops there and returns the iterate that step made
    p26, n26, _ = jax_mlp.mlp_train_kernel(
        p0, *data, solver="l-bfgs", max_iter=200, tol=3e-5, step_size=0.03)
    assert int(n26) == 26
    value, grad = jax.value_and_grad(jax_mlp.mean_cross_entropy)(p26, *data)
    z = np.asarray(data[0] @ p26[0]["w"] + p26[0]["b"])
    assert np.isfinite(float(value)) and z.min() < -88.72
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree_util.tree_leaves(grad))
    net = mlp_kernel.mlp_params_from_jax(p26, device="cpu",
                                         dtype=torch.float32)
    ws = [t.detach().clone().requires_grad_(True) for t in net.weights]
    port_value = mlp_kernel.mean_cross_entropy(
        ws, torch.as_tensor(x, dtype=torch.float32),
        torch.as_tensor(oh, dtype=torch.float32), torch.ones(301))
    port_value.backward()
    assert abs(port_value.item() - float(value)) <= 1e-6 * float(value)
    assert all(torch.isfinite(t.grad).all() for t in ws)
