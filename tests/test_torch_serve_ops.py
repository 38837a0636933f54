"""The port's serving ops against the JAX package's on the same seeded
numpy inputs: bucket padding and the staging pool, int8 quantization, the
serving projections (native / bf16 / int8), the PCA serving programs, the
metrics sketch, and the binary wire format in both directions.

Tolerances: quantization and the int8 projection bit for bit; bf16 within
rel 1e-6 (f32 sums in another order over bf16-exact products); native at
float64 within 1e-12.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu.obs.quantiles import QuantileSketch as JaxSketch
from spark_rapids_ml_tpu.ops import pca_kernel as jpk
from spark_rapids_ml_tpu.ops import quantize as jq
from spark_rapids_ml_tpu.serve import wire as jwire
from spark_rapids_ml_tpu.utils import padding as jpad
from spark_rapids_ml_tpu_torch import PCAModel
from spark_rapids_ml_tpu_torch.obs.metrics import MetricsRegistry
from spark_rapids_ml_tpu_torch.obs.quantiles import QuantileSketch
from spark_rapids_ml_tpu_torch.ops import pca_kernel as tpk
from spark_rapids_ml_tpu_torch.ops import quantize as tq
from spark_rapids_ml_tpu_torch.serve import wire as twire
from spark_rapids_ml_tpu_torch.utils import padding as tpad

ROWS = [1, 2, 7, 8, 9, 15, 16, 17, 31, 33, 64, 100, 127, 128, 129, 1000,
        1024, 1025]


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- bucket padding ---------------------------------------------------------

@pytest.mark.parametrize("max_rows", [1, 8, 9, 100, 1024, 1025, 4096])
def test_default_buckets_match_jax(max_rows):
    assert tpad.default_buckets(max_rows) == jpad.default_buckets(max_rows)


@pytest.mark.parametrize("ladder", [None, (8, 64, 256), (48, 96), (1024,)])
def test_bucket_for_matches_jax_over_a_sweep(ladder):
    got = [tpad.bucket_for(n, ladder) for n in ROWS]
    assert got == [jpad.bucket_for(n, ladder) for n in ROWS]


def test_bucket_for_rejects_nonpositive():
    with pytest.raises(ValueError):
        tpad.bucket_for(0)


@pytest.mark.parametrize("ladder", [None, (8, 64, 256)])
def test_pad_to_bucket_matches_jax_over_a_sweep(rng, ladder):
    for n in ROWS[:-2] + [0]:
        x = rng.normal(size=(n, 5))
        got, n_got = tpad.pad_to_bucket(x, ladder)
        want, n_want = jpad.pad_to_bucket(x, ladder)
        assert n_got == n_want == n
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tpad.pad_to_bucket(np.zeros(3))


@pytest.mark.parametrize("n,bucket", [(5, 8), (8, 8), (0, 8), (3, 0),
                                      (1000, 1024)])
def test_padding_waste_matches_jax(n, bucket):
    assert tpad.padding_waste(n, bucket) == jpad.padding_waste(n, bucket)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_staging_pool_fill_matches_jax_over_a_sweep(rng, dtype):
    """The same coalesced batches (one to three parts, rotating slots with
    stale tails) stage to equal arrays in both pools."""
    port, ref = tpad.StagingPool(dtype, slots=3), jpad.StagingPool(dtype,
                                                                   slots=3)
    for i, n in enumerate(ROWS[:-3]):
        parts = [rng.normal(size=(m, 6)) for m in
                 ([n] if i % 3 == 0 else [n, 1 + i % 5] if i % 3 == 1
                  else [1, n, 2])]
        got, n_got = port.fill(parts, (8, 16, 64, 128, 256))
        want, n_want = ref.fill(parts, (8, 16, 64, 128, 256))
        assert n_got == n_want and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_staging_pool_exact_fit_and_width_check(rng):
    pool = tpad.StagingPool(np.float64)
    x = rng.normal(size=(16, 3))
    staged, n = pool.fill([x])
    assert staged is x and n == 16  # an unpinned pool hands it over
    with pytest.raises(ValueError, match="coalesce"):
        pool.fill([rng.normal(size=(2, 3)), rng.normal(size=(2, 1))])
    with pytest.raises(ValueError):
        pool.fill([])


class _Fence:
    """A stand-in for the copy's CUDA event: records when it is waited
    on, and what the slot held then."""

    def __init__(self, pool_array):
        self.array = pool_array
        self.seen = None

    def synchronize(self):
        self.seen = np.array(self.array)


def test_staging_pool_waits_on_a_slots_fence_before_rewriting(rng):
    pool = tpad.StagingPool(np.float64, slots=2)
    first = rng.normal(size=(5, 4))
    staged, _ = pool.fill([first])
    fence = _Fence(staged)
    pool.fence(staged, fence)
    pool.fill([rng.normal(size=(6, 4))])       # the other slot
    assert fence.seen is None
    again, _ = pool.fill([rng.normal(size=(7, 4))])  # back to the first
    assert again is staged
    # the fence was waited on while the slot still held the first batch
    np.testing.assert_array_equal(fence.seen[:5], first)
    pool.fence(np.zeros((8, 4)), fence)  # not the pool's: ignored


# -- quantization -----------------------------------------------------------

QUANT_INPUTS = {
    "normal f64": lambda rng: rng.normal(size=(33, 17)),
    "normal f32": lambda rng: rng.normal(size=(8, 64)).astype(np.float32),
    "decaying": lambda rng: rng.normal(size=(64, 40))
    * (1.0 + np.arange(40)) ** -0.5,
    "ties": lambda rng: np.arange(-127, 128, 0.5)[None, :] / 127.0,
    "all zero": lambda rng: np.zeros((8, 5)),
    "one value": lambda rng: np.full((3, 3), -2.5),
}


@pytest.mark.parametrize("name", list(QUANT_INPUTS))
def test_quantize_symmetric_is_bit_equal_to_jax(rng, name):
    a = QUANT_INPUTS[name](rng)
    q, scale = tq.quantize_symmetric(_t(a))
    jqv, jscale = jq.quantize_symmetric(jnp.asarray(a))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    assert scale.item() == float(jscale)


@pytest.mark.parametrize("name", list(QUANT_INPUTS))
def test_quantize_symmetric_host_matches_jax(rng, name):
    a = QUANT_INPUTS[name](rng)
    q, scale = tq.quantize_symmetric_host(a)
    jqv, jscale = jq.quantize_symmetric_host(a)
    np.testing.assert_array_equal(q, jqv)
    assert scale == jscale and scale.dtype == np.float32


@pytest.mark.parametrize("d,k", [(13, 3), (16, 8), (64, 20), (5, 1)])
def test_pad_int8_components_pads_with_zeros_to_multiples_of_8(rng, d, k):
    q, _ = tq.quantize_symmetric_host(rng.normal(size=(d, k)))
    padded = tpk.pad_int8_components(q)
    assert padded.shape[0] % 8 == 0 and padded.shape[1] % 8 == 0
    np.testing.assert_array_equal(padded[:d, :k], q)
    assert not padded[d:].any() and not padded[:, k:].any()


# -- the serving projections -------------------------------------------------

PROJ_SHAPES = [(1, 13, 3), (8, 13, 3), (16, 64, 20), (17, 40, 7),
               (64, 33, 5), (256, 96, 16)]


@pytest.mark.parametrize("rows,d,k", PROJ_SHAPES)
def test_project_int8_is_bit_equal_to_jax(rng, rows, d, k):
    """The port pads to torch._int_mm's shapes and slices; the int32 sums
    are exact, so the padding changes nothing."""
    x = rng.normal(size=(rows, d)) * (1.0 + np.arange(d)) ** -0.5
    pc = rng.normal(size=(d, k))
    q, scale = tq.quantize_symmetric_host(pc)
    want = np.asarray(jpk._project_int8(jnp.asarray(x), jnp.asarray(q),
                                        jnp.asarray(scale)))
    got = tpk._project_int8(_t(x), _t(tpk.pad_int8_components(q)),
                            torch.tensor(scale))[:, :k]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rows,d,k", PROJ_SHAPES)
def test_project_bf16_matches_jax(rng, dtype, rows, d, k):
    x = (rng.normal(size=(rows, d)) * 3.0).astype(dtype)
    pc = rng.normal(size=(d, k))
    want = np.asarray(jpk._project_bf16(
        jnp.asarray(x), jnp.asarray(pc, dtype=jnp.bfloat16)))
    got = tpk._project_bf16(_t(x), _t(pc).to(torch.bfloat16))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("rows,d,k", PROJ_SHAPES)
def test_native_projection_at_float64_matches_jax(rng, rows, d, k):
    x = rng.normal(loc=2.0, size=(rows, d))
    pc = rng.normal(size=(d, k))
    want = np.asarray(jpk._project(jnp.asarray(x), jnp.asarray(pc)))
    got = tpk.pca_transform_serve(_t(x), _t(pc)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(
        want).max())


@pytest.mark.parametrize("setting", ["highest", "high", "medium"])
def test_native_float32_projection_ignores_the_matmul_precision(rng,
                                                                setting):
    """The full-f32 repair: a float32 batch is multiplied in float64 and
    rounded once, whatever torch.set_float32_matmul_precision says."""
    x = rng.normal(size=(40, 96)).astype(np.float32)
    pc = rng.normal(size=(96, 12)).astype(np.float32)
    exact = x.astype(np.float64) @ pc.astype(np.float64)
    torch.set_float32_matmul_precision(setting)
    try:
        got = tpk._project(_t(x), _t(pc))
    finally:
        torch.set_float32_matmul_precision("highest")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))


def test_serving_stage_bodies_keyed_like_jax():
    assert set(tpk.SERVING_STAGE_BODIES) == set(jpk.SERVING_STAGE_BODIES)


# -- the PCA serving programs ------------------------------------------------

@pytest.fixture
def models(rng):
    """One float64 PCA fit, in the JAX package and carried across."""
    x = rng.normal(size=(300, 13)) * (1.0 + np.arange(13)) ** -0.5
    ref = JaxPCA().setK(3).setDtype("float64").fit(x)
    port = PCAModel.from_numpy(ref.pc, ref.explained_variance,
                               ref.mean).setDtype("float64")
    return ref, port, x


def _run(program, x):
    return program.fetch(program.run(program.put(x)))


@pytest.mark.parametrize("precision", ["native", "bf16", "int8"])
@pytest.mark.parametrize("bucket", [8, 16, 64])
def test_pca_serving_program_matches_jax(models, rng, precision, bucket):
    ref, port, _ = models
    x = rng.normal(size=(bucket, 13))
    want = _run(ref.serving_transform_program(precision), x)
    program = port.serving_transform_program(precision)
    got = _run(program, x)
    assert program.precision == precision and program.algo == "pca"
    assert program.device == torch.device("cpu") and program.prime is None
    assert program.weight_bytes > 0 and program.dtype == np.float64
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    if precision == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        bar = 1e-12 if precision == "native" else 1e-6
        assert np.abs(got - want).max() <= bar * np.abs(want).max()


def test_serving_program_refuses_unknown_precision_and_host_models(models):
    _, port, _ = models
    with pytest.raises(ValueError, match="unknown serving precision"):
        port.serving_transform_program("fp8")
    port.setUseXlaDot(False)
    assert port.serving_transform_program() is None
    assert port.serving_stage() is None


@pytest.mark.parametrize("precision", ["native", "bf16", "int8"])
def test_serving_stage_computes_the_program(models, rng, precision):
    from spark_rapids_ml_tpu_torch.models._serving import staged_weight_bytes

    _, port, _ = models
    stage = port.serving_stage(precision)
    x = rng.normal(size=(16, 13))
    out = stage.fn(torch.from_numpy(x), *stage.weights).double().numpy()
    np.testing.assert_array_equal(
        out, _run(port.serving_transform_program(precision), x))
    assert stage.algo == "pca" and stage.fetch_dtype == np.float64
    assert staged_weight_bytes(stage.weights) == sum(
        w.nbytes for w in stage.weights)


def test_on_serving_thread_runs_card_work_on_a_thread_that_has_ended(
        monkeypatch):
    """Device work beside the batcher: inline for the CPU; for a CUDA
    device (streams faked here) on a thread of its own, with the serving
    compute stream current and the caller's context variables, ended by
    the time it returns its value or raises its error."""
    import contextlib
    import contextvars
    import threading

    from spark_rapids_ml_tpu_torch.models import _serving

    assert _serving.on_serving_thread(
        torch.device("cpu"), threading.current_thread) is (
        threading.current_thread())
    assert _serving.on_serving_thread(None, lambda: 7) == 7
    entered = []
    monkeypatch.setattr(_serving, "serving_streams",
                        lambda device: ("copy", "compute"))
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: (
        entered.append(stream) or contextlib.nullcontext()))
    var = contextvars.ContextVar("serving_test_var")
    var.set("caller's")
    ran = _serving.on_serving_thread(
        "cuda", lambda: (threading.current_thread(), var.get()))
    assert ran[0] is not threading.current_thread()
    assert not ran[0].is_alive() and ran[1] == "caller's"
    assert entered == ["compute"]

    def fails():
        raise KeyError("from the device thread")

    with pytest.raises(KeyError, match="from the device thread"):
        _serving.on_serving_thread("cuda", fails)


# -- metrics ------------------------------------------------------------------

def test_quantile_sketch_matches_jax(rng):
    values = np.concatenate([rng.lognormal(size=500), -rng.lognormal(
        size=50), np.zeros(5)])
    port, ref = QuantileSketch(), JaxSketch()
    for v in values:
        port.observe(v)
        ref.observe(v)
    qs = (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0)
    assert port.quantiles(qs) == ref.quantiles(qs)
    assert (port.count, port.sum, port.min, port.max) == (
        ref.count, ref.sum, ref.min, ref.max)


def test_prometheus_text_for_counters_gauges_and_summaries():
    reg = MetricsRegistry()
    reg.counter("c_total", "a counter", ("model",)).inc(3, model='a"b')
    reg.gauge("g", "a gauge").set(0.25)
    s = reg.summary("lat_seconds", "a summary", ("algo",))
    for v in (0.001, 0.002, 0.004):
        s.observe(v, algo="pca")
    text = reg.prometheus_text()
    assert '# TYPE c_total counter\nc_total{model="a\\"b"} 3' in text
    assert "# TYPE g gauge\ng 0.25" in text
    assert 'lat_seconds{algo="pca",quantile="0.5"}' in text
    assert 'lat_seconds_count{algo="pca"} 3' in text
    with pytest.raises(ValueError):
        reg.gauge("c_total")
    with pytest.raises(ValueError):
        reg.counter("c_total", labelnames=("other",))
    with pytest.raises(ValueError):
        reg.counter("c_total", labelnames=("model",)).inc(-1, model="a")
    assert reg.snapshot()["g"]["samples"][0]["value"] == 0.25


# -- the wire format, both directions ----------------------------------------

WIRE_DTYPES = [np.float32, np.float64, np.int32, np.int64]


@pytest.mark.parametrize("dtype", WIRE_DTYPES)
def test_jax_request_decodes_in_the_port_and_bytes_agree(rng, dtype):
    rows = (rng.normal(size=(7, 5)) * 100).astype(dtype)
    body = jwire.encode_request("pca@2", rows, deadline_ms=250)
    assert twire.encode_request("pca@2", rows, deadline_ms=250) == body
    req = twire.decode_request(body)
    assert req.model == "pca@2" and req.deadline_ms == 250.0 and req.binary
    assert req.rows.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(req.rows, rows)


@pytest.mark.parametrize("outputs", [
    np.arange(12.0).reshape(4, 3),
    np.arange(6, dtype=np.float32).reshape(3, 2),
    np.array([0, 1, 1], dtype=np.int32),
    np.array([[1.5]], dtype=np.float16),  # carried as f64
])
def test_port_response_decodes_in_jax_and_bytes_agree(outputs):
    body = twire.encode_response(outputs)
    assert jwire.encode_response(outputs) == body
    got = jwire.decode_response(body)
    np.testing.assert_array_equal(got, outputs)
    np.testing.assert_array_equal(twire.decode_response(body), got)


def _mutations():
    good = jwire.encode_request("pca", np.ones((2, 3)))
    return {
        "bad magic": b"XXXX" + good[4:],
        "bad version": good[:4] + bytes([9]) + good[5:],
        "bad dtype": good[:5] + bytes([99]) + good[6:],
        "truncated header": good[:10],
        "truncated payload": good[:-8],
        "trailing bytes": good + b"\x00" * 8,
        "zero rows": jwire._REQ_HEADER.pack(
            jwire.MAGIC, 1, 2, 0, 0, 3, 3, 0, 0) + b"pca",
        "bad utf-8 ref": jwire._REQ_HEADER.pack(
            jwire.MAGIC, 1, 2, 0, 1, 1, 2, 0, 0) + b"\xff\xfe" + b"\0" * 8,
        "ref past the body": jwire._REQ_HEADER.pack(
            jwire.MAGIC, 1, 2, 0, 1, 1, 50, 0, 0) + b"pca",
    }


@pytest.mark.parametrize("name", list(_mutations()))
def test_bad_frames_give_the_same_reason_and_status(name):
    body = _mutations()[name]
    with pytest.raises(jwire.WireError) as want:
        jwire.decode_request(body)
    with pytest.raises(twire.WireError) as got:
        twire.decode_request(body)
    assert (got.value.reason, got.value.status, got.value.kind) == (
        want.value.reason, want.value.status, want.value.kind)


@pytest.mark.parametrize("body", [b"not json", b'{"rows": [[1]]}',
                                  b'{"model": "m", "rows": [["x"]]}'])
def test_bad_json_is_a_json_kind_wire_error(body):
    with pytest.raises(twire.WireError) as exc:
        twire.decode_body(body, "application/json")
    assert exc.value.kind == "json" and exc.value.reason == "bad_json"


def test_json_request_and_negotiation_match_jax():
    body = b'{"model": "pca", "rows": [[1, 2], [3, 4]], "deadline_ms": 9}'
    got, want = twire.decode_body(body, None), jwire.decode_body(body, None)
    assert (got.model, got.deadline_ms, got.binary) == (
        want.model, want.deadline_ms, want.binary)
    np.testing.assert_array_equal(got.rows, want.rows)
    for accept in (None, "*/*", "application/json", twire.BINARY_CONTENT_TYPE,
                   "text/html"):
        for binary in (False, True):
            assert twire.wants_binary_response(accept, binary) == \
                jwire.wants_binary_response(accept, binary)
    assert twire.is_binary_content_type(
        "application/x-sparkml-columnar; charset=binary")


def test_wire_module_is_importable_standalone():
    mod = importlib.import_module("spark_rapids_ml_tpu_torch.serve.wire")
    assert mod.MAGIC == jwire.MAGIC and mod.DTYPE_CODES == jwire.DTYPE_CODES
