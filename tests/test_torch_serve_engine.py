"""The port's serving engine: the same PCA model, carried across, served
through both packages' ``ServeEngine`` on every ladder; the registry; the
micro-batcher's invariants; and the engine's fault handling (queue full,
deadlines, retries, the breaker's degraded answer, the NaN guard, drain,
worker supervision).

Every wait has a timeout and every engine is shut down in ``finally``;
tests synchronise on events or on queue state, never on a bare sleep, and
read counters as deltas (the metrics registry is process-wide).
"""

import threading
import time

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu.serve import ModelRegistry as JaxRegistry
from spark_rapids_ml_tpu.serve import ServeEngine as JaxEngine
from spark_rapids_ml_tpu_torch import PCAModel
from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
from spark_rapids_ml_tpu_torch.serve import (
    BatcherClosed,
    BreakerOpen,
    DeadlineExpired,
    EngineClosed,
    MicroBatcher,
    ModelRegistry,
    NumericsError,
    QueueFull,
    ServeEngine,
    WorkerCrashed,
    extract_output,
    fault_plane,
    reset_fault_plane,
)
from spark_rapids_ml_tpu_torch.serve.batching import AsyncTransformSpec

WAIT = 30.0


@pytest.fixture(autouse=True)
def _cpu_requested(monkeypatch, tmp_path):
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    # a wedge writes a flight dump: keep it in this test's directory
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_DUMP_DIR", str(tmp_path))
    reset_fault_plane()
    yield
    reset_fault_plane()


def _counter(name, **labels):
    family = get_registry().snapshot().get(name, {"samples": []})
    return sum(s["value"] for s in family["samples"]
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def _until(predicate, timeout=WAIT):
    """Wait for a state the test set up (a queue depth, a dead worker)."""
    end = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > end:
            raise AssertionError("condition not reached")
        time.sleep(0.001)


# Not 16: the JAX package's serving tests compile their bf16 / int8
# programs for a 16-feature model and count the new signatures in the
# process-wide compile log, which a same-shape program compiled here
# first would already hold.
N_FEAT = 20


@pytest.fixture
def models(rng):
    """One float64 PCA fit in the JAX package, and the same model carried
    across with PCAModel.from_numpy; dtype float64 named in both."""
    x = rng.normal(size=(400, N_FEAT)) * (1.0 + np.arange(N_FEAT)) ** -0.5
    ref = JaxPCA().setK(4).setDtype("float64").fit(x)
    port = PCAModel.from_numpy(ref.pc, ref.explained_variance,
                               ref.mean).setDtype("float64")
    return ref, port, x


class _Gate:
    """A registry model whose transform blocks on an event: deterministic
    queue buildup. ``entered`` is set once a batch is executing."""

    def __init__(self, out=None):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.out = out

    def transform(self, matrix):
        self.entered.set()
        assert self.release.wait(WAIT)
        return np.asarray(matrix) if self.out is None else self.out(matrix)


class _Identity:
    def __init__(self):
        self.calls = 0

    def transform(self, matrix):
        self.calls += 1
        return np.asarray(matrix, dtype=np.float64)


# -- the same model through both engines -------------------------------------

SIZES = {"tiny": [1, 3, 8], "ragged": [5, 9, 17, 31], "buckets": [16, 32, 64],
         "mixed": [2, 40, 7, 64, 13]}


@pytest.mark.parametrize("sizes", list(SIZES))
@pytest.mark.parametrize("precision", ["native", "bf16", "int8"])
def test_engine_outputs_match_jax_on_every_ladder(models, precision, sizes):
    """Each request is served alone (sequential calls), so both engines
    see the same batch at the same bucket: native within 1e-12, bf16
    within 1e-6, int8 bit for bit."""
    ref, port, x = models
    jeng = JaxEngine(JaxRegistry(), max_batch_rows=64, max_wait_ms=1,
                     precision=precision)
    teng = ServeEngine(ModelRegistry(), max_batch_rows=64, max_wait_ms=1,
                       precision=precision)
    try:
        jeng.registry.register("pca", ref)
        teng.registry.register("pca", port)
        start = 0
        for n in SIZES[sizes]:
            rows = x[start:start + n]
            start += n
            want = jeng.predict("pca", rows)
            got = teng.predict("pca", rows)
            assert got.shape == want.shape == (n, 4)
            if precision == "int8":
                np.testing.assert_array_equal(got, want)
            else:
                bar = 1e-12 if precision == "native" else 1e-6
                assert np.abs(got - want).max() <= bar * np.abs(want).max()
        assert teng.stats()["queues"]["pca@1"]["precision"] == precision
    finally:
        jeng.shutdown()
        teng.shutdown()


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_concurrent_requests_get_their_own_rows_at_any_depth(models, depth):
    """Concurrent mixed-size requests through the pipeline (or the
    blocking path at depth 1): every request equals the host product of
    its own rows."""
    _, port, x = models
    engine = ServeEngine(ModelRegistry(), max_batch_rows=64, max_wait_ms=2,
                         pipeline_depth=depth)
    engine.registry.register("pca", port)
    sizes = [1 + (7 * i) % 50 for i in range(48)]
    outputs, errors = {}, []

    def client(i):
        try:
            outputs[i] = engine.predict("pca", x[i:i + sizes[i]],
                                        timeout=WAIT)
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(48)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads) and not errors
        for i in range(48):
            np.testing.assert_allclose(outputs[i], x[i:i + sizes[i]]
                                       @ port.pc, rtol=0, atol=1e-12)
        batcher = engine._batchers[("pca", 1)]
        assert (batcher.async_spec is None) == (depth == 1)
    finally:
        engine.shutdown()


def test_pipelined_outputs_equal_the_blocking_path(models):
    _, port, x = models
    outs = []
    for depth in (1, 2):
        engine = ServeEngine(ModelRegistry(), max_wait_ms=1,
                             pipeline_depth=depth)
        engine.registry.register("pca", port)
        try:
            outs.append([engine.predict("pca", x[:n]) for n in (3, 8, 20)])
        finally:
            engine.shutdown()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_engine_warmup_covers_the_engines_buckets(models):
    _, port, _ = models
    engine = ServeEngine(ModelRegistry(), max_batch_rows=96, max_wait_ms=1,
                         buckets=(48, 96))
    engine.registry.register("pca", port, buckets=(64,))
    try:
        report = engine.warmup("pca")
        assert sorted(report["buckets"]) == [48, 96]
        assert report["pipeline"]["precision"] == "native"
        assert sorted(report["pipeline"]["buckets"]) == [48, 96]
        assert engine.registry.resolve_entry("pca").warmed_buckets == (48, 96)
    finally:
        engine.shutdown()


def test_precision_guard_falls_back_to_native(models):
    _, port, x = models
    before = _counter("sparkml_serve_precision_fallback_total",
                      model="guarded", precision="int8")
    engine = ServeEngine(ModelRegistry(), max_wait_ms=1, precision="int8",
                         precision_max_err=1e-12)
    engine.registry.register("guarded", port)
    try:
        out = engine.predict("guarded", x[:5])
        np.testing.assert_allclose(out, x[:5] @ port.pc, atol=1e-12)
        check = engine.precision_checks[("guarded", 1, "int8")]
        assert check["verdict"] == "fail" and check["error"] > 1e-12
        assert engine.stats()["queues"]["guarded@1"]["precision"] == "native"
        assert _counter("sparkml_serve_precision_fallback_total",
                        model="guarded", precision="int8") == before + 1
    finally:
        engine.shutdown()


def test_unknown_precision_spelling_serves_native(models):
    _, port, _ = models
    engine = ServeEngine(ModelRegistry(), precision="fp4")
    assert engine.precision == "native"
    engine.shutdown()


def test_failed_program_build_is_counted_and_served_blocking(models):
    _, port, x = models

    class _NoProgram(PCAModel):
        def serving_transform_program(self, precision="native", device=None):
            raise RuntimeError("no program")

    broken = _NoProgram.from_numpy(port.pc, port.explained_variance)
    broken.setDtype("float64")
    before = _counter("sparkml_serve_errors_total", model="noprog",
                      error="serving_program")
    engine = ServeEngine(ModelRegistry(), max_wait_ms=1)
    engine.registry.register("noprog", broken)
    try:
        out = engine.predict("noprog", x[:3])
        np.testing.assert_allclose(out, x[:3] @ port.pc, atol=1e-12)
        assert engine._batchers[("noprog", 1)].async_spec is None
        assert _counter("sparkml_serve_errors_total", model="noprog",
                        error="serving_program") == before + 1
    finally:
        engine.shutdown()


def test_predict_without_a_card_or_a_cpu_request_raises(models, monkeypatch):
    _, port, x = models
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    engine = ServeEngine(ModelRegistry(), max_wait_ms=1, retries=0)
    engine.registry.register("pca", port)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine.predict("pca", x[:2], timeout=WAIT)
    finally:
        engine.shutdown()


# -- the registry ---------------------------------------------------------------

def test_registry_versions_and_aliases(models):
    _, port, _ = models
    reg = ModelRegistry()
    assert reg.register("pca", port) == 1
    assert reg.register("pca", port) == 2
    reg.alias("prod", "pca", version=1)
    reg.alias("canary", "pca")
    assert reg.resolve_entry("prod").version == 1
    assert reg.resolve_entry("canary").version == 2
    assert reg.resolve_entry("pca@1").version == 1
    assert reg.names() == ["pca"]
    for bad in ("nope", "pca@9", "pca@latest"):
        with pytest.raises(KeyError):
            reg.resolve_entry(bad)
    with pytest.raises(ValueError):
        reg.register("bad@name", port)
    with pytest.raises(KeyError):
        reg.alias("x", "ghost")
    reg.deregister("pca", version=2)
    assert reg.resolve_entry("pca").version == 1


def test_registry_load_and_warmup(models, tmp_path):
    _, port, _ = models
    path = str(tmp_path / "pca")
    port.save(path)
    reg = ModelRegistry()
    assert reg.load("pca", path, buckets=(8, 32)) == 1
    entry = reg.resolve_entry("pca")
    np.testing.assert_array_equal(entry.model.pc, port.pc)
    assert entry.source_path == path
    report = reg.warmup("pca")
    assert sorted(report["buckets"]) == [8, 32]
    with pytest.raises(ValueError, match="n_features"):
        reg.register("opaque", _Identity())
        reg.warmup("opaque")


def test_registry_manifest_recovers_after_a_crash(models, tmp_path):
    _, port, x = models
    path = str(tmp_path / "pca")
    port.save(path)
    manifest = str(tmp_path / "manifest.json")
    reg = ModelRegistry(manifest_path=manifest)
    reg.load("pca", path)
    reg.load("pca", path)
    reg.register("inproc", port)
    reg.alias("prod", "pca", version=1)
    reg.warmup("pca", buckets=(8,))
    back = ModelRegistry(manifest_path=manifest)
    report = back.recovery_report_
    assert sorted(report["recovered"]) == ["pca@1", "pca@2"]
    assert report["skipped"] == ["inproc@1"] and report["aliases"] == 1
    assert back.resolve_entry("prod").version == 1
    assert back.resolve_entry("pca@2").warmed_buckets == (8,)
    # the unrecoverable slot is retained: its version is never reused
    assert back.register("inproc", port) == 2
    np.testing.assert_array_equal(back.resolve("pca").pc, port.pc)


def test_registry_survives_a_corrupt_manifest(tmp_path):
    manifest = tmp_path / "manifest.json"
    manifest.write_text("{not json")
    reg = ModelRegistry(manifest_path=str(manifest))
    assert "error" in reg.recovery_report_ and reg.names() == []


# -- the micro-batcher -------------------------------------------------------

class _Recorder:
    """Identity transform returning the FULL padded matrix, so a padding
    leak would show in a response."""

    def __init__(self):
        self.batches = []

    def __call__(self, matrix):
        self.batches.append(np.array(matrix))
        return matrix


def test_padded_rows_never_leak_and_order_survives(rng):
    fn = _Recorder()
    b = MicroBatcher(fn, name="leak", max_batch_rows=64, max_wait_ms=20)
    try:
        xs = [rng.normal(size=(n, 3)) for n in (5, 7, 13)]
        reqs = [b.submit(x) for x in xs]
        for x, req in zip(xs, reqs):
            np.testing.assert_array_equal(req.wait(WAIT), x)
        assert all(m.shape[0] in b.buckets for m in fn.batches)
    finally:
        b.close()


def test_concurrent_submits_see_every_row_exactly_once(rng):
    b = MicroBatcher(_Recorder(), name="once", max_batch_rows=32,
                     max_wait_ms=1)
    results, lock = {}, threading.Lock()

    def client(t):
        for i in range(20):
            x = np.full((1 + (t + i) % 5, 2), t * 1000 + i, dtype=float)
            out = b.submit(x).wait(WAIT)
            with lock:
                results[(t, i)] = np.array_equal(out, x)

    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert len(results) == 160 and all(results.values())
    finally:
        b.close()


def test_batcher_rejects_bad_requests_and_clamps_to_its_ladder():
    b = MicroBatcher(_Recorder(), name="shape", max_batch_rows=100,
                     buckets=(8, 32))
    try:
        assert b.max_batch_rows == 32 and b.buckets == (8, 32)
        for bad in (np.zeros((0, 3)), np.zeros((2, 2, 2))):
            with pytest.raises(ValueError):
                b.submit(bad)
        with pytest.raises(ValueError, match="exceeds max_batch_rows"):
            b.submit(np.zeros((33, 2)))
        np.testing.assert_array_equal(b.submit(np.ones(3)).wait(WAIT),
                                      np.ones((1, 3)))
    finally:
        b.close()
    with pytest.raises(BatcherClosed):
        b.submit(np.ones((1, 3)))


def test_batch_failure_reaches_only_its_batch(rng):
    calls = []

    def flaky(matrix):
        calls.append(matrix.shape[0])
        if len(calls) == 1:
            raise ValueError("boom")
        return matrix

    b = MicroBatcher(flaky, name="flaky", max_wait_ms=1)
    try:
        with pytest.raises(ValueError, match="boom"):
            b.submit(np.ones((2, 2))).wait(WAIT)
        np.testing.assert_array_equal(b.submit(np.ones((2, 2))).wait(WAIT),
                                      np.ones((2, 2)))
    finally:
        b.close()


def test_batch_metrics_are_recorded():
    before = _counter("sparkml_serve_batches_total", model="metered")
    rows = _counter("sparkml_serve_batch_rows_total", model="metered")
    b = MicroBatcher(_Recorder(), name="metered", max_wait_ms=1)
    try:
        b.submit(np.ones((5, 2))).wait(WAIT)
    finally:
        b.close()
    assert _counter("sparkml_serve_batches_total",
                    model="metered") == before + 1
    assert _counter("sparkml_serve_batch_rows_total",
                    model="metered") == rows + 5
    assert _counter("sparkml_serve_padding_waste", model="metered") == \
        pytest.approx(3 / 8)


def test_async_spec_batch_failure_mid_window_fails_only_its_members():
    """A dispatch that raises for one batch fails that batch's request;
    the batches around it in the window complete."""
    seen = []

    def dispatch(x):
        seen.append(float(x[0, 0]))
        if x[0, 0] == 2.0:
            raise ValueError("bad batch")
        return x * 10

    spec = AsyncTransformSpec(stage=np.array, dispatch=dispatch,
                              complete=np.asarray, dtype=np.float64,
                              algo="toy")
    # one row per batch: no coalescing, a window of three batches
    b = MicroBatcher(None, name="window", max_batch_rows=1, max_wait_ms=0,
                     async_spec=spec, pipeline_depth=3)
    try:
        reqs = [b.submit(np.full((1, 2), float(i))) for i in range(1, 5)]
        for i, req in enumerate(reqs, start=1):
            if i == 2:
                with pytest.raises(ValueError, match="bad batch"):
                    req.wait(WAIT)
            else:
                np.testing.assert_array_equal(req.wait(WAIT),
                                              np.full((1, 2), 10.0 * i))
    finally:
        b.close()


# -- engine fault handling ----------------------------------------------------

def test_queue_full_is_rejected_at_the_door():
    gate = _Gate()
    engine = ServeEngine(ModelRegistry(), max_batch_rows=2, max_wait_ms=0,
                         max_queue_depth=1)
    engine.registry.register("gated", gate)
    results = []
    first = threading.Thread(target=lambda: results.append(
        engine.predict("gated", np.zeros((2, 3)), timeout=WAIT)))
    second = threading.Thread(target=lambda: results.append(
        engine.predict("gated", np.zeros((2, 3)), timeout=WAIT)))
    before = _counter("sparkml_serve_rejected_total", model="gated")
    try:
        first.start()
        assert gate.entered.wait(WAIT)
        second.start()
        _until(lambda: engine.queue_depth("gated") == 1)
        with pytest.raises(QueueFull):
            engine.predict("gated", np.zeros((2, 3)))
        assert _counter("sparkml_serve_rejected_total",
                        model="gated") == before + 1
    finally:
        gate.release.set()
        first.join(WAIT)
        second.join(WAIT)
        engine.shutdown()
    assert len(results) == 2


def test_deadline_expires_in_the_queue_before_device_time():
    gate = _Gate()
    engine = ServeEngine(ModelRegistry(), max_batch_rows=2, max_wait_ms=0)
    engine.registry.register("slow", gate)
    plug = threading.Thread(target=lambda: engine.predict(
        "slow", np.zeros((2, 3)), timeout=WAIT))
    before = _counter("sparkml_serve_deadline_expired_total", model="slow")
    errors = []

    def late():
        try:
            engine.predict("slow", np.zeros((2, 3)), deadline_ms=1,
                           timeout=WAIT)
        except DeadlineExpired as exc:
            errors.append(exc)

    waiter = threading.Thread(target=late)
    try:
        plug.start()
        assert gate.entered.wait(WAIT)
        waiter.start()
        _until(lambda: engine.queue_depth("slow") == 1)
        time.sleep(0.005)  # let the 1 ms deadline pass while it is queued
        gate.release.set()
        waiter.join(WAIT)
        assert len(errors) == 1
        assert _counter("sparkml_serve_deadline_expired_total",
                        model="slow") == before + 1
    finally:
        gate.release.set()
        plug.join(WAIT)
        engine.shutdown()


def test_one_injected_raise_is_retried(models):
    _, port, x = models
    engine = ServeEngine(ModelRegistry(), max_wait_ms=1, retries=2,
                         backoff_ms=1)
    engine.registry.register("retry", port)
    fault_plane().inject("retry", "raise", count=1)
    before = _counter("sparkml_serve_retries_total", model="retry")
    try:
        result = engine.predict_detailed("retry", x[:6], timeout=WAIT)
        assert result.retries == 1 and not result.degraded
        np.testing.assert_allclose(result.outputs, x[:6] @ port.pc,
                                   atol=1e-12)
        assert _counter("sparkml_serve_retries_total",
                        model="retry") == before + 1
    finally:
        engine.shutdown()


def test_retry_budget_exhaustion_raises_the_backend_error(models):
    from spark_rapids_ml_tpu_torch.serve import InjectedBackendError

    _, port, x = models
    engine = ServeEngine(ModelRegistry(), max_wait_ms=1, retries=1,
                         backoff_ms=1, breaker_failures=10)
    engine.registry.register("exhaust", port)
    fault_plane().inject("exhaust", "raise", count=2)
    try:
        with pytest.raises(InjectedBackendError):
            engine.predict("exhaust", x[:2], timeout=WAIT)
    finally:
        engine.shutdown()


def test_open_breaker_gives_a_counted_degraded_answer(models):
    _, port, x = models
    engine = ServeEngine(ModelRegistry(), max_wait_ms=1, retries=0,
                         breaker_failures=2, breaker_cooldown_ms=60_000)
    engine.registry.register("brk", port)
    fault_plane().inject("brk", "raise", count=None)
    before = _counter("sparkml_serve_degraded_total", model="brk")
    try:
        from spark_rapids_ml_tpu_torch.serve import InjectedBackendError

        with pytest.raises(InjectedBackendError):
            engine.predict("brk", x[:3], timeout=WAIT)
        # the second failure opens the breaker: this request degrades
        second = engine.predict_detailed("brk", x[:3], timeout=WAIT)
        third = engine.predict_detailed("brk", x[3:9], timeout=WAIT)
        for result, rows in ((second, x[:3]), (third, x[3:9])):
            assert result.degraded
            np.testing.assert_allclose(result.outputs, rows @ port.pc,
                                       atol=1e-12)
        assert engine.breaker_snapshot()["brk"]["state"] == "open"
        assert _counter("sparkml_serve_degraded_total",
                        model="brk") == before + 2
    finally:
        engine.shutdown()


def test_open_breaker_without_fallback_sheds_fast():
    engine = ServeEngine(ModelRegistry(), max_wait_ms=1, retries=0,
                         breaker_failures=1, breaker_cooldown_ms=60_000)
    engine.registry.register("nofb", _Identity())
    fault_plane().inject("nofb", "raise", count=None)
    try:
        from spark_rapids_ml_tpu_torch.serve import InjectedBackendError

        with pytest.raises(InjectedBackendError):
            engine.predict("nofb", np.ones((2, 2)), timeout=WAIT)
        with pytest.raises(BreakerOpen):
            engine.predict("nofb", np.ones((2, 2)), timeout=WAIT)
    finally:
        engine.shutdown()


def test_nan_output_is_a_numerics_error(models):
    _, port, x = models
    engine = ServeEngine(ModelRegistry(), max_wait_ms=1, retries=0,
                         breaker_failures=10)
    engine.registry.register("nan", port)
    fault_plane().inject("nan", "nan", count=1)
    try:
        with pytest.raises(NumericsError):
            engine.predict("nan", x[:4], timeout=WAIT)
        np.testing.assert_allclose(engine.predict("nan", x[:4]),
                                   x[:4] @ port.pc, atol=1e-12)
    finally:
        engine.shutdown()


def test_nan_guard_ignores_padding_rows():
    """A model that maps zero (padding) rows to NaN serves its real rows."""
    def log_rows(matrix):
        with np.errstate(divide="ignore"):
            return np.log(np.abs(np.asarray(matrix)))

    gate = _Gate(out=log_rows)
    gate.release.set()
    engine = ServeEngine(ModelRegistry(), max_wait_ms=1)
    engine.registry.register("log", gate)
    try:
        out = engine.predict("log", np.full((3, 2), np.e), timeout=WAIT)
        np.testing.assert_allclose(out, np.ones((3, 2)))
    finally:
        engine.shutdown()


def test_shutdown_drains_queued_requests():
    gate = _Gate()
    engine = ServeEngine(ModelRegistry(), max_batch_rows=2, max_wait_ms=0)
    engine.registry.register("drain", gate)
    results = []
    threads = [threading.Thread(target=lambda i=i: results.append(
        engine.predict("drain", np.full((2, 2), float(i)), timeout=WAIT)))
        for i in range(3)]
    try:
        threads[0].start()
        assert gate.entered.wait(WAIT)
        for t in threads[1:]:
            t.start()
        _until(lambda: engine.queue_depth("drain") == 2)
        closer = threading.Thread(target=engine.shutdown)
        closer.start()
        _until(lambda: engine._closed)
        with pytest.raises(EngineClosed):
            engine.predict("drain", np.ones((2, 2)))
        gate.release.set()
        closer.join(WAIT)
        for t in threads:
            t.join(WAIT)
        assert sorted(float(r[0, 0]) for r in results) == [0.0, 1.0, 2.0]
    finally:
        gate.release.set()
        engine.shutdown()


def test_shutdown_without_drain_fails_queued_requests():
    gate = _Gate()
    engine = ServeEngine(ModelRegistry(), max_batch_rows=2, max_wait_ms=0)
    engine.registry.register("nodrain", gate)
    errors = []

    def client():
        try:
            engine.predict("nodrain", np.ones((2, 2)), timeout=WAIT)
        except BatcherClosed as exc:
            errors.append(exc)

    plug = threading.Thread(target=lambda: engine.predict(
        "nodrain", np.ones((2, 2)), timeout=WAIT))
    queued = threading.Thread(target=client)
    try:
        plug.start()
        assert gate.entered.wait(WAIT)
        queued.start()
        _until(lambda: engine.queue_depth("nodrain") == 1)
        closer = threading.Thread(target=lambda: engine.shutdown(drain=False))
        closer.start()
        queued.join(WAIT)
        assert len(errors) == 1
        gate.release.set()
        closer.join(WAIT)
    finally:
        gate.release.set()
        plug.join(WAIT)
        engine.shutdown()


def test_worker_crash_restarts_and_recovers(models):
    _, port, x = models
    engine = ServeEngine(ModelRegistry(), max_wait_ms=1, retries=0,
                         breaker_failures=10)
    engine.registry.register("crash", port)
    before = _counter("sparkml_serve_worker_restarts_total", model="crash")
    try:
        engine.predict("crash", x[:2])
        fault_plane().inject("crash", "crash_worker", count=1)
        with pytest.raises(WorkerCrashed):
            engine.predict("crash", x[:2], timeout=WAIT)
        _until(lambda: _counter("sparkml_serve_worker_restarts_total",
                                model="crash") == before + 1)
        np.testing.assert_allclose(engine.predict("crash", x[:2],
                                                  timeout=WAIT),
                                   x[:2] @ port.pc, atol=1e-12)
    finally:
        engine.shutdown()


def test_dead_worker_fails_fast_and_the_probe_revives_it(models):
    _, port, x = models
    clock = [0.0]
    engine = ServeEngine(ModelRegistry(), max_wait_ms=1, retries=0,
                         max_worker_restarts=0, breaker_failures=1,
                         breaker_cooldown_ms=1000, clock=lambda: clock[0])
    engine.registry.register("dead", port)
    engine._fallbacks[("dead", 1)] = None  # shed instead of degrading
    try:
        fault_plane().inject("dead", "crash_worker", count=1)
        with pytest.raises(WorkerCrashed):
            engine.predict("dead", x[:2], timeout=WAIT)
        batcher = engine._batchers[("dead", 1)]
        _until(batcher.dead)
        with pytest.raises(BreakerOpen):
            engine.predict("dead", x[:2], timeout=WAIT)
        clock[0] += 2.0  # past the cooldown: the next request probes
        out = engine.predict("dead", x[:2], timeout=WAIT)
        np.testing.assert_allclose(out, x[:2] @ port.pc, atol=1e-12)
        assert engine._batchers[("dead", 1)] is not batcher
        assert engine.breaker_snapshot()["dead"]["state"] == "closed"
    finally:
        engine.shutdown()


def test_wedged_worker_is_failed_fast_by_the_watchdog(tmp_path):
    stalls = threading.Event()

    def stall(matrix):
        if not stalls.is_set():
            stalls.set()
            threading.Event().wait(2.0)  # a wedged call
        return matrix

    b = MicroBatcher(stall, name="wedge", max_wait_ms=0,
                     worker_budget_s=0.05)
    before = _counter("sparkml_serve_worker_restarts_total", model="wedge")
    try:
        t0 = time.monotonic()
        with pytest.raises(WorkerCrashed, match="wedged"):
            b.submit(np.ones((1, 2))).wait(WAIT)
        assert time.monotonic() - t0 < 1.5
        np.testing.assert_array_equal(b.submit(np.ones((1, 2))).wait(WAIT),
                                      np.ones((1, 2)))
        assert _counter("sparkml_serve_worker_restarts_total",
                        model="wedge") == before + 1
        # and the wedge left its flight dump
        _until(lambda: list(tmp_path.glob("flightdump_*.json")))
        (dump,) = tmp_path.glob("flightdump_*.json")
        assert "budget_exceeded_serve_worker_wedge" in dump.name
    finally:
        b.close(timeout=5)


def test_evict_and_version_rollover_close_old_batchers(models):
    _, port, x = models
    engine = ServeEngine(ModelRegistry(), max_wait_ms=1)
    engine.registry.register("roll", port)
    try:
        engine.predict("roll", x[:2])
        engine.registry.register("roll", port)
        engine.registry.deregister("roll", version=1)
        engine.predict("roll", x[:2])
        assert set(engine._batchers) == {("roll", 2)}
        assert engine.evict("roll", 2) and not engine.evict("roll", 2)
        assert engine.stats()["queues"] == {}
    finally:
        engine.shutdown()


def test_unknown_model_and_bad_shape_are_client_errors(models):
    _, port, _ = models
    engine = ServeEngine(ModelRegistry(), max_wait_ms=1)
    engine.registry.register("pca", port)
    try:
        with pytest.raises(KeyError):
            engine.predict("ghost", np.ones((1, N_FEAT)))
        with pytest.raises(ValueError):
            engine.predict("pca", np.ones((0, N_FEAT)))
        assert engine.breaker_snapshot()["pca"]["consecutive_failures"] == 0
    finally:
        engine.shutdown()


def test_extract_output_prefers_the_output_column(models):
    _, port, x = models
    out = extract_output(port, port.transform(x[:8]))
    assert out.shape == (8, 4)
    arr = np.ones((2, 2))
    assert extract_output(port, arr) is arr
    with pytest.raises(TypeError):
        extract_output(port, {"not": "a frame"})
