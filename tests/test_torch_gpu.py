"""Tests of the port that need the card (marker ``gpu``).

They skip, with a reason, where there is no CUDA device: whether there is
one is decided inside the ``cuda_device`` fixture, never at import. This
file imports neither jax nor the JAX package, so it runs on a machine
without them; tests/conftest.py does import jax, so run it there with

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""

import os
import time

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu_torch import PCA
from spark_rapids_ml_tpu_torch.ops import fused_gram
from spark_rapids_ml_tpu_torch.ops.fused_gram import (
    fused_centered_gram,
    fused_centered_gram_reference,
)
from spark_rapids_ml_tpu_torch.utils import cuda_build
from torch_stage_families import FAMILY_ALGOS, stage_family

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device(monkeypatch):
    """The card, with entry points resolving to it; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", raising=False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda", 0)


def _decaying(rows, d, seed=0, loc=3.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return rng.normal(size=(rows, d)) @ (q * 2.0 ** (-np.arange(d) / 4)) + loc


def test_kernel_builds_with_nvcc(cuda_device):
    result = cuda_build.build("fused_gram")
    assert os.path.isfile(result.path)


@pytest.mark.parametrize("precision", ["highest", "bfloat16", "bfloat16_3x"])
@pytest.mark.parametrize("rows,n", [(1000, 1100), (256, 128), (5, 129)])
def test_kernel_matches_plain_version_on_card(cuda_device, precision, rows, n):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(rows, n, generator=g, device=cuda_device)
    mean = 0.3 * torch.randn(n, generator=g, device=cuda_device)
    rowmul = torch.full((rows,), (rows - 1) ** -0.5, device=cuda_device)
    rowmul[rows - rows // 5:] = 0.0  # a masked tail
    name = fused_gram.kernel_name(precision)
    before = fused_gram.launches[name]
    got = fused_centered_gram(x, mean, rowmul, precision)
    torch.cuda.synchronize()
    assert fused_gram.launches[name] == before + 1
    want = fused_centered_gram_reference(x, mean, rowmul, precision)
    # f32 sums in another order (tensor-core accumulation in bf16 modes)
    err = (got - want).abs().max().item()
    assert err <= fused_gram.PLAIN_RTOL[name] * want.abs().max().item()
    assert torch.equal(got, got.T)


# The pipelines' edges, as (rows, n, masked tail rows, extra
# columns of the parent whose row view x is, from column 1).
EDGES = {
    "one row": (1, 64, 0, 0),
    "rows below one k-block": (40, 130, 0, 0),
    "rows not a multiple of 64": (200, 136, 0, 0),
    "n not a multiple of 8": (300, 131, 0, 0),
    "n 4096, diagonal tiles": (256, 4096, 0, 0),
    "strided row view": (500, 300, 0, 7),
    "masked tail of garbage": (700, 260, 200, 0),
}


def _edge_inputs(device, edge):
    rows, n, masked, extra = EDGES[edge]
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(rows, n + extra, generator=g, device=device) + 0.5
    if extra:
        x = x[:, 1:n + 1]
    mask = torch.ones(rows, device=device)
    if masked:
        mask[rows - masked:] = 0.0
        x[rows - masked:] = 1e6  # padding garbage the mask must hide
    valid = int(mask.sum())
    mean = (x * mask[:, None]).sum(0) / valid
    rowmul = mask / max(valid - 1, 1) ** 0.5
    return x, mean.contiguous(), rowmul.contiguous()


@pytest.mark.parametrize("precision", ["highest", "bfloat16", "bfloat16_3x"])
@pytest.mark.parametrize("edge", list(EDGES))
def test_pipeline_edges_match_plain_version(cuda_device, precision, edge):
    x, mean, rowmul = _edge_inputs(cuda_device, edge)
    name = fused_gram.kernel_name(precision)
    before = fused_gram.launches[name]
    got = fused_centered_gram(x, mean, rowmul, precision)
    torch.cuda.synchronize()
    assert fused_gram.launches[name] == before + 1
    want = fused_centered_gram_reference(x, mean, rowmul, precision)
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err <= fused_gram.PLAIN_RTOL[name] * want.abs().max().item()
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("precision", ["highest", "bfloat16", "bfloat16_3x"])
@pytest.mark.parametrize("edge", list(EDGES))
def test_prep_pass_is_bit_equal_to_its_plain_version(cuda_device, precision,
                                                     edge):
    x, mean, rowmul = _edge_inputs(cuda_device, edge)
    before = fused_gram.launches[fused_gram.PREP_KERNEL]
    got = fused_gram.gram_prep(x, mean, rowmul, precision)
    torch.cuda.synchronize()
    assert fused_gram.launches[fused_gram.PREP_KERNEL] == before + 1
    want = fused_gram.gram_prep_reference(x, mean, rowmul, precision)
    assert got.shape == want.shape and got.dtype == want.dtype
    bits = torch.int32 if got.dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("precision", ["highest", "bfloat16", "bfloat16_3x"])
@pytest.mark.parametrize("rows,n", [(262_144, 256), (20_000, 300)])
def test_tall_whole_shard_launch_matches_plain_version(cuda_device, precision,
                                                       rows, n):
    """The sharded fits hand a rank's whole shard to the kernel in one
    launch: 262,144 rows (scratch depth 262,144, 32 folds of FOLD_ROWS), far
    past the 8,192-row buckets of the streamed fits, and 20,000 rows (a
    partial last fold, a ragged width), each with a masked tail."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(rows, n, generator=g, device=cuda_device) + 0.5
    mask = torch.ones(rows, device=cuda_device)
    mask[rows - 1000:] = 0.0
    mean = (x * mask[:, None]).sum(0) / (rows - 1000)
    rowmul = (mask / (rows - 1001) ** 0.5).contiguous()
    name = fused_gram.kernel_name(precision)
    before = fused_gram.launches[name]
    got = fused_centered_gram(x, mean, rowmul, precision)
    torch.cuda.synchronize()
    assert fused_gram.launches[name] == before + 1
    want = fused_centered_gram_reference(x, mean, rowmul, precision)
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err <= fused_gram.PLAIN_RTOL[name] * want.abs().max().item()
    assert torch.equal(got, got.T)


def _route_inputs(device, rows, n, view, seed):
    """x + 0.5 with a masked tail of 1e6 garbage (a tenth of the rows) and,
    with ``view``, as a row view of a parent 3 columns wider from column 1
    (an odd row stride, unaligned); its masked mean and rowmul."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(rows, n + 3 * view, generator=g, device=device) + 0.5
    if view:
        x = x[:, 1:n + 1]
    masked = rows // 10
    mask = torch.ones(rows, device=device)
    mask[rows - masked:] = 0.0
    x[rows - masked:] = 1e6
    valid = rows - masked
    mean = ((x * mask[:, None]).sum(0) / valid).contiguous()
    return x, mean, (mask / max(valid - 1, 1) ** 0.5).contiguous()


def _hold_route_to_one_run(device, rows, n, precision, view=False, seed=0):
    """The routed call against the private whole-depth 128-tile launch
    (``_one_run``): bit for bit, counted once under the plan's kernel, a
    repeat bit-equal, and within the plain version's bar. Returns the
    plan."""
    x, mean, rowmul = _route_inputs(device, rows, n, view, seed)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = fused_gram.gram_plan(rows, n, precision, sms)
    fused_gram.reset_launches()
    got = fused_centered_gram(x, mean, rowmul, precision)
    again = fused_centered_gram(x, mean, rowmul, precision)
    torch.cuda.synchronize()
    assert {k: v for k, v in fused_gram.launches.items() if v} == {
        plan.kernel: 2}
    one = fused_centered_gram(x, mean, rowmul, precision, _one_run=True)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), one.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = fused_centered_gram_reference(x, mean, rowmul, precision)
    err = (got - want).abs().max().item()
    assert err <= fused_gram.PLAIN_RTOL[plan.kernel] * want.abs().max().item()
    return plan


@pytest.mark.parametrize("precision", ["highest", "bfloat16", "bfloat16_3x"])
@pytest.mark.parametrize("rows,n", [(60_000, 784), (262_144, 256)])
def test_split_launch_is_bit_equal_to_one_run(cuda_device, precision, rows,
                                              n):
    """The rows split across blocks in whole folds, then the reduce launch:
    MNIST's shape (a ragged tile column and last fold) and a rank's whole
    shard at 256 wide, at every precision."""
    plan = _hold_route_to_one_run(cuda_device, rows, n, precision)
    assert plan.route == "split" and plan.runs > 1


@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("rows", [8192, 8193, 70_000])
@pytest.mark.parametrize("n", [1, 4, 28, 33, 64])
def test_narrow_launch_is_bit_equal_to_one_run(cuda_device, n, rows, view):
    """Highest at n ≤ 64 past one fold reads X once; one fold stays on the
    whole-depth launch."""
    plan = _hold_route_to_one_run(cuda_device, rows, n, "highest", view,
                                  seed=n)
    assert plan.route == ("tile128" if rows == 8192 else "narrow")


def test_fold_workspace_sizes_match_the_plan(cuda_device):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for rows, n, precision in [(2_097_152, 28, "highest"),
                               (60_000, 784, "highest"),
                               (60_000, 784, "bfloat16_3x"),
                               (65_536, 4096, "highest"),
                               (32_768, 256, "highest")]:
        plan = fused_gram.gram_plan(rows, n, precision, sms)
        assert fused_gram.fold_workspace_floats(n, plan) == plan.fold_floats


def test_highest_bar_rejects_tf32_and_the_bf16_split(cuda_device):
    """At the main-path bucket the full-f32 kernel is within its bar, and a
    TF32 product or the bf16 hi/lo split of the same inputs is not."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(8192, 4096, generator=g, device=cuda_device) + 0.5
    mean = x.mean(0)
    rowmul = torch.full((8192,), 8191 ** -0.5, device=cuda_device)
    want = fused_centered_gram_reference(x, mean, rowmul, "highest")
    scale = want.abs().max().item()
    bar = fused_gram.PLAIN_RTOL[fused_gram.kernel_name("highest")]

    def rel(got):
        return (got - want).abs().max().item() / scale

    assert rel(fused_centered_gram(x, mean, rowmul, "highest")) < bar
    assert rel(fused_centered_gram(x, mean, rowmul, "bfloat16_3x")) > bar
    xc = (x - mean) * rowmul[:, None]
    torch.backends.cuda.matmul.allow_tf32 = True  # restored by the fixture
    tf32 = xc.T @ xc
    assert rel(torch.triu(tf32) + torch.triu(tf32, 1).T) > bar


def test_kernel_takes_a_strided_row_view(cuda_device):
    """Any row stride, no copy: a column slice of a wider matrix."""
    wide = torch.randn(300, 200, device=cuda_device)
    x = wide[:, 10:150]
    mean = torch.zeros(140, device=cuda_device)
    rowmul = torch.ones(300, device=cuda_device)
    got = fused_centered_gram(x, mean, rowmul, "highest")
    want = fused_centered_gram_reference(x.contiguous(), mean, rowmul,
                                         "highest")
    bar = fused_gram.PLAIN_RTOL[fused_gram.kernel_name("highest")]
    assert (got - want).abs().max().item() <= bar * want.abs().max().item()


def test_kernel_wrapper_raises_on_card_input_it_does_not_take(cuda_device):
    before = sum(fused_gram.launches.values())
    x = torch.randn(16, 8, device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError):
        fused_centered_gram(x, torch.zeros(8, device=cuda_device),
                            torch.ones(16, device=cuda_device))
    with pytest.raises(ValueError):
        fused_centered_gram(x.float(), torch.zeros(8), torch.ones(16))
    assert sum(fused_gram.launches.values()) == before


@pytest.mark.parametrize("streamed", [False, True])
def test_float32_fit_on_card_goes_through_the_kernel(cuda_device, streamed):
    x = _decaying(3000, 40)
    fused_gram.reset_launches()
    est = PCA().setK(4).setDtype("float32").setBatchRows(1024)
    model = est.fit((lambda: iter([x])) if streamed else x)
    assert sum(fused_gram.launches.values()) == (3 if streamed else 1)
    ref = (PCA().setK(4).setUseXlaDot(False).setUseXlaSvd(False).fit(x))
    cos = np.abs(np.sum(model.pc * ref.pc, axis=0))
    assert cos.min() > 0.9999
    np.testing.assert_allclose(model.explained_variance,
                               ref.explained_variance, atol=1e-5)


def test_float64_fit_on_card_matches_host_fit(cuda_device):
    """float64 takes the plain path on the card: no kernel, oracle bar."""
    x = _decaying(500, 12)
    fused_gram.reset_launches()
    model = PCA().setK(5).setDtype("float64").fit(x)
    assert sum(fused_gram.launches.values()) == 0
    ref = PCA().setK(5).setUseXlaDot(False).setUseXlaSvd(False).fit(x)
    np.testing.assert_allclose(model.pc, ref.pc, atol=1e-5)
    np.testing.assert_allclose(model.explained_variance,
                               ref.explained_variance, atol=1e-5)
    out = np.asarray(model.transform(x).column("pca_features"))
    np.testing.assert_allclose(out, x @ model.pc, atol=1e-8)


# -- the serving path ---------------------------------------------------------

def _serving_model(d, k, seed=0, dtype="float32"):
    from spark_rapids_ml_tpu_torch import PCAModel

    rng = np.random.default_rng(seed)
    pc, _ = np.linalg.qr(rng.normal(size=(d, k)))
    return PCAModel.from_numpy(pc, np.full(k, 1.0 / k)).setDtype(dtype)


def _program_runs(device_type):
    from spark_rapids_ml_tpu_torch.obs.metrics import get_registry

    snap = get_registry().snapshot().get("sparkml_serve_program_runs_total")
    if snap is None:
        return 0.0
    return sum(s["value"] for s in snap["samples"]
               if s["labels"]["device"] == device_type)


def _run(program, x):
    return program.fetch(program.run(program.put(x)))


@pytest.mark.parametrize("precision", ["native", "bf16", "int8"])
@pytest.mark.parametrize("rows,d,k", [(8, 13, 3), (16, 300, 20),
                                      (1024, 4096, 256)])
def test_serving_program_on_card_matches_its_plain_version(
        cuda_device, precision, rows, d, k):
    """put / run / fetch on the card against the same program on the CPU:
    int8 bit for bit (int32 sums are exact), native and bf16 within their
    f32 summation-order bars."""
    model = _serving_model(d, k)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((rows, d)) * (1.0 + np.arange(d)) ** -0.5
         ).astype(np.float32)
    card = model.serving_transform_program(precision)
    plain = model.serving_transform_program(precision,
                                            device=torch.device("cpu"))
    assert card.device.type == "cuda" and plain.device.type == "cpu"
    before = _program_runs("cuda")
    got = _run(card, x)
    assert _program_runs("cuda") == before + 1
    want = _run(plain, x)
    assert got.shape == want.shape == (rows, k) and got.dtype == np.float64
    if precision == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        bar = 1e-6 if precision == "native" else 1e-5
        assert np.abs(got - want).max() <= bar * np.abs(want).max()


def test_programs_on_one_card_share_the_serving_streams(cuda_device):
    """Every serving program on a card runs on one (copy, compute) pair,
    and card work beside the batcher runs with that compute stream
    current: a rebuilt program meets no stream new to cuBLAS."""
    from spark_rapids_ml_tpu_torch.models._serving import (
        on_serving_thread,
        serving_streams,
    )

    copy, compute = serving_streams(cuda_device)
    assert serving_streams(cuda_device) == (copy, compute)
    assert copy != compute
    model = _serving_model(64, 8)
    x = np.random.default_rng(3).standard_normal((16, 64)).astype(np.float32)
    first = model.serving_transform_program("native")
    second = model.serving_transform_program("native")
    np.testing.assert_array_equal(first.fetch(first.run(first.put(x))),
                                  second.fetch(second.run(second.put(x))))
    assert serving_streams(cuda_device) == (copy, compute)
    assert on_serving_thread(cuda_device,
                             torch.cuda.current_stream) == compute


def test_bf16_program_returns_float32_on_card(cuda_device):
    model = _serving_model(64, 8)
    program = model.serving_transform_program("bf16")
    x = np.random.default_rng(2).standard_normal((32, 64)).astype(np.float32)
    out = program.run(program.put(x))
    assert out.is_cuda and out.dtype == torch.float32
    xb = torch.as_tensor(x).to(torch.bfloat16).float()
    cb = torch.as_tensor(model.pc).to(torch.bfloat16).float()
    ref = (xb.double() @ cb.double()).numpy()
    assert np.abs(out.cpu().numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_native_program_is_full_f32_under_the_tf32_setting(cuda_device):
    """With torch.set_float32_matmul_precision('high') a plain float32
    product misses the 1e-5 transform bar; the native program does not."""
    d, k = 4096, 256
    model = _serving_model(d, k)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((1024, d)) * (1.0 + np.arange(d)) ** -0.5
         ).astype(np.float32)
    ref = x.astype(np.float64) @ model.pc
    program = model.serving_transform_program("native")
    torch.set_float32_matmul_precision("high")
    try:
        assert torch.backends.cuda.matmul.allow_tf32
        got = _run(program, x)
        plain = (torch.as_tensor(x, device=cuda_device)
                 @ torch.as_tensor(model.pc, dtype=torch.float32,
                                   device=cuda_device)).double().cpu().numpy()
        transform = np.asarray(model.transform(x).column("pca_features"))
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-5 * scale
    assert np.abs(transform - ref).max() <= 1e-5 * scale
    assert np.abs(plain - ref).max() > 1e-5 * scale


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_staging_reuse_under_a_deep_pipeline(cuda_device, dtype):
    """Hundreds of ragged requests through pipeline depth 4, each request's
    rows encoding its own id; an identity projection returns them
    unchanged, so a staging slot overwritten before its copy ran shows as
    another request's rows."""
    import threading

    from spark_rapids_ml_tpu_torch import PCAModel
    from spark_rapids_ml_tpu_torch.serve import ModelRegistry, ServeEngine

    d = 16
    model = PCAModel.from_numpy(np.eye(d), np.full(d, 1.0 / d)).setDtype(
        dtype)
    registry = ModelRegistry()
    registry.register("id", model)
    engine = ServeEngine(registry, max_batch_rows=64, max_wait_ms=0.5,
                         pipeline_depth=4, max_queue_depth=1024)
    n_requests, n_threads = 480, 16
    sizes = np.random.default_rng(4).integers(1, 48, n_requests)
    wrong, failures = [], []

    def rows_of(i):
        # integers and small binary fractions: exact in float32
        return (i * 64.0 + np.arange(int(sizes[i]))[:, None]
                + np.arange(d)[None, :] / 32.0)

    def client(ids):
        try:
            for i in ids:
                want = rows_of(i)
                got = engine.predict("id", want, timeout=120)
                if not np.array_equal(got, want):
                    wrong.append(i)
        except Exception as exc:  # noqa: BLE001 - reported below
            failures.append(repr(exc))

    try:
        engine.warmup("id")
        batcher = engine._batchers[("id", 1)]
        assert batcher.async_spec is not None and batcher.async_spec.pinned
        threads = [threading.Thread(target=client,
                                    args=(range(t, n_requests, n_threads),))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        engine.shutdown()
    assert failures == [] and wrong == []


def test_fair_queue_preemption_under_a_deep_pipeline(cuda_device):
    """Two tenants' self-identifying requests through pipeline depth 4
    with a fair queue 8 deep and the shed controller pinned at level 2
    (interactive first, lower-ranked work evicted from a full queue).
    Every served output row is its own request's; every victim gets
    ``ShedLoad`` at once and no request waits past its timeout; no staged
    batch ever carried an evicted request."""
    import threading

    from spark_rapids_ml_tpu_torch import PCAModel
    from spark_rapids_ml_tpu_torch.serve import (
        ModelRegistry,
        QueueFull,
        ServeEngine,
        ShedController,
        ShedLoad,
    )

    d = 16
    model = PCAModel.from_numpy(np.eye(d), np.full(d, 1.0 / d)).setDtype(
        "float32")
    registry = ModelRegistry()
    registry.register("id", model)
    shed = ShedController(refresh_seconds=1e9, hold_seconds=1e9)
    shed.note_signals(burn=100.0, queue_wait_s=10.0, depth_frac=1.0)
    engine = ServeEngine(registry, max_batch_rows=64, max_wait_ms=0.5,
                         pipeline_depth=4, max_queue_depth=8,
                         fair_scheduling=True, shed=shed)
    n_requests, n_threads = 640, 32
    sizes = np.random.default_rng(5).integers(1, 48, n_requests)
    outcomes, wrong, failures = {}, [], []
    staged, victims = [], []

    def rows_of(i):
        return (i * 64.0 + np.arange(int(sizes[i]))[:, None]
                + np.arange(d)[None, :] / 32.0)

    def client(ids, priority):
        for i in ids:
            want = rows_of(i)
            t0 = time.monotonic()
            try:
                got = engine.predict("id", want, timeout=60,
                                     tenant=priority, priority=priority)
                outcomes[i] = "ok"
                if not np.array_equal(got, want):
                    wrong.append(i)
            except ShedLoad as exc:
                outcomes[i] = exc.reason
            except QueueFull:
                outcomes[i] = "rejected"
            except Exception as exc:  # noqa: BLE001 - reported below
                failures.append(repr(exc))
            if time.monotonic() - t0 > 60:
                failures.append(f"request {i} waited past its timeout")

    try:
        engine.warmup("id")
        batcher = engine._batchers[("id", 1)]
        assert batcher.async_spec is not None
        stage_dispatch, shed_preempted = (batcher._stage_dispatch,
                                          batcher._shed_preempted)

        def spy_stage(entry, *args):
            staged.append(list(entry.batch))
            return stage_dispatch(entry, *args)

        def spy_shed(victim):
            victims.append(victim)
            shed_preempted(victim)
            assert victim.error is not None  # the latch failed at once

        batcher._stage_dispatch, batcher._shed_preempted = (spy_stage,
                                                            spy_shed)
        threads = [threading.Thread(
            target=client,
            args=(range(t, n_requests, n_threads),
                  "interactive" if t % 4 == 0 else "batch"))
            for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        engine.shutdown()
    assert failures == [] and wrong == []
    assert len(outcomes) == n_requests
    assert victims, "no preemption happened"
    assert sum(v == "preempted" for v in outcomes.values()) == len(victims)
    assert all(isinstance(v.error, ShedLoad) for v in victims)
    assert all(v.priority == "batch" for v in victims)
    evicted = {id(v) for v in victims}
    assert not any(id(r) in evicted for batch in staged for r in batch)


def test_parked_model_frees_its_device_bytes_and_gets_them_back(
        cuda_device):
    """Tiering on the card: parking a 4096 x 256 model (float64 weights,
    8 MiB) lowers ``memory_allocated`` by at least its accounted weights,
    and its first hit stages them again, with the same answer, and adds
    nothing else (within 4 MiB): the rebuilt program meets the cuBLAS
    workspaces of the serving stream pair it shares."""
    import gc

    from spark_rapids_ml_tpu_torch import PCAModel
    from spark_rapids_ml_tpu_torch.obs import accounting
    from spark_rapids_ml_tpu_torch.serve import (
        ModelRegistry,
        ServeEngine,
        TieringController,
    )

    def settled():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(0)

    rng = np.random.default_rng(0)
    basis = np.linalg.qr(rng.normal(size=(4096, 256)))[0]
    model = PCAModel.from_numpy(basis, np.linspace(1.0, 0.01, 256))
    accounting.reset_ledger()
    registry = ModelRegistry()
    registry.register("gpu_tier", model.setDtype("float64"))
    engine = ServeEngine(registry, max_batch_rows=64, max_wait_ms=1.0)
    ctl = TieringController(engine, hbm_budget_bytes=1, clock=lambda: 0.0)
    engine.attach_tiering(ctl)
    weight = 4096 * 256 * 8
    try:
        x = rng.normal(size=(8, 4096)).astype(np.float32)
        engine.warmup("gpu_tier")
        ref = engine.predict("gpu_tier", x)
        ledger = accounting.get_ledger()
        assert ledger.memory_bytes("gpu_tier") == {"gpu_tier": weight}
        before = settled()
        assert [a["model"] for a in ctl.evaluate_once()] == ["gpu_tier"]
        parked = settled()
        assert before - parked >= weight
        assert ledger.memory_bytes("gpu_tier") == {}
        np.testing.assert_array_equal(engine.predict("gpu_tier", x), ref)
        assert abs(settled() - parked - weight) <= 4 << 20
        assert ledger.memory_bytes("gpu_tier") == {"gpu_tier": weight}
    finally:
        engine.shutdown()
        accounting.reset_ledger()


def test_device_memory_stats_track_a_known_allocation(cuda_device):
    """The allocator's counters under PJRT's keys follow a 256 MiB block
    exactly, in use and at the peak, and the limit is the card's memory."""
    from spark_rapids_ml_tpu_torch.obs.memory import device_memory_stats

    torch.cuda.synchronize(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    before = device_memory_stats(cuda_device)
    n = 256 << 20
    block = torch.empty(n, dtype=torch.uint8, device=cuda_device)
    held = device_memory_stats(cuda_device)
    assert held["bytes_in_use"] - before["bytes_in_use"] == n
    assert held["bytes_in_use"] == torch.cuda.memory_allocated(cuda_device)
    assert held["peak_bytes_in_use"] == held["bytes_in_use"]
    assert held["bytes_limit"] == torch.cuda.get_device_properties(
        cuda_device).total_memory
    del block
    freed = device_memory_stats(cuda_device)
    assert freed["bytes_in_use"] == before["bytes_in_use"]
    assert freed["peak_bytes_in_use"] == held["peak_bytes_in_use"]


def test_a_device_monitor_sample_makes_no_sync(cuda_device, monkeypatch):
    """One sweep of the monitor beside live work: no synchronising call
    (sync debug mode ``error`` raises on one) and no driver query of free
    memory."""
    from spark_rapids_ml_tpu_torch.obs.devmon import DeviceMonitor

    def forbidden(*_args, **_kwargs):
        raise AssertionError("a sample asked the driver for free memory")

    monitor = DeviceMonitor()
    assert monitor.default_device_label() == "cuda:0"
    x = torch.randn(4096, 4096, device=cuda_device)
    monkeypatch.setattr(torch.cuda, "mem_get_info", forbidden)
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = x @ x  # in flight while the sample reads the counters
        out = monitor.sample()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(cuda_device)
    assert [e["device"] for e in out] == [
        f"cuda:{i}" for i in range(torch.cuda.device_count())]
    assert {e["source"] for e in out} == {"cuda"}
    assert out[0]["bytes_in_use"] == torch.cuda.memory_allocated(0)
    assert 0.0 < monitor.memory_pressure("cuda:0") < 1.0
    del x, y


@pytest.fixture
def capture_dir(cuda_device, tmp_path, monkeypatch):
    """Profile captures under ``tmp_path``, the profiler warmed up: the
    first ``start()`` in a process takes seconds on a card, so
    one capture is started, waited for and stopped first. Drained
    after."""
    from spark_rapids_ml_tpu_torch.obs import profiler

    monkeypatch.setenv(profiler.PROFILE_DIR_ENV, str(tmp_path))
    profiler.wait(60.0)
    profiler.start_capture(60.0, label="warmup")
    assert _started(profiler)
    profiler.stop_capture()
    assert profiler.wait(60.0)["torch_outcome"] == "ok"
    yield profiler
    profiler.stop_capture()
    profiler.wait(60.0)


def _started(profiler, timeout=120.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        active = profiler.capture_active()
        if active is None or active["torch_trace"]:
            return active is not None
        time.sleep(0.005)
    return False


def _torch_trace(profiler, result):
    import json

    with open(profiler.torch_trace_path(result["path"], result["id"])) as f:
        return json.load(f)["traceEvents"]


def test_capture_holds_a_prior_threads_gemm_and_its_cpu_op(capture_dir):
    """A capture around a 4096 × 4096 f32 ``torch.mm`` on a worker thread
    that existed before it: the trace holds the GEMM's ``kernel`` event
    and that thread's CPU ``aten::mm`` (``profile_all_threads``)."""
    import threading

    profiler = capture_dir
    go, done = threading.Event(), threading.Event()
    x = torch.randn(4096, 4096, device="cuda")

    def worker():
        assert go.wait(120.0)
        torch.mm(x, x)
        torch.cuda.synchronize()
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    try:
        profiler.start_capture(1.0, label="gpu_mm")
        assert _started(profiler)
        go.set()
        assert done.wait(120.0)
    finally:
        go.set()
        t.join(120.0)
    result = profiler.wait(60.0)  # the 1 s window ends by itself
    assert result["id"].startswith("gpu_mm_")
    assert result["torch_outcome"] == "ok" and result["torch_trace"]
    events = _torch_trace(profiler, result)
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "gemm" in e["name"].lower()]
    assert kernels, sorted({e["name"][:50] for e in events
                            if e.get("cat") == "kernel"})
    assert any(e.get("name", "").startswith("aten::mm")
               and e.get("tid") == t.native_id for e in events)


def test_cuda_capture_is_never_ok_without_a_device_event(capture_dir,
                                                          monkeypatch):
    """With [CPU, CUDA] activities, ``ok`` comes only with a device event
    in the trace: the profiler's own probe gives an idle window one, and
    without the probe an idle window is ``torch_unavailable``."""
    profiler = capture_dir

    def idle_capture(label):
        # a process's first start() takes seconds: stop once it runs
        profiler.start_capture(60.0, label=label)
        assert _started(profiler)
        profiler.stop_capture()
        return profiler.wait(120.0)

    result = idle_capture("idle_probe")
    assert result["torch_outcome"] == "ok"
    assert any(e.get("cat") in profiler.DEVICE_CATEGORIES
               for e in _torch_trace(profiler, result))
    monkeypatch.setattr(profiler, "_probe_device", lambda: None)
    result = idle_capture("idle_no_probe")
    path = profiler.torch_trace_path(result["path"], result["id"])
    events = _torch_trace(profiler, result) if os.path.exists(path) else []
    seen = any(e.get("cat") in profiler.DEVICE_CATEGORIES for e in events)
    assert result["torch_outcome"] == ("ok" if seen else "torch_unavailable")
    assert result["torch_outcome"] != "ok" or seen


# -- the auto-incident engine on the card ---------------------------------------


def test_latency_incident_on_the_card_opens_one_and_resolves(capture_dir,
                                                             tmp_path,
                                                             monkeypatch):
    """A served model on the card, the incident engine on the sampler,
    swept on an injected clock: a latency fault sized off the store's own
    baseline p99 opens exactly one ``serve_p99_spike`` incident two sweeps
    later; its guarded capture, with requests served under it, holds the
    card's GEMM kernels; and the incident resolves once the fault clears.
    The drill's registry is its own: the bundle starts from the registry's
    slowest exemplars."""
    import http.client
    import json

    from spark_rapids_ml_tpu_torch.obs import (
        accounting,
        devmon,
        flight,
        incidents,
        metrics,
        tsdb,
    )
    from spark_rapids_ml_tpu_torch.serve import (
        ModelRegistry,
        ServeEngine,
        fault_plane,
        reset_fault_plane,
        start_serve_server,
        wire,
    )

    profiler = capture_dir
    monkeypatch.setenv(flight.DUMP_DIR_ENV, str(tmp_path / "dumps"))
    monkeypatch.setenv(incidents.CAPTURE_ENV, "60")
    monkeypatch.delenv(incidents.ENABLED_ENV, raising=False)
    monkeypatch.setattr(metrics, "_default_registry",
                        metrics.MetricsRegistry())

    def fresh():
        tsdb.reset_tsdb()
        devmon.reset_device_monitor()
        reset_fault_plane()
        accounting.reset_ledger()
        incidents.reset_incident_engine()

    fresh()
    model = _serving_model(512, 32)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 512)).astype(np.float32)
    ref = x.astype(np.float64) @ model.pc
    registry = ModelRegistry()
    registry.register("gpu_inc", model)
    engine = ServeEngine(registry, max_batch_rows=64, max_wait_ms=1.0)
    engine.warmup("gpu_inc")
    server = start_serve_server(engine, port=0)
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                      timeout=120)

    def predict():
        conn.request("POST", "/predict", body=wire.encode_request(
            "gpu_inc", x), headers={"Content-Type": wire.BINARY_CONTENT_TYPE})
        resp = conn.getresponse()
        out = wire.decode_response(resp.read())
        assert resp.status == 200
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()

    try:
        sampler = tsdb.get_sampler()
        sampler.stop()
        engine_ = incidents.get_incident_engine()
        store = tsdb.get_tsdb()
        t_base = time.time() - 120.0
        for s in range(20):
            predict()
            predict()
            sampler.sample_once(now=t_base + s)
        (p99,) = store.range_query(
            "sparkml_serve_request_latency_seconds",
            {"model": "gpu_inc", "quantile": "0.99"}, 60.0, now=t_base + 19)
        delay = max(3.0 * p99["points"][-1][1], 0.15)
        fault_plane().inject("gpu_inc", "latency", count=None, seconds=delay)
        for _ in range(4):
            predict()
        sampler.sample_once(now=t_base + 21)
        assert engine_.snapshot()["open"] == []
        sampler.sample_once(now=t_base + 22)
        (incident,) = engine_.snapshot()["open"]
        assert incident["detector"] == "serve_p99_spike"
        assert incident["labels"]["model"] == "gpu_inc"
        started = incident["evidence"]["profile"]["started"]
        assert _started(profiler)
        predict()
        predict()
        profiler.stop_capture()
        result = profiler.wait(60.0)
        assert result["id"] == started["id"]
        assert result["torch_outcome"] == "ok"
        events = _torch_trace(profiler, result)
        gemms = [e for e in events if e.get("cat") == "kernel"
                 and "gemm" in e["name"].lower()]
        assert len(gemms) >= 2, sorted({e["name"][:50] for e in events
                                        if e.get("cat") == "kernel"})
        fault_plane().clear()
        for s in range(70):
            sampler.sample_once(now=t_base + 23 + s)
        snap = engine_.snapshot()
        assert snap["open"] == [] and snap["resolved_total"] == 1
        assert snap["opened_total"] == 1
        bundle = incident["evidence"]["dir"]
        with open(os.path.join(bundle, "incident.json")) as f:
            assert json.load(f)["state"] == "resolved"
    finally:
        conn.close()
        fault_plane().clear()
        server.shutdown()
        server.server_close()
        engine.shutdown()
        flight.unregister_dump_section("metrics_history")
        fresh()


# -- fit and transform reports on the card ------------------------------------


def test_health_probe_and_watermark_on_the_card(cuda_device):
    from spark_rapids_ml_tpu_torch.obs import memory
    from spark_rapids_ml_tpu_torch.utils import health

    verdict = health.check_devices()
    assert verdict.healthy, verdict.error
    assert verdict.platform == "cuda"
    assert verdict.device_count == torch.cuda.device_count()
    assert verdict.devices == [f"cuda:{i}"
                               for i in range(torch.cuda.device_count())]
    block = torch.empty(64 << 20, dtype=torch.uint8, device=cuda_device)
    wm = memory.memory_watermarks()
    assert wm["source"] == "cuda"
    assert wm["per_device"][0]["device"] == "cuda:0"
    assert wm["peak_bytes"] >= torch.cuda.memory_allocated(0) >= block.numel()
    assert wm["per_device"][0]["bytes_limit"] == \
        torch.cuda.get_device_properties(0).total_memory
    del block


def test_fit_and_transform_reports_on_the_card(cuda_device):
    x = _decaying(4096, 256).astype(np.float32)
    model = PCA().setK(16).fit(x)
    rep = model.fit_report_
    assert rep.device_platform == "cuda" and rep.healthy is True
    assert rep.device_count == torch.cuda.device_count()
    assert rep.memory["source"] == "cuda"
    assert rep.peak_device_bytes >= x.nbytes
    assert set(rep.phases) == set(model.fit_timings_) | {"total"}
    model.transform(x[:1024])
    t = model.transform_report_
    assert set(t.phases) == {"device_put", "compute", "host_sync", "total"}
    assert t.rows == 1024 and t.numerics["checked_rows"] == 1024
    assert t.numerics["nan_rows"] == t.numerics["inf_rows"] == 0


def test_fit_watchdog_on_the_card(cuda_device):
    """The watchdog's own devices and canary on the card: healthy, the
    card's name and count, a real canary time; a ``cpu`` expectation is
    a platform mismatch."""
    from spark_rapids_ml_tpu_torch.obs import fitmon

    verdict = fitmon.BackendWatchdog(expected_platform=None).check()
    assert verdict["ok"] is True and verdict["reason"] is None
    assert verdict["platform"] == "cuda"
    assert verdict["device_kind"] == torch.cuda.get_device_name(0)
    assert verdict["device_count"] == torch.cuda.device_count()
    assert verdict["canary"] == "ok" and verdict["canary_seconds"] > 0
    mismatch = fitmon.BackendWatchdog(expected_platform="cpu").check()
    assert mismatch["ok"] is False
    assert mismatch["reason"] == "platform_mismatch"


def test_the_cards_peaks(cuda_device, monkeypatch):
    """The peak table keyed by the card's name: the H100's published 700 W
    figures, and absent (never guessed) for a card the table lacks."""
    from spark_rapids_ml_tpu_torch.obs import fitmon, xprof
    from spark_rapids_ml_tpu_torch.utils import platform

    for name in ("SPARK_RAPIDS_ML_TORCH_FITMON_PEAK_FLOPS",
                 "SPARK_RAPIDS_ML_TORCH_FITMON_PEAK_BW"):
        monkeypatch.delenv(name, raising=False)
    kind = torch.cuda.get_device_name(0)
    assert platform.device_kind() == kind
    want = (platform.PEAK_FLOPS_BF16.get(kind),
            platform.PEAK_HBM_BYTES_PER_SECOND.get(kind))
    assert fitmon.device_peaks() == want
    assert xprof.peak_flops_per_second() == want[0]
    if kind == "NVIDIA H100 80GB HBM3":
        assert want == (989e12, 3.35e12)


def test_the_flops_of_a_cuda_gram(cuda_device, monkeypatch):
    """A Gram on the card through ``centered_gram`` inside a monitored
    step: one kernel launch, the step's FLOPs the Gram formula, a device
    time that covers the kernel (the step syncs), and an MFU against the
    card's peak in (0, 1]."""
    from spark_rapids_ml_tpu_torch.obs import fitmon
    from spark_rapids_ml_tpu_torch.ops.covariance import centered_gram

    monkeypatch.setattr(fitmon, "_monitor", fitmon.FitMonitor(enabled=True))
    rows, n = 8192, 1024
    x = torch.randn(rows, n, device=cuda_device)
    name = fused_gram.kernel_name(None)
    before = fused_gram.launches[name]
    with fitmon.fit_run("gram_probe") as run:
        with run.step("gram", rows=rows):
            g = centered_gram(x)
    assert fused_gram.launches[name] == before + 1
    assert g.shape == (n, n)
    (step,) = run.steps
    assert step["flops"] == rows * n * (n + 1)
    assert step["bytes_accessed"] == rows * n * 4 + n * n * 4
    assert step["device_seconds"] > 0
    peak, _ = fitmon.device_peaks()
    if peak:
        assert step["mfu"] == pytest.approx(
            step["flops"] / step["device_seconds"] / peak, rel=1e-12)
        assert 0 < step["mfu"] <= 1


# -- RowMatrix, TruncatedSVD and LinearRegression: the kernel's new routes -----

# route → (rows, n, x's shift, the row multiplier, precision)
SLICE_14_ROUTES = {
    # TruncatedSVD's uncentred XᵀX: no mean, unit rows, data off zero
    "uncentred": (2000, 300, 1.0, "ones", "bfloat16_3x"),
    # LinearRegression's XᵀWX: √weight rows, full f32
    "root_weights": (3000, 257, 0.0, "root_weights", "highest"),
    # the streamed Z = [X | y] at the north-star width: n + 1 = 4097, one
    # tile column past 4096, with a masked tail bucket
    "ragged_4097": (1000, 4097, 0.0, "masked_tail", "bfloat16_3x"),
}


@pytest.mark.parametrize("route", list(SLICE_14_ROUTES))
def test_slice_14_routes_match_plain_version(cuda_device, route):
    rows, n, shift, rowmul_kind, precision = SLICE_14_ROUTES[route]
    g = torch.Generator(device=cuda_device).manual_seed(14)
    x = torch.randn(rows, n, generator=g, device=cuda_device) + shift
    mean = torch.zeros(n, device=cuda_device)
    rowmul = torch.ones(rows, device=cuda_device)
    if rowmul_kind == "root_weights":
        rowmul = torch.sqrt(0.5 + 1.5 * torch.rand(
            rows, generator=g, device=cuda_device))
    elif rowmul_kind == "masked_tail":
        rowmul[rows - 300:] = 0.0
    name = fused_gram.kernel_name(precision)
    before = fused_gram.launches[name]
    got = fused_centered_gram(x, mean, rowmul, precision)
    torch.cuda.synchronize()
    assert fused_gram.launches[name] == before + 1
    want = fused_centered_gram_reference(x, mean, rowmul, precision)
    err = (got - want).abs().max().item()
    assert err <= fused_gram.PLAIN_RTOL[name] * want.abs().max().item()
    assert torch.equal(got, got.T)


def test_slice_14_entry_points_launch_the_kernel(cuda_device):
    """RowMatrix once per partition, TruncatedSVD once, LinearRegression's
    one-shot fit once at highest and its streamed fit once per bucket; each
    within its float32 bar of the float64 host computation."""
    from spark_rapids_ml_tpu_torch import (
        LinearRegression,
        RowMatrix,
        TruncatedSVD,
    )

    default = fused_gram.kernel_name(None)
    highest = fused_gram.kernel_name("highest")
    x = _decaying(4000, 64, loc=0.0).astype(np.float32)

    fused_gram.reset_launches()
    cov = RowMatrix(x, num_partitions=4).compute_covariance()
    assert fused_gram.launches[default] == 4
    ref = RowMatrix(x, use_xla_dot=False).compute_covariance()
    assert np.abs(cov - ref).max() <= 1e-5 * np.abs(ref).max()

    fused_gram.reset_launches()
    svd = TruncatedSVD().setK(4).fit(x + 1.0)
    assert fused_gram.launches[default] == 1
    host = TruncatedSVD().setK(4).setUseXlaDot(False).setUseXlaSvd(False) \
        .fit(x + 1.0)
    # a float32 solve errs by ~eps·λ₁ on every eigenvalue, so σᵢ by about
    # eps·(σ₁/σᵢ)² relative: the mean shift makes σ₁/σ₄ ≈ 11
    bar = 16 * np.finfo(np.float32).eps * (host.singular_values[0]
                                           / host.singular_values) ** 2
    assert (np.abs(svd.singular_values - host.singular_values)
            <= bar * host.singular_values).all()

    # a Gaussian design (XᵀX/n of condition ≈ 1.7): the decaying rows above
    # have condition ~3e9, where float32 normal equations hold no digit
    rng = np.random.default_rng(14)
    x = rng.normal(size=(4000, 64)).astype(np.float32)
    y = x @ rng.normal(size=64) + 3.0 + 0.1 * rng.normal(size=4000)
    fused_gram.reset_launches()
    one_shot = LinearRegression().fit(x, labels=y)
    assert fused_gram.launches[highest] == 1
    fused_gram.reset_launches()
    streamed = LinearRegression().fit(
        lambda: ((x[i:i + 1000], y[i:i + 1000]) for i in range(0, 4000, 1000)))
    assert fused_gram.launches[default] == 1   # one bucket of auto rows
    host = LinearRegression().setUseXlaDot(False).fit(x, labels=y)
    for model in (one_shot, streamed):
        np.testing.assert_allclose(model.coefficients, host.coefficients,
                                   atol=1e-4 * np.abs(host.coefficients).max())


# -- KMeans, StandardScaler and the fused pipeline -------------------------------

def _blobs(rows, n, k, seed=15, spread=20.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, n)) * spread
    truth = rng.integers(0, k, rows)
    return centers[truth] + rng.normal(size=(rows, n)), centers, truth


def _one_to_one(labels, truth):
    """Whether ``labels`` equal ``truth`` under one permutation."""
    pairs = set(zip(truth.tolist(), labels.tolist()))
    return (len(pairs) == len(set(truth.tolist()))
            == len({b for _, b in pairs}))


def test_kmeans_fit_and_transform_on_the_card(cuda_device):
    """One-shot, weighted and streamed fits on the card recover the blobs;
    the device Lloyd from the fit's own initial centres equals the float64
    Lloyd on the card within 1e-5, and the cost the host cost within 1e-5,
    under the TF32 setting."""
    from spark_rapids_ml_tpu_torch import KMeans
    from spark_rapids_ml_tpu_torch.ops import kmeans_kernel as kk

    x, _, truth = _blobs(20_000, 32, 8)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        model = KMeans().setK(8).setSeed(1).fit(x)
        labels = np.asarray(model.transform(x).column("prediction"))
        assert _one_to_one(labels, truth)
        assert model.training_cost_ == pytest.approx(model.compute_cost(x),
                                                     rel=1e-5)
        x_dev = torch.as_tensor(x, dtype=torch.float32, device=cuda_device)
        init = kk.kmeans_plus_plus_init(x_dev, 8, 1)
        f64 = kk.kmeans_fit_kernel(x_dev.double(), init.double())
        np.testing.assert_allclose(model.cluster_centers,
                                   f64.centers.cpu().numpy(), rtol=0,
                                   atol=1e-5 * np.abs(model.cluster_centers)
                                   .max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    w = np.random.default_rng(2).uniform(0.5, 2.0, len(x))
    weighted = KMeans().setK(8).setSeed(1).setWeightCol("w").fit(
        VectorFrame({"features": x, "w": list(w)}))
    assert _one_to_one(np.asarray(weighted.transform(x).column("prediction")),
                       truth)
    streamed = KMeans().setK(8).setSeed(1).fit(
        lambda: (x[i:i + 3000] for i in range(0, len(x), 3000)))
    assert _one_to_one(np.asarray(streamed.transform(x).column("prediction")),
                       truth)


@pytest.mark.parametrize("precision", ["native", "bf16", "int8"])
@pytest.mark.parametrize("rows", [1, 16, 17, 300])
def test_kmeans_serving_precisions_on_the_card(cuda_device, precision, rows):
    """Each ladder's program on the card against its CPU twin: the same
    labels on blobs (int8 pads the batch to 32 rows and k = 5 to 8
    columns)."""
    from spark_rapids_ml_tpu_torch import KMeansModel

    x, centers, truth = _blobs(rows, 24, 5)
    model = KMeansModel(cluster_centers=centers)
    prog = model.serving_transform_program(precision)
    assert prog.device.type == "cuda"
    got = prog.fetch(prog.run(prog.put(x)))
    os.environ["SPARK_RAPIDS_ML_TORCH_PLATFORM"] = "cpu"
    try:
        twin = model.serving_transform_program(precision)
        want = twin.fetch(twin.run(twin.put(x)))
    finally:
        del os.environ["SPARK_RAPIDS_ML_TORCH_PLATFORM"]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert _one_to_one(got, truth)


def test_scaler_device_fit_on_the_card(cuda_device):
    from spark_rapids_ml_tpu_torch import StandardScaler

    rng = np.random.default_rng(3)
    x = rng.normal(size=(50_000, 64)) * np.linspace(0.1, 10, 64) + 1e3
    x[:, 7] = 5.0
    model = StandardScaler().setWithMean(True).fit(x)
    x32 = x.astype(np.float32).astype(np.float64)
    np.testing.assert_allclose(model.mean, x32.mean(axis=0), rtol=1e-6)
    np.testing.assert_allclose(model.std, x32.std(axis=0, ddof=1),
                               rtol=1e-4, atol=1e-6)
    assert model.std[7] == 0.0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fused_pipeline_bit_equal_staged_on_the_card(cuda_device, dtype):
    """StandardScaler → PCA → KMeans at 256 features: the fused program
    (one put, one run, one fetch) equals ``run_staged_pipeline`` bit for
    bit over ragged batch sizes, with one device→host copy per batch; the
    PCA fit inside the pipeline launches the Gram kernel once (float32)."""
    from spark_rapids_ml_tpu_torch import (
        KMeans,
        PCA,
        Pipeline,
        StandardScaler,
    )
    from spark_rapids_ml_tpu_torch.models._serving import run_staged_pipeline

    rng = np.random.default_rng(4)
    x = rng.normal(size=(8192, 256)) * np.linspace(0.5, 2.0, 256) + 1.0
    fused_gram.reset_launches()
    model = Pipeline([
        StandardScaler().setWithMean(True).setOutputCol("s").setDtype(dtype),
        PCA().setK(32).setInputCol("s").setOutputCol("r").setDtype(dtype),
        KMeans().setK(16).setInputCol("r").setDtype(dtype),
    ]).fit(x)
    assert sum(fused_gram.launches.values()) == (dtype == "float32")
    prog = model.serving_transform_program()
    assert prog.device.type == "cuda"
    for n in (1, 3, 17, 64, 100, 1024):
        batch = x[:n]
        fused = prog.fetch(prog.run(prog.put(batch)))
        assert np.array_equal(fused, run_staged_pipeline(model, batch)), n
    frame = np.asarray(model.transform(x[:1024]).column("prediction"))
    fused = prog.fetch(prog.run(prog.put(x[:1024])))
    assert np.mean(fused != frame) <= (1e-3 if dtype == "float32" else 0.0)


# -- slice 16: LogisticRegression ---------------------------------------------

def _logistic(rows, n, seed=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, n)).astype(np.float32)
    w = rng.normal(size=n) * (2.0 / np.sqrt(n))
    y = (rng.random(rows) < 1.0 / (1.0 + np.exp(-(x @ w + 0.5)))).astype(
        np.float32)
    return x, y


def test_logreg_newton_hessian_is_the_kernel_on_the_card(cuda_device):
    """One highest launch per Newton iteration, each Hessian within the
    kernel's bar of its plain version on the same √s rows, and the fit
    within 1e-4 of the float64 Newton on the card."""
    from spark_rapids_ml_tpu_torch.ops import logreg_kernel as lk

    x, y = _logistic(20_000, 256)
    xd = torch.as_tensor(x, device=cuda_device)
    yd = torch.as_tensor(y, device=cuda_device)
    highest = fused_gram.kernel_name("highest")
    fused_gram.reset_launches()
    result = lk.logreg_fit_kernel(xd, yd, reg_param=0.01, max_iter=8,
                                  tol=0.0)
    torch.cuda.synchronize()
    assert int(result.n_iter) == 8
    assert {k: v for k, v in fused_gram.launches.items() if v} == {
        highest: 8}
    w = torch.cat([result.coefficients, result.intercept.reshape(1)])
    p = torch.sigmoid(xd @ w[:-1] + w[-1])
    root = torch.sqrt(p * (1 - p))
    zeros = torch.zeros(256, device=cuda_device)
    got = fused_centered_gram(xd, zeros, root, "highest")
    want = fused_centered_gram_reference(xd, zeros, root, "highest")
    err = (got - want).abs().max().item()
    assert err <= fused_gram.PLAIN_RTOL[highest] * want.abs().max().item()
    ref = lk.logreg_fit_kernel(xd.double(), yd.double(), reg_param=0.01,
                               max_iter=8, tol=0.0)
    w64 = torch.cat([ref.coefficients, ref.intercept.reshape(1)])
    assert (torch.linalg.norm(w.double() - w64)
            / torch.linalg.norm(w64)).item() <= 1e-4


def test_logreg_multinomial_blocks_on_the_card(cuda_device):
    """K(K+1)/2 launches per statistics pass; every diagonal block is
    positive semidefinite, every off-diagonal block negative semidefinite,
    h_raw exactly symmetric, and the whole within 1e-5 of the float64
    blocks."""
    from spark_rapids_ml_tpu_torch.ops import logreg_kernel as lk

    k, n = 4, 128
    x, _ = _logistic(8192, n)
    rng = np.random.default_rng(17)
    y_oh = np.eye(k, dtype=np.float32)[rng.integers(0, k, 8192)]
    wb = rng.normal(size=(k, n + 1)).astype(np.float32) * 0.05
    xd = torch.as_tensor(x, device=cuda_device)
    args = (torch.as_tensor(y_oh, device=cuda_device),
            torch.ones(8192, device=cuda_device))
    fused_gram.reset_launches()
    gxa, h_raw, cnt = lk.multinomial_raw_stats(
        torch.as_tensor(wb, device=cuda_device), xd, *args)
    torch.cuda.synchronize()
    assert fused_gram.launches[fused_gram.kernel_name("highest")] == \
        k * (k + 1) // 2
    assert torch.equal(h_raw, h_raw.T)
    dim = n + 1
    for a in range(k):
        for b in range(k):
            blk = h_raw[a * dim:(a + 1) * dim, b * dim:(b + 1) * dim]
            ev = torch.linalg.eigvalsh(blk.double())
            scale = ev.abs().max().item()
            if a == b:
                assert ev.min().item() >= -1e-5 * scale
            else:
                assert ev.max().item() <= 1e-5 * scale
    _, h64, _ = lk.multinomial_raw_stats(
        torch.as_tensor(wb, device=cuda_device).double(), xd.double(),
        *(t.double() for t in args))
    assert ((h_raw.double() - h64).abs().max()
            / h64.abs().max()).item() <= 1e-5


def test_logreg_serving_program_on_the_card(cuda_device):
    """The device-resident program (native) equals its CPU twin within one
    float32 ulp of σ and the float64 host σ(Xw + b) within 1e-5; the int8
    body (``torch._int_mm``, rows padded to 32 and the coefficients to 8
    columns) on CUDA equals its CPU twin bit for bit; bf16 within 0.02."""
    from spark_rapids_ml_tpu_torch import LogisticRegressionModel

    rng = np.random.default_rng(18)
    coef = rng.normal(size=64) * 0.2
    model = LogisticRegressionModel(coefficients=coef, intercept=0.3)
    for rows in (1, 16, 17, 300):
        x = rng.normal(size=(rows, 64))
        host = 1.0 / (1.0 + np.exp(-(x.astype(np.float32).astype(np.float64)
                                     @ coef + 0.3)))
        for precision in ("native", "bf16", "int8"):
            prog = model.serving_transform_program(precision)
            assert prog.device.type == "cuda"
            got = prog.fetch(prog.run(prog.put(x)))
            os.environ["SPARK_RAPIDS_ML_TORCH_PLATFORM"] = "cpu"
            try:
                twin = model.serving_transform_program(precision)
                want = twin.fetch(twin.run(twin.put(x)))
            finally:
                del os.environ["SPARK_RAPIDS_ML_TORCH_PLATFORM"]
            assert got.dtype == np.float64 and got.shape == (rows,)
            if precision == "int8":
                np.testing.assert_array_equal(got, want)
            elif precision == "native":
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=np.finfo(np.float32).eps)
                assert np.max(np.abs(got - host) / host) <= 1e-5
            else:
                assert np.max(np.abs(got - host)) <= 0.02


def test_classifier_chain_bit_equal_staged_on_the_card(cuda_device):
    """StandardScaler → PCA → LogisticRegression at 256 features: the fit
    launches one bfloat16_3x Gram (PCA) and one highest Gram per Newton
    iteration; the fused program equals ``run_staged_pipeline`` bit for
    bit over ragged batch sizes and the frame loop within 1e-5."""
    from spark_rapids_ml_tpu_torch import (
        LogisticRegression,
        PCA,
        Pipeline,
        StandardScaler,
    )
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
    from spark_rapids_ml_tpu_torch.models._serving import run_staged_pipeline

    rng = np.random.default_rng(19)
    x = rng.normal(size=(8192, 256)) * np.linspace(0.5, 2.0, 256) + 1.0
    xs = (x - x.mean(0)) / x.std(0, ddof=1)
    y = (rng.random(8192) < 1 / (1 + np.exp(-(xs[:, :8].sum(1))))).astype(
        float)
    fused_gram.reset_launches()
    model = Pipeline([
        StandardScaler().setWithMean(True).setOutputCol("s"),
        PCA().setK(32).setInputCol("s").setOutputCol("r"),
        LogisticRegression().setInputCol("r").setMaxIter(10),
    ]).fit(VectorFrame({"features": x, "label": list(y)}))
    n_iter = model.stages[2].n_iter_
    assert {k: v for k, v in fused_gram.launches.items() if v} == {
        fused_gram.kernel_name(None): 1,
        fused_gram.kernel_name("highest"): n_iter}
    prog = model.serving_transform_program()
    assert prog.device.type == "cuda"
    for n in (1, 3, 17, 64, 100, 1024):
        fused = prog.fetch(prog.run(prog.put(x[:n])))
        assert np.array_equal(fused, run_staged_pipeline(model, x[:n])), n
    frame = np.asarray(model.transform(x[:1024]).column("probability"))
    fused = prog.fetch(prog.run(prog.put(x[:1024])))
    assert np.max(np.abs(fused - frame)) <= 1e-5


# -- slice 17: the other stage families ---------------------------------------

# whose float32 body must equal the host transform of the same float32 rows
EXACT_FAMILIES = {"binarizer", "vector_slicer", "feature_selector"}


@pytest.mark.parametrize("algo", FAMILY_ALGOS)
def test_stage_family_bodies_on_the_card(cuda_device, algo):
    """Each family's stage body on CUDA tensors against its host
    transform: at float64 bit-equal (Normalizer within 1e-12 relative); at
    float32 against the host transform of the same float32 rows, equal
    for the exact families and within 1e-6 relative (Normalizer 1e-5)
    for the arithmetic ones."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4096, 64)) * np.linspace(0.5, 3.0, 64) + 0.2
    x[:, ::16] = 2.5  # constant columns
    model = stage_family(algo, x)
    for dtype, rows in ((torch.float64, x),
                        (torch.float32, x.astype(np.float32))):
        spec = model.serving_stage(device=cuda_device, dtype=dtype)
        out = spec.fn(torch.as_tensor(rows, device=cuda_device), *spec.weights)
        assert out.device.type == "cuda" and out.dtype == dtype
        got = out.cpu().numpy().astype(np.float64)
        host = np.asarray(model.transform(rows).column(model.getOutputCol()))
        if dtype == torch.float64 and algo != "normalizer":
            np.testing.assert_array_equal(got, host)
        elif dtype == torch.float32 and algo in EXACT_FAMILIES:
            np.testing.assert_array_equal(got, host)
        else:
            bar = {torch.float64: 1e-12, torch.float32: 1e-6}[dtype]
            if dtype == torch.float32 and algo == "normalizer":
                bar = 1e-5
            assert np.abs(got - host).max() <= bar * np.abs(host).max()


# -- slice 18: LinearSVC and GeneralizedLinearRegression ----------------------

def test_svc_newton_hessian_is_the_kernel_on_the_card(cuda_device):
    """One highest launch per Newton iteration, the Hessian on √s rows (s
    the active set) within the kernel's bar of its plain version, and the
    fit within 1e-4 of the float64 Newton on the card; the estimator and
    its streamed route launch the same kernel (once per bucket a pass)."""
    from spark_rapids_ml_tpu_torch import LinearSVC
    from spark_rapids_ml_tpu_torch.data.batches import auto_batch_rows
    from spark_rapids_ml_tpu_torch.ops import svm_kernel as sk

    x, y = _logistic(20_000, 256, seed=18)
    xd = torch.as_tensor(x, device=cuda_device)
    yd = torch.as_tensor(y, device=cuda_device)
    highest = fused_gram.kernel_name("highest")
    fused_gram.reset_launches()
    result = sk.svc_fit_kernel(xd, yd, reg_param=0.01, max_iter=6, tol=0.0)
    torch.cuda.synchronize()
    assert int(result.n_iter) == 6
    assert {k: v for k, v in fused_gram.launches.items() if v} == {
        highest: 6}
    margin = 1.0 - (2.0 * yd - 1.0) * (xd @ result.coefficients
                                       + result.intercept)
    root = (margin > 0).float()
    zeros = torch.zeros(256, device=cuda_device)
    got = fused_centered_gram(xd, zeros, root, "highest")
    want = fused_centered_gram_reference(xd, zeros, root, "highest")
    err = (got - want).abs().max().item()
    assert err <= fused_gram.PLAIN_RTOL[highest] * want.abs().max().item()
    ref = sk.svc_fit_kernel(xd.double(), yd.double(), reg_param=0.01,
                            max_iter=6, tol=0.0)
    w = torch.cat([result.coefficients, result.intercept.reshape(1)])
    w64 = torch.cat([ref.coefficients, ref.intercept.reshape(1)])
    assert (torch.linalg.norm(w.double() - w64)
            / torch.linalg.norm(w64)).item() <= 1e-4
    fused_gram.reset_launches()
    model = LinearSVC().setRegParam(0.01).setMaxIter(3).setTol(0.0).fit(x, y)
    assert fused_gram.launches[highest] == model.n_iter_ == 3
    fused_gram.reset_launches()
    streamed = LinearSVC().setRegParam(0.01).setMaxIter(2).setTol(
        0.0).setStandardization(False).fit(
        lambda: iter([(x[:12_000], y[:12_000]), (x[12_000:], y[12_000:])]))
    buckets = -(-20_000 // auto_batch_rows(256))
    assert fused_gram.launches[highest] == buckets * streamed.n_iter_


@pytest.mark.parametrize("family,link", [("poisson", "log"),
                                         ("gamma", "log"),
                                         ("binomial", "probit")])
def test_glm_irls_gram_is_the_kernel_on_the_card(cuda_device, family, link):
    """One highest launch per IRLS pass with √W as its row multiplier,
    within the kernel's bar of its plain version; the pass's statistics
    within 1e-5 of the float64 pass on the card; a fit launches once per
    pass and once more for the final deviance at maxIter."""
    from spark_rapids_ml_tpu_torch import GeneralizedLinearRegression
    from spark_rapids_ml_tpu_torch.ops import glm_kernel as gk

    rng = np.random.default_rng(19)
    rows, n = 16_384, 128
    x = rng.normal(size=(rows, n)).astype(np.float32)
    eta = x @ (rng.normal(size=n) * 0.3 / np.sqrt(n)) + 0.2
    y = {"poisson": rng.poisson(np.exp(eta)),
         "gamma": rng.gamma(5.0, np.exp(eta) / 5.0),
         "binomial": rng.random(rows) < 0.5}[family].astype(np.float32)
    xd, yd = (torch.as_tensor(a, device=cuda_device) for a in (x, y))
    ones = torch.ones(rows, device=cuda_device)
    coef = torch.as_tensor(rng.normal(size=n) * 0.01, dtype=torch.float32,
                           device=cuda_device)
    b = torch.tensor(0.1, device=cuda_device)
    kw = dict(family=family, link=link, var_power=0.0, link_power=1.0)
    highest = fused_gram.kernel_name("highest")
    fused_gram.reset_launches()
    out = gk.glm_irls_device_step(xd, yd, ones, torch.zeros_like(ones),
                                  coef, b, **kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in fused_gram.launches.items() if v} == {
        highest: 1}
    ref = gk.glm_irls_device_step(xd.double(), yd.double(), ones.double(),
                                  torch.zeros_like(ones).double(),
                                  coef.double(), b.double(), **kw)
    for name, got, want in zip(gk.GlmStepOut._fields, out, ref):
        assert torch.isfinite(got).all(), name
        scale = want.abs().max().item()
        assert (got.double() - want).abs().max().item() <= 1e-5 * scale, name
    fused_gram.reset_launches()
    model = GeneralizedLinearRegression(family=family).setLink(
        link).setMaxIter(3).setTol(0.0).fit(x, labels=y)
    assert model.num_iterations_ == 3
    assert fused_gram.launches[highest] == 4
    assert np.isfinite(model.coefficients).all()


def _knn_blobs(rows, dim, seed=0, n_blobs=32):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(n_blobs, dim))
    x = centers[rng.integers(0, n_blobs, rows)] + rng.normal(size=(rows, dim))
    q = centers[rng.integers(0, n_blobs, 300)] + rng.normal(size=(300, dim))
    return x.astype(np.float32), q.astype(np.float32)


def test_knn_brute_on_the_card_is_tf32_proof(cuda_device):
    """Brute force under ``set_float32_matmul_precision("high")`` equals
    the same search under "highest" bit for bit (float32 distances are
    float64 ones rounded once), matches float64 within 1e-5 relative with
    equal index sets outside near-ties, and launches no hand kernel."""
    from spark_rapids_ml_tpu_torch import NearestNeighbors

    x, q = _knn_blobs(50_000, 128)
    model = NearestNeighbors().setK(10).fit(x)
    fused_gram.reset_launches()
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        high = model.kneighbors(q)
        torch.set_float32_matmul_precision("highest")
        highest = model.kneighbors(q)
    finally:
        torch.set_float32_matmul_precision(saved)
    assert sum(fused_gram.launches.values()) == 0
    np.testing.assert_array_equal(high[0], highest[0])
    np.testing.assert_array_equal(high[1], highest[1])
    d64, i64 = model.copy().setDtype("float64").kneighbors(q, k=11)
    assert (np.abs(high[0] ** 2 - d64[:, :10] ** 2).max()
            <= 1e-5 * (d64[:, :10] ** 2).max())
    tied = np.isclose(d64[:, 9], d64[:, 10], rtol=1e-5)
    for row in np.nonzero(~tied)[0]:
        assert set(high[1][row]) == set(i64[row, :10]), row


def test_ivfpq_codes_stay_uint8_on_the_card(cuda_device):
    """The IVF-PQ index on the card: uint8 codes laid out (M, nlist,
    max_size), the real codes n·M bytes; a search with and without the
    re-rank returns real ids in ascending distance."""
    from spark_rapids_ml_tpu_torch import NearestNeighbors

    x, q = _knn_blobs(20_000, 64)
    model = (NearestNeighbors().setK(10).setAlgorithm("ivfpq").setNlist(64)
             .setNprobe(8).fit(x))
    d, i = model.kneighbors(q)
    cent, books, codes, ids, mask, nlist = model._ivfpq_index_cache[1]
    assert codes.dtype == torch.uint8 and codes.is_cuda
    m_sub = books.shape[0]
    assert m_sub == 16 and codes.shape == (m_sub, nlist, ids.shape[1])
    assert int((mask > 0).sum()) * m_sub * codes.element_size() == \
        20_000 * m_sub
    assert (i >= 0).all() and (np.diff(d, axis=1) >= -1e-6).all()
    d0, i0 = model.setRefineRatio(0.0).kneighbors(q)
    assert (i0 >= 0).all()


def test_ivfflat_on_the_card_equals_its_cpu_copy(cuda_device):
    """The same card-built index searched on the card and, copied, on the
    CPU gives the same ids, and distances within an ulp (torch's CPU
    float32 square root is not correctly rounded)."""
    from spark_rapids_ml_tpu_torch import NearestNeighbors
    from spark_rapids_ml_tpu_torch.ops.knn_kernel import ivf_search

    x, q = _knn_blobs(20_000, 64)
    model = (NearestNeighbors().setK(10).setAlgorithm("ivfflat")
             .setNlist(64).setNprobe(4).fit(x))
    d, i = model.kneighbors(q)
    cent, items, ids, mask, _ = model._ivf_index_cache[1]
    cd, ci = ivf_search(torch.as_tensor(q), cent.cpu(), items.cpu(),
                        ids.cpu(), mask.cpu(), 10, 4)
    np.testing.assert_array_equal(i, ci.numpy())
    np.testing.assert_allclose(d, torch.sqrt(cd).numpy(), rtol=1e-6)


def test_dbscan_dense_equals_blocked_on_the_card(cuda_device):
    """Dense and tiled DBSCAN on the card give the same labels and core
    mask, equal to the host BFS in float64 on lattice blobs (every d² a
    multiple of 1/16, ε² between levels)."""
    from spark_rapids_ml_tpu_torch import DBSCAN
    from spark_rapids_ml_tpu_torch.models.dbscan import (
        _host_dbscan,
        _relabel_consecutive,
    )

    rng = np.random.default_rng(4)
    centers = np.round(rng.normal(scale=8.0, size=(12, 4)))
    x = np.concatenate(
        [c + np.round(4 * rng.normal(scale=0.8, size=(300, 4))) / 4
         for c in centers]
        + [np.round(4 * rng.uniform(-40, 40, size=(80, 4))) / 4])
    eps = float(np.sqrt(1.5 + 1 / 32))
    dense = DBSCAN().setEps(eps).setMinPts(6).fit(x)
    for block in (512, 1000):
        blocked = DBSCAN().setEps(eps).setMinPts(6).setBlockRows(block).fit(x)
        np.testing.assert_array_equal(blocked.labels_, dense.labels_)
        np.testing.assert_array_equal(blocked.core_mask_, dense.core_mask_)
    host_labels, host_core = _host_dbscan(x, eps, 6)
    np.testing.assert_array_equal(dense.labels_,
                                  _relabel_consecutive(host_labels))
    np.testing.assert_array_equal(dense.core_mask_, host_core)
    assert dense.n_clusters_ >= 2


# -- the tree family (slice 20) ------------------------------------------------

def _tree_rows(rows=300_000, d=12, seed=20):
    """Rows over several of the histogram's row blocks, a binary label
    from a planted rule and a continuous one."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    z = x[:, 0] * x[:, 1] + np.sin(2 * x[:, 2]) + 0.5 * x[:, 3]
    return (x, (z + 0.5 * rng.standard_normal(rows) > 0).astype(np.float64),
            z + 0.1 * rng.standard_normal(rows))


def _tree_fits(x, y_cls, y_reg, dtype="float32"):
    from spark_rapids_ml_tpu_torch import (
        GBTRegressor,
        RandomForestClassifier,
        RandomForestRegressor,
    )

    return (RandomForestClassifier().setNumTrees(6).setMaxDepth(5)
            .setFeatureSubsetStrategy("auto").setDtype(dtype)
            .fit(x, y_cls),
            RandomForestRegressor().setNumTrees(4).setMaxDepth(5)
            .setDtype(dtype).fit(x, y_reg),
            GBTRegressor().setMaxIter(3).setMaxDepth(4).setDtype(dtype)
            .fit(x, y_reg))


def _tree_state(models):
    return [np.asarray(a) for m in models for a in m.ensemble_]


@pytest.mark.parametrize("trees", [1, 5])
def test_tree_histogram_float32_is_float64_rounded_once(cuda_device, trees):
    """The histogram contraction on the card: its float32 result is its
    float64 result rounded once (no TF32 path, whatever the switch), and
    the float64 result equals the CPU's within 1e-12 relative."""
    from spark_rapids_ml_tpu_torch.ops import forest_kernel as fk

    rows, d, bins, nodes = 300_000, 12, 32, 8
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    binned = torch.randint(0, bins, (rows, d), generator=gen,
                           device=cuda_device, dtype=torch.int32)
    node = torch.randint(0, nodes, (trees, rows), generator=gen,
                         device=cuda_device)
    chans = torch.randn((trees, rows, 3), generator=gen, device=cuda_device,
                        dtype=torch.float64).to(torch.float32)
    h64 = fk.channel_histograms(node, nodes, binned, chans, bins)
    torch.backends.cuda.matmul.allow_tf32 = True
    h32 = fk.channel_histograms(node, nodes, binned, chans, bins,
                                dtype=torch.float32)
    assert h64.dtype == torch.float64 and h64.is_cuda
    assert torch.equal(h32, h64.to(torch.float32))
    cpu = fk.channel_histograms(node.cpu(), nodes, binned.cpu(), chans.cpu(),
                                bins)
    scale = cpu.abs().max()
    assert float((h64.cpu() - cpu).abs().max() / scale) <= 1e-12


def test_tree_fits_on_the_card_are_bit_identical_twice(cuda_device):
    x, y_cls, y_reg = _tree_rows()
    first = _tree_state(_tree_fits(x, y_cls, y_reg))
    second = _tree_state(_tree_fits(x, y_cls, y_reg))
    for a, b in zip(first, second):
        assert np.array_equal(a, b)


def test_tf32_changes_no_tree(cuda_device):
    """``allow_tf32 = True`` moves no split and no leaf bit: every float
    product of the grower is float64 (no TF32 mode) rounded once."""
    x, y_cls, y_reg = _tree_rows()
    off = _tree_state(_tree_fits(x, y_cls, y_reg))
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        on = _tree_state(_tree_fits(x, y_cls, y_reg))
    finally:
        torch.set_float32_matmul_precision("highest")
    for a, b in zip(off, on):
        assert np.array_equal(a, b)


def test_tree_fits_keep_cuda_tensors_on_the_card(cuda_device, monkeypatch):
    """Every histogram, split selection and routing of a fit and a
    transform on the card takes CUDA tensors: none reaches the CPU."""
    from spark_rapids_ml_tpu_torch.ops import forest_kernel as fk

    seen = []

    def watch(name):
        real = getattr(fk, name)

        def wrapper(*args, **kwargs):
            seen.append((name, [a.device.type for a in args
                                if isinstance(a, torch.Tensor)]))
            return real(*args, **kwargs)

        monkeypatch.setattr(fk, name, wrapper)

    for name in ("channel_histograms", "level_split", "route_to_leaves"):
        watch(name)
    x, y_cls, y_reg = _tree_rows(rows=50_000)
    models = _tree_fits(x, y_cls, y_reg)
    for m in models:
        m.transform(x[:1000])
    names = {name for name, _ in seen}
    assert names == {"channel_histograms", "level_split", "route_to_leaves"}
    assert all(devices and set(devices) == {"cuda"} for _, devices in seen)


def test_tree_fits_card_equal_cpu_at_float64(cuda_device, monkeypatch):
    """At float64 the classifier's trees on the card equal the CPU's (exact
    class counts), and the regressors' predictions agree within 1e-9."""
    x, y_cls, y_reg = _tree_rows(rows=65_536)
    card = _tree_fits(x, y_cls, y_reg, dtype="float64")
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    cpu = _tree_fits(x, y_cls, y_reg, dtype="float64")
    np.testing.assert_array_equal(card[0].ensemble_.feature,
                                  cpu[0].ensemble_.feature)
    np.testing.assert_array_equal(card[0].ensemble_.threshold,
                                  cpu[0].ensemble_.threshold)
    for a, b in zip(card[1:], cpu[1:]):
        got = np.asarray(a.transform(x[:5000]).column("prediction"))
        want = np.asarray(b.transform(x[:5000]).column("prediction"))
        assert np.abs(got - want).max() <= 1e-9


def _plane_rows(rows=20_000, d=256, seed=31):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d)) / np.sqrt(1.0 + np.arange(d)) + 0.2
    w = rng.normal(size=d) / np.sqrt(d)
    y_reg = x @ w + 0.5 + 0.1 * rng.normal(size=rows)
    y_bin = (x @ w + rng.logistic(size=rows) * 0.5 > 0).astype(np.float64)
    return x, y_reg, y_bin


def _partition_launches(fn, kernel):
    fused_gram.reset_launches()
    rows = list(fn())
    torch.cuda.synchronize()
    return rows, fused_gram.launches[kernel]


# a float32 partial against the host float64 plane, max |Δ| / max |ref|:
# float32 sums over 20,000 rows (the bfloat16_3x Gram partial of 65,536 ×
# 4096 rows was 2.985e-05 from float64 on the H100, chip_smoke.py phase 21)
PLANE_F32_RTOL = 1e-4


def test_spark_device_partials_on_the_card(cuda_device):
    """The gram, Z = [X | y] and binary logreg executor partials on the
    card against the host float64 plane of the same partition (ragged
    batches, unpadded), each launching the Gram kernel (once a batch:
    bfloat16_3x for the Grams, highest for the Hessian)."""
    from spark_rapids_ml_tpu_torch.spark import aggregate as agg
    from spark_rapids_ml_tpu_torch.spark import device_aggregate as dev

    assert dev.executor_device_available()
    x, y_reg, y_bin = _plane_rows()
    halves = [x[:12_345], x[12_345:]]
    row, n = _partition_launches(
        lambda: dev.partition_gram_stats_device(halves, "f"),
        fused_gram.kernel_name(None))
    host = next(agg.partition_gram_stats(halves, "f"))
    assert n == 2 and row[0]["count"] == host["count"] == x.shape[0]
    for key in ("gram", "col_sum"):
        got, want = np.asarray(row[0][key]), np.asarray(host[key])
        assert np.abs(got - want).max() / np.abs(want).max() \
            <= PLANE_F32_RTOL, key

    xy = [(x[:7_000], y_reg[:7_000]), (x[7_000:], y_reg[7_000:])]
    row, n = _partition_launches(
        lambda: dev.partition_xy_stats_device(xy, "f", "l"),
        fused_gram.kernel_name(None))
    host = next(agg.partition_xy_stats(xy, "f", "l"))
    assert n == 2
    g, h = np.asarray(row[0]["gram"]), np.asarray(host["gram"])
    assert np.abs(g - h).max() / np.abs(h).max() <= PLANE_F32_RTOL

    w0, b0 = np.full(x.shape[1], 0.01), -0.1
    lab = [(x[:9_999], y_bin[:9_999]), (x[9_999:], y_bin[9_999:])]
    row, n = _partition_launches(
        lambda: dev.partition_logreg_stats_device(lab, "f", "l", w0, b0),
        fused_gram.kernel_name("highest"))
    host = next(agg.partition_logreg_stats(lab, "f", "l", w0, b0))
    assert n == 2 and row[0]["count"] == host["count"]
    for key in ("gx", "hxx", "hxb"):
        got, want = np.asarray(row[0][key]), np.asarray(host[key])
        assert np.abs(got - want).max() / np.abs(want).max() \
            <= PLANE_F32_RTOL, key
    for key in ("rsum", "ssum"):   # sums of terms in [-1, 1], per row
        assert abs(row[0][key] - host[key]) / host["count"] <= 1e-6, key
    # both on the host in float64 (the sums taken in another order)
    assert abs(row[0]["loss"] / host["loss"] - 1.0) <= 1e-12


def test_spark_plane_pca_on_the_card_matches_the_host_plane(cuda_device):
    """Partitions → device partials → combine → the driver's eigensolve on
    the card, against the host float64 plane and the host eigensolve."""
    from spark_rapids_ml_tpu_torch.spark import aggregate as agg
    from spark_rapids_ml_tpu_torch.spark import device_aggregate as dev

    x, _, _ = _plane_rows(rows=30_000, d=128)
    parts = [x[:10_000], x[10_000:20_000], x[20_000:29_999]]
    dev_rows = [r for p in parts
                for r in dev.partition_gram_stats_device([p], "f")]
    host_rows = [r for p in parts for r in agg.partition_gram_stats([p], "f")]
    pc, evr, mean = agg.finalize_pca_from_stats(*agg.combine_stats(dev_rows),
                                                8)
    hpc, hevr, hmean = agg.finalize_pca_from_stats(
        *agg.combine_stats(host_rows), 8, use_xla_svd=False)
    cos = np.abs(np.sum(pc * hpc, axis=0))
    assert cos.min() >= 0.999
    assert np.abs(evr - hevr).max() / np.abs(hevr).max() <= 1e-3
    np.testing.assert_allclose(mean, hmean, atol=1e-5)


def _forest_plane_inputs(rows=200_000, d=12):
    """Tree-plane batches (two of them, so the device accumulates) and a
    level-3 spec of 4 partial trees, from ``_tree_rows``."""
    from spark_rapids_ml_tpu_torch.ops.forest_kernel import quantile_bins

    x, y_cls, y_reg = _tree_rows(rows=rows, d=d)
    x = x.astype(np.float64)
    _, edges = quantile_bins(x[:8192], 32)
    rng = np.random.default_rng(22)
    trees = [{"tree": t,
              "feature": rng.integers(0, d, 7).astype(np.int32),
              "threshold": rng.integers(1, 31, 7).astype(np.int32)}
             for t in range(4)]
    spec = {"edges": edges, "n_bins": 32, "level": 3,
            "subsampling_rate": 1.0, "seed": 7, "classes": None,
            "trees": trees}
    half = rows // 2 + 1
    return x, y_cls, y_reg, spec, half


def test_spark_forest_partials_on_the_card_equal_the_cpu(cuda_device,
                                                         monkeypatch):
    """The forest and GBT device partials on the card against the same
    partials on the CPU (float64 contractions a row block at a time, the
    blocks in order): class counts equal, regression and GBT channels
    within 1e-12 relative; and the classification partial equal to the
    host float64 plane's."""
    from spark_rapids_ml_tpu_torch.spark import device_aggregate as dev
    from spark_rapids_ml_tpu_torch.spark import forest_plane as fp

    x, y_cls, y_reg, spec, half = _forest_plane_inputs()
    cls_spec = dict(spec, classes=np.array([0.0, 1.0]))
    prior = spec["trees"][:2]
    gbt_spec = {**{k: spec[k] for k in ("edges", "n_bins", "level", "seed")},
                "depth": 3, "subsampling_rate": 1.0, "tree": 2,
                "init": 0.1, "step_size": 0.1, "classification": True,
                "ens_feature": np.stack([t["feature"] for t in prior]),
                "ens_threshold": np.stack([t["threshold"] for t in prior]),
                "ens_leaf": np.stack([np.linspace(-1.0, 1.0, 8),
                                      np.linspace(0.5, -0.5, 8)]),
                "feature": spec["trees"][2]["feature"],
                "threshold": spec["trees"][2]["threshold"]}
    cases = ((dev.partition_forest_histograms_device, y_cls, cls_spec, True),
             (dev.partition_forest_histograms_device, y_reg, spec, False),
             (dev.partition_gbt_histograms_device, y_cls, gbt_spec, False))
    for fn, y, s, exact in cases:
        batches = [(x[:half], y[:half]), (x[half:], y[half:])]
        card = list(fn(batches, "f", "l", s))
        monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
        cpu = list(fn(batches, "f", "l", s))
        monkeypatch.delenv("SPARK_RAPIDS_ML_TORCH_PLATFORM")
        assert [r["tree"] for r in card] == [r["tree"] for r in cpu]
        for a, b in zip(card, cpu):
            got, want = np.asarray(a["hist"]), np.asarray(b["hist"])
            if exact:
                np.testing.assert_array_equal(got, want)
            else:
                assert np.abs(got - want).max() <= \
                    1e-12 * np.abs(want).max()
    host = list(fp.partition_forest_histograms(
        [(x[:half], y_cls[:half]), (x[half:], y_cls[half:])], "f", "l",
        cls_spec))
    card = list(dev.partition_forest_histograms_device(
        [(x[:half], y_cls[:half]), (x[half:], y_cls[half:])], "f", "l",
        cls_spec))
    assert [a["hist"] for a in card] == [b["hist"] for b in host]


def test_spark_streamed_tree_fit_on_the_card_equals_cpu(cuda_device,
                                                        monkeypatch):
    """A streamed forest and a streamed GBT, their level jobs on the
    device partials ('on'), on the card and on the CPU: the classifier's
    trees equal (exact class counts), the GBT's features and thresholds
    equal and its leaves within 1e-9."""
    from spark_rapids_ml_tpu_torch import GBTRegressor, RandomForestClassifier

    x, y_cls, y_reg, _, _ = _forest_plane_inputs(rows=120_000)

    def chunks(y):
        return lambda: ((x[i:i + 40_000], y[i:i + 40_000])
                        for i in range(0, x.shape[0], 40_000))

    def fits():
        return (RandomForestClassifier().setNumTrees(5).setMaxDepth(4)
                .setFeatureSubsetStrategy("auto").setExecutorDevice("on")
                .fit(chunks(y_cls)),
                GBTRegressor().setMaxIter(3).setMaxDepth(4)
                .setMinInstancesPerNode(8).setExecutorDevice("on")
                .fit(chunks(y_reg)))

    card = fits()
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    cpu = fits()
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a.ensemble_.feature,
                                      b.ensemble_.feature)
        np.testing.assert_array_equal(a.ensemble_.threshold,
                                      b.ensemble_.threshold)
    np.testing.assert_array_equal(card[0].ensemble_.leaf_value,
                                  cpu[0].ensemble_.leaf_value)
    assert np.abs(card[1].ensemble_.leaf_value
                  - cpu[1].ensemble_.leaf_value).max() <= 1e-9


# -- NaiveBayes (slice 23) ----------------------------------------------------

def _nb_data(kind, rows=20_000, d=64, k=5, seed=23):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, size=rows).astype(np.float64)
    profile = rng.uniform(0.5, 1.5, size=(k, d))[y.astype(int)]
    if kind == "gaussian":
        x = rng.normal(size=(rows, d)) + profile
    else:
        x = rng.poisson(0.05 * profile).astype(np.float64)
        if kind == "bernoulli":
            x = (x > 0).astype(np.float64)
    return x.astype(np.float32), y


@pytest.mark.parametrize("kind", ["multinomial", "complement", "bernoulli",
                                  "gaussian"])
def test_nb_class_stats_on_the_card_match_the_host(cuda_device, kind):
    """Each family's float32 fit on the card: its class products run on
    CUDA tensors, within 1e-6 of the host float64 fit, and bit-equal
    under set_float32_matmul_precision("high") (taken in float64)."""
    from spark_rapids_ml_tpu_torch import NaiveBayes
    from spark_rapids_ml_tpu_torch.models import naive_bayes

    x, y = _nb_data(kind)
    devices = []
    real = naive_bayes.class_products

    def spy(xt, oh, need_sq):
        devices.append((xt.device.type, xt.dtype))
        return real(xt, oh, need_sq)

    naive_bayes.class_products = spy
    try:
        card = NaiveBayes().setModelType(kind).fit(x, labels=y)
    finally:
        naive_bayes.class_products = real
    assert devices == [("cuda", torch.float32)]
    host = NaiveBayes().setModelType(kind).setUseXlaDot(False).fit(
        x, labels=y)
    for got, want in ((card.theta, host.theta), (card.pi, host.pi),
                      (card.sigma, host.sigma)):
        if want is None:
            assert got is None
            continue
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        high = NaiveBayes().setModelType(kind).fit(x, labels=y)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert np.array_equal(high.theta, card.theta)
    assert np.array_equal(high.pi, card.pi)
    if kind == "gaussian":
        assert np.array_equal(high.sigma, card.sigma)


def test_distributed_nb_fit_on_one_nccl_rank(cuda_device, tmp_path):
    """``distributed_nb_fit`` in a one-rank NCCL world equals the local
    float32 fit on the card (one rank reduces nothing)."""
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch import NaiveBayes
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        distributed_nb_fit,
    )

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        for kind in ("gaussian", "multinomial"):
            x, y = _nb_data(kind, seed=24)
            model = distributed_nb_fit(x, y, data_mesh(1), model_type=kind)
            local = NaiveBayes().setModelType(kind).fit(x, labels=y)
            assert np.array_equal(model.theta, local.theta)
            assert np.array_equal(model.pi, local.pi)
            assert model.fit_report_.collectives["all_reduce"]["count"] == 1
    finally:
        dist.destroy_process_group()


# -- UMAP (slice 24) ----------------------------------------------------------

def _umap_rows(n=3000, d=32, classes=6, seed=30):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, size=n)
    x = rng.normal(size=(classes, d))[y] * 3.0 + rng.normal(size=(n, d))
    return x.astype(np.float32), y


def _umap_fits(x, epochs=5):
    """Both fit paths (dense, and tiled with a ragged last block of 1000
    rows a block) and the transform of 200 rows."""
    from spark_rapids_ml_tpu_torch import UMAP

    out = []
    for block in (0, 1000):
        model = UMAP().setNEpochs(epochs).setBlockRows(block).fit(x)
        out.append(model.embedding_)
        out.append(np.asarray(model.transform(x[:200]).column("embedding")))
    return out


def test_umap_fits_on_the_card_are_bit_identical_twice(cuda_device):
    """Two fits from one seed give the same bits: the edge sums take a
    fixed order (``SegmentSum``, no atomics) and every product is a
    float64 cuBLAS call."""
    x, _ = _umap_rows()
    for a, b in zip(_umap_fits(x), _umap_fits(x)):
        assert np.array_equal(a, b)


def test_umap_on_the_card_is_tf32_proof(cuda_device):
    """``allow_tf32`` and ``set_float32_matmul_precision("high")`` move
    no bit of either fit or of the transform (no float32 product on the
    path), and no hand kernel launches but the tiled fit's one PCA-init
    Gram."""
    x, _ = _umap_rows()
    fused_gram.reset_launches()
    off = _umap_fits(x)
    launched = dict(fused_gram.launches)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        on = _umap_fits(x)
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    assert {k: v for k, v in launched.items() if v} == {
        fused_gram.kernel_name("bfloat16_3x"): 1}
    for a, b in zip(off, on):
        assert np.array_equal(a, b)


def test_umap_sharded_optimizer_on_one_nccl_rank(cuda_device, tmp_path):
    """``distributed_umap_optimize`` in a one-rank NCCL world equals the
    tiled optimizer on the card bit for bit at float32 and float64 (one
    rank reduces nothing; the panel streams in the same blocks)."""
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch.models.umap import knn_without_self
    from spark_rapids_ml_tpu_torch.ops.umap_kernel import (
        fit_ab,
        memberships,
        optimize_embedding_blocked,
        pca_init,
        symmetric_edge_list,
    )
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        distributed_umap_optimize,
    )

    x, _ = _umap_rows()
    xt = torch.as_tensor(x, device=cuda_device)
    d, i = knn_without_self(xt, xt, 15)
    ei, ej, ep = symmetric_edge_list(memberships(d).cpu().numpy(),
                                     i.cpu().numpy(), len(x))
    emb0 = pca_init(xt, 2).cpu().numpy()
    a, b = fit_ab(0.1)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        for dtype in (torch.float32, torch.float64):
            npd = np.float32 if dtype == torch.float32 else np.float64
            got = distributed_umap_optimize(ei, ej, ep, emb0, data_mesh(1),
                                            a, b, 1.0, 0.05, 5, dtype=npd,
                                            block_rows=1000)
            want = optimize_embedding_blocked(
                ei, ej, torch.as_tensor(ep, dtype=dtype, device=cuda_device),
                torch.as_tensor(emb0, dtype=dtype, device=cuda_device), None,
                a, b, 1.0, 0.05, 5, 1000)
            assert np.array_equal(got, want.double().cpu().numpy())
            assert got.fit_report_.collectives["all_gather"]["count"] == 5
    finally:
        dist.destroy_process_group()


# -- GaussianMixture and BisectingKMeans (slice 25) ---------------------------

def _gmm_rows(rows=20_000, d=12, k=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.normal(size=(k, d))
    return (centers[rng.integers(0, k, size=rows)]
            + rng.normal(size=(rows, d))).astype(np.float32)


def test_gmm_float32_estep_on_the_card_matches_its_plain_version(
        cuda_device):
    """One float32 E-step on the card: Σ r·x·xᵀ from the hand kernel, one
    narrow launch per component, within the kernel's bar of the plain
    Gram on the same √r rows; every other statistic bit-equal to the
    plain route's (they do not touch the Gram)."""
    from spark_rapids_ml_tpu_torch.ops import gmm_kernel as gk

    x = _gmm_rows()
    w = np.ones(x.shape[0])
    weights, means, covs = gk.init_params(x.astype(np.float64), w, 4, 1)
    prec, log_det = gk.precision_cholesky(covs)
    xt = torch.as_tensor(x, device=cuda_device)
    wt = torch.ones(x.shape[0], device=cuda_device)
    # 20,000 × 12 at highest: the narrow route
    name = fused_gram.NARROW_KERNEL
    fused_gram.reset_launches()
    got = gk.gmm_estep_device(xt, wt, means, prec, log_det, np.log(weights))
    torch.cuda.synchronize()
    assert fused_gram.launches[name] == 4
    want = gk.gmm_estep_device(xt, wt, means, prec, log_det,
                               np.log(weights), plain=True)
    assert fused_gram.launches[name] == 4
    bar = fused_gram.PLAIN_RTOL[name]
    for j in range(4):
        scale = want.sq_sum[j].abs().max()
        assert (got.sq_sum[j] - want.sq_sum[j]).abs().max() <= bar * scale
    for field in ("resp_sum", "mean_sum", "loglik", "w_sum"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    host = gk.estep_stats_math(np, x.astype(np.float64), w, means, prec,
                               log_det, np.log(weights))
    for a, b in zip(gk.stats_to_host(got), host):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_gmm_float32_fit_on_the_card_repeats_under_tf32(cuda_device):
    """A float32 fit twice and once under ``allow_tf32`` and
    ``set_float32_matmul_precision("high")``: the same bits every time (the
    products are float64 or the hand kernel's full f32), with k launches
    per EM pass."""
    from spark_rapids_ml_tpu_torch import GaussianMixture

    x = _gmm_rows(seed=1)

    def fit():
        return GaussianMixture(k=4, seed=2, maxIter=6, tol=0.0).fit(x)

    fused_gram.reset_launches()
    first = fit()
    # 20,000 × 12 at highest: the narrow route
    assert fused_gram.launches[fused_gram.NARROW_KERNEL] == \
        4 * first.num_iterations_ == 24
    second = fit()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        tf32 = fit()
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    for other in (second, tf32):
        for attr in ("means", "weights", "covs"):
            assert np.array_equal(getattr(first, attr), getattr(other, attr))
        assert first.log_likelihood_ == other.log_likelihood_


def test_bisecting_kmeans_on_the_card_recovers_blobs(cuda_device):
    from spark_rapids_ml_tpu_torch import BisectingKMeans

    rng = np.random.default_rng(3)
    centers = 20.0 * rng.normal(size=(8, 6))
    truth = rng.integers(0, 8, size=40_000)
    x = centers[truth] + rng.normal(size=(40_000, 6))
    model = BisectingKMeans(k=8, seed=1).fit(x)
    labels = np.asarray(model.transform(x).column("prediction"))
    for b in range(8):
        assert np.unique(labels[truth == b]).size == 1
    assert model.computeCost(x) == pytest.approx(model.training_cost_,
                                                 rel=1e-6)


# -- evaluation, tuning and ml.stat (phase 26) ---------------------------------

@pytest.mark.parametrize("shift", [0.0, 1.0])
def test_correlation_on_the_card_is_one_gram_launch(cuda_device, monkeypatch,
                                                    shift):
    """Pearson at float32 is one bfloat16_3x launch of the hand kernel,
    within 1e-4 of the same call at float64 on the card (cuBLAS) on
    zero-mean columns; with every column shifted by 1.0 the uncentred
    G/n − μμᵀ cancels (as the JAX package's does), so only its launch and
    NaN pattern are held there."""
    from spark_rapids_ml_tpu_torch import stat

    rng = np.random.default_rng(4)
    x = rng.normal(size=(8192, 512)) * (1.0 + np.arange(512)) ** -0.5 + shift
    name = fused_gram.kernel_name(None)
    fused_gram.reset_launches()
    got = stat.Correlation.corr(x)
    assert fused_gram.launches[name] == 1
    assert sum(fused_gram.launches.values()) == 1
    monkeypatch.setattr(stat, "_DTYPE", torch.float64)
    want = stat.Correlation.corr(x)
    assert sum(fused_gram.launches.values()) == 1
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.diag(got), np.ones(512))
    if shift == 0.0:
        assert np.abs(got - want).max() <= 1e-4


def test_cross_validator_on_the_card_matches_float64(cuda_device):
    """An in-memory CrossValidator over LinearRegression: one highest Gram
    launch per fold fit and one for the refit, the same bestIndex as the
    same search at float64 on the card, avgMetrics within 1e-4."""
    from spark_rapids_ml_tpu_torch import (
        CrossValidator,
        LinearRegression,
        ParamGridBuilder,
        RegressionEvaluator,
    )
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    rng = np.random.default_rng(5)
    x = rng.normal(size=(4096, 256))
    y = x @ rng.normal(size=256) + 3.0 + 0.1 * rng.normal(size=4096)
    frame = VectorFrame({"features": x, "label": y})
    grid = ParamGridBuilder().addGrid("regParam", [0.0, 1.0]).build()

    def cv(dtype):
        return CrossValidator(
            estimator=LinearRegression().setDtype(dtype),
            estimatorParamMaps=grid, evaluator=RegressionEvaluator(),
            numFolds=3, seed=26).fit(frame)

    fused_gram.reset_launches()
    ours = cv("float32")
    counts = {k: v for k, v in fused_gram.launches.items() if v}
    assert counts == {fused_gram.kernel_name("highest"): 7}
    ref = cv("float64")
    assert ours.bestIndex == ref.bestIndex == 0
    rel = np.abs(np.subtract(ours.avgMetrics, ref.avgMetrics)) / \
        np.abs(ref.avgMetrics)
    assert rel.max() <= 1e-4


def test_front_end_cross_validator_partials_on_the_card(cuda_device,
                                                        tmp_path):
    """The DataFrame Pipeline under spark.CrossValidator on the local
    engine: LinearRegression's partials launch the bfloat16_3x Gram on the
    card; the search equals the host float64 plane's within 1e-4 and a
    saved → loaded model transforms bit for bit."""
    from spark_rapids_ml_tpu_torch import spark as S
    from spark_rapids_ml_tpu_torch.spark.local_engine import (
        DenseVector,
        LocalSparkSession,
    )

    rng = np.random.default_rng(6)
    x = rng.normal(size=(1024, 16))
    y = x @ rng.normal(size=16) + 0.1 * rng.normal(size=1024)
    df = LocalSparkSession(n_partitions=4).createDataFrame(
        [{"features": DenseVector(r), "label": float(v)}
         for r, v in zip(x, y)])

    def cv(device):
        pipe = S.Pipeline(stages=[
            S.StandardScaler(featuresCol="features", outputCol="s"),
            S.LinearRegression(featuresCol="s", executorDevice=device)])
        return S.CrossValidator(
            estimator=pipe, estimatorParamMaps=S.ParamGridBuilder()
            .addGrid("regParam", [0.0, 1.0]).build(),
            evaluator=S.RegressionEvaluator(), numFolds=3, seed=3).fit(df)

    fused_gram.reset_launches()
    card = cv("auto")
    counts = {k: v for k, v in fused_gram.launches.items() if v}
    assert set(counts) == {fused_gram.kernel_name(None)}
    assert counts[fused_gram.kernel_name(None)] >= 7
    host = cv("off")
    assert card.bestIndex == host.bestIndex
    rel = np.abs(np.subtract(card.avgMetrics, host.avgMetrics)) / \
        np.abs(host.avgMetrics)
    assert rel.max() <= 1e-4
    card.save(str(tmp_path / "cvm"))
    loaded = S.CrossValidatorModel.load(str(tmp_path / "cvm"))

    def preds(model):
        return [r["prediction"] for r in model.transform(df).collect()]

    assert preds(loaded) == preds(card)


# -- PowerIterationClustering (slice 28) --------------------------------------

def _pic_edges(communities=4, nodes=512, seed=28):
    """A planted partition of ``communities`` × ``nodes`` (n = 2048): a
    ring with 7-step chords and 12 random chords a node in each, one
    cross edge per 16 nodes, weights U(0.5, 2)."""
    rng = np.random.default_rng(seed)
    i = np.arange(nodes)
    src, dst = [], []
    for c in range(communities):
        rand = rng.integers(0, nodes, nodes * 6)
        hop = rng.integers(1, nodes, rand.shape[0])
        src += [c * nodes + i, c * nodes + i, c * nodes + rand]
        dst += [c * nodes + (i + 1) % nodes, c * nodes + (i + 7) % nodes,
                c * nodes + (rand + hop) % nodes]
    n = communities * nodes
    a = rng.integers(0, n, n // 16)
    b = ((a // nodes + rng.integers(1, communities, a.shape[0]))
         % communities) * nodes + rng.integers(0, nodes, a.shape[0])
    src = np.concatenate(src + [a]).astype(np.float64)
    dst = np.concatenate(dst + [b]).astype(np.float64)
    return src, dst, rng.uniform(0.5, 2.0, src.shape[0])


def test_pic_on_the_card_matches_the_cpu_and_ignores_tf32(cuda_device,
                                                          monkeypatch):
    """``assign_clusters`` at float32 on the card: the iterate within 1e-5
    (relative L1) of the CPU's float64 iterate from the same start, v and
    labels bit-equal under ``set_float32_matmul_precision("high")`` (the
    product is a GEMV), the labels' partition equal to the CPU float64
    run's, and no Gram launch."""
    from spark_rapids_ml_tpu_torch import PowerIterationClustering
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
    from spark_rapids_ml_tpu_torch.models import pic

    src, dst, w = _pic_edges()
    frame = VectorFrame({"src": src, "dst": dst, "w": w})
    seen = []
    real = pic._power_iterate

    def iterate(*args):
        seen.append(real(*args))
        return seen[-1]

    monkeypatch.setattr(pic, "_power_iterate", iterate)
    fused_gram.reset_launches()
    est = PowerIterationClustering(k=4, maxIter=20, weightCol="w", seed=5,
                                   dtype="float32")
    out = est.assign_clusters(frame)
    torch.set_float32_matmul_precision("high")
    try:
        high = est.assign_clusters(frame)
    finally:
        torch.set_float32_matmul_precision("highest")
    assert not any(fused_gram.launches.values())
    assert seen[0].is_cuda and seen[0].dtype == torch.float32
    assert torch.equal(seen[0], seen[1])
    assert high.column("cluster") == out.column("cluster")
    monkeypatch.setenv("SPARK_RAPIDS_ML_TORCH_PLATFORM", "cpu")
    cpu = est.copy({"dtype": "float64"}).assign_clusters(frame)
    v64 = seen[2].numpy()
    rel = np.abs(seen[0].cpu().numpy() - v64).sum() / np.abs(v64).sum()
    assert rel <= 1e-5
    labels, want = np.asarray(out.column("cluster")), np.asarray(
        cpu.column("cluster"))
    assert np.array_equal(labels[:, None] == labels[None, :],
                          want[:, None] == want[None, :])


def test_distributed_pic_on_one_nccl_rank(cuda_device, tmp_path):
    """``distributed_pic_assign`` in a one-rank NCCL world equals
    ``assign_clusters`` on the card label for label (the panel is the
    whole W), with 20 all_gathers of the iterate recorded."""
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch import PowerIterationClustering
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        distributed_pic_assign,
    )

    src, dst, w = _pic_edges()
    local = PowerIterationClustering(k=4, maxIter=20, weightCol="w",
                                     seed=5).assign_clusters(
        VectorFrame({"src": src, "dst": dst, "w": w}))
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        result = distributed_pic_assign(src, dst, w, k=4, mesh=data_mesh(1),
                                        max_iter=20, seed=5)
    finally:
        dist.destroy_process_group()
    ids, labels = result
    assert ids.tolist() == local.column("id")
    assert labels.tolist() == local.column("cluster")
    assert result.fit_report_.collectives == {
        "all_gather": {"count": 20, "bytes": 20 * 2048 * 4}}


# -- the MLP, the optimizer loop and OneVsRest (slice 29) ---------------------

def _mlp_rows(rows=4096, d=20, k=4, seed=29):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, size=rows).astype(np.float64)
    centres = rng.normal(scale=2.0, size=(k, d))
    return rng.normal(size=(rows, d)) + centres[y.astype(int)], y


def test_mlp_fit_on_the_card_repeats_bit_equal_and_ignores_tf32(
        cuda_device):
    """A float32 L-BFGS fit on the card (an MLP [20, 16, 4] on 4096 seeded
    rows, 15 iterations) repeated bit-equal, bit-equal under
    ``set_float32_matmul_precision("high")`` (every layer product is
    float64 rounded once, forward and backward), within 1e-4 of the same
    fit at float64 on the card, and no Gram launch."""
    from spark_rapids_ml_tpu_torch import MultilayerPerceptronClassifier

    x, y = _mlp_rows()
    params = dict(layers=[20, 16, 4], seed=3, maxIter=15, tol=0.0)
    fused_gram.reset_launches()
    first = MultilayerPerceptronClassifier(**params).fit(x, labels=y)
    again = MultilayerPerceptronClassifier(**params).fit(x, labels=y)
    torch.set_float32_matmul_precision("high")
    try:
        high = MultilayerPerceptronClassifier(**params).fit(x, labels=y)
    finally:
        torch.set_float32_matmul_precision("highest")
    f64 = MultilayerPerceptronClassifier(dtype="float64", **params).fit(
        x, labels=y)
    np.testing.assert_array_equal(first.flat_weights, again.flat_weights)
    np.testing.assert_array_equal(first.flat_weights, high.flat_weights)
    assert first.final_loss_ == high.final_loss_
    rel = np.abs(first.flat_weights - f64.flat_weights).max() / \
        np.abs(f64.flat_weights).max()
    assert rel <= 1e-4
    assert not any(fused_gram.launches.values())


def test_distributed_mlp_on_one_nccl_rank_equals_the_local_fit(cuda_device,
                                                               tmp_path):
    """``distributed_mlp_fit`` in a one-rank NCCL world equals the local
    float32 fit bit for bit (one rank sums nothing), with one all-reduce
    per objective evaluation recorded."""
    import torch.distributed as dist

    from spark_rapids_ml_tpu_torch import MultilayerPerceptronClassifier
    from spark_rapids_ml_tpu_torch.ops.mlp_kernel import flatten_weights
    from spark_rapids_ml_tpu_torch.parallel import (
        data_mesh,
        distributed_mlp_fit,
    )

    x, y = _mlp_rows(rows=2048)
    local = MultilayerPerceptronClassifier(layers=[20, 16, 4], seed=3,
                                           maxIter=10).fit(x, labels=y)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        result = distributed_mlp_fit(x, y, [20, 16, 4], data_mesh(1),
                                     max_iter=10, seed=3)
    finally:
        dist.destroy_process_group()
    params, n_iter, loss = result
    assert n_iter == local.num_iterations_
    assert loss == local.final_loss_
    np.testing.assert_array_equal(flatten_weights(params),
                                  local.flat_weights)
    count = result.fit_report_.collectives["all_reduce"]["count"]
    assert count >= n_iter + 1


@pytest.mark.parametrize("kind", ["logreg", "svc"])
def test_ovr_sub_fits_launch_the_narrow_gram_once_per_newton_iteration(
        cuda_device, kind):
    """OneVsRest over LogisticRegression or LinearSVC at float32 on 20,000
    × 12 rows (3 folds of 8192: the narrow route, n ≤ 64), 3 classes: the
    Gram kernel launches once per Newton iteration of each sub-fit, all
    on the narrow instantiation."""
    from spark_rapids_ml_tpu_torch import (
        LinearSVC,
        LogisticRegression,
        OneVsRest,
    )
    from spark_rapids_ml_tpu_torch.data.frame import VectorFrame

    x, y = _mlp_rows(rows=20_000, d=12, k=3, seed=7)
    assert fused_gram.gram_plan(20_000, 12, "highest",
                                fused_gram._sm_count(0)).route == "narrow"
    clf = (LogisticRegression().setMaxIter(6) if kind == "logreg"
           else LinearSVC().setMaxIter(6))
    frame = VectorFrame({"features": list(x), "label": list(y)})
    fused_gram.reset_launches()
    model = OneVsRest(classifier=clf).fit(frame)
    iterations = sum(int(m.n_iter_) for m in model.models)
    assert iterations >= 3
    assert fused_gram.launches[fused_gram.NARROW_KERNEL] == iterations
    assert sum(fused_gram.launches.values()) == iterations
    pred = np.asarray(model.transform(frame).column("prediction"))
    assert (pred == y).mean() > 0.9
