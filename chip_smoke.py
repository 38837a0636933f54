#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (spark_rapids_ml_tpu_torch) on one NVIDIA
GPU and check it, kernel by kernel and end to end.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device, nvcc and PyTorch
built for CUDA, and nothing of JAX. It exits non-zero, printing no result,
when there is no CUDA device or the port is not importable.

Phases (any failure raises and the script exits non-zero):

1. Environment: the card's name and power limit, torch and CUDA versions;
   TF32 off for matmuls and cuDNN, so every f32 product is full f32.
2. Build: every kernel of the path from the checkout's sources, with the
   registers, shared memory and spills ``ptxas -v`` reports for the FFMA,
   prep and tensor-core kernels, and the tensor-core launches' dynamic
   shared memory. Fails unless the SASS of both tensor-core instantiations
   (``cuobjdump -sass``) holds wgmma (``HGMMA``) and TMA loads
   (``UTMALDG``).
3. Each kernel against its plain PyTorch version on the card, per
   precision, at the main-path bucket (8192 × 4096), with a masked tail, at
   a ragged shape, at 5 × 129 and on a row view with an odd stride, within
   its bar (``ops/fused_gram.PLAIN_RTOL``); the bf16 modes' prep pass must
   equal its plain version bit for bit on each. At the bucket, controls
   that compute in another precision must miss that bar, so the bar can
   tell a wrong precision. Timed with CUDA events at the bucket (the whole
   call, and the prep pass alone) beside its plain version, a library
   yardstick and its bound.
4. The PCA slice at the north-star width (4096 features, k = 256; rows cut
   from 10,485,760 to fit the run's time), data with a decaying spectrum
   made per chunk from a seed on the card:
   (a) two-pass streamed fit from a factory of 65,536-row chunks,
       262,144 rows → 32 buckets of 8192 rows, default gramPrecision;
   (b) one-pass streamed fit from a one-shot generator, 65,536 rows → 8
       buckets, gramPrecision 'highest';
   (c) one-shot fit of a 32,768 × 4096 array (1 GiB as float64, not above
       the streaming threshold) → 1 launch, gramPrecision 'bfloat16'.
   Each fit runs with the launch counts set to 0 just before it and read
   just after, must launch its kernel exactly that often, and is held
   against the same fit computed with the kernel's plain version on the
   card. Then a few 4096-row transform requests, and save → load →
   transform again. A small fit is held against a float64 numpy oracle.

Then one JSON line ``{"kernels": [...]}``, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_FEATURES = 4096
K = 256
BUCKET_ROWS = 8192
CHUNK_ROWS = 65536
NORTH_STAR_ROWS = 10_485_760
SEED = 0

# NVIDIA's published H100 SXM peaks (dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}

# per precision: kernel instantiation, operand type and bf16 passes
PRECISIONS = {
    "bfloat16_3x": ("fused_centered_gram_bf16x3", "bf16", 3),
    "bfloat16": ("fused_centered_gram_bf16", "bf16", 1),
    "highest": ("fused_centered_gram_f32", "f32", 1),
}
SOURCE = "spark_rapids_ml_tpu_torch/csrc/fused_gram.cu"
REPLACES = "spark_rapids_ml_tpu/ops/pallas_gram.py:200"

# Fit vs plain-version fit: components whose spectral gap is well above
# f32 rounding (the first 64 of a 1/(1+j) spectrum) and their EVR.
TOP_COMPONENTS = 64
COS_BAR = 0.999
EVR_RTOL = 1e-3


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {message}")


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(rows: int, n: int, operand: str, passes: int):
    """Least time for the Gram on this input: each input byte read once and
    G written once over the memory rate, vs the upper triangle's
    multiply-adds (2 operations each) per pass over the operand type's
    peak. Returns (ms, 'bytes' | 'operations')."""
    bytes_moved = 4 * (rows * n + n + rows + n * n)
    ops = passes * 2.0 * rows * n * (n + 1) / 2
    bytes_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[operand] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def check_sass(cuda_build, path: str) -> None:
    """Fail unless each tensor-core instantiation's SASS holds wgmma
    (HGMMA) and TMA tile loads (UTMALDG)."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    found = 0
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if "gram_tc_kernel" not in name:
            continue
        found += 1
        hgmma, utmaldg = block.count("HGMMA"), block.count("UTMALDG")
        log(f"  SASS {name}: {hgmma} HGMMA, {utmaldg} UTMALDG")
        check(hgmma > 0 and utmaldg > 0,
              f"{name} has no wgmma or no TMA load in its SASS")
    check(found == 2, f"{found} tensor-core instantiations in the SASS, "
          f"expected 2")


def mirrored(torch, g):
    return torch.triu(g) + torch.triu(g, 1).T


def controls(torch, fg, x, mean, rowmul, precision):
    """What a kernel that computed ``precision`` in another precision would
    return on these inputs: {label: G}."""
    xc = (x - mean[None, :]) * rowmul[:, None]
    if precision == "highest":
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = mirrored(torch, xc.T @ xc)
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        return {"TF32 product": tf32,
                "bfloat16_3x kernel": fg.fused_centered_gram(
                    x, mean, rowmul, "bfloat16_3x")}
    if precision == "bfloat16_3x":
        hi = xc.to(torch.bfloat16).to(torch.float32)
        lo = (xc - hi).to(torch.bfloat16).to(torch.float32)
        return {"one bf16 pass": fg.fused_centered_gram_reference(
                    x, mean, rowmul, "bfloat16"),
                "lo·hi dropped": mirrored(torch, hi.T @ hi + hi.T @ lo)}
    return {"full f32": fg.fused_centered_gram_reference(
                x, mean, rowmul, "highest"),
            "bfloat16_3x kernel": fg.fused_centered_gram(
                x, mean, rowmul, "bfloat16_3x")}


def check_prep(torch, fg, x, mean, rowmul, precision, label) -> None:
    """The prep pass's hi (and lo) planes equal its plain version's bit for
    bit, padding included."""
    got = fg.gram_prep(x, mean, rowmul, precision)
    torch.cuda.synchronize()
    want = fg.gram_prep_reference(x, mean, rowmul, precision)
    same = got.shape == want.shape and torch.equal(
        got.view(torch.int16), want.view(torch.int16))
    log(f"  prep pass {precision} {label} {tuple(x.shape)} → "
        f"{tuple(got.shape)} bf16: bit-equal to its plain version {same}")
    check(same, f"prep pass {precision} {label} differs from its plain version")


def log_tensor_core_share(fg, rows, n, precision, passes, gemm_ms) -> None:
    """The tensor-core launch's share of a bf16 call (call time − prep
    time): its rate on the upper triangle's bf16 products, and the panel
    bytes its 128 × 128 tiles read through L2 (each upper tile reads its
    two panels of every plane over the whole padded depth) over that
    time."""
    tiles = -(-n // 128)
    planes, _, kp = fg.scratch_shape(rows, n, precision)
    panel_bytes = tiles * (tiles + 1) // 2 * 2 * planes * 128 * kp * 2
    tflops = passes * 2.0 * rows * n * (n + 1) / 2 / gemm_ms * 1e-9
    log(f"    tensor-core launch (call − prep) {gemm_ms:.4f} ms: "
        f"{tflops:.1f} TFLOP/s of bf16 products; panels read through L2 "
        f"{panel_bytes / 1e9:.2f} GB, {panel_bytes / gemm_ms * 1e-9:.2f} TB/s")


def phase_kernels(torch, fg, device):
    """Phase 3. Returns {kernel name: measurements}."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    # label: (rows, n, masked tail rows, extra columns of the parent whose
    # row view x is, starting at column 1: an odd row stride, unaligned)
    shapes = {
        "bucket": (BUCKET_ROWS, N_FEATURES, 0, 0),
        "masked tail": (BUCKET_ROWS, N_FEATURES, 3000, 0),
        "ragged": (1000, 1100, 0, 0),
        "tiny": (5, 129, 0, 0),
        "odd-stride view": (3000, 1000, 0, 3),
    }
    inputs = {}
    for label, (rows, n, masked, extra) in shapes.items():
        x = torch.randn(rows, n + extra, generator=gen, device=device) + 0.5
        if extra:
            x = x[:, 1:n + 1]
        mask = torch.ones(rows, device=device)
        if masked:
            mask[rows - masked:] = 0.0
            x[rows - masked:] = 1e6  # padding garbage the mask must hide
        valid = int(mask.sum())
        mean = (x * mask[:, None]).sum(0) / valid
        rowmul = (mask / (valid - 1) ** 0.5).contiguous()
        inputs[label] = (x, mean.contiguous(), rowmul)

    results = {}
    for precision, (name, operand, passes) in PRECISIONS.items():
        bar = fg.PLAIN_RTOL[name]
        worst = worst_rel = 0.0
        for label, (x, mean, rowmul) in inputs.items():
            if operand == "bf16":
                check_prep(torch, fg, x, mean, rowmul, precision, label)
            got = fg.fused_centered_gram(x, mean, rowmul, precision)
            torch.cuda.synchronize()
            want = fg.fused_centered_gram_reference(x, mean, rowmul, precision)
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            xc64 = (x.double() - mean.double()) * rowmul.double()[:, None]
            truth = xc64.T @ xc64
            k_true = (got.double() - truth).abs().max().item() / scale
            p_true = (want.double() - truth).abs().max().item() / scale
            log(f"  {name} {label} {tuple(x.shape)}: max_abs_err {err:.3e} "
                f"rel {err / scale:.3e} (bar {bar:g}); vs float64: "
                f"kernel {k_true:.3e}, plain {p_true:.3e}")
            check(bool(torch.isfinite(got).all()), f"{name} {label} finite")
            check(bool(torch.equal(got, got.T)), f"{name} {label} symmetric")
            check(err <= bar * scale,
                  f"{name} {label} kernel vs plain {err / scale:.3e}")
            worst = max(worst, err)
            worst_rel = max(worst_rel, err / scale)

        x, mean, rowmul = inputs["bucket"]
        want = fg.fused_centered_gram_reference(x, mean, rowmul, precision)
        scale = want.abs().max().item()
        nearest = float("inf")
        for label, g in controls(torch, fg, x, mean, rowmul, precision).items():
            rel = (g - want).abs().max().item() / scale
            nearest = min(nearest, rel)
            log(f"  {name} control at the bucket, {label}: rel {rel:.3e} "
                f"(must exceed the bar {bar:g})")
        check(worst_rel < bar < nearest,
              f"{name}: bar {bar:g} does not lie between the kernel's "
              f"{worst_rel:.3e} and the nearest control's {nearest:.3e}")

        x, mean, rowmul = inputs["bucket"]
        rows, n = x.shape
        xc = (x - mean[None, :]) * rowmul[:, None]
        lib_in = xc.to(torch.bfloat16) if precision == "bfloat16" else xc
        ms = time_ms(torch, lambda: fg.fused_centered_gram(
            x, mean, rowmul, precision), iters=20)
        prep_ms = time_ms(torch, lambda: fg.gram_prep(
            x, mean, rowmul, precision), iters=20) \
            if operand == "bf16" else None
        plain_ms = time_ms(torch, lambda: fg.fused_centered_gram_reference(
            x, mean, rowmul, precision), iters=5)
        library_ms = time_ms(torch, lambda: torch.matmul(lib_in.T, lib_in),
                             iters=20)
        bound_ms, bound_by = bound(rows, n, operand, passes)
        prep = "" if prep_ms is None else f" (prep pass {prep_ms:.4f} ms)"
        log(f"  {name} at {rows}x{n}: kernel {ms:.4f} ms{prep}, plain "
            f"{plain_ms:.4f} ms, torch.matmul yardstick {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of "
            f"the bound")
        if prep_ms is not None:
            log_tensor_core_share(fg, rows, n, precision, passes, ms - prep_ms)
        results[name] = {
            "max_abs_err": worst, "ms": ms, "prep_ms": prep_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        }
    return results


def chunk(torch, device, index: int, rows: int = CHUNK_ROWS) -> np.ndarray:
    """One chunk of the decaying-spectrum data (variance of column j is
    1/(1+j), as bench.py's synthetic batch), made on the card from
    SEED + index and handed over as a host float32 array, as a user's
    loader would."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1 + index)
    scale = (1.0 + torch.arange(N_FEATURES, device=device)) ** -0.5
    x = torch.randn(rows, N_FEATURES, generator=gen, device=device) * scale
    return x.cpu().numpy()


def plain_fit(torch, fg, source, k, precision, device, one_pass, x_oneshot=None):
    """The same fit as the port's PCA, with the Gram computed by the
    kernel's plain version on the card."""
    from spark_rapids_ml_tpu_torch.ops.covariance import covariance_from_stats
    from spark_rapids_ml_tpu_torch.ops.eigh import pca_from_covariance_gated

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()

    n = N_FEATURES
    zeros = torch.zeros(n, device=device)
    if x_oneshot is not None:
        x = dev(x_oneshot)
        mean = x.mean(0)
        rowmul = torch.full((x.shape[0],), (x.shape[0] - 1) ** -0.5,
                            device=device)
        cov = fg.fused_centered_gram_reference(x, mean, rowmul, precision)
    elif one_pass:
        g = torch.zeros(n, n, device=device)
        s = torch.zeros(n, device=device)
        count = 0
        for batch, mask in source.batches():
            m = torch.ones(batch.shape[0], device=device) if mask is None \
                else dev(mask)
            b = dev(batch)
            g += fg.fused_centered_gram_reference(b, zeros, m, precision)
            s += (b * m[:, None]).sum(0)
            count += int(m.sum())
        cov = covariance_from_stats(g, s, torch.tensor(count, device=device))
    else:
        s = torch.zeros(n, device=device)
        count = 0
        for batch, mask in source.batches():
            m = torch.ones(batch.shape[0], device=device) if mask is None \
                else dev(mask)
            s += (dev(batch) * m[:, None]).sum(0)
            count += int(m.sum())
        mean = s / count
        g = torch.zeros(n, n, device=device)
        for batch, mask in source.batches():
            m = torch.ones(batch.shape[0], device=device) if mask is None \
                else dev(mask)
            g += fg.fused_centered_gram_reference(dev(batch), mean, m, precision)
        cov = g / (count - 1)
    pc, evr, used = pca_from_covariance_gated(cov, k, solver="auto")
    return pc.cpu().numpy(), evr.cpu().numpy(), used


def compare_fits(label, model, pc, evr, used):
    cos = np.abs(np.sum(model.pc * pc, axis=0))
    evr_rel = np.abs(model.explained_variance - evr) / np.abs(evr)
    log(f"  {label}: |cos| min over top {TOP_COMPONENTS} "
        f"{cos[:TOP_COMPONENTS].min():.6f} (bar {COS_BAR}), over all {K} "
        f"{cos.min():.6f}; EVR max rel err top {TOP_COMPONENTS} "
        f"{evr_rel[:TOP_COMPONENTS].max():.3e} (bar {EVR_RTOL:g}), all "
        f"{evr_rel.max():.3e}; solver kernel fit {model.svd_solver_used_}, "
        f"plain fit {used}")
    check(np.isfinite(model.pc).all() and model.pc.shape == (N_FEATURES, K),
          f"{label} components finite, shape {model.pc.shape}")
    check(cos[:TOP_COMPONENTS].min() >= COS_BAR, f"{label} component |cos|")
    check(evr_rel[:TOP_COMPONENTS].max() <= EVR_RTOL, f"{label} EVR")


def counted_fit(fg, label, estimator, data, kernel, expected):
    """One fit with the launch counts set to 0 just before and read just
    after. Returns (model, launches of ``kernel``)."""
    fg.reset_launches()
    t0 = time.perf_counter()
    model = estimator.fit(data)
    seconds = time.perf_counter() - t0
    counts = dict(fg.launches)
    log(f"  {label}: {seconds:.2f} s, launches {counts}, svd_solver_used_ "
        f"{model.svd_solver_used_}, fit_timings_ "
        f"{ {k: round(v, 4) for k, v in model.fit_timings_.items()} }")
    check(counts[kernel] == expected,
          f"{label}: {kernel} launched {counts[kernel]} times, expected "
          f"{expected}")
    check(sum(counts.values()) == expected,
          f"{label}: other kernels launched: {counts}")
    return model, counts[kernel]


def phase_slice(torch, fg, device):
    """Phase 4. Returns {kernel name: launches on the main path}."""
    from spark_rapids_ml_tpu_torch import PCA, PCAModel
    from spark_rapids_ml_tpu_torch.data.batches import BatchSource

    n_chunks = 4
    rows = n_chunks * CHUNK_ROWS
    log(f"  rows cut from {NORTH_STAR_ROWS:,} (north star) to {rows:,} "
        f"streamed and {CHUNK_ROWS // 2:,} one-shot to fit the run's time; "
        f"{N_FEATURES} features, k = {K}")
    launches = {}

    def factory():
        return (chunk(torch, device, i) for i in range(n_chunks))

    # (a) two-pass streamed, default precision
    kernel = fg.kernel_name(None)
    model_a, launches[kernel] = counted_fit(
        fg, "(a) two-pass streamed", PCA().setK(K), factory, kernel,
        rows // BUCKET_ROWS)
    compare_fits("(a) vs plain", model_a,
                 *plain_fit(torch, fg, BatchSource(factory), K, None, device,
                            one_pass=False))

    # (b) one-pass streamed from a one-shot generator, 'highest'
    kernel = fg.kernel_name("highest")
    model_b, launches[kernel] = counted_fit(
        fg, "(b) one-pass streamed",
        PCA().setK(K).setGramPrecision("highest"),
        iter([chunk(torch, device, 10)]), kernel, CHUNK_ROWS // BUCKET_ROWS)
    compare_fits("(b) vs plain", model_b,
                 *plain_fit(torch, fg,
                            BatchSource(iter([chunk(torch, device, 10)])),
                            K, "highest", device, one_pass=True))

    # (c) one-shot ndarray, 'bfloat16'
    kernel = fg.kernel_name("bfloat16")
    x_c = chunk(torch, device, 20, rows=CHUNK_ROWS // 2)
    model_c, launches[kernel] = counted_fit(
        fg, "(c) one-shot", PCA().setK(K).setGramPrecision("bfloat16"),
        x_c, kernel, 1)
    compare_fits("(c) vs plain", model_c,
                 *plain_fit(torch, fg, None, K, "bfloat16", device,
                            one_pass=False, x_oneshot=x_c))

    # requests: transform 4096-row batches, then save → load → transform
    requests = [chunk(torch, device, 30 + i, rows=4096) for i in range(4)]
    outputs = []
    for i, batch in enumerate(requests):
        t0 = time.perf_counter()
        out = np.asarray(model_a.transform(batch).column("pca_features"))
        seconds = time.perf_counter() - t0
        want = batch.astype(np.float64) @ model_a.pc
        err = np.abs(out - want).max() / np.abs(want).max()
        log(f"  transform request {i}: {batch.shape} → {out.shape} in "
            f"{seconds * 1e3:.2f} ms, rel err vs float64 {err:.3e}")
        check(out.shape == (4096, K) and np.isfinite(out).all(),
              "transform output shape/finite")
        check(err <= 1e-5, f"transform rel err {err:.3e}")
        outputs.append(out)
    with tempfile.TemporaryDirectory() as tmp:
        model_a.save(f"{tmp}/pca")
        loaded = PCAModel.load(f"{tmp}/pca")
    check(np.array_equal(loaded.pc, model_a.pc)
          and np.array_equal(loaded.explained_variance,
                             model_a.explained_variance),
          "components after save/load")
    worst = 0.0
    for batch, out in zip(requests, outputs):
        again = np.asarray(loaded.transform(batch).column("pca_features"))
        worst = max(worst, np.abs(again - out).max() / np.abs(out).max())
    log(f"  save → load: identical components; transform again, max rel "
        f"diff {worst:.3e}")
    check(worst <= 1e-6, "transform after save/load")

    # a small fit on the card against a float64 numpy oracle
    rng = np.random.default_rng(SEED)
    q, _ = np.linalg.qr(rng.normal(size=(64, 64)))
    x = rng.normal(size=(4000, 64)) @ (q * 2.0 ** (-np.arange(64) / 4)) + 3.0
    small = PCA().setK(8).fit(x)
    xc = x - x.mean(0)
    evals, evecs = np.linalg.eigh(xc.T @ xc / (x.shape[0] - 1))
    evals, evecs = evals[::-1], evecs[:, ::-1]
    cos = np.abs(np.sum(small.pc * evecs[:, :8], axis=0))
    evr_err = np.abs(small.explained_variance - evals[:8] / evals.sum()).max()
    log(f"  small fit vs float64 oracle: |cos| min {cos.min():.8f}, EVR max "
        f"abs err {evr_err:.3e}")
    check(cos.min() >= 0.9999 and evr_err <= 1e-5, "small fit vs oracle")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from spark_rapids_ml_tpu_torch.ops import fused_gram as fg
    from spark_rapids_ml_tpu_torch.utils import cuda_build

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log("[1] environment")
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")

    log("[2] build")
    t0 = time.perf_counter()
    result = cuda_build.build("fused_gram")
    log(f"  {result.name}: nvcc {result.seconds:.2f} s "
        f"({'cached' if result.cached else 'built'}) → {result.path}")
    for line in result.ptxas.splitlines():
        if any(key in line for key in ("Compiling entry", "registers",
                                       "spill", "wgmma", "setmaxnreg")):
            log("   ", line.strip())
    for precision in ("bfloat16", "bfloat16_3x"):
        log(f"  {fg.kernel_name(precision)} tensor-core launch: "
            f"{fg.dynamic_smem_bytes(precision)} B dynamic shared memory")
    check_sass(cuda_build, result.path)
    log(f"  build phase {time.perf_counter() - t0:.2f} s")

    log("[3] kernels vs plain versions")
    measured = phase_kernels(torch, fg, device)

    log("[4] PCA slice at full width")
    launches = phase_slice(torch, fg, device)

    kernels = []
    for name, m in measured.items():
        check(launches.get(name, 0) > 0, f"{name} not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "prep_ms": m["prep_ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        })
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
