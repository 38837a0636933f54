#!/usr/bin/env python3
"""Hold the PyTorch port's Gram routes against the whole-depth launch, and
time them, on one CUDA card.

    python3 scripts/torch_gram_route_sweep.py --check   # bits, at the edges
    python3 scripts/torch_gram_route_sweep.py --sweep   # widths × rows × precisions

``fused_centered_gram`` picks its route from the shape and the card's SM
count (``ops/fused_gram.gram_plan``): the split launch, the narrow launch or
the whole-depth 128-tile launch. ``--check`` runs each route at its edges
(ragged last fold, ragged tile column, masked tail, odd-stride view, the
widths around the narrow limit and the split rule's limit) and fails unless
the routed call is bit-equal to the private whole-depth launch
(``_one_run=True``), within ``PLAIN_RTOL`` of the plain version, and
bit-equal to itself when repeated. ``--sweep`` times, at highest and
bfloat16_3x, widths {1, 28, 64, 128, 256, 784, 1024, 1920, 2048} × rows
{65,536, 2,097,152}: the routed call, the whole-depth launch and
``torch.matmul`` on the same scaled rows, with CUDA events, each beside the
bound (bytes or operations, NVIDIA's published H100 SXM peaks), and the
host's time to enqueue one routed call. Device times are taken with the card
held busy while the host enqueues the timed calls. Each result
is one JSON line on stdout and in ``chiprun_out/gram_route_sweep.jsonl``;
the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"highest": 67e12, "bfloat16_3x": 989e12,
                  "bfloat16": 989e12}
PASSES = {"highest": 1, "bfloat16_3x": 3, "bfloat16": 1}
# ~50 ms of the card's time at 1.755 GHz: longer than the host takes to
# enqueue any timed loop below
SLEEP_CYCLES = 90_000_000

# label: (precision, rows, n, masked tail rows, extra parent columns)
CHECKS = [
    ("HIGGS shape", "highest", 2_097_152, 28, 0, 0),
    ("MNIST shape", "highest", 60_000, 784, 0, 0),
    ("MNIST shape", "bfloat16", 60_000, 784, 0, 0),
    ("MNIST shape", "bfloat16_3x", 60_000, 784, 0, 0),
    ("multinomial partials", "highest", 32_768, 256, 0, 0),
    ("whole shard", "highest", 262_144, 256, 1000, 0),
    ("whole shard", "bfloat16", 262_144, 256, 1000, 0),
    ("whole shard", "bfloat16_3x", 262_144, 256, 1000, 0),
    ("split limit", "highest", 16_384, 1920, 0, 0),
    ("split limit", "bfloat16_3x", 16_384, 1920, 0, 0),
    ("no split past it", "highest", 16_384, 2048, 0, 0),
    ("one fold", "highest", 8192, 28, 0, 0),
    ("narrow 1", "highest", 8193, 1, 100, 0),
    ("narrow 4", "highest", 70_000, 4, 0, 0),
    ("narrow 28 view", "highest", 70_000, 28, 3000, 3),
    ("narrow 33", "highest", 8193, 33, 0, 0),
    ("narrow 33 view", "highest", 70_000, 33, 0, 1),
    ("narrow 64", "highest", 70_000, 64, 500, 0),
    ("past narrow 65", "highest", 70_000, 65, 0, 0),
    ("ragged split view", "bfloat16_3x", 20_000, 300, 700, 5),
]
SWEEP_WIDTHS = (1, 28, 64, 128, 256, 784, 1024, 1920, 2048)
SWEEP_ROWS = (65_536, 2_097_152)
SWEEP_PRECISIONS = ("highest", "bfloat16_3x")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def inputs(torch, device, rows, n, masked, extra, seed):
    """x (rows, n) + 0.5, a row view of a wider parent from column 1 when
    ``extra``, a masked tail of 1e6 garbage, its masked mean and rowmul."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(rows, n + extra, generator=gen, device=device) + 0.5
    if extra:
        x = x[:, 1:n + 1]
    mask = torch.ones(rows, device=device)
    if masked:
        mask[rows - masked:] = 0.0
        x[rows - masked:] = 1e6
    valid = int(mask.sum())
    mean = ((x * mask[:, None]).sum(0) / valid).contiguous()
    return x, mean, (mask / max(valid - 1, 1) ** 0.5).contiguous()


def time_ms(torch, fn, iters, warmup=2):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, with
    the card held busy (``torch.cuda._sleep``) while the host enqueues them,
    so a call shorter than its own host work is not timed as that work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(torch, fn, iters):
    """Mean host time to enqueue one call (no synchronisation inside)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e3


def bound_ms(rows, n, precision):
    bytes_ms = 4 * (rows * n + n + rows + n * n) / PEAK_BYTES_PER_S * 1e3
    ops_ms = (PASSES[precision] * rows * n * (n + 1)
              / PEAK_OPS_PER_S[precision] * 1e3)
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                               "bytes")


def same_bits(torch, a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check(torch, fg, device, out):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    failures = 0
    for i, (label, precision, rows, n, masked, extra) in enumerate(CHECKS):
        x, mean, rowmul = inputs(torch, device, rows, n, masked, extra, i)
        plan = fg.gram_plan(rows, n, precision, sms)
        fg.reset_launches()
        got = fg.fused_centered_gram(x, mean, rowmul, precision)
        again = fg.fused_centered_gram(x, mean, rowmul, precision)
        torch.cuda.synchronize()
        counted = {k: v for k, v in fg.launches.items() if v}
        one = fg.fused_centered_gram(x, mean, rowmul, precision,
                                     _one_run=True)
        torch.cuda.synchronize()
        want = fg.fused_centered_gram_reference(x, mean, rowmul, precision)
        scale = want.abs().max().item()
        rel = (got - want).abs().max().item() / scale
        bar = fg.PLAIN_RTOL[plan.kernel]
        row = {"check": label, "precision": precision, "rows": rows, "n": n,
               "masked": masked, "row_stride": x.stride(0),
               "route": plan.route, "runs": plan.runs, "folds": plan.folds,
               "launches": counted,
               "bit_equal_one_run": same_bits(torch, got, one),
               "repeat_bit_equal": same_bits(torch, got, again),
               "rel_vs_plain": rel, "bar": bar,
               "finite": bool(torch.isfinite(got).all()),
               "symmetric": bool(torch.equal(got, got.T))}
        if plan.fold_floats:
            row["fold_floats_match"] = (fg.fold_workspace_floats(n, plan)
                                        == plan.fold_floats)
        ok = (row["bit_equal_one_run"] and row["repeat_bit_equal"]
              and rel <= bar and row["finite"] and row["symmetric"]
              and counted == {plan.kernel: 2}
              and row.get("fold_floats_match", True))
        row["ok"] = ok
        failures += not ok
        out(row)
        del x, mean, rowmul, got, again, one, want
        torch.cuda.empty_cache()
    return failures


def sweep(torch, fg, device, out, widths, row_counts, precisions):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    failures = 0
    for rows in row_counts:
        for n in widths:
            x, mean, rowmul = inputs(torch, device, rows, n, 0, 0, n)
            xs = (x - mean[None, :]) * rowmul[:, None]
            for precision in precisions:
                plan = fg.gram_plan(rows, n, precision, sms)
                got = fg.fused_centered_gram(x, mean, rowmul, precision)
                one = fg.fused_centered_gram(x, mean, rowmul, precision,
                                             _one_run=True)
                torch.cuda.synchronize()
                equal = same_bits(torch, got, one)
                failures += not equal
                del got, one
                heavy = rows * n * n > 2e12
                ms = time_ms(torch, lambda: fg.fused_centered_gram(
                    x, mean, rowmul, precision), 3 if heavy else 10)
                one_ms = time_ms(torch, lambda: fg.fused_centered_gram(
                    x, mean, rowmul, precision, _one_run=True),
                    2 if heavy or plan.route == "narrow" else 5, warmup=1)
                lib_ms = time_ms(torch, lambda: torch.matmul(xs.T, xs),
                                 3 if heavy else 10)
                enqueue_ms = host_ms(torch, lambda: fg.fused_centered_gram(
                    x, mean, rowmul, precision), 3 if heavy else 10)
                b_ms, b_by = bound_ms(rows, n, precision)
                out({"sweep": True, "precision": precision, "rows": rows,
                     "n": n, "route": plan.route, "runs": plan.runs,
                     "folds": plan.folds, "ms": ms, "one_run_ms": one_ms,
                     "matmul_ms": lib_ms, "host_enqueue_ms": enqueue_ms,
                     "bound_ms": b_ms,
                     "bound_by": b_by, "share_of_bound": b_ms / ms,
                     "bit_equal_one_run": equal})
            del x, mean, rowmul, xs
            torch.cuda.empty_cache()
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--widths", default=",".join(map(str, SWEEP_WIDTHS)),
                    help="the sweep's widths, comma-separated")
    ap.add_argument("--rows", default=",".join(map(str, SWEEP_ROWS)),
                    help="the sweep's row counts, comma-separated")
    ap.add_argument("--precisions", default=",".join(SWEEP_PRECISIONS),
                    help="the sweep's precisions, comma-separated")
    ns = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_gram_route_sweep: no CUDA device is available",
              file=sys.stderr)
        return 2
    from spark_rapids_ml_tpu_torch.ops import fused_gram as fg
    from spark_rapids_ml_tpu_torch.utils import cuda_build

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    log_path = os.path.join(ROOT, "chiprun_out", "gram_route_sweep.jsonl")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(log_path, "a") as log:
        def out(row):
            line = json.dumps(row)
            print(line, flush=True)
            log.write(line + "\n")
            log.flush()

        result = cuda_build.build("fused_gram")
        out({"card": smi_line(), "torch": torch.__version__,
             "cuda": torch.version.cuda, "nvcc_s": result.seconds,
             "cached": result.cached})
        for line in result.ptxas.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill")):
                print("   ", line.strip(), flush=True)
        failures = 0
        if ns.check:
            failures += check(torch, fg, device, out)
        if ns.sweep:
            failures += sweep(
                torch, fg, device, out,
                [int(v) for v in ns.widths.split(",")],
                [int(v) for v in ns.rows.split(",")],
                ns.precisions.split(","))
        out({"failures": failures})
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
