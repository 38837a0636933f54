#!/usr/bin/env python3
"""Time shapes of the PyTorch port's narrow Gram kernel on one CUDA card.

    python3 scripts/torch_narrow_variants.py

``csrc/fused_gram.cu``'s narrow route (highest, n ≤ 64) has a few shape
constants: the block of the upper triangle each compute thread owns
(``NW_TR`` × ``NW_TC``), the rows of a chunk (``NW_ROWS``), the chunks in
its shared-memory ring (``NW_STAGES``) and the k-loop's unroll
(``NW_UNROLL``). This script compiles copies of the checkout's source with
other values into a temporary directory (``nvcc``, in parallel), calls each
copy's narrow route through its C entry point on the same inputs, checks its
G bit-equal to the checkout's own constants' result, and prints one JSON
line per (variant, shape): the mean device time over 20 calls with the card
held busy while the host enqueues them. The card's name and power limit
come first. The checkout's source is not changed.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "spark_rapids_ml_tpu_torch", "csrc")

# label: constant → value ("as built" keeps the checkout's values)
VARIANTS = {
    "as built": {},
    "2x4": {"NW_TR": 2, "NW_TC": 4},
    "2x2": {"NW_TR": 2, "NW_TC": 2},
    "1x4": {"NW_TR": 1, "NW_TC": 4},
    "4x4": {"NW_TR": 4, "NW_TC": 4},
    "unroll 4": {"NW_UNROLL": 4},
    "unroll 64": {"NW_UNROLL": 64},
    "128-row chunks, 3 stages": {"NW_ROWS": 128, "NW_STAGES": 3},
}
SHAPES = [(65_536, 1), (65_536, 28), (65_536, 64), (2_097_152, 28),
          (2_097_152, 33), (2_097_152, 64)]
SLEEP_CYCLES = 90_000_000


def source(values: dict) -> str:
    text = open(os.path.join(CSRC, "fused_gram.cu")).read()
    for name, value in values.items():
        text, count = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
        if count != 1:
            raise RuntimeError(f"no constant {name} in fused_gram.cu")
    return text


def build(args):
    label, values, workdir = args
    sys.path.insert(0, ROOT)
    from spark_rapids_ml_tpu_torch.utils import cuda_build

    tag = re.sub(r"\W+", "_", label)
    cu = os.path.join(workdir, f"{tag}.cu")
    with open(cu, "w") as f:
        f.write(source(values))
    so = os.path.join(workdir, f"{tag}.so")
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", so, cu,
         *cuda_build.LINK_FLAGS], capture_output=True, text=True)
    lines = proc.stderr.splitlines()
    report = [" ".join(line.strip() for line in lines[i + 1:i + 3])
              for i, line in enumerate(lines) if "gram_narrow" in line]
    return label, so, proc.returncode, report or proc.stderr[-2000:]


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_narrow_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    print(json.dumps({"card": smi.strip().splitlines()[0]}), flush=True)
    device = torch.device("cuda", 0)
    workdir = tempfile.mkdtemp(prefix="narrow_variants_")
    try:
        shutil.copy(os.path.join(CSRC, "hopper_ptx.cuh"), workdir)
        with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
            built = list(pool.map(build, [(k, v, workdir)
                                          for k, v in VARIANTS.items()]))
        inputs = {}
        for rows, n in SHAPES:
            gen = torch.Generator(device=device).manual_seed(n)
            x = torch.randn(rows, n, generator=gen, device=device) + 0.5
            inputs[(rows, n)] = (x, x.mean(0).contiguous(),
                                 torch.full((rows,), (rows - 1) ** -0.5,
                                            device=device))
        want, failures = {}, 0
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for label, so, rc, report in built:
            print(json.dumps({"variant": label, "nvcc_rc": rc,
                              "ptxas": report}), flush=True)
            if rc:
                failures += 1
                continue
            lib = ctypes.CDLL(so)
            gram = lib.tpuml_fused_centered_gram
            gram.argtypes = [ptr, i64, ptr, ptr, ptr, i32, i32, i32, ptr,
                             i32, ptr, i32, i32, ptr]
            gram.restype = i32
            floats = lib.tpuml_gram_fold_floats
            floats.argtypes = [i32, i32, i32, i32]
            floats.restype = i64
            for (rows, n), (x, mean, rowmul) in inputs.items():
                kp = -(-rows // 64) * 64
                folds = -(-kp // 8192)
                g = torch.empty(n, n, device=device)
                fold = torch.empty(floats(n, folds, folds, 1), device=device)
                stream = torch.cuda.current_stream().cuda_stream

                def call():
                    return gram(x.data_ptr(), n, mean.data_ptr(),
                                rowmul.data_ptr(), g.data_ptr(), rows, n, 0,
                                None, kp, fold.data_ptr(), folds, 1, stream)

                if call() != 0:
                    raise RuntimeError(f"{label}: launch failed at {rows}x{n}")
                torch.cuda.synchronize()
                got = g.clone()
                want.setdefault((rows, n), got)
                same = torch.equal(got.view(torch.int32),
                                   want[(rows, n)].view(torch.int32))
                failures += not same
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(SLEEP_CYCLES)
                start.record()
                for _ in range(20):
                    call()
                end.record()
                torch.cuda.synchronize()
                print(json.dumps({"variant": label, "rows": rows, "n": n,
                                  "ms": start.elapsed_time(end) / 20,
                                  "bit_equal_as_built": same}), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"failures": failures}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
