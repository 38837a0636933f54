#!/usr/bin/env python3
"""Does a ``torch.profiler`` capture leave a cost behind in the serving
process? Measures the PyTorch port on one CUDA card.

    python3 scripts/torch_capture_cost.py

Serves a random 4096 x 256 PCA model from a ``ServeEngine`` and measures
two things at each step: the host time of one small ``add_`` on the card
(20,000 in a row, after a synchronize), and the rate of 256 requests of
1-369 rows sent from 8 threads. Each is taken three times. The steps are
two baselines before any capture, then after a plain capture, after one
with ``profile_all_threads`` (as ``chip_smoke.py::copies_per_batch``
takes) and after a second plain capture. Each capture records 8 served
requests. Prints the card's name and power limit, then one line a step.
"""

from __future__ import annotations

import concurrent.futures
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_ml_tpu_torch import PCAModel
    from spark_rapids_ml_tpu_torch.serve import ModelRegistry, ServeEngine

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    if shutil.which("nvidia-smi"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip())
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    pc = np.linalg.qr(rng.normal(size=(4096, 256)))[0]
    registry = ModelRegistry()
    registry.register("m", PCAModel.from_numpy(pc, np.ones(256)))
    engine = ServeEngine(registry, max_batch_rows=1024, pipeline_depth=2)
    engine.warmup("m")
    requests = [rng.normal(size=(int(n), 4096)).astype(np.float32)
                for n in rng.integers(1, 370, 256)]
    small = torch.ones(16, device=device)

    def per_op_us():
        for _ in range(200):
            small.add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20000):
            small.add_(1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 20000 * 1e6

    def rate():
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda r: engine.predict("m", r), requests))
        return len(requests) / (time.perf_counter() - t0)

    def capture(all_threads):
        extra = ({"experimental_config": _ExperimentalConfig(
            profile_all_threads=True)} if all_threads else {})
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], **extra):
            for r in requests[:8]:
                engine.predict("m", r)
            torch.cuda.synchronize()

    steps = (("before any capture", None),
             ("before any capture, again", None),
             ("after a plain capture", False),
             ("after a profile_all_threads capture", True),
             ("after a second plain capture", False))
    try:
        for step, all_threads in steps:
            if all_threads is not None:
                capture(all_threads)
            ops = [round(per_op_us(), 3) for _ in range(3)]
            rates = [round(rate(), 1) for _ in range(3)]
            print(f"{step}: per add_ {ops} us, requests/s {rates}",
                  flush=True)
    finally:
        engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
