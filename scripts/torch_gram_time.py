#!/usr/bin/env python3
"""Time the PyTorch port's Gram kernel from the checkout this script is in,
on one CUDA card.

    python3 scripts/torch_gram_time.py --precision highest --rows 8192 --n 4096

Builds the checkout's ``csrc/fused_gram.cu`` if needed, makes centred
inputs from a seed on the card, and prints one JSON line: the card, the
checkout, the shape, the precision and the mean CUDA-event time of
``fused_centered_gram`` over ``--iters`` calls after three warm-up calls.
To compare two checkouts, run each one's copy of the script in turns (A, B,
B, A) in one command on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--precision", default="bfloat16_3x",
                    choices=("highest", "bfloat16", "bfloat16_3x"))
    ap.add_argument("--rows", type=int, default=8192)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ns = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_gram_time: no CUDA device is available", file=sys.stderr)
        return 2
    from spark_rapids_ml_tpu_torch.ops import fused_gram as fg

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(ns.seed)
    x = torch.randn(ns.rows, ns.n, generator=gen, device=device) + 0.5
    mean = x.mean(0)
    rowmul = torch.full((ns.rows,), (ns.rows - 1) ** -0.5, device=device)

    def call():
        return fg.fused_centered_gram(x, mean, rowmul, ns.precision)

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ns.iters):
        call()
    end.record()
    torch.cuda.synchronize()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "checkout": ROOT,
        "precision": ns.precision, "rows": ns.rows, "n": ns.n,
        "iters": ns.iters, "ms": start.elapsed_time(end) / ns.iters,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
