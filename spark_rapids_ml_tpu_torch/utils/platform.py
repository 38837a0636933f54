"""Per-device-kind peak tables: the denominators of every MFU and roofline
figure the port reports (``obs.xprof``, ``obs.fitmon``).

The port's copy of the two tables in the JAX package's
``utils/platform.py``, keyed by ``torch.cuda.get_device_name()`` instead of
a PJRT ``device_kind``. Unknown kinds, the CPU included, report None rather
than a made-up number.
"""

from __future__ import annotations

from typing import Optional

import torch

from spark_rapids_ml_tpu_torch.utils.resources import cpu_requested

# Peak dense FLOP/s per card by device kind (bf16 tensor cores). NVIDIA's
# published H100 SXM data-sheet figure, dense (no sparsity), at the full
# 700 W power limit: a published peak, not a measurement. A card set below
# 700 W reaches less.
PEAK_FLOPS_BF16 = {
    "NVIDIA H100 80GB HBM3": 989e12,
}

# Peak HBM bandwidth (bytes/s) per card by device kind — the roofline's
# second axis. A step whose arithmetic intensity (FLOPs / bytes accessed)
# sits below the ridge point ``peak_flops / peak_bw`` is memory-bound;
# above it, compute-bound. Same source and contract as the FLOPs table.
PEAK_HBM_BYTES_PER_SECOND = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def device_kind() -> Optional[str]:
    """This process's card name (``torch.cuda.get_device_name`` of the
    current device), or None on the CPU: when the CPU was asked for
    (``SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu``) or there is no card."""
    if cpu_requested() or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(torch.cuda.current_device())


__all__ = ["PEAK_FLOPS_BF16", "PEAK_HBM_BYTES_PER_SECOND", "device_kind"]
