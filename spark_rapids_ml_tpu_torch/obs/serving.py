"""The pipelined serving path's program contract and per-batch record.

The port's cut of the JAX package's ``obs/serving.py``: ``ServingProgram``
(the put / run / fetch split the micro-batcher overlaps across batches) and
``PipelineTransform``, a per-batch latency record that feeds
``sparkml_transform_latency_seconds`` and the transform counters. The
JAX package's ``TransformReport``, numerics sentinel, flight deadlines and
spans are not ported yet.
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np

from spark_rapids_ml_tpu_torch.obs.metrics import get_registry

LATENCY_SUMMARY = "sparkml_transform_latency_seconds"
LATENCY_QUANTILES = (0.5, 0.9, 0.95, 0.99)


class ServingProgram(NamedTuple):
    """A model's device-resident serving program for the pipelined
    micro-batcher (``serve.batching``), split into three steps:

    * ``put(host_matrix) → device batch`` — start the host→device copy of
      a staged (bucket, d) batch (on the card: a copy stream, pinned
      source, ``non_blocking``, an event recorded after it);
    * ``run(device batch) → device result`` — launch the product on the
      compute stream, which first waits on the copy's event; no host sync;
    * ``fetch(device result) → np.ndarray`` — the only host sync: a
      device→host copy and a wait on its event, then ``fetch_dtype``.

    ``dtype`` is the numpy dtype the batcher stages requests in;
    ``algo`` labels the per-batch record; ``precision`` names the ladder
    (native / bf16 / int8); ``device`` is where the weights live;
    ``prime`` is a compile-without-execute hook, None here (nothing to
    compile ahead); ``weight_bytes`` the device bytes of the staged
    weights.
    """

    put: Callable[[np.ndarray], Any]
    run: Callable[[Any], Any]
    fetch: Callable[[Any], np.ndarray]
    dtype: Any
    algo: str
    precision: str = "native"
    prime: Optional[Callable[[Any], bool]] = None
    weight_bytes: int = 0
    device: Any = None


class DeviceBatch(NamedTuple):
    """What ``ServingProgram.put`` returns: the batch on the device and
    the event its copy recorded (None where the copy is synchronous). The
    batcher ties its staging slot's reuse to ``copied``."""

    tensor: Any
    copied: Any = None


class PipelineTransform:
    """Per-batch record for the pipelined serving path: on ``finish`` the
    batch's wall time (stage to completion) goes into
    ``sparkml_transform_latency_seconds{algo}`` with the transform and row
    counters — or, for a failed batch, the error counter (failed batches
    never feed the latency summary). The per-stage split lives in the
    batcher's ``sparkml_serve_stage_latency_seconds``."""

    __slots__ = ("algo", "_t0")

    def __init__(self, algo: str):
        self.algo = algo
        self._t0 = time.perf_counter()

    def finish(self, *, rows: Optional[int] = None,
               error: Optional[BaseException] = None) -> None:
        """Close the batch: count it, and a successful one's latency."""
        reg = get_registry()
        if error is not None:
            reg.counter(
                "sparkml_transform_errors_total",
                "transform/predict calls that raised", ("algo", "error"),
            ).inc(algo=self.algo, error=type(error).__name__)
            return
        reg.counter(
            "sparkml_transforms_total", "completed transform/predict calls",
            ("algo",),
        ).inc(algo=self.algo)
        reg.summary(
            LATENCY_SUMMARY, "transform/predict call latency", ("algo",),
            quantiles=LATENCY_QUANTILES,
        ).observe(time.perf_counter() - self._t0, algo=self.algo)
        if rows:
            reg.counter(
                "sparkml_rows_transformed_total", "rows seen by transforms",
                ("algo",),
            ).inc(rows, algo=self.algo)
