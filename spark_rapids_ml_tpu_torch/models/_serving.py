"""Shared ``ServingProgram`` construction for the pipelined serving hook,
plus the fused whole-pipeline program.

Counterpart of the JAX package's ``models/_serving.py`` (its single-model
and fused-pipeline parts; the batch-sharded builder waits for a
multi-device tier in the port). A model contributes only its kernel table
and its per-precision weights, staged on the device once per program;
this module resolves the device and dtype and wraps put / run / fetch into
an ``obs.serving.ServingProgram``.

On the card every program on a device shares one pair of CUDA streams
(``serving_streams``), made on the first build and captured by each
program's closures, so whichever thread calls them (the batcher's
worker) works on them explicitly rather than on its current stream.
The pair is shared, not made per program, because PyTorch caches a
cuBLAS workspace (32 MiB on Hopper) for each (thread's handle, stream)
pair it meets and never frees it: fresh streams per program would add
workspaces on every rebuild (a tiering reactivation, a new version),
outside the bytes the cost ledger accounts. The handle half of the key
is the calling thread's, held until that thread ends, so device work a
caller does beside the batcher (a warmup, a precision check) runs
through ``on_serving_thread``: on a short-lived thread of its own, whose
handle goes back to PyTorch's pool, serving-stream workspace and all,
for the batcher worker that serves next. On the pair:

* ``put`` copies a staged (pinned) host batch to the card with
  ``non_blocking=True`` on the copy stream and records an event;
* ``run`` makes the compute stream wait on that event, marks the batch
  as used there (``record_stream``: it was allocated on the copy stream)
  and launches the product with no host sync;
* ``fetch`` is the only sync: a device→host copy into pinned memory on
  the compute stream, a wait on its event, then ``fetch_dtype``.

On a card ``put`` and ``fetch`` each run inside a ``torch.profiler``
range (``PUT_RANGE``, ``FETCH_RANGE``), so a capture can tie each copy
the runtime was asked for to the batch step that issued it.

Every ``run`` counts ``sparkml_serve_program_runs_total{algo, precision,
device}`` with the device of the tensor it was handed, so a caller can
tell from the metrics that every batch ran on the card.

**Fused pipelines.** A ``PipelineModel.transform`` pays one host round
trip per stage. Models also expose ``serving_stage(precision=...)``
returning a ``ServingStage``: the stage's device function plus its
device-staged weights. The JAX package composes a chain of them into one
XLA program, which fuses the elementwise stages into the products. Eager
PyTorch has no such compiler step; what the port keeps is the property
that program exists for: ``build_fused_pipeline_program`` is ONE ``put``,
ONE ``run`` that chains every stage body on the serving compute stream
with no host sync between them, and ONE ``fetch``, so a batch makes one
host round trip however many stages it has. ``run_staged_pipeline`` is
the N-round-trip reference, built from the SAME stage bodies, with a
device→host→device copy between stages, on the same serving stream.
"""

from __future__ import annotations

import contextvars
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from spark_rapids_ml_tpu_torch.obs.metrics import get_registry
from spark_rapids_ml_tpu_torch.obs.serving import DeviceBatch, ServingProgram

# profiler ranges around a card program's put and fetch
PUT_RANGE = "sparkml.serve.put"
FETCH_RANGE = "sparkml.serve.fetch"


class ServingStage(NamedTuple):
    """One model's composable contribution to a fused pipeline program:
    ``fn(x_dev, *weights) → y_dev``, the device function, with its
    device-staged ``weights``; ``terminal`` marks output-typed stages that
    can only sit last; ``fetch_dtype`` is the host dtype of a last
    stage's output."""

    fn: Callable
    weights: Tuple
    algo: str
    terminal: bool = False
    fetch_dtype: Optional[np.dtype] = None


def resolve_serving_context(model=None, device=None):
    """``(device, dtype)`` for a model's serving program: the model's
    resolved device (the card unless the CPU was asked for; see
    ``utils/resources.py``) and transform dtype. An explicit ``device``
    overrides the model's own resolution. (The JAX package also returns
    whether to donate the staged input; PyTorch has no donation.)"""
    from spark_rapids_ml_tpu_torch.models.pca import _resolve_dtype
    from spark_rapids_ml_tpu_torch.utils.resources import resolve_device

    get_dt = getattr(model, "getDtype", None)
    dtype = _resolve_dtype(get_dt() if callable(get_dt) else "auto")
    if device is None:
        get_dev = getattr(model, "getDeviceId", None)
        device = resolve_device(get_dev() if callable(get_dev) else -1)
    return torch.device(device), dtype


def staged_weight_bytes(weights) -> int:
    """Device bytes a program's staged constant weights occupy: each
    staged tensor's ``nbytes`` (weightless entries count 0)."""
    return sum(int(getattr(w, "nbytes", 0) or 0) for w in weights)


_STREAMS: Dict[torch.device, Tuple["torch.cuda.Stream",
                                   "torch.cuda.Stream"]] = {}
_STREAMS_LOCK = threading.Lock()


def serving_streams(device) -> Tuple["torch.cuda.Stream",
                                     "torch.cuda.Stream"]:
    """The (copy, compute) CUDA stream pair every serving program on
    ``device`` shares (see the module docstring), made on first use."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    with _STREAMS_LOCK:
        pair = _STREAMS.get(device)
        if pair is None:
            pair = (torch.cuda.Stream(device=device),
                    torch.cuda.Stream(device=device))
            _STREAMS[device] = pair
        return pair


def on_serving_thread(device, fn: Callable):
    """``fn()`` on a CUDA ``device``'s serving compute stream, run on a
    thread of its own that ends before this returns (see the module
    docstring); inline when ``device`` is None or not CUDA. Returns what
    ``fn`` returns and raises what it raises."""
    if device is None or torch.device(device).type != "cuda":
        return fn()
    stream = serving_streams(device)[1]
    ctx = contextvars.copy_context()
    out: Dict[str, object] = {}

    def work():
        try:
            with torch.cuda.stream(stream):
                out["value"] = ctx.run(fn)
        except BaseException as exc:  # noqa: BLE001 - raised by the caller
            out["error"] = exc

    thread = threading.Thread(target=work, name="sparkml-serve-device",
                              daemon=True)
    thread.start()
    thread.join()
    if "error" in out:
        raise out["error"]
    return out["value"]


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def build_serving_program(
    *,
    device,
    dtype: torch.dtype,
    algo: str,
    precision: str,
    kernels: Dict[str, Callable],
    weights: Tuple,
    fetch_dtype: Optional[np.dtype] = None,
) -> ServingProgram:
    """The shared put / run / fetch assembly (see the module docstring).

    ``kernels`` maps precision → kernel; ``weights`` are the device-staged
    constant operands the kernel takes after the batch (already cast or
    quantized for this precision); ``fetch_dtype`` is the host dtype of
    the fetched output (None keeps the device result's own). Raises
    ``ValueError`` for an unknown precision.
    """
    kernel = kernels.get(precision)
    if kernel is None:
        raise ValueError(
            f"unknown serving precision {precision!r} "
            f"(one of {sorted(kernels)})"
        )
    return _assemble_program(
        device=device, dtype=dtype, algo=algo, precision=precision,
        call=lambda x: kernel(x, *weights),
        weight_bytes=staged_weight_bytes(weights), fetch_dtype=fetch_dtype)


def _assemble_program(*, device, dtype: torch.dtype, algo: str,
                      precision: str, call: Callable[[torch.Tensor],
                                                     torch.Tensor],
                      weight_bytes: int, fetch_dtype: Optional[np.dtype],
                      count: bool = True) -> ServingProgram:
    """put / run / fetch around ``call(batch) → output`` on ``device``'s
    serving streams; ``count=False`` leaves the runs counter alone (the
    staged reference is not served traffic)."""
    device = torch.device(device)
    host_dtype = _numpy_dtype(dtype)
    runs = get_registry().counter(
        "sparkml_serve_program_runs_total",
        "serving-program launches by the device of the batch tensor",
        ("algo", "precision", "device"),
    )

    def counted(x: torch.Tensor) -> None:
        if count:
            runs.inc(algo=algo, precision=precision, device=x.device.type)

    def finish(out: np.ndarray) -> np.ndarray:
        if fetch_dtype is None:
            return out
        return out.astype(fetch_dtype, copy=False)

    if device.type == "cuda":
        copy_stream, compute_stream = serving_streams(device)

        def put(matrix):
            host = torch.from_numpy(np.ascontiguousarray(matrix,
                                                         dtype=host_dtype))
            with record_function(PUT_RANGE), torch.cuda.stream(copy_stream):
                x = torch.empty(host.shape, dtype=dtype, device=device)
                x.copy_(host, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(copy_stream)
            return DeviceBatch(x, copied)

        def run(batch: DeviceBatch):
            x = batch.tensor
            compute_stream.wait_event(batch.copied)
            # allocated on the copy stream: without this the allocator
            # could hand its memory to the next copy while the product
            # still reads it
            x.record_stream(compute_stream)
            with torch.cuda.stream(compute_stream):
                out = call(x)
            counted(x)
            return out

        def fetch(out: torch.Tensor) -> np.ndarray:
            with record_function(FETCH_RANGE), \
                    torch.cuda.stream(compute_stream):
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record(compute_stream)
                done.synchronize()
            return finish(host.numpy())
    else:
        def put(matrix):
            # a copy, as a device transfer would be: the batch never
            # aliases a staging buffer or a (read-only) request
            return DeviceBatch(torch.tensor(np.asarray(matrix), dtype=dtype,
                                            device=device))

        def run(batch: DeviceBatch):
            x = batch.tensor
            out = call(x)
            counted(x)
            return out

        def fetch(out: torch.Tensor) -> np.ndarray:
            return finish(out.numpy())

    return ServingProgram(put=put, run=run, fetch=fetch, dtype=host_dtype,
                          algo=algo, precision=precision, prime=None,
                          weight_bytes=weight_bytes, device=device)


def build_host_stat_stage(model, fn, host_weights, algo: str,
                          device, dtype) -> ServingStage:
    """Shared ``serving_stage`` assembly for the host-statistics families
    (the scalers): the per-feature constants staged on the device once,
    the elementwise body left as it is for the pipeline composer. Every
    precision shares the native body (the product stages carry the
    reduced ones). Float constants stage at the chain dtype; integer
    index arrays and boolean masks keep their own dtype."""
    if device is None or dtype is None:
        device, dtype = resolve_serving_context(model)
    weights = tuple(
        torch.as_tensor(np.asarray(w), device=device,
                        dtype=dtype if np.issubdtype(np.asarray(w).dtype,
                                                     np.floating) else None)
        for w in host_weights
    )
    return ServingStage(fn=fn, weights=weights, algo=algo,
                        fetch_dtype=np.dtype(np.float64))


# -- whole-pipeline fusion ---------------------------------------------------


def resolve_pipeline_context(stages, device=None):
    """The shared ``(device, dtype)`` a fused pipeline stages every weight
    under: the first stage carrying device params decides (a pipeline
    mixing device preferences is already incoherent for one program); an
    all-host-statistics chain falls back to the defaults. ``device``
    overrides the resolution, as in ``resolve_serving_context``."""
    for stage in stages:
        if callable(getattr(stage, "getDeviceId", None)) and callable(
                getattr(stage, "getDtype", None)):
            return resolve_serving_context(stage, device=device)
    return resolve_serving_context(None, device=device)


def collect_pipeline_stages(stages, precision: str, *, device, dtype,
                            ) -> Optional[List[ServingStage]]:
    """Every stage's ``ServingStage`` at ``precision`` under the shared
    device/dtype, or None when the chain is not fusable: a stage without
    the hook, a hook declining (returning None), or an output-typed
    (``terminal``) stage anywhere but last — labels cannot feed a
    downstream transformer."""
    specs: List[ServingStage] = []
    last = len(stages) - 1
    for i, stage in enumerate(stages):
        hook = getattr(stage, "serving_stage", None)
        if not callable(hook):
            return None
        spec = hook(precision=precision, device=device, dtype=dtype)
        if spec is None:
            return None
        if spec.terminal and i < last:
            return None
        specs.append(spec)
    return specs or None


def _chain(specs: List[ServingStage]) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    def run_chain(x: torch.Tensor) -> torch.Tensor:
        for spec in specs:
            x = spec.fn(x, *spec.weights)
        return x

    return run_chain


def build_fused_pipeline_program(
    *,
    device,
    dtype: torch.dtype,
    stages: List[ServingStage],
    precision: str,
    algo: str = "pipeline",
) -> ServingProgram:
    """ONE ``ServingProgram`` for a whole stage chain: one ``put``, one
    ``run`` threading the batch through every stage body on the serving
    compute stream with no host sync between stages, one ``fetch`` (see
    the module docstring). The weights are each stage's, staged once."""
    flat_weights = tuple(w for s in stages for w in s.weights)
    return _assemble_program(
        device=device, dtype=dtype, algo=algo, precision=precision,
        call=_chain(stages), weight_bytes=staged_weight_bytes(flat_weights),
        fetch_dtype=stages[-1].fetch_dtype)


def run_staged_pipeline(model, x, precision: str = "native") -> np.ndarray:
    """The N-round-trip reference: each composable stage as a program of
    its own (put → run → fetch), with the host holding every intermediate
    result, from the SAME stage bodies as the fused program, on the same
    serving streams (through ``on_serving_thread``), so the fused program
    can be held bit-equal to it. Raises ``ValueError`` when the pipeline
    is not fusable (mirrors the hook declining)."""
    stages = getattr(model, "stages", None) or []
    device, dtype = resolve_pipeline_context(stages)
    specs = collect_pipeline_stages(stages, precision,
                                    device=device, dtype=dtype)
    if not specs:
        raise ValueError("pipeline has no fusable stage chain")

    def staged() -> np.ndarray:
        out = np.asarray(x)
        for i, spec in enumerate(specs):
            stage_dtype = (torch.from_numpy(np.ascontiguousarray(out[:0]))
                           .dtype if i else dtype)
            program = _assemble_program(
                device=device, dtype=stage_dtype, algo=spec.algo,
                precision=precision, call=_chain([spec]), weight_bytes=0,
                fetch_dtype=None, count=False)
            # the host round trip between stages IS the point of comparison
            out = program.fetch(program.run(program.put(out)))
        return out

    out = on_serving_thread(device, staged)
    if specs[-1].fetch_dtype is not None:
        out = out.astype(specs[-1].fetch_dtype, copy=False)
    return out
