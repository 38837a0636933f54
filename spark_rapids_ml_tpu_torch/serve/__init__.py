"""The serving engine: model registry, shape-bucketed dynamic batching,
a stdlib HTTP front end — and the fault-tolerance layer that keeps it
answering when the device does not.

The port's counterpart of the JAX package's ``serve`` package, cut to what
one model on one card needs:

* ``ModelRegistry`` (``serve.registry``) — register / alias / version
  fitted models, load them through the port's ``io.persistence``, warm
  them at their shape buckets; with a ``manifest_path`` it persists its
  deployment state and recovers it after a crash;
* ``MicroBatcher`` (``serve.batching``) — coalesce concurrent requests,
  pad to row buckets in pinned staging buffers, run ONE program per
  bucket, split results per request; a pipelined inner loop over the
  model's ``ServingProgram`` (copy of batch N+1 on a copy stream while N
  computes), a supervised worker (crash restart, wedge watchdog,
  ``WorkerCrashed``);
* ``AdmissionController`` (``serve.admission``) and the fair scheduler
  (``serve.scheduler``) — requests carry a tenant id and a priority class;
  per-tenant token-bucket quotas tag over-quota work, a hysteresis shed
  controller over the SLO fast burn, queue wait and queue depth sheds only
  over-quota work (``ShedLoad`` → HTTP 503 + ``Retry-After``), and each
  batcher's ``FairQueue`` orders requests by start-time fair queuing over
  row-cost virtual time, preempting lower-ranked work on a full queue;
* ``ServeEngine`` (``serve.engine``) — bounded queues, deadlines, drain,
  retries with backoff, a per-model circuit breaker (``serve.breaker``),
  the degraded CPU fallback (``serve.fallback``), the NaN guard, and the
  bf16 / int8 precision ladder behind an offline max-error check;
* ``fault_plane`` (``serve.faults``) — deterministic fault injection that
  rehearses all of the above;
* ``TieringController`` (``serve.tiering``) — parks the coldest models
  off the card under a byte budget, ranked by the cost ledger
  (``obs.accounting``), and brings one back on its first request
  through admission's gate;
* ``start_serve_server`` (``serve.server``) — ``POST /predict`` (JSON and
  the binary columnar wire format, ``serve.wire``), ``GET /healthz``,
  ``/readyz``, ``/metrics`` and the debug plane ``/debug/traces``,
  ``/debug/slo``, ``/debug/history`` (the history sampler, which it
  starts, with the device monitor as a collector), ``/debug/costs`` and
  ``/debug/tiering``.
"""

# Import order as in the JAX package: ``faults`` / ``breaker`` /
# ``fallback`` have no intra-package dependencies and initialize before
# ``batching`` / ``engine``, which import them.
from spark_rapids_ml_tpu_torch.serve.faults import (  # noqa: F401
    FaultPlane,
    FaultSpec,
    InjectedBackendError,
    InjectedWorkerCrash,
    fault_plane,
    reset_fault_plane,
)
from spark_rapids_ml_tpu_torch.serve.breaker import (  # noqa: F401
    BreakerOpen,
    CircuitBreaker,
    breaker_events,
)
from spark_rapids_ml_tpu_torch.serve.fallback import cpu_fallback  # noqa: F401
from spark_rapids_ml_tpu_torch.serve.admission import (  # noqa: F401
    AdmissionController,
    ShedController,
    ShedLoad,
    TokenBucket,
)
from spark_rapids_ml_tpu_torch.serve.scheduler import (  # noqa: F401
    FairQueue,
    FifoQueue,
    fair_scheduling_from_env,
)
from spark_rapids_ml_tpu_torch.serve.batching import (  # noqa: F401
    AsyncTransformSpec,
    BatcherClosed,
    DeadlineExpired,
    MicroBatcher,
    QueueFull,
    WaitTimeout,
    WorkerCrashed,
)
from spark_rapids_ml_tpu_torch.serve.engine import (  # noqa: F401
    EngineClosed,
    NumericsError,
    PredictResult,
    ServeEngine,
    extract_output,
)
from spark_rapids_ml_tpu_torch.serve.registry import (  # noqa: F401
    ModelRegistry,
    RegisteredModel,
)
from spark_rapids_ml_tpu_torch.serve.server import (  # noqa: F401
    make_handler,
    start_serve_server,
)
from spark_rapids_ml_tpu_torch.serve.tiering import (  # noqa: F401
    TieringController,
)

__all__ = [
    "AdmissionController",
    "AsyncTransformSpec",
    "BatcherClosed",
    "BreakerOpen",
    "CircuitBreaker",
    "DeadlineExpired",
    "EngineClosed",
    "FairQueue",
    "FaultPlane",
    "FaultSpec",
    "FifoQueue",
    "InjectedBackendError",
    "InjectedWorkerCrash",
    "MicroBatcher",
    "ModelRegistry",
    "NumericsError",
    "PredictResult",
    "QueueFull",
    "RegisteredModel",
    "ServeEngine",
    "ShedController",
    "ShedLoad",
    "TieringController",
    "TokenBucket",
    "WaitTimeout",
    "WorkerCrashed",
    "breaker_events",
    "cpu_fallback",
    "extract_output",
    "fair_scheduling_from_env",
    "fault_plane",
    "make_handler",
    "reset_fault_plane",
    "start_serve_server",
]
