"""Multi-host runtime: joining the job, and each rank's share of the rows.

Counterpart of the JAX package's ``parallel/multihost.py``. The reference's
multi-node story is Spark's: executors each own one GPU and all cross-node
traffic is Spark RPC (a driver-side ``reduce`` of n×n partials,
``RapidsRowMatrix.scala:202``). Here every device is one process, the
processes join one ``torch.distributed`` process group over TCP, and the
fits' collectives run in it (NCCL between cards, gloo between CPU ranks).
The data plane (Spark, a queue, a loader) only feeds each rank its rows; it
never moves tensors.

Configuration, in order: explicit arguments, then the
``SPARK_RAPIDS_ML_TORCH_COORDINATOR`` / ``_NUM_PROCESSES`` / ``_PROCESS_ID``
environment variables (``launch.py`` sets them, and ``LOCAL_RANK``). The JAX
package has a third tier, the Cloud TPU pod metadata that
``jax.distributed.initialize`` discovers by itself; nothing on a GPU host
plays that part, so it has no counterpart here.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from spark_rapids_ml_tpu_torch.parallel.mesh import (
    BACKENDS,
    DATA_AXIS,
    data_mesh,
    mesh_device,
)
from spark_rapids_ml_tpu_torch.utils.resources import resolve_device

_ENV_COORD = "SPARK_RAPIDS_ML_TORCH_COORDINATOR"
_ENV_NPROC = "SPARK_RAPIDS_ML_TORCH_NUM_PROCESSES"
_ENV_PID = "SPARK_RAPIDS_ML_TORCH_PROCESS_ID"
_ENV_LOCAL_RANK = "LOCAL_RANK"

_initialized_coordinator: Optional[str] = None


def local_device() -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (unset: the entry points'
    usual ordinal), or the CPU when requested; raises with neither."""
    local_rank = os.environ.get(_ENV_LOCAL_RANK)
    return resolve_device(-1 if local_rank is None else int(local_rank))


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join (or skip joining) the job's process group. Idempotent.

    Returns True when the job has more than one rank after the call, False
    for a single process: with no coordinator configured anywhere it
    creates no process group at all. The device is resolved first, so
    without a card and without the CPU request this raises. On the card it
    sets ``cuda:LOCAL_RANK`` current before joining, as NCCL needs, and the
    backend is NCCL; on the CPU it is gloo.
    """
    global _initialized_coordinator
    device = local_device()
    if dist.is_initialized():
        # Reuse is only safe for the SAME job: a second collective fit in a
        # long-lived executor process may arrive with a fresh coordinator,
        # and reusing the first job's group would hang its collectives.
        requested = coordinator_address or os.environ.get(_ENV_COORD)
        if requested is not None:
            if _initialized_coordinator is None:
                _initialized_coordinator = requested
            elif requested != _initialized_coordinator:
                raise RuntimeError(
                    "torch.distributed is already initialized in this "
                    f"process with coordinator {_initialized_coordinator!r}, "
                    f"but this fit requests {requested!r}. A process joins "
                    f"one job: pre-set {_ENV_COORD} to one coordinator for "
                    "the whole session, or use a fresh process per "
                    "collective fit.")
        if dist.get_backend() != BACKENDS[device.type]:
            raise RuntimeError(
                f"the process group's backend is {dist.get_backend()!r}; "
                f"{device} needs {BACKENDS[device.type]!r}")
        return dist.get_world_size() > 1

    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if coordinator_address is None:
        return False
    if num_processes is None and os.environ.get(_ENV_NPROC):
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and os.environ.get(_ENV_PID):
        process_id = int(os.environ[_ENV_PID])
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address!r} given without the number "
            f"of processes and this process's id ({_ENV_NPROC}, {_ENV_PID})")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        BACKENDS[device.type], init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    _initialized_coordinator = coordinator_address
    return num_processes > 1


def global_data_mesh():
    """1-D ``data`` mesh over every rank of the job, in rank order, so rank
    r's rows are ``host_local_shard(n, r)``. Every rank must call it."""
    return data_mesh()


def process_info() -> dict:
    """Who am I in the job? (for logging / data-plane partition routing)."""
    initialized = dist.is_initialized()
    count = dist.get_world_size() if initialized else 1
    return {
        "process_id": dist.get_rank() if initialized else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }


def host_local_shard(
    n_rows: int,
    process_id: Optional[int] = None,
    process_count: Optional[int] = None,
) -> slice:
    """The half-open row range this rank should load, splitting ``n_rows``
    as evenly as possible (earlier ranks take the remainder, as
    ``np.array_split`` does). ``process_id`` / ``process_count`` default to
    the job's values."""
    info = process_info()
    pid = info["process_id"] if process_id is None else process_id
    pcount = info["process_count"] if process_count is None else process_count
    base, rem = divmod(n_rows, pcount)
    start = pid * base + min(pid, rem)
    stop = start + base + (1 if pid < rem else 0)
    return slice(start, stop)


class LocalShard(NamedTuple):
    x: torch.Tensor      # this rank's rows, on its device
    mask: torch.Tensor   # ones over them, x's dtype
    n_global_rows: int


def make_global_array(local_rows: np.ndarray, mesh,
                      n_global_rows: int) -> LocalShard:
    """This rank's rows placed on its device, with their mask, for
    ``distributed_pca_fit_kernel``. The JAX package assembles one global
    array from every process's rows; here each rank keeps its own and the
    fit's collectives combine them. Ranks may hold different row counts;
    their sum must be ``n_global_rows`` (checked with one ``all_reduce``
    over the ``data`` group, so every rank must call this). The host →
    device copy is timed into a ``multihost:placement`` span and the
    current fit-monitor run (``host<rank>`` seconds, a ``placement``
    collective), as the JAX seam does."""
    device = mesh_device(mesh)
    local_rows = np.asarray(local_rows)
    t0 = time.perf_counter()
    x = torch.as_tensor(local_rows, device=device).contiguous()
    t1 = time.perf_counter()
    try:
        # this rank's placement seconds are the skew/straggler input: each
        # process reports its own seam time into the live FitRun, and the
        # run's skew() compares them against the fleet median
        from spark_rapids_ml_tpu_torch.obs import fitmon, spans

        nbytes = int(local_rows.nbytes)
        spans.record_event(
            "multihost:placement", t0, t1,
            rows=int(local_rows.shape[0]), nbytes=nbytes,
        )
        run = fitmon.current_run()
        run.note_host_step(f"host{process_info()['process_id']}", t1 - t0)
        run.record_collective(
            "placement", nbytes=nbytes, count=1, seconds=t1 - t0
        )
    except Exception:
        pass
    total = torch.tensor(x.shape[0], dtype=torch.int64, device=device)
    dist.all_reduce(total, group=mesh.get_group(DATA_AXIS))
    if int(total) != n_global_rows:
        raise ValueError(
            f"the ranks hold {int(total)} rows in all, not {n_global_rows}")
    mask = torch.ones(x.shape[0], dtype=x.dtype, device=device)
    return LocalShard(x, mask, n_global_rows)
