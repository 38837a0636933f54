"""Device assignment: which CUDA device a task computes on.

Counterpart of the JAX package's ``utils/resources.py::resolve_device_ordinal``
and ``models/pca.py::_resolve_device``: ``deviceId == -1`` takes the task's
assigned ``gpu`` resource address (Spark's TaskContext resources, the
reference's gpuId discovery, ``RapidsRowMatrix.scala:171-175``), else the
``SPARK_RAPIDS_ML_TORCH_DEVICE`` env var, else ordinal 0.

Entry points run on the card. The CPU is taken only when it is asked for
explicitly with ``SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu`` (the counterpart of
``JAX_PLATFORMS=cpu``). With neither a CUDA device nor that request,
resolution raises: the port never carries on quietly on the CPU.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Mapping, Optional, Sequence

import torch

RESOURCE_NAME = "gpu"
PLATFORM_ENV = "SPARK_RAPIDS_ML_TORCH_PLATFORM"
_ENV_TASK_DEVICE = "SPARK_RAPIDS_ML_TORCH_DEVICE"
_ENV_VISIBLE = "CUDA_VISIBLE_DEVICES"


def resolve_device_ordinal(
    device_id: int = -1,
    task_resources: Optional[Mapping[str, Sequence[str]]] = None,
    env: Optional[Mapping[str, str]] = None,
) -> int:
    """Which local device ordinal a task should use.

    Precedence mirrors ``RapidsRowMatrix.scala:171-175``: an explicit
    ``deviceId != -1`` wins; otherwise the first address of the task's
    assigned ``gpu`` resource; otherwise ``SPARK_RAPIDS_ML_TORCH_DEVICE``;
    otherwise ordinal 0. ``task_resources`` maps a resource name to its
    addresses.
    """
    if device_id != -1:
        return device_id
    if task_resources and task_resources.get(RESOURCE_NAME):
        return int(task_resources[RESOURCE_NAME][0])
    env = os.environ if env is None else env
    if env.get(_ENV_TASK_DEVICE):
        return int(env[_ENV_TASK_DEVICE])
    return 0


def cpu_requested() -> bool:
    """Whether the caller asked for the CPU explicitly."""
    value = os.environ.get(PLATFORM_ENV, "cuda").strip().lower()
    if value not in ("cpu", "cuda"):
        raise ValueError(f"{PLATFORM_ENV}={value!r}: expected 'cuda' or 'cpu'")
    return value == "cpu"


def resolve_device(device_id: int = -1) -> torch.device:
    """The torch device an entry point computes on: the resolved CUDA
    ordinal, or the CPU when explicitly requested.

    A pinned executor (``CUDA_VISIBLE_DEVICES=2``) re-enumerates its one
    visible card as ordinal 0, so an assignment past the device count maps
    to that card; without pinning env that is a misrouted task, and it
    warns.
    """
    if cpu_requested():
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; set "
            f"{PLATFORM_ENV}=cpu to run on the CPU explicitly"
        )
    ordinal = resolve_device_ordinal(device_id)
    count = torch.cuda.device_count()
    if 0 <= ordinal < count:
        return torch.device("cuda", ordinal)
    if count == 1:
        if not os.environ.get(_ENV_VISIBLE):
            warnings.warn(
                f"deviceId {ordinal} does not match the single visible CUDA "
                f"device and {_ENV_VISIBLE} is not set; running on cuda:0. "
                "Check task resource assignment.",
                RuntimeWarning,
                stacklevel=2,
            )
        return torch.device("cuda", 0)
    raise ValueError(
        f"deviceId {ordinal} matches none of the {count} visible CUDA devices"
    )


def local_devices() -> List[torch.device]:
    """The port's devices: ``[cpu]`` when the CPU was requested
    (``SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu``), else every visible CUDA
    device; raises without either."""
    if cpu_requested():
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; set "
            f"{PLATFORM_ENV}=cpu to run on the CPU explicitly"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def tree_group_budget_bytes(local_est=None) -> int:
    """Tree-group memory budget of the forest fit (the JAX package's
    ``utils/resources.py::tree_group_budget_bytes``): the estimator's
    ``maxMemoryInMB`` (Spark's aggregation-memory knob, default 256 on
    the estimators; 64MB bare default), overridable by
    SPARK_RAPIDS_ML_TPU_TREE_GROUP_BYTES (the JAX package's name). Parsed
    lazily at fit time so a malformed env value fails the FIT with a
    clear message."""
    raw = os.environ.get("SPARK_RAPIDS_ML_TPU_TREE_GROUP_BYTES")
    if raw is not None:
        try:
            value = int(raw)
            if value < 1:
                raise ValueError
            return value
        except ValueError:
            raise ValueError(
                f"SPARK_RAPIDS_ML_TPU_TREE_GROUP_BYTES={raw!r}: expected "
                "a positive integer byte count"
            ) from None
    if local_est is not None and local_est.has_param("maxMemoryInMB"):
        return int(local_est.get_or_default("maxMemoryInMB")) * 1024 * 1024
    return 64 * 1024 * 1024
