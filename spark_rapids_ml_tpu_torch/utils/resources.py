"""Spark-style GPU resource discovery and device assignment.

Counterpart of the JAX package's ``utils/resources.py``. Spark schedules
GPUs as the resource ``gpu``: ``spark.task.resource.gpu.amount``,
``spark.executor.resource.gpu.amount`` and a
``spark.executor.resource.gpu.discoveryScript`` that prints Spark's
ResourceInformation JSON (the reference's deployment contract and its
``getGpusResources.sh``). The script ships as package data
(``discovery_script_path()``) and needs no Python;
``discover_gpu_addresses`` reads the same signals in process, and asks
torch only on request.

Which CUDA device a task computes on: ``deviceId == -1`` takes the task's
assigned ``gpu`` resource address (Spark's TaskContext resources, the
reference's gpuId discovery, ``RapidsRowMatrix.scala:171-175``), else the
``SPARK_RAPIDS_ML_TORCH_DEVICE`` env var, else ordinal 0.

Entry points run on the card. The CPU is taken only when it is asked for
explicitly with ``SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu`` (the counterpart of
``JAX_PLATFORMS=cpu``). With neither a CUDA device nor that request,
resolution raises: the port never carries on quietly on the CPU.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Union

import torch

RESOURCE_NAME = "gpu"
PLATFORM_ENV = "SPARK_RAPIDS_ML_TORCH_PLATFORM"
_ENV_TASK_DEVICE = "SPARK_RAPIDS_ML_TORCH_DEVICE"
_ENV_VISIBLE = "CUDA_VISIBLE_DEVICES"

# Spark's own conf keys for GPU scheduling
TASK_AMOUNT_KEY = "spark.task.resource.gpu.amount"
EXECUTOR_AMOUNT_KEY = "spark.executor.resource.gpu.amount"
DISCOVERY_SCRIPT_KEY = "spark.executor.resource.gpu.discoveryScript"


@dataclass
class ResourceInformation:
    """Mirror of ``org.apache.spark.resource.ResourceInformation``: the
    JSON shape a discovery script must print."""

    name: str
    addresses: List[str] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps({"name": self.name, "addresses": self.addresses})

    @staticmethod
    def from_json(text: str) -> "ResourceInformation":
        obj = json.loads(text)
        if not isinstance(obj.get("name"), str) or not isinstance(
            obj.get("addresses"), list
        ):
            raise ValueError(f"not a ResourceInformation payload: {text!r}")
        return ResourceInformation(
            name=obj["name"], addresses=[str(a) for a in obj["addresses"]]
        )


class ResourceConf:
    """A properties mapping (``spark.*`` keys) with typed accessors for the
    gpu resource keys."""

    def __init__(self, conf: Optional[Mapping[str, str]] = None):
        self._conf: Dict[str, str] = dict(conf or {})

    @staticmethod
    def from_properties(text: str) -> "ResourceConf":
        """Parse ``key value`` / ``key=value`` lines (spark-defaults.conf
        syntax: comments with #, blank lines ignored)."""
        conf: Dict[str, str] = {}
        for raw in text.splitlines():
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            # split at the FIRST separator so values containing '=' (java
            # options, paths) survive intact
            m = re.match(r"^([^=\s]+)\s*[=\s]\s*(.*)$", line)
            if m:
                conf[m.group(1)] = m.group(2).strip()
        return ResourceConf(conf)

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._conf.get(key, default)

    def task_gpu_amount(self, default: float = 0.0) -> float:
        return float(self.get(TASK_AMOUNT_KEY, str(default)))

    def executor_gpu_amount(self, default: int = 0) -> int:
        return int(float(self.get(EXECUTOR_AMOUNT_KEY, str(default))))

    def discovery_script(self) -> Optional[str]:
        return self.get(DISCOVERY_SCRIPT_KEY)


def discovery_script_path() -> str:
    """Absolute path of the packaged discovery script: what to set
    ``spark.executor.resource.gpu.discoveryScript`` to."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scripts",
        "get_gpus_resources.sh",
    )


def _nvidia_smi_indexes() -> Optional[List[str]]:
    """GPU indexes from ``nvidia-smi``, or None when it is absent or
    fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0:
        return None
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def discover_gpu_addresses(probe_torch: bool = False) -> List[str]:
    """Enumerate local GPU addresses, cheapest signal first:

    1. ``CUDA_VISIBLE_DEVICES`` (explicit pinning); set but empty means no
       GPU is visible to this process, as CUDA reads it;
    2. ``nvidia-smi --query-gpu=index --format=csv,noheader``;
    3. only with ``probe_torch=True``, ``torch.cuda.device_count()``, which
       initializes CUDA in this process.
    """
    val = os.environ.get(_ENV_VISIBLE)
    if val is not None:
        return [a.strip() for a in val.split(",") if a.strip()]
    indexes = _nvidia_smi_indexes()
    if indexes:
        return indexes
    if probe_torch and torch.cuda.is_available():
        return [str(i) for i in range(torch.cuda.device_count())]
    return []


def discovery_json(probe_torch: bool = False) -> str:
    """What the discovery script prints: the exact contract
    ``spark.executor.resource.gpu.discoveryScript`` expects."""
    return ResourceInformation(
        RESOURCE_NAME, discover_gpu_addresses(probe_torch=probe_torch)
    ).to_json()


def resolve_device_ordinal(
    device_id: int = -1,
    task_resources: Optional[
        Mapping[str, Union[ResourceInformation, Sequence[str]]]] = None,
    env: Optional[Mapping[str, str]] = None,
) -> int:
    """Which local device ordinal a task should use.

    Precedence mirrors ``RapidsRowMatrix.scala:171-175``: an explicit
    ``deviceId != -1`` wins; otherwise the first address of the task's
    assigned ``gpu`` resource; otherwise ``SPARK_RAPIDS_ML_TORCH_DEVICE``;
    otherwise ordinal 0. ``task_resources`` maps a resource name to its
    ``ResourceInformation`` or to its addresses.
    """
    if device_id != -1:
        return device_id
    if task_resources and task_resources.get(RESOURCE_NAME):
        info = task_resources[RESOURCE_NAME]
        addresses = getattr(info, "addresses", info)
        if addresses:
            return int(addresses[0])
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
