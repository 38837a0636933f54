"""Device meshes over a ``torch.distributed`` job, and the collective
helpers every sharded fit shares.

Counterpart of the JAX package's ``parallel/mesh.py``. The reference's
"cluster" is Spark executors each owning one GPU, all cross-device traffic
shipped to the driver as JVM-serialised matrices
(``RapidsRowMatrix.scala:171-175, 202``). The JAX package lays data out on a
``jax.sharding.Mesh`` and lets XLA compile the collectives. Here the mesh is
one process per device: rank r owns ``cuda:LOCAL_RANK`` (or the CPU when the
caller asked for it with ``SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu``), and a
``DeviceMesh`` names the ranks' layout. Its per-dimension process groups take
the place of axis names: ``psum`` is ``all_reduce`` over a dimension's group,
``all_gather`` is ``all_gather_into_tensor``, and ``ppermute`` is
``batch_isend_irecv`` to a ring neighbour. Tensors stay plain per-rank
tensors with explicit collectives.

Axis convention, as in the JAX package: rows (samples) shard over ``data``;
the ``feature`` axis shards the columns, and with them the n×n Gram, when
n is too large for one device.

The backend follows the device: NCCL for the card, gloo only when the CPU is
requested. A mesh refuses a process group whose backend is the other one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from spark_rapids_ml_tpu_torch.utils.resources import (
    PLATFORM_ENV,
    cpu_requested,
    resolve_device,
)

DATA_AXIS = "data"
FEATURE_AXIS = "feature"

# process-group backend by device type; nothing runs NCCL's work over gloo
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

# A row count travels in a float collective as (count // 4096, count % 4096):
# each part is an integer that float32 holds exactly while the global count
# stays below 2³⁶ rows (float32 is exact to 2²⁴), where one float32 count
# would stop being exact at 2²⁴ rows.
_COUNT_SPLIT = 4096


def device_count() -> int:
    """Devices in the job: the world size once the process group is
    initialised (one device per rank), else 1."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type() -> str:
    """'cuda', or 'cpu' when requested; raises with neither (through
    ``resolve_device``) and when the process group's backend does not
    match the device."""
    device_type = resolve_device().type
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call "
            "spark_rapids_ml_tpu_torch.parallel.multihost.initialize_multihost "
            "first (the launcher's environment configures it)")
    backend = dist.get_backend()
    if backend != BACKENDS[device_type]:
        raise RuntimeError(
            f"the process group's backend is {backend!r}, but a {device_type} "
            f"mesh needs {BACKENDS[device_type]!r}")
    return device_type


def data_mesh(n_devices: Optional[int] = None):
    """1-D ``DeviceMesh`` over the ``data`` axis.

    Unlike the JAX package, which takes the first ``n_devices`` of the
    devices one process sees, the mesh spans the whole job, one device per
    rank: ``n_devices`` must equal the world size. Every rank must call it.
    """
    from torch.distributed.device_mesh import init_device_mesh

    device_type = _device_type()
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"requested {n_devices} devices, {world} visible (the mesh spans "
            "the job: one device per rank)")
    return init_device_mesh(device_type, (world,), mesh_dim_names=(DATA_AXIS,))


def grid_mesh(n_data: int, n_feature: int):
    """2-D (data × feature) ``DeviceMesh`` for the sharded-Gram path; rank r
    sits at (r // n_feature, r % n_feature). ``n_data · n_feature`` must
    equal the world size. Every rank must call it."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = _device_type()
    world = dist.get_world_size()
    need = n_data * n_feature
    if need != world:
        raise ValueError(
            f"requested {need} devices, {world} visible (the mesh spans the "
            "job: one device per rank)")
    return init_device_mesh(device_type, (n_data, n_feature),
                            mesh_dim_names=(DATA_AXIS, FEATURE_AXIS))


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on for ``mesh``. A CPU mesh needs the
    CPU request still in force, so no fit carries on quietly on the CPU."""
    if mesh.device_type == "cpu":
        if not cpu_requested():
            raise RuntimeError(
                f"a CPU mesh runs only with {PLATFORM_ENV}=cpu set")
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def axis_size(mesh, axis: str) -> int:
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def mesh_shape(mesh) -> dict:
    """Axes/shape/device summary of a ``DeviceMesh`` for fit reports and
    logs; the platform is the mesh's device type (``cuda`` or ``cpu``)."""
    return {
        "axes": tuple(str(a) for a in (mesh.mesh_dim_names or ())),
        "shape": tuple(int(s) for s in mesh.mesh.shape),
        "devices": int(mesh.mesh.numel()),
        "platform": str(mesh.device_type),
    }


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors stacked along dim 0, in group-rank order
    (``all_gather_into_tensor``, named ``all_gather_single`` in newer
    releases)."""
    out = t.new_empty((dist.get_world_size(group) * t.shape[0],)
                      + tuple(t.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, t.contiguous(), group=group)
    return out


def pack_count(count: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An int64 row count as two exact floats for a float collective."""
    return torch.stack([count // _COUNT_SPLIT, count % _COUNT_SPLIT]).to(dtype)


def unpack_count(packed: torch.Tensor) -> torch.Tensor:
    """The int64 row count from a summed ``pack_count`` pair."""
    hi, lo = packed.round().to(torch.int64)
    return hi * _COUNT_SPLIT + lo


def collective_nbytes(shape, dtype) -> int:
    """Payload bytes of one collective operand of ``shape``/``dtype`` (a
    numpy or torch dtype) — the unit every fit's collective accounting
    (``FitContext.record_collective``) is declared in."""
    itemsize = (dtype.itemsize if isinstance(dtype, torch.dtype)
                else np.dtype(dtype).itemsize)
    return int(np.prod([int(s) for s in shape], dtype=np.int64)) * itemsize


def pad_rows_to_multiple(x: np.ndarray, multiple: int):
    """Pad rows so the leading dim divides the mesh; returns (padded, mask).

    The JAX package pads because XLA shardings need equal extents per
    device; the port's collectives reduce statistics whose shape does not
    depend on the rows, but the host-array fits keep the same row layout.
    """
    n = x.shape[0]
    rem = (-n) % multiple
    mask = np.ones(n + rem, dtype=x.dtype if np.issubdtype(x.dtype, np.floating) else np.float64)
    if rem:
        x = np.concatenate([x, np.zeros((rem,) + x.shape[1:], dtype=x.dtype)])
        mask[n:] = 0.0
    return x, mask
