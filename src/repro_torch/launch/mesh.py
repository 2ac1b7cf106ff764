"""Device meshes: the production mesh's shape, a local ``DeviceMesh``, and
the shard mesh of the device-partitioned SpGEMM path.

The port of ``repro.launch.mesh``. Three kinds, one constructor each:

* :func:`make_production_mesh` is a :class:`LogicalMesh` that holds only a
  shape, ``{"data": 16, "model": 16}`` or ``{"pod": 2, "data": 16,
  "model": 16}``. No process holds a ``DeviceMesh`` of 256 or 512 ranks,
  and the dry-run reads only the mesh's shape.
* :func:`make_local_mesh` is a ``torch.distributed`` ``DeviceMesh`` with
  axes ``("data", "model")`` over the ranks of the default process group,
  which it starts (world size 1, a ``HashStore``) when there is none.
* :func:`make_shard_mesh` is a 1-D :class:`LogicalMesh` on axis
  ``"shard"`` that holds this process's own devices: the sharded SpGEMM
  executor drives several devices from one process, which a
  ``DeviceMesh`` (one rank a process) cannot name.

Nothing here touches a device or a process group at import.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Named axes with sizes and, optionally, the devices they hold in
    row-major order (``None`` for a mesh that is only a shape)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} with sizes "
                             f"{self.axis_sizes}")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """16 x 16 = 256 chips a pod; 2 pods = 512 chips for the multi-pod
    run."""
    if multi_pod:
        return LogicalMesh(("pod", "data", "model"), (2, 16, 16))
    return LogicalMesh(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``data x model`` ranks, axes ``("data",
    "model")``. Without a default process group it starts one of world
    size 1 (``nccl`` on ``cuda``, ``gloo`` on ``cpu``); raises when
    ``data * model`` is not the world size, and on ``cuda`` without a
    GPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_local_mesh: no CUDA device; pass "
                           "device_type='cpu'")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks, the world has {world}")
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def make_shard_mesh(n_devices: Optional[int] = None,
                    device_type: str = "cuda") -> LogicalMesh:
    """1-D mesh on axis ``"shard"`` over this process's devices, for
    ``ocean_spgemm(devices=...)`` and ``core.partition.partition_plan``.
    On ``cuda``, the first ``n_devices`` cards (default: every card;
    raises when there are fewer); on ``cpu``, ``n_devices`` logical shards
    of the CPU (default 1), the port's device-list convention."""
    if device_type == "cpu":
        n = 1 if n_devices is None else n_devices
        devs = (torch.device("cpu"),) * n
    elif device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else n_devices
        if n > have or not have:
            raise ValueError(f"requested {n} CUDA devices, have {have}")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    else:
        raise ValueError(f"unknown device type {device_type!r}")
    if n < 1:
        raise ValueError(f"a shard mesh needs a device, got {n}")
    return LogicalMesh(("shard",), (n,), devs)
