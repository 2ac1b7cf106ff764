"""Async device-launch substrate: dispatch -> async D2H -> collect.

PyTorch port of ``repro.core.dispatch``. A :class:`Launch` holds the
device tensors a stage produced; :func:`mark_in_flight` records a CUDA
event behind its work (the executor's launches, which stay on the card),
and :func:`start_async_host_copies` copies each CUDA tensor into a pinned
host buffer with ``non_blocking=True`` on the current stream and records
the event behind the copies (the analysis's launches). A launch is ready
when its event's ``query()`` is True; CPU tensors are ready at once.
Collection yields launches in completion order, never behind one global
barrier. Device-set plumbing (:func:`resolve_devices`, :func:`topology_key`)
lives here too, so the sharded analysis need not import the partitioner.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..launch.mesh import LogicalMesh
from ..obs import trace


def _cuda_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _device_mesh_devices(mesh) -> Tuple[torch.device, ...]:
    """The device of each rank of a ``torch.distributed`` ``DeviceMesh``,
    row-major: ``cuda:{rank % device_count}``, or the mesh's device type
    (``cpu``)."""
    ranks = mesh.mesh.flatten().tolist()
    if mesh.device_type == "cuda":
        have = _cuda_count()
        if not have:
            raise ValueError("a CUDA device mesh, have 0 CUDA devices")
        return tuple(torch.device("cuda", r % have) for r in ranks)
    return tuple(torch.device(mesh.device_type) for _ in ranks)


def _is_device_mesh(devices) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(devices, DeviceMesh)


def resolve_devices(devices=None) -> Tuple[torch.device, ...]:
    """Normalize a device spec to a tuple of ``torch.device``.

    ``None`` gives every CUDA device and an int N the first N; both raise
    ``ValueError`` when there are fewer. A sequence of devices or strings
    is taken in order, repeats allowed (logical shards of one card, or
    ``["cpu"] * n``); a CUDA device it names must exist. A mesh is
    flattened in row-major order: a ``launch.mesh.LogicalMesh`` that holds
    devices (``make_shard_mesh``; a production mesh, a shape only,
    raises), or a ``DeviceMesh`` (``make_local_mesh``), each rank on
    ``cuda:{rank % device_count}`` or on the CPU.
    """
    if devices is None or isinstance(devices, int):
        have = _cuda_count()
        want = have if devices is None else devices
        if want < 1 or want > have:
            raise ValueError(f"requested {want} CUDA devices, have {have}")
        return tuple(torch.device("cuda", i) for i in range(want))
    if isinstance(devices, (str, torch.device)):
        raise TypeError(f"a device set is a sequence of devices, got "
                        f"{devices!r}; pass [{devices!r}]")
    if isinstance(devices, LogicalMesh):
        if devices.devices is None:
            raise ValueError(f"mesh {devices.shape} is a shape and holds no "
                             "devices (make_shard_mesh gives one that does)")
        devices = devices.devices
    elif _is_device_mesh(devices):
        devices = _device_mesh_devices(devices)
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("empty device set")
    have = _cuda_count()
    out = []
    for d in devs:
        if d.type == "cuda":
            if not have:
                raise ValueError(f"device {d} requested, have 0 CUDA "
                                 "devices")
            d = torch.device("cuda", torch.cuda.current_device()
                             if d.index is None else d.index)
            if d.index >= have:
                raise ValueError(f"device {d} requested, have {have} CUDA "
                                 "devices")
        out.append(d)
    return tuple(out)


def topology_key(devices: Sequence) -> str:
    """Stable string identity of an ordered device set: the component plan
    caches add to a sharded plan's key (``"cuda:0,cuda:0"``)."""
    return ",".join(str(torch.device(d)) for d in devices)


@dataclasses.dataclass
class Launch:
    """One in-flight device computation awaiting collection.

    ``tag`` is caller-owned identity; ``order`` is the dispatch order;
    ``arrays`` the device tensors; ``host`` their host copies once
    :func:`start_async_host_copies` ran, and ``event`` the CUDA event
    behind the launch's work and copies (``None`` for CPU tensors).
    ``timing``: the ``trace.DeviceTimer`` around the launch's device work
    while tracing (``None`` otherwise)."""
    tag: object
    order: int
    arrays: Tuple
    host: Optional[Tuple] = None
    event: Optional[object] = None
    timing: Optional[object] = None


def device_context(device):
    """Context manager placing work on ``device`` (no-op for ``None`` and
    for CPU devices)."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def mark_in_flight(it: Launch) -> Launch:
    """Record an event behind a launch's work without copying it to the
    host, so :func:`launch_ready` can tell whether it is still running."""
    dev = next((a.device for a in it.arrays
                if isinstance(a, torch.Tensor) and a.is_cuda), None)
    if dev is not None:
        it.event = torch.cuda.Event()
        it.event.record(torch.cuda.current_stream(dev))
    return it


def start_async_host_copies(launches: Sequence[Launch]) -> None:
    """Begin async D2H copies (pinned buffers, current stream) for every
    launch so collection overlaps transfers with outstanding compute."""
    for it in launches:
        if it.host is not None:
            continue
        copies = []
        for arr in it.arrays:
            if isinstance(arr, torch.Tensor) and arr.is_cuda:
                buf = torch.empty(arr.shape, dtype=arr.dtype,
                                  pin_memory=True)
                buf.copy_(arr, non_blocking=True)
                copies.append(buf)
            else:
                copies.append(arr)
        # the copies ran on the device's current stream: mark their end
        mark_in_flight(it)
        it.host = tuple(copies)


def launch_ready(it: Launch) -> bool:
    """True when the launch's host copies are complete (non-blocking)."""
    return it.event is None or it.event.query()


def host_arrays(it: Launch) -> List[np.ndarray]:
    """Host numpy arrays of a launch; blocks only on this launch's copy."""
    if it.host is None:
        start_async_host_copies([it])
    if it.event is not None:
        it.event.synchronize()
    return [a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            for a in it.host]


def overlap_host_work(launches: Sequence[Launch],
                      work: Callable[[], object]
                      ) -> Tuple[object, float, bool]:
    """Run independent host-side ``work`` while ``launches`` are in flight.

    Returns ``(result, seconds, overlapped)``; ``overlapped`` is True iff
    at least one launch was still pending when the work started."""
    pending = any(not launch_ready(it) for it in launches)
    t0 = time.perf_counter()
    result = work()
    dt = time.perf_counter() - t0
    trace.add_span("dispatch.overlap_host_work", t0, dt, overlapped=pending)
    return result, dt, pending


def collect_in_completion_order(launches: Sequence[Launch]
                                ) -> Iterator[Launch]:
    """Yield launches as they complete (ready-first, no global barrier).
    When nothing is ready the oldest outstanding launch is yielded."""
    remaining: List[Launch] = list(launches)
    while remaining:
        idx = next((i for i, it in enumerate(remaining)
                    if launch_ready(it)), 0)
        yield remaining.pop(idx)
