"""Async device-launch substrate: dispatch -> async D2H -> collect.

PyTorch port of ``repro.core.dispatch``. A :class:`Launch` holds the
device tensors a stage produced; :func:`start_async_host_copies` copies
each CUDA tensor into a pinned host buffer with ``non_blocking=True`` on
the current stream and records a CUDA event behind the copies. A launch is
ready when its event's ``query()`` is True; CPU tensors are ready at once.
Collection yields launches in completion order, never behind one global
barrier.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import trace


def resolve_devices(devices):
    """Only ``None`` (the inputs' own device) is supported in this port."""
    if devices is not None:
        raise NotImplementedError(
            "device sets (devices=) are ROADMAP queue 1, item 5 "
            "(multi-GPU); only devices=None runs in this port")
    return None


@dataclasses.dataclass
class Launch:
    """One in-flight device computation awaiting collection.

    ``tag`` is caller-owned identity; ``order`` is the dispatch order;
    ``arrays`` the device tensors; ``host`` their host copies once
    :func:`start_async_host_copies` ran, and ``event`` the CUDA event
    behind the launch's work and copies (``None`` for CPU tensors)."""
    tag: object
    order: int
    arrays: Tuple
    host: Optional[Tuple] = None
    event: Optional[object] = None


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
