"""The device trace of a traced window, and the arithmetic read from it.

``Capture`` records the device's activity (kernels, copies, memsets) with
``torch.profiler`` over the window, CUDA activity only, so the trace stays
small. Device times are moved onto the host's ``perf_counter`` clock by a
marker kernel launched just after the profiler starts. The functions below
work on plain lists of ``(start, end, name)`` in seconds, so they are
tested without a device: the union of intervals (busy time, as a union so
overlapping activities count once), the idle gaps of a window, the gaps'
time by the port's span open on the host, and the top device operations.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Interval = Tuple[float, float, str]
OUTSIDE = "(no port span open)"
MARKER = "spin_kernel"


def kind_of(name: str) -> str:
    """"copy", "memset" or "kernel" from an activity's name."""
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def clip(events: Sequence[Interval], w0: float, w1: float) -> List[Interval]:
    """Events cut to the window [w0, w1]; those outside it dropped."""
    return [(max(s, w0), min(e, w1), n) for s, e, n in events
            if e > w0 and s < w1]


def union(events: Sequence[Interval]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals covered by any event."""
    out: List[List[float]] = []
    for s, e, _ in sorted(events):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(events: Sequence[Interval]) -> float:
    """Seconds in which at least one event ran."""
    return sum(e - s for s, e in union(events))


def gaps(events: Sequence[Interval], w0: float, w1: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [w0, w1] in which no event ran."""
    out, t = [], w0
    for s, e in union(clip(events, w0, w1)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if w1 > t:
        out.append((t, w1))
    return out


def idle_by_span(idle: Sequence[Tuple[float, float]],
                 spans: Sequence[Interval]) -> Dict[str, float]:
    """Idle seconds by the innermost (shortest) span open on the host at
    the time; time that no span covers goes to ``OUTSIDE``."""
    points = []
    for i, (s, e, _) in enumerate(spans):
        points.append((s, 1, i))
        points.append((e, -1, i))
    for s, e in idle:
        points.append((s, 2, -1))
        points.append((e, -2, -1))
    points.sort(key=lambda p: (p[0], p[1]))
    active: Dict[int, float] = {}
    in_gap = 0
    out: Dict[str, float] = {}
    prev = None
    for t, what, i in points:
        if prev is not None and in_gap and t > prev:
            if active:
                inner = min(active, key=active.get)
                label = spans[inner][2]
            else:
                label = OUTSIDE
            out[label] = out.get(label, 0.0) + (t - prev)
        if what == 1:
            active[i] = spans[i][1] - spans[i][0]
        elif what == -1:
            active.pop(i, None)
        else:
            in_gap += 1 if what == 2 else -1
        prev = t
    return out


def top(totals: Dict[str, float], n: int = 10) -> List[List]:
    """The ``n`` largest entries as [[name, seconds], ...]."""
    rows = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], secs] for name, secs in rows]


def time_by_name(events: Sequence[Interval]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s, e, n in events:
        out[n] = out.get(n, 0.0) + (e - s)
    return out


def _device_events(prof) -> List[Interval]:
    """(start, end, name) in seconds on the profiler's clock, of every
    activity that ran on a CUDA device."""
    from torch.autograd import DeviceType
    return [(ev.start_ns() * 1e-9,
             (ev.start_ns() + ev.duration_ns()) * 1e-9, ev.name())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == DeviceType.CUDA]


class Capture:
    """Context manager: the device's activity while it is open, on the
    host's ``perf_counter`` clock (``events`` after exit). Where the trace
    lacks the marker kernel the two clocks cannot be aligned, and
    ``events`` stays empty: no device metric is read from it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.events: List[Interval] = []
        self._prof = None
        self._mark = 0.0

    def __enter__(self) -> "Capture":
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize(self.device)
        self._mark = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc) -> bool:
        torch.cuda.synchronize(self.device)
        self._prof.__exit__(*exc)
        raw = _device_events(self._prof)
        marks = [s for s, _, n in raw if MARKER in n]
        if marks:
            offset = self._mark - min(marks)
            self.events = [(s + offset, e + offset, n) for s, e, n in raw
                           if MARKER not in n]
        self._prof = None
        return False


def spans_of(tracer) -> List[Interval]:
    """The port's recorded spans as (start, end, name) on the host's
    ``perf_counter`` clock."""
    if tracer is None:
        return []
    return [(ev["t0"], ev["t0"] + ev["dur"], ev["name"])
            for ev in tracer.events()]


def breakdown(events: Sequence[Interval], spans: Sequence[Interval],
              w0: float, w1: float) -> Optional[dict]:
    """``device_ops`` (most time first) and ``idle_gaps`` (idle seconds by
    the port span open on the host), each at most 10 entries."""
    inside = clip(events, w0, w1)
    if not inside:
        return None
    return {"device_ops": top(time_by_name(inside)),
            "idle_gaps": top(idle_by_span(gaps(inside, w0, w1), spans))}
