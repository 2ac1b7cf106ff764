"""Span tracing for the Ocean port (zero-dependency, thread-safe).

A :class:`Tracer` records nested, named spans — ``with span("analysis.wave1",
shard=i): ...`` — across every thread that touches a request: the workflow
entry point, the planner's analysis/prediction/binning stages, the
executor's dispatch/collect/merge pipeline, and the serving pool's
queue-wait/batch/warmer paths.
The reference's span names (``repro.obs.trace``) are kept, so traces of
the two packages line up; the port adds:

* a root span per multiply (:func:`root_span`, ``ocean.spgemm``) that
  gives every span recorded during the call one multiply id, ``mid``
  (``None`` outside a call);
* sub-spans of the merge's and the plan lookup's steps (:data:`SUB_SPANS`),
  timed once (:func:`timed`) into the span and the report's
  ``span_seconds``;
* device spans (:meth:`Tracer.device_events`): CUDA event pairs around the
  executor's bin launches (:func:`device_timer`), placed on the host's
  ``perf_counter`` clock through one anchor per device.

``docs/observability_torch.md`` lists the spans, the report fields they
feed and the registry's launch counters.

Tracing is *off by default* and the instrumented paths are allocation-free
when it is off:

* :func:`span` and :func:`root_span` return the singleton
  :data:`NULL_SPAN` (no ``Span`` object is ever constructed);
* :func:`add_span` (retroactive recording for code that already measured a
  ``(t0, duration)`` pair, e.g. the pool's queue-wait accounting) returns
  after one module-global read;
* :func:`device_timer` returns ``None``: no CUDA event, no synchronisation;
* hot per-slab loops guard on :func:`enabled` before building any
  attribute dict.

The timed steps are the exception: :func:`timed` makes a ``Span`` for
each, traced or not, since its seconds feed the report; with no tracer it
is a stopwatch and records nothing (a handful a multiply).

Timing discipline: instrumented stages measure **once** with
``time.perf_counter()`` and feed the same measurement to both the stage
dict on :class:`~repro_torch.core.planner.OceanReport` and the span record — the
report's timing fields are views of the numbers the spans carry, so the
two can never drift.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["Tracer", "Span", "DeviceTimer", "NULL_SPAN", "ROOT",
           "SUB_SPANS", "span", "root_span", "timed", "add_span",
           "device_timer", "current_mid", "enabled", "install", "current",
           "tracing"]

# the root span of one multiply
ROOT = "ocean.spgemm"

# the steps timed inside a parent span, by parent: each is recorded nested
# in it, and its seconds in ``OceanReport.span_seconds`` never exceed the
# parent's
SUB_SPANS: Dict[str, Tuple[str, ...]] = {
    "plan.lookup": ("plan.key", "plan.probe"),
    "exec.compact": ("exec.compact.scatter",),
    "exec.overflow_fallback": ("exec.fallback.gather", "exec.fallback.esc"),
}

# process-wide multiply ids, drawn only while a tracer is installed
_MIDS = itertools.count(1)


class Tracer:
    """Thread-safe span recorder.

    Spans are stored as flat dicts (``name``, ``t0``/``dur`` in seconds on
    the ``perf_counter`` clock, ``tid``/``thread``, ``parent``, ``mid``,
    ``attrs``) with per-thread nesting stacks, so concurrent threads trace
    independently and a span's parent is whatever span was open on the
    *same thread* when it closed. ``t0`` is absolute ``perf_counter``
    time; exporters rebase on :attr:`epoch` (captured at construction).
    ``mid`` is the multiply id of the :func:`root_span` open on the
    recording thread, or ``None``.

    Device spans (:meth:`device_events`) are kept apart from the host's:
    ``device``, ``t0``/``dur`` in ``perf_counter`` seconds, ``tid`` (the
    recording thread), ``mid``, ``attrs``.
    """

    def __init__(self):
        self.epoch = time.perf_counter()
        self._events: List[Dict] = []
        self._device_events: List[Dict] = []
        # device -> (perf_counter reading, CUDA event completed right
        # after it): the device clock's anchor on the host's
        self._anchors: Dict[str, Tuple[float, object]] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- per-thread nesting stack and multiply id --------------------------

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current_mid(self) -> Optional[int]:
        """The multiply id of the root span open on this thread."""
        return getattr(self._local, "mid", None)

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **attrs) -> "Span":
        """Open a nested span; use as a context manager."""
        return Span(self, name, attrs)

    def add_span(self, name: str, t0: float, dur: float,
                 tid: Optional[int] = None, thread: Optional[str] = None,
                 **attrs) -> None:
        """Record a span retroactively from an already-measured
        ``(t0, duration)`` pair (``perf_counter`` seconds). The span joins
        the calling thread's timeline unless ``tid``/``thread`` override
        it (e.g. the pool's per-request queue-wait lanes); it nests under
        the currently open span, if any, and takes this thread's multiply
        id — unless ``tid`` names another lane, in which case it is
        recorded parentless and with no multiply id."""
        stack = self._stack() if tid is None else ()
        mid = self.current_mid() if tid is None else None
        self._record(name, t0, max(dur, 0.0),
                     tid if tid is not None else threading.get_ident(),
                     thread if thread is not None
                     else threading.current_thread().name,
                     stack[-1] if stack else None, attrs, mid)

    def _record(self, name, t0, dur, tid, thread, parent, attrs,
                mid) -> None:
        ev = {"name": name, "t0": t0, "dur": dur, "tid": tid,
              "thread": thread, "parent": parent, "mid": mid,
              "attrs": dict(attrs) if attrs else {}}
        with self._lock:
            self._events.append(ev)

    # -- the device lane ---------------------------------------------------

    def _anchor(self, device) -> Tuple[float, object]:
        """The device clock's anchor, taken the first time this tracer
        times work on ``device``: synchronise, read ``perf_counter``,
        record an event and wait for it. (The event is recorded once
        before, since its first record creates it.)"""
        key = str(device)
        anchor = self._anchors.get(key)
        if anchor is None:
            import torch
            with self._lock:
                anchor = self._anchors.get(key)
                if anchor is None:
                    stream = torch.cuda.current_stream(device)
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record(stream)
                    torch.cuda.synchronize(device)
                    host = time.perf_counter()
                    ev.record(stream)
                    ev.synchronize()
                    anchor = self._anchors[key] = (host, ev)
        return anchor

    def add_device_span(self, name: str, timer: "DeviceTimer",
                        **attrs) -> float:
        """Record a completed :class:`DeviceTimer` as a device span on the
        host's clock; returns its seconds."""
        host, anchor = self._anchor(timer.device)
        t0 = host + anchor.elapsed_time(timer.start) / 1e3
        dur = timer.start.elapsed_time(timer.end) / 1e3
        mid = self.current_mid()
        ev = {"name": name, "device": str(timer.device), "t0": t0,
              "dur": max(dur, 0.0), "tid": threading.get_ident(),
              "mid": mid, "attrs": dict(attrs, mid=mid)}
        with self._lock:
            self._device_events.append(ev)
        return ev["dur"]

    # -- inspection --------------------------------------------------------

    def events(self) -> List[Dict]:
        """Snapshot of recorded host spans (close order)."""
        with self._lock:
            return list(self._events)

    def device_events(self) -> List[Dict]:
        """Snapshot of recorded device spans (record order)."""
        with self._lock:
            return list(self._device_events)

    def names(self) -> List[str]:
        return [e["name"] for e in self.events()]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._device_events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


class Span:
    """One open span; records itself on ``__exit__``. A root span
    (:func:`root_span`) draws a fresh multiply id for its thread while it
    is open. A timed step (:func:`timed`) also adds its seconds to
    ``into[name]``; while tracing is off it is made with no tracer, and is
    then a stopwatch that records nothing."""

    __slots__ = ("_tracer", "name", "attrs", "t0", "seconds", "_into",
                 "_root", "_prev_mid")

    def __init__(self, tracer: Optional[Tracer], name: str, attrs: Dict,
                 root: bool = False,
                 into: Optional[Dict[str, float]] = None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.seconds = 0.0
        self._into = into
        self._root = root
        self._prev_mid = None

    def set(self, **attrs) -> "Span":
        """Attach attributes after opening (e.g. results known at exit)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tr = self._tracer
        if tr is not None:
            if self._root:
                self._prev_mid = tr.current_mid()
                tr._local.mid = self.attrs["mid"] = next(_MIDS)
            tr._stack().append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self.t0
        if self._into is not None:
            self._into[self.name] = (self._into.get(self.name, 0.0)
                                     + self.seconds)
        tr = self._tracer
        if tr is not None:
            stack = tr._stack()
            stack.pop()
            tr._record(self.name, self.t0, self.seconds,
                       threading.get_ident(),
                       threading.current_thread().name,
                       stack[-1] if stack else None, self.attrs,
                       tr.current_mid())
            if self._root:
                tr._local.mid = self._prev_mid
        return False


class DeviceTimer:
    """A CUDA event pair around work enqueued on ``device``'s current
    stream: ``start`` is recorded at construction, ``end`` by
    :meth:`stop`. Once the work is known complete, :meth:`record` puts it
    on the tracer's device lane."""

    __slots__ = ("tracer", "device", "start", "end")

    def __init__(self, tracer: Tracer, device):
        import torch
        tracer._anchor(device)
        self.tracer = tracer
        self.device = device
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record(torch.cuda.current_stream(device))

    def stop(self) -> "DeviceTimer":
        import torch
        self.end.record(torch.cuda.current_stream(self.device))
        return self

    def record(self, name: str, **attrs) -> float:
        """The device span's seconds, recorded under ``name``."""
        return self.tracer.add_device_span(name, self, **attrs)


class _NullSpan:
    """Singleton no-op span returned whenever tracing is off.

    ``__slots__ = ()`` and a module-level singleton mean the disabled path
    allocates nothing: no ``Span``, no attrs dict retained, no record."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()

# module-global active tracer; None = tracing off (the default)
_tracer: Optional[Tracer] = None


def install(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install ``tracer`` as the process-wide active tracer (``None``
    turns tracing off). Returns the previously active tracer."""
    global _tracer
    prev = _tracer
    _tracer = tracer
    return prev


def current() -> Optional[Tracer]:
    """The active tracer, or ``None`` when tracing is off."""
    return _tracer


def enabled() -> bool:
    """True iff a tracer is installed. Hot loops guard attribute-dict
    construction on this so the disabled path stays allocation-free."""
    return _tracer is not None


def current_mid() -> Optional[int]:
    """The multiply id open on this thread, or ``None`` (also when
    tracing is off)."""
    t = _tracer
    return None if t is None else t.current_mid()


def span(name: str, **attrs):
    """Open a span on the active tracer — or return :data:`NULL_SPAN`
    (no allocation, no record) when tracing is off."""
    t = _tracer
    if t is None:
        return NULL_SPAN
    return Span(t, name, attrs)


def root_span(name: str = ROOT, **attrs):
    """Open the root span of one multiply: every span this thread records
    until it closes carries its fresh multiply id (``mid``, also in its
    attrs). :data:`NULL_SPAN`, and no id drawn, when tracing is off."""
    t = _tracer
    if t is None:
        return NULL_SPAN
    return Span(t, name, attrs, root=True)


def timed(name: str, into: Dict[str, float], **attrs) -> Span:
    """Time a step into ``into[name]`` (summed) and, when tracing is on,
    record the same measurement as a nested span."""
    return Span(_tracer, name, attrs, into=into)


def add_span(name: str, t0: float, dur: float, **attrs) -> None:
    """Retroactively record a measured ``(t0, duration)`` span on the
    active tracer; a single global read + None check when tracing is
    off."""
    t = _tracer
    if t is not None:
        t.add_span(name, t0, dur, **attrs)


def device_timer(device) -> Optional[DeviceTimer]:
    """A started :class:`DeviceTimer` on a CUDA ``device`` while tracing
    is on; ``None`` (no event, no synchronisation) otherwise."""
    t = _tracer
    if t is None or device is None or getattr(device, "type", None) != "cuda":
        return None
    return DeviceTimer(t, device)


class tracing:
    """Context manager: install a tracer for the block, restore after.

    >>> tr = Tracer()
    >>> with tracing(tr):
    ...     ocean_spgemm(a, b)
    >>> tr.names()
    """

    def __init__(self, tracer: Optional[Tracer]):
        self.tracer = tracer
        self._prev: Optional[Tracer] = None

    def __enter__(self) -> Optional[Tracer]:
        self._prev = install(self.tracer)
        return self.tracer

    def __exit__(self, *exc) -> bool:
        install(self._prev)
        return False
