"""Span tracing for the Ocean pipeline (zero-dependency, thread-safe).

A :class:`Tracer` records nested, named spans — ``with span("analysis.wave1",
shard=i): ...`` — across every thread that touches a request: the workflow
entry point, the planner's analysis/prediction/binning stages, the
executor's dispatch/collect/merge pipeline (including the dedicated merge
worker thread), and the serving pool's queue-wait/batch/warmer paths.
A copy of ``repro.obs.trace`` with the same span names, so traces of the
two packages line up.

Tracing is *off by default* and the instrumented paths are allocation-free
when it is off:

* :func:`span` returns the singleton :data:`NULL_SPAN` (no ``Span`` object
  is ever constructed);
* :func:`add_span` (retroactive recording for code that already measured a
  ``(t0, duration)`` pair, e.g. the pool's queue-wait accounting) returns
  after one module-global read;
* hot per-slab loops guard on :func:`enabled` before building any
  attribute dict.

Timing discipline: instrumented stages measure **once** with
``time.perf_counter()`` and feed the same measurement to both the stage
dict on :class:`~repro_torch.core.planner.OceanReport` and the span record — the
report's timing fields are views of the numbers the spans carry, so the
two can never drift.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

__all__ = ["Tracer", "Span", "NULL_SPAN", "span", "add_span", "enabled",
           "install", "current", "tracing"]


class Tracer:
    """Thread-safe span recorder.

    Spans are stored as flat dicts (``name``, ``t0``/``dur`` in seconds on
    the ``perf_counter`` clock, ``tid``/``thread``, ``parent``, ``attrs``)
    with per-thread nesting stacks, so concurrent threads trace
    independently and a span's parent is whatever span was open on the
    *same thread* when it closed. ``t0`` is absolute ``perf_counter``
    time; exporters rebase on :attr:`epoch` (captured at construction).
    """

    def __init__(self):
        self.epoch = time.perf_counter()
        self._events: List[Dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- per-thread nesting stack -----------------------------------------

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

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
        it (e.g. the threaded executor recording its merge worker's spans
        after joining it); it nests under the currently open span, if
        any — unless ``tid`` points at another thread, in which case it is
        recorded parentless (the other thread's nesting is unknown
        here)."""
        stack = self._stack() if tid is None else ()
        self._record(name, t0, max(dur, 0.0),
                     tid if tid is not None else threading.get_ident(),
                     thread if thread is not None
                     else threading.current_thread().name,
                     stack[-1] if stack else None, attrs)

    def _record(self, name, t0, dur, tid, thread, parent, attrs) -> None:
        ev = {"name": name, "t0": t0, "dur": dur, "tid": tid,
              "thread": thread, "parent": parent,
              "attrs": dict(attrs) if attrs else {}}
        with self._lock:
            self._events.append(ev)

    # -- inspection --------------------------------------------------------

    def events(self) -> List[Dict]:
        """Snapshot of recorded spans (close order)."""
        with self._lock:
            return list(self._events)

    def names(self) -> List[str]:
        return [e["name"] for e in self.events()]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


class Span:
    """One open span; records itself on ``__exit__``."""

    __slots__ = ("_tracer", "name", "attrs", "t0")

    def __init__(self, tracer: Tracer, name: str, attrs: Dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0

    def set(self, **attrs) -> "Span":
        """Attach attributes after opening (e.g. results known at exit)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._tracer._stack().append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter() - self.t0
        stack = self._tracer._stack()
        stack.pop()
        self._tracer._record(
            self.name, self.t0, dur, threading.get_ident(),
            threading.current_thread().name,
            stack[-1] if stack else None, self.attrs)
        return False


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


def span(name: str, **attrs):
    """Open a span on the active tracer — or return :data:`NULL_SPAN`
    (no allocation, no record) when tracing is off."""
    t = _tracer
    if t is None:
        return NULL_SPAN
    return Span(t, name, attrs)


def add_span(name: str, t0: float, dur: float, **attrs) -> None:
    """Retroactively record a measured ``(t0, duration)`` span on the
    active tracer; a single global read + None check when tracing is
    off."""
    t = _tracer
    if t is not None:
        t.add_span(name, t0, dur, **attrs)


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
