"""Labeled metrics registry: counters, gauges, histograms.

One :class:`MetricsRegistry` holds every series a component emits, keyed
by ``(name, sorted labels)``. A copy of ``repro.obs.metrics``; the port's
accuracy telemetry and its kernel wrappers (``kernel.launches{kernel}``,
:func:`count_launch`) count into it when a registry is installed.

Aggregation across workers is first-class: :meth:`MetricsRegistry.merge`
folds another registry in (counters sum, gauges follow their declared
``agg`` policy, histogram reservoirs concatenate under their bound) and
:meth:`MetricsRegistry.reset` zeroes everything — the primitives behind
``ServiceStats.merge`` / ``ServiceStats.reset``.

Everything is plain Python + a lock; no external metrics client is
required (zero-dependency, like the tracer).
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "install_registry", "active_registry", "count", "count_launch",
           "launch_counts", "launched", "LAUNCHES"]

# counter of the hand-written kernels' launches, labelled ``kernel``
LAUNCHES = "kernel.launches"

LabelKey = Tuple[Tuple[str, object], ...]


def _label_key(labels: Dict) -> LabelKey:
    return tuple(sorted(labels.items(), key=lambda kv: kv[0]))


class Counter:
    """Monotonic-by-convention numeric series (int or float)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value. ``agg`` declares how :meth:`MetricsRegistry.
    merge` folds two workers' gauges: ``"sum"`` (default), ``"max"``, or
    ``"last"`` (the merged-in value wins)."""

    __slots__ = ("value", "agg")

    def __init__(self, agg: str = "sum"):
        self.value = 0
        self.agg = agg

    def set(self, v) -> None:
        self.value = v

    def set_max(self, v) -> None:
        if v > self.value:
            self.value = v


class Histogram:
    """Bounded-reservoir distribution, exact over the newest ``cap``
    observations (the ServiceStats latency-reservoir semantics: old
    entries age out so percentiles track current traffic)."""

    __slots__ = ("cap", "count", "total", "_sample")

    def __init__(self, cap: int = 4096):
        self.cap = cap
        self.count = 0
        self.total = 0.0
        self._sample: List[float] = []

    def record(self, v: float) -> None:
        self.count += 1
        self.total += v
        self._sample.append(v)
        excess = len(self._sample) - self.cap
        if excess > 0:
            del self._sample[:excess]

    def sample(self) -> List[float]:
        return list(self._sample)

    def percentile(self, q: float) -> float:
        """Exact ``q``-th percentile (0..100) of the retained sample,
        linear interpolation between closest ranks (numpy's default
        convention). 0.0 on an empty sample."""
        xs = sorted(self._sample)
        if not xs:
            return 0.0
        rank = (len(xs) - 1) * (q / 100.0)
        lo = int(math.floor(rank))
        hi = int(math.ceil(rank))
        frac = rank - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac


class MetricsRegistry:
    """Thread-safe get-or-create registry of labeled series.

    ``counter("plan_warm_hits", tenant="acme")`` and
    ``counter("plan_warm_hits", tenant="globex")`` are distinct series of
    one metric; :meth:`series` returns the label->value map of a metric
    and :meth:`snapshot` exports everything as plain dicts.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelKey], Gauge] = {}
        self._histograms: Dict[Tuple[str, LabelKey], Histogram] = {}

    # -- get-or-create -----------------------------------------------------

    def counter(self, name: str, **labels) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter())
        return c

    def gauge(self, name: str, agg: str = "sum", **labels) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge(agg))
        return g

    def histogram(self, name: str, cap: int = 4096, **labels) -> Histogram:
        key = (name, _label_key(labels))
        h = self._histograms.get(key)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(key, Histogram(cap))
        return h

    # -- inspection --------------------------------------------------------

    def series(self, name: str) -> Dict[LabelKey, object]:
        """Label-key -> value map for every series of counter/gauge
        ``name`` (counters and gauges share the namespace read side)."""
        out: Dict[LabelKey, object] = {}
        with self._lock:
            for (n, lk), c in self._counters.items():
                if n == name:
                    out[lk] = c.value
            for (n, lk), g in self._gauges.items():
                if n == name:
                    out[lk] = g.value
        return out

    def labeled_values(self, name: str, label: str) -> Dict:
        """``{label_value: total}`` view of one metric's series, summing
        any series that carry the label (the ``*_by_tenant`` dict shape
        ServiceStats exposes)."""
        out: Dict = {}
        for lk, v in self.series(name).items():
            d = dict(lk)
            if label in d:
                out[d[label]] = out.get(d[label], 0) + v
        return out

    @staticmethod
    def _fmt_key(name: str, lk: LabelKey) -> str:
        if not lk:
            return name
        inner = ",".join(f"{k}={v}" for k, v in lk)
        return f"{name}{{{inner}}}"

    def snapshot(self) -> Dict[str, Dict]:
        """Export everything as plain dicts (JSON-ready). Histograms
        surface count/sum plus exact p50/p95/p99 of the retained
        sample."""
        with self._lock:
            counters = {self._fmt_key(n, lk): c.value
                        for (n, lk), c in self._counters.items()}
            gauges = {self._fmt_key(n, lk): g.value
                      for (n, lk), g in self._gauges.items()}
            hists = dict(self._histograms)
        histograms = {}
        for (n, lk), h in hists.items():
            histograms[self._fmt_key(n, lk)] = {
                "count": h.count, "sum": h.total,
                "p50": h.percentile(50.0), "p95": h.percentile(95.0),
                "p99": h.percentile(99.0)}
        return {"counters": counters, "gauges": gauges,
                "histograms": histograms}

    # -- aggregation -------------------------------------------------------

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold ``other`` into this registry: counters sum, gauges follow
        their ``agg`` policy, histogram reservoirs concatenate (oldest
        entries age out under the bound; counts/sums add exactly)."""
        with other._lock:
            o_counters = {k: c.value for k, c in other._counters.items()}
            o_gauges = {k: (g.value, g.agg) for k, g in
                        other._gauges.items()}
            o_hists = {k: (h.cap, h.count, h.total, list(h._sample))
                       for k, h in other._histograms.items()}
        for (n, lk), v in o_counters.items():
            self.counter(n, **dict(lk)).value += v
        for (n, lk), (v, agg) in o_gauges.items():
            g = self.gauge(n, agg=agg, **dict(lk))
            if agg == "max":
                g.set_max(v)
            elif agg == "last":
                g.value = v
            else:
                g.value += v
        for (n, lk), (cap, count, total, sample) in o_hists.items():
            h = self.histogram(n, cap=cap, **dict(lk))
            h.count += count
            h.total += total
            h._sample.extend(sample)
            excess = len(h._sample) - h.cap
            if excess > 0:
                del h._sample[:excess]

    def reset(self) -> None:
        """Zero every counter/gauge and clear every histogram (series
        identities survive; their values restart)."""
        with self._lock:
            for c in self._counters.values():
                c.value = 0
            for g in self._gauges.values():
                g.value = 0
            for h in self._histograms.values():
                h.count = 0
                h.total = 0.0
                h._sample.clear()


# process-wide registry hook (mirrors trace.install/current): components
# that emit without owning a registry — e.g. the planner's workflow-
# decision audit counters — record here when one is installed
_registry: Optional[MetricsRegistry] = None


def install_registry(registry: Optional[MetricsRegistry]
                     ) -> Optional[MetricsRegistry]:
    """Install a process-wide registry (``None`` = off). Returns the
    previous one."""
    global _registry
    prev = _registry
    _registry = registry
    return prev


def active_registry() -> Optional[MetricsRegistry]:
    return _registry


def count(name: str, n=1, **labels) -> None:
    """Add ``n`` to counter ``name{labels}`` of the installed registry,
    under its lock (several threads multiply); one global read when none
    is."""
    r = _registry
    if r is not None:
        c = r.counter(name, **labels)
        with r._lock:
            c.value += n


def count_launch(kernel: str) -> None:
    """Count one launch of a hand-written kernel into
    ``kernel.launches{kernel=...}`` of the installed registry."""
    count(LAUNCHES, kernel=kernel)


def launch_counts(registry: Optional[MetricsRegistry] = None
                  ) -> Dict[str, int]:
    """``{kernel: launches}`` counted in ``registry`` (default: the
    installed one; empty when none is)."""
    r = _registry if registry is None else registry
    return {} if r is None else r.labeled_values(LAUNCHES, "kernel")


def launched(*kernels: str) -> int:
    """Launches of ``kernels`` counted so far in the installed registry
    (0 when none is)."""
    counts = launch_counts()
    return sum(counts.get(k, 0) for k in kernels)
