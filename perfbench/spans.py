"""Per-multiply numbers the port puts in its ``OceanReport`` while a
window is traced: ``span_seconds`` (the timed steps of the merge and the
plan lookup, by span name) and ``device_seconds`` (the bin launches' device
time, by kind). A port without these fields gives nothing to read, so a
reader returns ``None`` there rather than raising."""
from __future__ import annotations

from typing import Optional

from .context import TraceContext, mean


def step_ms(ctx: TraceContext, name: str) -> Optional[float]:
    """The step's milliseconds, mean over the window's multiplies, a
    multiply that did not run the step counting 0 (no row overflowed, no
    cache consulted); ``None`` where the port keeps no ``span_seconds``."""
    return mean(s.get(name, 0.0) * 1e3 for s in
                (getattr(r, "span_seconds", None) for r in ctx.reports)
                if s is not None)


def device_ms(ctx: TraceContext) -> Optional[float]:
    """The bin launches' device milliseconds, all kinds summed, mean over
    the window's multiplies that measured them (0 where the bins ran on
    the host, which times no device); ``None`` where none did."""
    return mean(sum(d.values()) * 1e3 for d in
                (getattr(r, "device_seconds", None) for r in ctx.reports)
                if d is not None)
