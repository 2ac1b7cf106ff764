"""Executor layer: rows whose accumulator overflowed and went to the exact
ESC fallback, mean over the window's multiplies, from the port's
``OceanReport.overflow_rows``."""
from ..context import mean


def read(ctx):
    return mean(float(r.overflow_rows) for r in ctx.reports)
