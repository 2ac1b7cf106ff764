"""Planner layer: the entries the plan's slabs reserve over C's entries,
mean over the window's multiplies, from the port's
``OceanReport.alloc_entries`` and ``nnz_out``: the slack that estimated
or exact sizing leaves, which the peak memory pays for. Nothing to read
from a port without the counter."""
from ..context import mean


def read(ctx):
    if not ctx.reports or not all(hasattr(r, "alloc_entries")
                                  for r in ctx.reports):
        return None
    return mean(r.alloc_entries / r.nnz_out for r in ctx.reports
                if r.nnz_out > 0)
