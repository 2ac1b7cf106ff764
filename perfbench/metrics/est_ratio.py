"""Planner layer: the plan's predicted entries over C's entries, mean over
the window's multiplies, from the port's ``OceanReport.pred_entries`` and
``nnz_out``. 1 is an exact prediction; the estimation workflow sizes its
bins 1.5 times above it. Nothing to read from a port without the counter."""
from ..context import mean


def read(ctx):
    if not ctx.reports or not all(hasattr(r, "pred_entries")
                                  for r in ctx.reports):
        return None
    return mean(r.pred_entries / r.nnz_out for r in ctx.reports
                if r.nnz_out > 0)
