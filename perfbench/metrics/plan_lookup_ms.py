"""Workflow layer: the plan-cache lookup (the structure hash and the
cache probe), mean over the window's multiplies, from the port's
``stage_seconds["plan_lookup"]``. Nothing to read where no multiply
consulted the cache."""
from ..context import mean


def read(ctx):
    return mean(r.stage_seconds["plan_lookup"] * 1e3 for r in ctx.reports
                if "plan_lookup" in r.stage_seconds)
