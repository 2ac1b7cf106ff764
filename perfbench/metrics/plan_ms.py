"""Planner layer: analysis + prediction + binning of the multiplies that
built their plan (no plan-cache hit), mean, from the port's
``stage_seconds``. Nothing to read where every multiply replayed a plan."""
from ..context import mean

STAGES = ("analysis", "prediction", "binning")


def read(ctx):
    return mean(sum(r.stage_seconds.get(k, 0.0) for k in STAGES) * 1e3
                for r in ctx.reports if not r.plan_cache_hit)
