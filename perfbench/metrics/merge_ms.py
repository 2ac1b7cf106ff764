"""Executor layer: the host merge (overflow scan, overflow fallback and
compaction), mean over the window's multiplies, from the port's
``stage_seconds["merge"]``."""
from ..context import mean


def read(ctx):
    return mean(r.stage_seconds["merge"] * 1e3 for r in ctx.reports
                if "merge" in r.stage_seconds)
