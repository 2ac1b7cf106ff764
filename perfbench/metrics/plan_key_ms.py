"""Workflow layer: the plan-cache key inside the lookup (``structure_key``:
both patterns copied to the host and hashed), mean over the window's
multiplies, from the port's ``span_seconds["plan.key"]`` (span
``plan.key``); a multiply that did not consult the cache counts 0."""
from ..spans import step_ms


def read(ctx):
    return step_ms(ctx, "plan.key")
