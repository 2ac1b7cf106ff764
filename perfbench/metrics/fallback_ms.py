"""Executor layer: the overflow fallback (gather of the overflowed rows,
ESC on the card, the copy back, the slab on the host), mean over the
window's multiplies, from the port's
``span_seconds["exec.overflow_fallback"]`` (span
``exec.overflow_fallback``, whose steps are the ``exec.fallback.*``
spans); a multiply in which no row overflowed counts 0."""
from ..spans import step_ms


def read(ctx):
    return step_ms(ctx, "exec.overflow_fallback")
