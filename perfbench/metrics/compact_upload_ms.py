"""Executor layer: the compaction's copy of C to the card
(``csr_from_arrays``), mean over the window's multiplies, from the port's
``span_seconds["exec.compact.upload"]`` (span ``exec.compact.upload``)."""
from ..spans import step_ms


def read(ctx):
    return step_ms(ctx, "exec.compact.upload")
