"""Executor layer: the compaction's host half (the merge state's final
slabs, then the numpy count, cumsum and scatter of every slab into C's
arrays), mean over the window's multiplies, from the port's
``span_seconds["exec.compact.scatter"]`` (span ``exec.compact.scatter``)."""
from ..spans import step_ms


def read(ctx):
    return step_ms(ctx, "exec.compact.scatter")
