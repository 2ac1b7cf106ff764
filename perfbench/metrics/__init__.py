"""Per-layer metric readers, one module per metric, found by the metric's
name in ``BENCHMARK.json``. Each defines ``read(ctx)`` returning a number,
or ``None`` where the run gave it nothing to read."""
