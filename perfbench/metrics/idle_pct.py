"""Device layer: the share of the traced window in which nothing (no
kernel, copy or memset) ran on the device, from the union of the device
activities' intervals in the profiler's trace. Nothing to read where the
trace recorded no device activity."""
from .. import devtrace


def read(ctx):
    if not ctx.device_events:
        return None
    w0, w1 = ctx.window
    busy = devtrace.covered(devtrace.clip(ctx.device_events, w0, w1))
    return 100.0 * (1.0 - busy / (w1 - w0))
