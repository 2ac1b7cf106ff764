"""Kernels layer: the multiplies' least time on the card over the time the
device's kernels took, summed over the window.

The least time of one multiply is the larger of two terms, counted from
the configuration's A, B and C and its declared widths alone, whatever
kernels, layouts or launches the program uses:

* bytes: A and B read once (A once where B is A) and C written once, each
  as row offsets, column indices and values, at the card's memory rate;
* operations: 2 a product (a multiply and an add), at the card's float32
  rate outside the tensor cores.

The kernels' time is the union of every kernel interval in the profiler's
trace within the window (copies and memsets excluded), so overlapping
kernels count once. That is every kernel the multiply launches: the
port's hand-written ones (``kernels/csrc/*.cu``) and the PyTorch kernels
its planner and executor launch (the ESC fallback's sorts and segmented
sums among them), so the share reads all device work of a multiply
against its least time, not the hand-written kernels alone: work moved
onto the device by PyTorch kernels lowers it. Nothing to read for a card
without published peaks or a trace without kernels.
"""
from .. import devtrace


def matrix_bytes(rows: int, nnz: int, widths: dict) -> int:
    """Bytes of a CSR: rows + 1 offsets, nnz column indices and values."""
    return (widths["offset_bytes"] * (rows + 1)
            + nnz * (widths["index_bytes"] + widths["value_bytes"]))


def bytes_moved(work: dict, widths: dict) -> int:
    """Operand bytes read once plus C's bytes written once."""
    a = matrix_bytes(work["rows"], work["nnz_a"], widths)
    b = 0 if work["same_operand"] else matrix_bytes(
        work["inner"], work["nnz_b"], widths)
    return a + b + matrix_bytes(work["rows"], work["nnz_c"], widths)


def operations(work: dict) -> int:
    return 2 * work["products"]


def bound_seconds(work: dict, widths: dict, peaks: dict) -> float:
    """The least time one multiply can take on the card."""
    return max(bytes_moved(work, widths) / peaks["memory_bytes_per_s"],
               operations(work) / peaks["f32_flops_per_s"])


def read(ctx):
    if ctx.peaks is None or not ctx.reports:
        return None
    w0, w1 = ctx.window
    kernels = [ev for ev in devtrace.clip(ctx.device_events, w0, w1)
               if devtrace.kind_of(ev[2]) == "kernel"]
    busy = devtrace.covered(kernels)
    if busy <= 0.0:
        return None
    bound = ctx.multiplies * bound_seconds(ctx.work, ctx.widths, ctx.peaks)
    return 100.0 * bound / busy
