"""Time the symbolic prediction's count on the power-law, triangle and MCL
inputs of ``chip_smoke.py``, on one CUDA card.

Run from the repository root:

    PYTHONPATH=src python3 src/repro_torch/tools/time_count.py
    PYTHONPATH=<checkout>/src python3 src/repro_torch/tools/time_count.py \\
        --label <name>

It builds the power-law matrix A (``2**log2_rows`` rows), the lower triangle
L of the R-MAT graph at ``--graph-scale`` and MCL's first operand M (the
R-MAT graph at ``--graph-scale - 4`` with self loops, columns normalised),
and takes the analysis stats of ``A @ A``, ``L @ L`` and ``M @ M``
(``analysis._fused_stats``). The counted rows are the rows with products
whose output range is at most ``WINDOW_LADDER[-1]`` columns wide. For each
product it times ``planner.symbolic_row_nnz`` with the host clock,
synchronised, median of ``--runs`` after one warm-up call:

- whole;
- its count part: the same call with the products of every other row set
  to 0, so that the call counts the counted rows and nothing else; with the
  count kernel's launches in one call (``kernel.launches`` in the metrics
  registry), their summed CUDA-event time (events around each count call of
  ``kernels.ops``) and, from torch.profiler, their device time (the device
  activities named after either kernel of ``spgemm_count.cu``), which
  leaves out the wrappers' Python and the gaps between launches;
- its ESC rest: the same call with the counted rows' products set to 0;

and one ``torch.sparse`` CSR @ CSR call (cuSPARSE) of the counted rows of
the left operand by the right, whose per-row nnz (its ``crow_indices``
diff) is checked against the prediction: the library's time for the count's
function.

It calls only functions that every version of the port since the graph
path has had, and reads whichever count wrappers the checkout has, so the
same file times another checkout through ``PYTHONPATH``, as long as its
wrappers count launches into the metrics registry
(``obs.metrics.launched``); an older checkout is timed by its own copy of
this file. The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def time_cuda(fn, runs: int) -> float:
    """Median milliseconds of ``fn`` over ``runs`` runs, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


class EventTimed:
    """Wraps a function: CUDA events around each call, summed on read."""

    def __init__(self, fn):
        self.fn = fn
        self.events = []

    def __call__(self, *args, **kw):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = self.fn(*args, **kw)
        t1.record()
        self.events.append((t0, t1))
        return out

    def take_ms(self) -> float:
        torch.cuda.synchronize()
        ms = sum(t0.elapsed_time(t1) for t0, t1 in self.events)
        self.events = []
        return ms


COUNT_WRAPPERS = ("spgemm_count_bin", "spgemm_count_rows")
COUNT_KERNELS = ("count_bin_kernel", "count_rows_kernel")


def count_device_ms(fn, runs: int) -> float:
    """Device time of the count kernels in one ``fn`` call, from
    torch.profiler: the summed durations of the count kernels' device
    activities over ``runs`` calls, divided by ``runs``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and any(k in e.name for k in COUNT_KERNELS))
    return us / 1e3 / runs


def count_launches() -> int:
    from repro_torch.obs import metrics
    return metrics.launched("count_bin", "count_rows")


def host_ms(fn, runs: int):
    """Median host milliseconds of ``fn`` over ``runs`` synchronised calls
    after one warm-up call, and the count launches of each call."""
    fn()
    times, launches = [], []
    for _ in range(runs):
        before = count_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches.append(count_launches() - before)
    return float(np.median(times)), sorted(set(launches))


def time_product(name, a, b, runs: int) -> dict:
    from repro_torch.core import analysis, formats, planner
    from repro_torch.core.binning import WINDOW_LADDER
    from repro_torch.kernels import ops
    prod, lo, hi = (formats.host(x) for x in analysis._fused_stats(a, b))
    fits = (prod > 0) & (hi.astype(np.int64) - lo + 1 <= WINDOW_LADDER[-1])
    counted = np.nonzero(fits)[0]
    prod_count = np.where(fits, prod, 0)
    prod_rest = np.where(fits, 0, prod)

    def call(p):
        return lambda: planner.symbolic_row_nnz(a, b, lo, hi, p)

    pred = call(prod)()
    whole_ms, _ = host_ms(call(prod), runs)
    rest_ms, rest_launches = host_ms(call(prod_rest), runs)
    if rest_launches != [0]:
        raise AssertionError(f"{name}: count launches {rest_launches} "
                             "without counted rows")
    # events around the count calls the ops make
    timed = {n: EventTimed(getattr(ops, n)) for n in COUNT_WRAPPERS
             if hasattr(ops, n)}
    for n, t in timed.items():
        setattr(ops, n, t)
    try:
        count_ms, launches = host_ms(call(prod_count), runs)
        for t in timed.values():
            t.take_ms()
        event_ms = []
        for _ in range(runs):
            call(prod_count)()
            event_ms.append(sum(t.take_ms() for t in timed.values()))
    finally:
        for n, t in timed.items():
            setattr(ops, n, t.fn)
    device_ms = count_device_ms(call(prod_count), runs)

    sub = planner.gather_rows(a, counted)
    ta = torch.sparse_csr_tensor(sub.indptr, sub.indices[: sub.nnz],
                                 sub.values[: sub.nnz], size=sub.shape,
                                 check_invariants=False)
    tb = torch.sparse_csr_tensor(b.indptr, b.indices[: b.nnz],
                                 b.values[: b.nnz], size=b.shape,
                                 check_invariants=False)
    lib_rows = formats.host(torch.diff((ta @ tb).crow_indices()))
    if not np.array_equal(lib_rows, pred[counted]):
        raise AssertionError(f"{name}: torch.sparse row nnz differs from the "
                             "prediction on the counted rows")
    return {
        "rows": int(a.m), "counted_rows": int(len(counted)),
        "counted_products": int(prod[counted].sum()),
        "esc_rows": int((prod_rest > 0).sum()),
        "symbolic_row_nnz_ms": whole_ms,
        "count_part_ms": count_ms,
        "count_launches_per_call": launches,
        "count_event_ms": float(np.median(event_ms)),
        "count_device_ms": device_ms,
        "esc_rest_ms": rest_ms,
        "library_ms": time_cuda(lambda: ta @ tb, runs),
        "counted_nnz": int(lib_rows.sum())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2-rows", type=int, default=20)
    ap.add_argument("--graph-scale", type=int, default=16)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_count: no CUDA device available")
    from repro_torch import graph
    from repro_torch.core import formats
    from repro_torch.graph import algorithms
    from repro_torch.obs import metrics
    metrics.install_registry(metrics.MetricsRegistry())
    n = 1 << args.log2_rows
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result = {"label": args.label, "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi, "rows": n, "graph_scale": args.graph_scale,
              "products": {}}
    low = graph.lower_triangle(graph.rmat_csr(1, args.graph_scale, 16,
                                              device="cuda"))
    m0 = graph.normalize_columns(algorithms._with_self_loops(
        graph.rmat_csr(1, args.graph_scale - 4, 16, device="cuda")))
    mats = {"powerlaw": formats.powerlaw_csr(3, n, n, 12, device="cuda"),
            "triangles": low, "mcl_iteration_1": m0}
    for name, a in mats.items():
        result["products"][name] = time_product(name, a, a, args.runs)
        print(f"{name}: {json.dumps(result['products'][name])}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
