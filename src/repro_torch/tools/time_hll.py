"""Time the two HLL kernels, and the cold planning stages that run them, on
the inputs of ``chip_smoke.py``, on one CUDA card.

Run from the repository root:

    PYTHONPATH=src python3 src/repro_torch/tools/time_hll.py
    PYTHONPATH=<checkout>/src python3 src/repro_torch/tools/time_hll.py \\
        --label <name>

Inputs: the banded and power-law matrices A (``2**log2_rows`` rows, each
multiplied by itself), MCL's first operand M (the R-MAT graph at
``--graph-scale - 4`` with self loops, columns normalised; ``M @ M``) and a
k-hop frontier F (the vertices two hops from {0, 1, 2} on the R-MAT graph G
at ``--graph-scale + 2``, one row; ``F @ G``). For each product ``X @ Y`` it
takes the register count the analysis picks and times, with CUDA events
(median of ``--runs`` after one warm-up call) and, from torch.profiler, the
device time of its kernels alone (the device activities whose names hold
``hll_sketch`` or ``hll_merge_kernel``; null unless the profiler recorded
each of them once a call; ``device_events`` gives each kernel's count and
milliseconds a call):

- ``kernels.hll.hll_sketch`` of Y, with its launches a call;
- ``kernels.hll.hll_merge`` of X's rows with Y's sketches as the checkout's
  own ``ops.build_sketches_op`` builds them (int32 registers before the
  one-byte layout, bytes after it), and of the analysis's sampled rows of X;
  each result is checked against the checkout's plain version;
- ``planner.build_plan(X, Y)`` whole, cold (no plan or sketch cache), with
  the host clock, synchronised: its ``analysis`` and ``prediction`` stages
  and the HLL launches one build makes.

It calls only functions that every version of the port since the graph
path has had, so the same file times another checkout through
``PYTHONPATH``, as long as its wrappers count launches into the metrics
registry (``obs.metrics.launched``); an older checkout is timed by its
own copy of this file. The last line is one JSON object.
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


def device_ms(fn, runs: int, kernel: str):
    """Device time of one ``fn`` call's kernels whose names hold ``kernel``,
    from torch.profiler: their durations summed over ``runs`` calls, divided
    by ``runs``; and for each such kernel, how many times the profiler
    recorded it and its milliseconds a call.
    The time is None unless every such kernel was recorded exactly ``runs``
    times: a reading that lost events would read low. The session idles
    20 ms before and after the calls, so that no launch lies near an edge of
    its window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    seen = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and kernel in e.name:
            n, us = seen.get(e.name, (0, 0.0))
            seen[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
    events = {name: [n, us / 1e3 / runs] for name, (n, us) in seen.items()}
    if not seen or any(n != runs for n, _ in seen.values()):
        return None, events
    return sum(us for _, us in seen.values()) / 1e3 / runs, events


def launches_per_call(fn, counter: str) -> int:
    from repro_torch.obs.metrics import launched
    before = launched(counter)
    fn()
    torch.cuda.synchronize()
    return launched(counter) - before


def time_kernel(fn, counter: str, kernel: str, runs: int) -> dict:
    dev_ms, events = device_ms(fn, runs, kernel)
    return {"launches": launches_per_call(fn, counter),
            "ms": time_cuda(fn, runs), "device_ms": dev_ms,
            "device_events": events}


def time_product(name, x, y, runs: int) -> dict:
    from repro_torch.core import analysis, planner
    from repro_torch.core import hll as chll
    from repro_torch.core.analysis import OceanConfig
    from repro_torch.kernels import hll as kl
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import launched
    cfg = OceanConfig()
    m = analysis.analyze(x, y, cfg).m_regs
    y_ids = y.indices[: y.nnz]
    sk = ops.build_sketches_op(y, m)
    regs = kl.hll_sketch(y.indptr, y_ids, m_regs=m)
    if not torch.equal(regs.int(), chll.sketch_registers_impl(
            y.indptr, y_ids, m, y.m)):
        raise AssertionError(f"{name}: hll_sketch differs from plain")
    out = {"m": m, "sketch_dtype": str(sk.dtype).replace("torch.", ""),
           "sketch_bytes": sk.numel() * sk.element_size(),
           "y_rows": y.m, "y_ids": y.nnz,
           "hll_sketch": time_kernel(
               lambda: kl.hll_sketch(y.indptr, y_ids, m_regs=m),
               "hll_sketch", "hll_sketch", runs)}
    rows = analysis._pick_sample_rows(x.m, cfg)
    for label, a in (("whole", x), ("sampled", planner.gather_rows(x, rows))):
        ids = a.indices[: a.nnz]
        merged, est = kl.hll_merge(a.indptr, ids, sk)
        pmerged, pest = kl.hll_merge_plain(a.indptr, ids, sk)
        torch.cuda.synchronize()
        if not torch.equal(merged.int(), pmerged.int()) or not torch.allclose(
                est, pest, rtol=1e-5, atol=0.0):
            raise AssertionError(f"{name} {label}: hll_merge differs from "
                                 "plain")
        del merged, est, pmerged, pest
        out[f"hll_merge_{label}"] = {
            "rows": a.m, "ids": a.nnz, **time_kernel(
                lambda: kl.hll_merge(a.indptr, ids, sk), "hll_merge",
                "hll_merge_kernel", runs)}
    stages = {"analysis": [], "prediction": [], "wall": []}
    launches = set()
    for _ in range(runs + 1):
        before = (launched("hll_sketch"), launched("hll_merge"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = planner.build_plan(x, y, cfg)
        torch.cuda.synchronize()
        stages["wall"].append(time.perf_counter() - t0)
        for k in ("analysis", "prediction"):
            stages[k].append(plan.build_seconds[k])
        launches.add((launched("hll_sketch") - before[0],
                      launched("hll_merge") - before[1]))
    out["cold_plan"] = {
        "workflow": plan.workflow, "sampled_cr": plan.sampled_cr,
        "launches_sketch_merge": sorted(launches),
        **{f"{k}_s": float(np.median(v[1:])) for k, v in stages.items()}}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2-rows", type=int, default=20)
    ap.add_argument("--graph-scale", type=int, default=16)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_hll: no CUDA device available")
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
    banded = formats.banded_csr(5, n, n, bandwidth=24, device="cuda")
    powerlaw = formats.powerlaw_csr(3, n, n, 12, device="cuda")
    m0 = graph.normalize_columns(algorithms._with_self_loops(
        graph.rmat_csr(1, args.graph_scale - 4, 16, device="cuda")))
    g = graph.rmat_csr(1, args.graph_scale + 2, 16, device="cuda")
    fronts, _ = graph.k_hop_frontier(g, [0, 1, 2], 2)
    f = algorithms.seeds_to_frontier(fronts[-1], g.n, device="cuda")
    for name, x, y in (("banded", banded, banded),
                       ("powerlaw", powerlaw, powerlaw),
                       ("mcl_iteration_1", m0, m0),
                       ("k_hop_frontier_hop_3", f, g)):
        result["products"][name] = time_product(name, x, y, args.runs)
        print(f"{name}: {json.dumps(result['products'][name])}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
