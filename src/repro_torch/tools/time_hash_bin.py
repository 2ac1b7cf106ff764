"""Time the hash accumulator's bin op on every hash bin of the main path's
power-law and triangle plans, on one CUDA card.

Run from the repository root:

    PYTHONPATH=src python3 src/repro_torch/tools/time_hash_bin.py
    PYTHONPATH=<checkout>/src python3 src/repro_torch/tools/time_hash_bin.py \\
        --label <name>

It builds ``chip_smoke.py``'s power-law matrix (``2**log2_rows`` rows) and
the lower triangle L of its R-MAT graph (scale ``--graph-scale``), and plans
``A @ A`` and ``L @ L`` with ``planner.build_plan``, the hash tuner's cache
filled beforehand with the default load factor (``HASH_LOAD_FACTOR``) for
every rung, so that every checkout plans the same bins. For each hash bin it
times with CUDA events (median of ``--runs`` after one warm-up call):

- ``ops.hash_bin_op``, the whole function the executor calls for a hash bin
  (the kernel and any compaction after it), with the hash launches one call
  makes and the device memory it allocates beyond its inputs; and, from
  torch.profiler, the device time of one call (its kernels and copies
  summed, without the time the device waits for the host);
- one ``torch.sparse`` CSR @ CSR call (cuSPARSE) computing the same rows of
  C, the bin's rows of A times A: the library's time for the same function,
  whose nnz is checked against the bin op's (rows that overflow their
  tables excepted: their nnz is a flag, not a count).

It also prints each bin's shape: rows, ELL width, table and spill,
products per row. It calls only functions that every version of the port
since the graph path has had, so the same file times another checkout
through ``PYTHONPATH``, as long as its wrappers count launches into the
metrics registry (``obs.metrics.launched``); an older checkout is timed by
its own copy of this file. The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess

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


def device_ms(fn, runs: int) -> float:
    """Device time of one ``fn`` call, from torch.profiler: the summed
    durations of the device activities (kernels, copies, fills) of ``runs``
    calls, over ``runs``. Unlike a CUDA-event time it leaves out the gaps in
    which the device waits for the host to enqueue the next launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / runs


def pin_tuning() -> None:
    """Every rung's load factor at the default, as if already timed."""
    from repro_torch.core import tuning
    for rung in [32 * 2 ** k for k in range(8)] + [tuning.REFERENCE_RUNG]:
        tuning.DEFAULT_TUNING_CACHE.insert(tuning.tuning_key(rung, "cuda"),
                                           tuning.HashTuning())


def bin_shape(hb) -> dict:
    live = hb.a_rows >= 0
    per_row = torch.where(live, hb.a_lens, 0).sum(1, dtype=torch.int64)
    q = torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=torch.float64,
                     device=per_row.device)
    return {"rows": len(hb.rows), "ell_width": int(hb.a_rows.shape[1]),
            "table": hb.table, "spill": hb.spill,
            "live_slots": int(live.sum()), "products": int(per_row.sum()),
            "products_per_row_p50_p90_p99_max": [
                float(x) for x in torch.quantile(per_row.double(), q)]}


def time_bin(a, hb, runs: int) -> dict:
    from repro_torch.core import planner
    from repro_torch.kernels import ops
    from repro_torch.obs.metrics import launched
    b_cols, b_vals = ops.pad_b_flat(a)
    a_vals = ops.gather_bin_values(a.values, hb.pos, hb.valid)
    args = (hb.a_rows, a_vals, hb.a_starts, hb.a_lens, b_cols, b_vals)
    kw = dict(table=hb.table, spill=hb.spill)
    width = hb.table + hb.spill
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = launched("hash")
    cols, vals, nnz = ops.hash_bin_op(*args, **kw)
    torch.cuda.synchronize()
    launches = launched("hash") - before
    scratch = torch.cuda.max_memory_allocated() - base
    ms = time_cuda(lambda: ops.hash_bin_op(*args, **kw), runs)
    dev_ms = device_ms(lambda: ops.hash_bin_op(*args, **kw), runs)
    out = bin_shape(hb)
    fits = nnz <= width
    out.update({"bin_op_ms": ms, "device_ms": dev_ms,
                "launches_per_call": launches,
                "alloc_beyond_inputs_gib": scratch / 2**30,
                "nnz": int(nnz[fits].long().sum()),
                "rows_over_tables": int((~fits).sum())})

    sub = planner.gather_rows(a, hb.rows)
    ta = torch.sparse_csr_tensor(sub.indptr, sub.indices[: sub.nnz],
                                 sub.values[: sub.nnz], size=sub.shape,
                                 check_invariants=False)
    tb = torch.sparse_csr_tensor(a.indptr, a.indices[: a.nnz],
                                 a.values[: a.nnz], size=a.shape,
                                 check_invariants=False)
    lib = ta @ tb
    lib_rows = torch.diff(lib.crow_indices())
    lib_nnz = int(lib_rows[fits].sum())
    if lib_nnz != out["nnz"]:
        raise AssertionError(f"t{hb.table}: torch.sparse has {lib_nnz} "
                             f"entries in the rows that fit, the bin op "
                             f"{out['nnz']}")
    out.update({"library_ms": time_cuda(lambda: ta @ tb, runs),
                "library_nnz": int(lib._nnz())})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2-rows", type=int, default=20)
    ap.add_argument("--graph-scale", type=int, default=16)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_hash_bin: no CUDA device available")
    from repro_torch import graph
    from repro_torch.core import formats, planner
    from repro_torch.obs import metrics
    metrics.install_registry(metrics.MetricsRegistry())
    n = 1 << args.log2_rows
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result = {"label": args.label, "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi, "rows": n, "graph_scale": args.graph_scale,
              "bins": {}}
    pin_tuning()
    low = graph.lower_triangle(graph.rmat_csr(1, args.graph_scale, 16,
                                              device="cuda"))
    mats = {"powerlaw": formats.powerlaw_csr(3, n, n, 12, device="cuda"),
            "triangles": low}
    for name, a in mats.items():
        plan = planner.build_plan(a, a)
        total = 0.0
        for hb in sorted(plan.hash, key=lambda h: h.table):
            key = f"{name}_t{hb.table}"
            result["bins"][key] = time_bin(a, hb, args.runs)
            total += result["bins"][key]["bin_op_ms"]
            print(f"{key}: {json.dumps(result['bins'][key])}", flush=True)
        result[f"{name}_bin_op_ms_sum"] = total
        print(f"{name}: {len(plan.hash)} hash bins, bin op ms summed "
              f"{total:.3f}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
