"""Time the dense accumulator's bin op on the main path's dense bins, on one
CUDA card.

Run from the repository root:

    PYTHONPATH=src python3 src/repro_torch/tools/time_dense_bin.py
    PYTHONPATH=<checkout>/src python3 src/repro_torch/tools/time_dense_bin.py \\
        --label <name>

It builds ``chip_smoke.py``'s banded and power-law matrices (``2**log2_rows``
rows), plans ``A @ A`` for each with ``planner.build_plan``, and times with
CUDA events (median of ``--runs`` after one warm-up call):

- ``ops.dense_bin_op``, the whole function the executor calls for a dense
  bin (the kernel and any compaction after it), on banded's largest windowed
  bin and on power-law's largest long-row bin; with the dense launches one
  call makes and the device memory it allocates beyond its inputs;
- one ``torch.sparse`` CSR @ CSR call (cuSPARSE) computing the same rows of
  C, the bin's rows of A times A: the library's time for the same function,
  whose nnz is checked against the bin op's.

It also prints each bin's shape: rows, ELL width, cap, live slots and
products per row. It calls only functions that every version of the port
has had, so the same file times another checkout through ``PYTHONPATH``,
as long as its wrappers count launches into the metrics registry
(``obs.metrics.launched``); an older checkout is timed by its own copy of
this file. The last line is one JSON object.
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


def dense_launches() -> int:
    from repro_torch.obs import metrics
    return metrics.launched("dense_window", "dense_longrow")


def bin_shape(be) -> dict:
    live = be.a_rows >= 0
    per_row = torch.where(live, be.a_lens, 0).sum(1, dtype=torch.int64)
    slots = live.sum(1)
    q = torch.tensor([0.5, 0.9, 0.99, 1.0], device=per_row.device)
    return {"rows": len(be.rows), "ell_width": int(be.a_rows.shape[1]),
            "window": be.window, "col_tiles": be.col_tiles, "cap": be.cap,
            "live_slots": int(live.sum()),
            "slots_per_row_p50_p90_p99_max": [
                float(x) for x in torch.quantile(slots.double(), q.double())],
            "products": int(per_row.sum()),
            "products_per_row_p50_p90_p99_max": [
                float(x) for x in torch.quantile(per_row.double(),
                                                 q.double())]}


def time_bin(a, be, runs: int) -> dict:
    from repro_torch.core import planner
    from repro_torch.kernels import ops
    b_cols, b_vals = ops.pad_b_flat(a)
    a_vals = ops.gather_bin_values(a.values, be.pos, be.valid)
    args = (be.a_rows, a_vals, be.a_starts, be.a_lens, be.row_lo, b_cols,
            b_vals)
    kw = dict(window=be.window, col_tiles=be.col_tiles, cap=be.cap)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dense_launches()
    cols, vals, nnz = ops.dense_bin_op(*args, **kw)
    torch.cuda.synchronize()
    launches = dense_launches() - before
    scratch = torch.cuda.max_memory_allocated() - base
    ms = time_cuda(lambda: ops.dense_bin_op(*args, **kw), runs)

    sub = planner.gather_rows(a, be.rows)
    ta = torch.sparse_csr_tensor(sub.indptr, sub.indices[: sub.nnz],
                                 sub.values[: sub.nnz], size=sub.shape,
                                 check_invariants=False)
    tb = torch.sparse_csr_tensor(a.indptr, a.indices[: a.nnz],
                                 a.values[: a.nnz], size=a.shape,
                                 check_invariants=False)
    lib_nnz = int((ta @ tb)._nnz())
    lib_ms = time_cuda(lambda: ta @ tb, runs)
    out = bin_shape(be)
    out.update({"bin_op_ms": ms, "launches_per_call": launches,
                "alloc_beyond_inputs_gib": scratch / 2**30,
                "nnz": int(nnz.long().sum()),
                "rows_over_cap": int((nnz > be.cap).sum()),
                "library_ms": lib_ms, "library_nnz": lib_nnz})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2-rows", type=int, default=20)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_dense_bin: no CUDA device available")
    from repro_torch.core import formats, planner
    from repro_torch.obs import metrics
    metrics.install_registry(metrics.MetricsRegistry())
    n = 1 << args.log2_rows
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result = {"label": args.label, "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi, "rows": n, "bins": {}}
    mats = {"banded": formats.banded_csr(5, n, n, bandwidth=24,
                                         device="cuda"),
            "powerlaw": formats.powerlaw_csr(3, n, n, 12, device="cuda")}
    for name, a in mats.items():
        plan = planner.build_plan(a, a)
        long = name == "powerlaw"
        bins = [be for be in plan.dense if be.is_longrow == long]
        if not bins:
            print(f"{name}: no {'long-row' if long else 'windowed'} bin")
            continue
        be = max(bins, key=lambda x: len(x.rows))
        key = f"{name}_{'longrow' if long else 'window'}"
        result["bins"][key] = time_bin(a, be, args.runs)
        print(f"{key}: {json.dumps(result['bins'][key])}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
