"""Time the dense accumulator's bin op on the main path's dense bins, on one
CUDA card.

Run from the repository root:

    PYTHONPATH=src python3 src/repro_torch/tools/time_dense_bin.py
    PYTHONPATH=<checkout>/src python3 src/repro_torch/tools/time_dense_bin.py \\
        --label <name>

It builds ``chip_smoke.py``'s banded and power-law matrices (``2**log2_rows``
rows) and a Graph500-style R-MAT graph (``--rmat-scale``, edge factor 16,
random weights; 0 leaves it out), plans ``A @ A`` for each with
``planner.build_plan``, and times with CUDA events (median of ``--runs``
after one warm-up call):

- ``ops.dense_bin_op``, the whole function the executor calls for a dense
  bin (the kernel and any compaction after it), on banded's largest windowed
  bin, on power-law's largest long-row bin and on every long-row launch of
  R-MAT's plan (the symbolic workflow sizes them from the rows' exact sizes,
  one launch a cap); with the dense launches one call makes and the device
  memory it allocates beyond its inputs; on R-MAT also the launch against
  ``spgemm_dense.dense_slab_plain`` on the card: columns and counts equal,
  and the values' largest difference (the plain version's ``torch.
  segment_reduce`` sums a segment in another order there);
- one ``torch.sparse`` CSR @ CSR call (cuSPARSE) computing the same rows of
  C, the bin's rows of A times A: the library's time for the same function,
  whose nnz is checked against the bin op's.

It also prints each bin's shape: rows, ELL width, cap, live slots,
products per row and the bin's bound (``bound_ms``: bytes at 3.35 TB/s or
two operations a product at 67 TFLOP/s). It calls only functions that
every version of the port has had, so the same file times another
checkout through ``PYTHONPATH``, as long as its wrappers count launches
into the metrics registry (``obs.metrics.launched``); an older checkout
is timed by its own copy of this file. The last line is one JSON object.
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


# the H100's HBM3 bandwidth and f32 rate (``perfbench/peaks.json``)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def bound_ms(be, products: int) -> float:
    """The least time the card could take for the bin: the bytes it must
    move (a_rows whole, the other ELL inputs at live slots, each row's
    window base, each B row the bin references once, the slabs and counts
    written) at the HBM peak, or two operations a product at the f32 peak,
    whichever is longer."""
    live = be.a_rows >= 0
    r, e = be.a_rows.shape
    b_len = torch.zeros(int(be.a_rows.max()) + 1 if live.any() else 1,
                        dtype=torch.int64, device=be.a_rows.device)
    b_len[be.a_rows[live].long()] = be.a_lens[live].long()
    by = (r * e * 4 + int(live.sum()) * 12 + r * 4 + int(b_len.sum()) * 8
          + r * (be.cap * 8 + 4))
    return 1e3 * max(by / PEAK_BYTES_PER_S, 2 * products / PEAK_F32_PER_S)


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
            "bound_ms": bound_ms(be, int(per_row.sum())),
            "products_per_row_p50_p90_p99_max": [
                float(x) for x in torch.quantile(per_row.double(),
                                                 q.double())]}


def time_bin(a, be, runs: int, check: bool = False) -> dict:
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
    if check:
        from repro_torch.kernels import spgemm_dense
        want = spgemm_dense.dense_slab_plain(*args, **kw)
        out["plain_cols_nnz_equal"] = (torch.equal(cols, want[0])
                                       and torch.equal(nnz, want[2]))
        out["plain_max_abs_err"] = float((vals - want[1]).abs().max())
        del want
    out.update({"bin_op_ms": ms, "launches_per_call": launches,
                "alloc_beyond_inputs_gib": scratch / 2**30,
                "nnz": int(nnz.long().sum()),
                "rows_over_cap": int((nnz > be.cap).sum()),
                "library_ms": lib_ms, "library_nnz": lib_nnz})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2-rows", type=int, default=20)
    ap.add_argument("--rmat-scale", type=int, default=15)
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
    if args.rmat_scale:
        from repro_torch import graph
        a = graph.rmat_csr(1, args.rmat_scale, 16, weights="random",
                           device="cuda")
        plan = planner.build_plan(a, a)
        result["rmat"] = {"scale": args.rmat_scale, "nnz": a.nnz,
                          "workflow": plan.workflow,
                          "exact_wide_rows": getattr(plan, "exact_wide_rows",
                                                     None)}
        for be in plan.dense:
            if be.is_longrow:
                key = f"rmat_longrow_cap{be.cap}"
                result["bins"][key] = time_bin(a, be, args.runs, check=True)
                print(f"{key}: {json.dumps(result['bins'][key])}",
                      flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
