#!/usr/bin/env python3
"""Drive the PyTorch port of Ocean SpGEMM on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py                  # 2**20-row matrices (default)
    python3 chip_smoke.py --log2-rows 14   # a quick, small run

Phases, each of which raises on failure:

1. print the card, the torch/CUDA versions, and build the CUDA kernels
   from ``src/repro_torch/kernels/csrc`` (build seconds printed);
2. main path: ``repro_torch.core.workflow.ocean_spgemm(a, a)`` on a banded
   matrix (estimation workflow: ``hll_merge`` + dense windows) and a
   power-law matrix (symbolic workflow: hash bins + long-row dense tiles),
   each called cold (plan built) and warm (plan-cache hit), with every
   kernel's launch count set to 0 just before each matrix and read just
   after, and the kernels each matrix's path must launch checked; C is
   checked against ``scipy.sparse``, and one ``torch.sparse`` product of
   the same matrix is timed as a yardstick; then one more warm call per
   matrix under torch.profiler gives the device's busy time and idle share;
3. kernels against their plain PyTorch versions, on the card, on real bins
   of the phase-2 plans at the shapes the main path launches them with,
   with times from CUDA events and each kernel's bound;
4. the small suite (``make_suite(1)``) through ``ocean_spgemm`` on the card
   against scipy, which also drives the ESC and upper-bound paths.

The line before the last holds ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
with a non-zero code and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
INT32_OPS_PER_S = 33.5e12   # H100 SXM int32 (half the f32 rate)
KERNEL_RUNS = 10            # timed launches per kernel (median reported)

REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    t0 = time.perf_counter()
    log(f"== {name}")
    return lambda: log(f"== {name}: {time.perf_counter() - t0:.2f} s")


def close_enough(got, want, rtol=1e-5, atol=1e-5) -> float:
    """Max abs difference; raises when any entry is outside atol+rtol*|want|."""
    import torch
    diff = (got.double() - want.double()).abs()
    bad = diff > atol + rtol * want.double().abs()
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} entries differ; max abs "
                             f"diff {float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def time_cuda(fn, runs: int) -> float:
    """Median milliseconds of ``fn`` over ``runs`` runs, CUDA events."""
    import torch
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


def bound(bytes_moved: float, ops: float, ops_per_s: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ell_bytes(a_rows) -> float:
    """Bytes of a bin's (R, E) ELL inputs that a kernel needs: ``a_rows``
    in full (it is scanned for the last live slot), ``a_vals``, ``a_starts``
    and ``a_lens`` only at live slots (padding is never read)."""
    return a_rows.numel() * 4 + float((a_rows >= 0).sum()) * 12


def unique_b_bytes(a_rows, a_lens) -> float:
    """Bytes of the B rows a bin references, each read once (col + val)."""
    import torch
    live = a_rows >= 0
    k = a_rows[live].long()
    lens = a_lens[live].long()
    if k.numel() == 0:
        return 0.0
    uk, first = torch.unique(k, return_inverse=True)
    per = torch.zeros(uk.shape[0], dtype=torch.int64, device=k.device)
    per.scatter_(0, first, lens)
    return float(per.sum()) * 8


def to_scipy(c):
    import scipy.sparse as sp
    from repro_torch.core import formats
    indptr, indices, values = formats.to_numpy(c)
    return sp.csr_matrix((values, indices, indptr), shape=c.shape)


def check_against_scipy(c, a_sp, label: str) -> float:
    ref = a_sp @ a_sp
    ref.sort_indices()
    ours = to_scipy(c)
    if not ours.has_sorted_indices:
        raise AssertionError(f"{label}: C rows are not column-sorted")
    if not np.isfinite(ours.data).all():
        raise AssertionError(f"{label}: C has non-finite values")
    ours.eliminate_zeros()  # scipy drops exact zeros from its product
    if not np.array_equal(ours.indptr, ref.indptr):
        raise AssertionError(f"{label}: indptr differs from scipy")
    if not np.array_equal(ours.indices, ref.indices):
        raise AssertionError(f"{label}: indices differ from scipy")
    # scipy sums products in another order: tolerance for f32 reordering
    np.testing.assert_allclose(ours.data, ref.data, rtol=1e-4, atol=1e-4,
                               err_msg=label)
    return float(np.abs(ours.data - ref.data).max()) if ours.nnz else 0.0


def library_product(a, runs: int):
    """Median ms of one ``torch.sparse`` CSR @ CSR call (cuSPARSE SpGEMM) on
    the same matrix, a yardstick for the whole multiply used nowhere in the
    port, and the nnz of its product."""
    import torch
    t = torch.sparse_csr_tensor(a.indptr, a.indices[: a.nnz],
                                a.values[: a.nnz], size=a.shape,
                                check_invariants=False)
    return time_cuda(lambda: t @ t, runs), int((t @ t)._nnz())


def reset_counts(kd, kh, kl) -> None:
    kd.spgemm_dense_bin.window_launches = 0
    kd.spgemm_dense_bin.longrow_launches = 0
    kh.spgemm_hash_bin.launches = 0
    kl.hll_merge.launches = 0


def read_counts(kd, kh, kl) -> dict:
    return {"dense_window": kd.spgemm_dense_bin.window_launches,
            "dense_longrow": kd.spgemm_dense_bin.longrow_launches,
            "hash": kh.spgemm_hash_bin.launches,
            "hll_merge": kl.hll_merge.launches}


def longrow_edge_cases(kd, dev) -> None:
    """The long-row rung on inputs the main path may not give it: a B row
    with more products than the kernel stages at once, ELL padding between
    live slots, a row of padding only, and a B row with a repeated column."""
    import torch
    rng = np.random.default_rng(0)
    window, tiles = 2048, 4
    width = window * tiles
    rows = [rng.choice(width, 6000, replace=False), rng.choice(width, 10,
                                                               replace=False),
            np.array([5, 5, 7]), rng.choice(width, 300, replace=False)]
    starts = np.cumsum([0] + [len(x) for x in rows])
    b_cols = np.concatenate(rows + [np.full(128, -1)]).astype(np.int32)
    b_vals = rng.standard_normal(len(b_cols)).astype(np.float32)
    ell = np.array([[0, -1, 1, 2, -1, 3, 0, -1],
                    [-1] * 8,
                    [3, 1, 2, 3, 1, 2, 3, 1]], np.int32)
    live = ell >= 0
    a_starts = np.where(live, starts[np.maximum(ell, 0)], 0).astype(np.int32)
    a_lens = np.where(live, np.diff(starts)[np.maximum(ell, 0)],
                      0).astype(np.int32)
    a_vals = np.where(live, rng.standard_normal(ell.shape), 0).astype(
        np.float32)
    t = [torch.as_tensor(x, device=dev) for x in
         (ell, a_vals, a_starts, a_lens, np.zeros((3, 1), np.int32), b_cols,
          b_vals)]
    acc, cnt = kd.spgemm_dense_bin(*t, window=window, col_tiles=tiles)
    pacc, pcnt = kd.dense_bin_plain(*t, window=window, col_tiles=tiles)
    if not torch.equal(cnt, pcnt):
        raise AssertionError("long-row edge cases: counts differ from plain")
    err = close_enough(acc, pacc)
    log(f"dense_longrow edge cases: max_abs_err {err:.3g}")


def profile_call(name, a, cache, workflow) -> None:
    """Device busy share of one warm ``ocean_spgemm`` call, and the device
    activities (kernels, copies) that took the most time, from
    torch.profiler. Busy time is the union of the device activities'
    intervals: the host ops that launched them are not counted again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        workflow.ocean_spgemm(a, a, cache=cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        log(f"{name} profile: no device activity recorded (not measured)")
        return
    busy_us, end = 0.0, float("-inf")
    by_name = {}
    for s, e, key in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        us, cnt = by_name.get(key, (0.0, 0))
        by_name[key] = (us + e - s, cnt + 1)
    busy_ms = busy_us / 1e3
    log(f"{name} profile: wall {wall * 1e3:.1f} ms device busy "
        f"{busy_ms:.1f} ms idle share {1 - busy_ms / (wall * 1e3):.3f} "
        "(profiler on)")
    for key, (us, cnt) in sorted(by_name.items(), key=lambda r: -r[1][0])[:8]:
        log(f"  {us / 1e3:9.2f} ms  x{cnt:<5d} {key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2-rows", type=int, default=20,
                    help="rows (= columns) of the two main-path matrices")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.core import formats, planner, workflow
    from repro_torch.core.analysis import OceanConfig
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import hll as kl
    from repro_torch.kernels import spgemm_dense as kd
    from repro_torch.kernels import spgemm_hash as kh
    from repro_torch.obs import trace

    # ---------------- 1. card + build ----------------
    done = phase("1. card and kernel build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.BUILD_SECONDS})")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas " + line.strip())
    done()

    # ---------------- 2. main path ----------------
    n = 1 << args.log2_rows
    dev = "cuda"
    done = phase(f"2. main path at {n} rows")
    t0 = time.perf_counter()
    mats = [("banded", formats.banded_csr(5, n, n, bandwidth=24,
                                          device=dev)),
            ("powerlaw", formats.powerlaw_csr(3, n, n, 12, device=dev))]
    log(f"generated in {time.perf_counter() - t0:.1f} s: " + ", ".join(
        f"{k} nnz {a.nnz}" for k, a in mats))
    results = {}
    caches = {}
    path_counts = {}

    def drive(name, a):
        cache = planner.PlanCache()
        caches[name] = cache
        outs = []
        reset_counts(kd, kh, kl)
        for call in ("cold", "warm"):
            before = read_counts(kd, kh, kl)
            tracer = trace.Tracer()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with trace.tracing(tracer):
                c, rep = workflow.ocean_spgemm(a, a, cache=cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {k: v - before[k]
                        for k, v in read_counts(kd, kh, kl).items()}
            spans = {}
            for ev in tracer.events():
                spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"]
            log(f"{name} {call}: wall {wall:.3f} s workflow {rep.workflow} "
                f"hit {rep.plan_cache_hit} nnz_out {rep.nnz_out} "
                f"overflow_rows {rep.overflow_rows} products "
                f"{rep.total_products} er {rep.er:.2f} cr {rep.sampled_cr} "
                f"peak_mem {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                "GiB")
            log(f"  stages {json.dumps({k: round(v, 4) for k, v in rep.stage_seconds.items()})}")
            log(f"  spans {json.dumps({k: round(v, 4) for k, v in spans.items()})}")
            log(f"  launches {json.dumps(launched)}")
            log(f"  bins {json.dumps(rep.bins)}")
            outs.append((c, rep, wall))
        path_counts[name] = read_counts(kd, kh, kl)
        log(f"{name}: launches on its path (cold + warm) "
            f"{json.dumps(path_counts[name])}")
        return outs

    for name, a in mats:
        results[name] = drive(name, a)

    def plan_of(name, a):
        key = planner.structure_key(a, a, OceanConfig(), None, True, True)
        return caches[name].peek(key)

    plan_p = plan_of("powerlaw", mats[1][1])
    if not any(bn.is_longrow for bn in plan_p.dense):
        a = formats.skewed_rows_csr(7, n, n, 6, device=dev)
        mats.append(("skewed", a))
        results["skewed"] = drive("skewed", a)
    long_path = "skewed" if "skewed" in path_counts else "powerlaw"
    need = {"banded": ["hll_merge", "dense_window"], "powerlaw": ["hash"]}
    need[long_path] = need.get(long_path, []) + ["dense_longrow"]
    for path, names in need.items():
        missing = [k for k in names if path_counts[path][k] == 0]
        if missing:
            raise AssertionError(f"{path}: kernels never launched on its "
                                 f"path: {missing}")
    counts = {k: sum(pc[k] for pc in path_counts.values())
              for k in read_counts(kd, kh, kl)}
    by_path = {k: {p: pc[k] for p, pc in path_counts.items()}
               for k in counts}
    log(f"launches on the main path: {json.dumps(counts)}")
    wf = {name: outs[0][1].workflow for name, outs in results.items()}
    if wf["banded"] != "estimation":
        raise AssertionError(f"banded took {wf['banded']}, not estimation")
    for name, a in mats:
        (c0, _, _), (c1, _, _) = results[name]
        for part, x, y in zip(("indptr", "indices", "values"),
                              formats.to_numpy(c0), formats.to_numpy(c1)):
            if not np.array_equal(x, y):
                raise AssertionError(f"{name}: warm C {part} differs from "
                                     "cold C")
        a_sp = to_scipy(a)
        t0 = time.perf_counter()
        err = check_against_scipy(c1, a_sp, name)
        log(f"{name}: C matches scipy (max abs diff {err:.3g}, check "
            f"{time.perf_counter() - t0:.1f} s)")
        lib_ms, lib_nnz = library_product(a, 3)
        if lib_nnz != c1.nnz:  # both keep structural zeros
            raise AssertionError(f"{name}: torch.sparse product has "
                                 f"{lib_nnz} entries, C {c1.nnz}")
        log(f"{name}: library torch.sparse CSR @ CSR {lib_ms:.1f} ms "
            f"(median of 3, CUDA events), nnz {lib_nnz} as C")
    done()

    done = phase("2b. torch.profiler over one more warm call per matrix")
    for name, a in mats:
        profile_call(name, a, caches[name], workflow)
    done()

    # ---------------- 3. kernels vs plain ----------------
    done = phase("3. kernels against their plain versions")
    kernels = []
    plan_b = plan_of("banded", mats[0][1])
    plan_l = plan_of(*mats[-1])
    a_band = mats[0][1]

    def first_launch_rows(be):
        """Rows of a bin's first launch, as ops.dense_bin_op chunks it."""
        w = be.window * be.col_tiles
        return slice(0, min(len(be.rows),
                            max(1, ops.DENSE_OUT_BYTES // (8 * w))))

    def dense_case(label, a, be, key):
        b_cols, b_vals = ops.pad_b_flat(a)
        sl = first_launch_rows(be)
        a_vals = ops.gather_bin_values(a.values, be.pos, be.valid)
        args_ = (be.a_rows[sl], a_vals[sl], be.a_starts[sl], be.a_lens[sl],
                 be.row_lo[sl], b_cols, b_vals)
        kw = dict(window=be.window, col_tiles=be.col_tiles)
        acc, cnt = kd.spgemm_dense_bin(*args_, **kw)
        pacc, pcnt = kd.dense_bin_plain(*args_, **kw)
        torch.cuda.synchronize()
        if not torch.equal(cnt, pcnt):
            raise AssertionError(f"{label}: counts differ from plain")
        err = close_enough(acc, pacc)
        ms = time_cuda(lambda: kd.spgemm_dense_bin(*args_, **kw), KERNEL_RUNS)
        plain_ms = time_cuda(lambda: kd.dense_bin_plain(*args_, **kw), 3)
        r, e = be.a_rows[sl].shape
        w = be.window * be.col_tiles
        products = float(be.a_lens[sl].long().sum())
        by = (ell_bytes(be.a_rows[sl]) + r * 4
              + unique_b_bytes(be.a_rows[sl], be.a_lens[sl]) + r * w * 8)
        b_ms, b_by = bound(by, 2 * products, F32_OPS_PER_S)
        log(f"{label}: R {r} E {e} W {be.window}x{be.col_tiles} products "
            f"{int(products)} max_abs_err {err:.3g} kernel {ms:.3f} ms plain "
            f"{plain_ms:.3f} ms bound {b_ms:.3f} ms ({b_by}, "
            f"{by / 1e9:.4f} GB)")
        kernels.append({
            "name": f"spgemm_dense_bin[{label.split('_')[-1]}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spgemm_dense.cu",
            "replaces": "src/repro/kernels/spgemm_dense.py:178",
            "launches": counts[key], "launches_by_path": by_path[key],
            "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "shape": {"R": r, "E": e, "window": be.window,
                      "col_tiles": be.col_tiles}})

    windowed = [be for be in plan_b.dense if not be.is_longrow]
    be_w = max(windowed, key=lambda be: len(be.rows))
    dense_case("dense_window", a_band, be_w, "dense_window")
    a_long = mats[-1][1]
    be_l = max((be for be in plan_l.dense if be.is_longrow),
               key=lambda be: len(be.rows))
    dense_case("dense_longrow", a_long, be_l, "dense_longrow")
    longrow_edge_cases(kd, dev)

    # hash: the largest hash bin of the power-law plan
    a_pl = mats[1][1]
    hb = max(plan_p.hash, key=lambda h: len(h.rows))
    b_cols, b_vals = ops.pad_b_flat(a_pl)
    a_vals = ops.gather_bin_values(a_pl.values, hb.pos, hb.valid)
    hargs = (hb.a_rows, a_vals, hb.a_starts, hb.a_lens, b_cols, b_vals)
    hkw = dict(table=hb.table, spill=hb.spill)
    cols, vals, nnz = kh.spgemm_hash_bin(*hargs, **hkw)
    pcols, pvals, pnnz = kh.hash_bin_plain(*hargs, **hkw)
    torch.cuda.synchronize()
    width = hb.table + hb.spill
    fits = pnnz <= width
    if not torch.equal(nnz > width, pnnz > width):
        raise AssertionError("hash: overflow flags differ from plain")
    if not torch.equal(nnz[fits], pnnz[fits]):
        raise AssertionError("hash: row nnz differs from plain")
    if not torch.equal(cols[fits], pcols[fits]):
        raise AssertionError("hash: columns differ from plain")
    err = close_enough(vals[fits], pvals[fits])
    # like for like: the wrapper (kernel + extraction into sorted slabs)
    # against the plain version, which also returns sorted slabs
    ms = time_cuda(lambda: kh.spgemm_hash_bin(*hargs, **hkw), KERNEL_RUNS)
    kernel_ms = time_cuda(lambda: kh.hash_tables(*hargs, **hkw), KERNEL_RUNS)
    plain_ms = time_cuda(lambda: kh.hash_bin_plain(*hargs, **hkw), 3)
    r, e = hb.a_rows.shape
    products = float(hb.a_lens.long().sum())
    by = (ell_bytes(hb.a_rows) + unique_b_bytes(hb.a_rows, hb.a_lens)
          + r * width * 8 + r * 4)
    b_ms, b_by = bound(by, 4 * products, INT32_OPS_PER_S)
    log(f"hash: R {r} E {e} table {hb.table}+{hb.spill} products "
        f"{int(products)} overflow rows {int((~fits).sum())} max_abs_err "
        f"{err:.3g} kernel + extraction {ms:.3f} ms (kernel alone "
        f"{kernel_ms:.3f} ms) plain {plain_ms:.3f} ms bound {b_ms:.3f} ms "
        f"({b_by}, {by / 1e9:.4f} GB)")
    kernels.append({
        "name": "spgemm_hash_bin", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spgemm_hash.cu",
        "replaces": "src/repro/kernels/spgemm_hash.py:170",
        "launches": counts["hash"], "launches_by_path": by_path["hash"],
        "max_abs_err": err, "ms": ms, "kernel_only_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
        "shape": {"R": r, "E": e, "table": hb.table, "spill": hb.spill}})

    # hll_merge: the estimation workflow's prediction merge over all of A
    sk = torch.cat([plan_b.b_sketches,
                    torch.zeros((1, plan_b.b_sketches.shape[1]),
                                dtype=torch.int32, device=dev)]).contiguous()
    ind = a_band.indices[: a_band.nnz]
    merged, est = kl.hll_merge(a_band.indptr, ind, sk)
    pmerged, pest = kl.hll_merge_plain(a_band.indptr, ind, sk)
    torch.cuda.synchronize()
    if not torch.equal(merged, pmerged):
        raise AssertionError("hll_merge: registers differ from plain")
    err = close_enough(est, pest, rtol=1e-5, atol=0.0)
    ms = time_cuda(lambda: kl.hll_merge(a_band.indptr, ind, sk), KERNEL_RUNS)
    plain_ms = time_cuda(lambda: kl.hll_merge_plain(a_band.indptr, ind, sk),
                         3)
    ra, m = a_band.m, sk.shape[1]
    by = (ra + 1) * 4 + a_band.nnz * 4 + sk.numel() * 4 + ra * m * 4 + ra * 4
    b_ms, b_by = bound(by, float(a_band.nnz) * m, INT32_OPS_PER_S)
    log(f"hll_merge: RA {ra} nnz {a_band.nnz} m {m} max_abs_err {err:.3g} "
        f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound {b_ms:.3f} ms "
        f"({b_by})")
    kernels.append({
        "name": "hll_merge", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hll_merge.cu",
        "replaces": "src/repro/kernels/hll.py:108",
        "launches": counts["hll_merge"],
        "launches_by_path": by_path["hll_merge"], "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "shape": {"RA": ra, "nnz": a_band.nnz, "m": m}})
    done()

    # ---------------- 4. small suite on the card ----------------
    done = phase("4. make_suite(1) through ocean_spgemm on the card")
    for name, a in formats.make_suite(1, device=dev):
        for ex in ("serial", "pipelined", "threaded"):
            c, rep = workflow.ocean_spgemm(a, a, cache=False, executor=ex)
            err = check_against_scipy(c, to_scipy(a), f"suite {name}")
        log(f"suite {name}: {rep.workflow} bins {json.dumps(rep.bins)} "
            f"max abs diff {err:.3g}")
    done()

    log(f"{smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
