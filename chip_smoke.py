#!/usr/bin/env python3
"""Drive the PyTorch port of Ocean SpGEMM on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py                  # 2**20-row matrices (default)
    # a quick run:
    python3 chip_smoke.py --log2-rows 14 --graph-scale 12 --serve-log2-rows 14

Phases, each of which raises on failure:

1. print the card, the torch/CUDA versions, and build the CUDA kernels
   from ``src/repro_torch/kernels/csrc`` (build seconds printed);
2. main path: ``repro_torch.core.workflow.ocean_spgemm(a, a)`` on a banded
   matrix (estimation workflow: ``hll_sketch`` + ``hll_merge`` + dense
   windows) and a power-law matrix (symbolic workflow: the count kernel on
   windowed rows, hash bins, the long-row dense rung), each called cold
   (plan built) and warm (plan-cache hit), with every kernel's launch count
   set to 0 just before each matrix and read just after, and the kernels
   each matrix's path must launch checked (the dense kernel once per dense
   bin of the plan; the count kernel once per cold symbolic prediction, not
   at all when warm; ``hll_merge`` once per cold call's sampled CR and once
   per cold estimation prediction, not at all when warm); C is checked
   against
   ``scipy.sparse``, and one ``torch.sparse`` product of the same matrix is
   timed as a yardstick;
2c. the graph path, each call counted the same way: ``triangle_count`` on
   an R-MAT graph of ``2**graph_scale`` vertices, cold and warm on one plan
   cache (the count kernel once in its cold symbolic prediction, and
   ``hll_merge`` as in phase 2 in every call of this phase; checked
   against
   scipy's ``sum(L .* (L @ L))``); ``k_hop_frontier`` over 3 hops on an
   R-MAT graph 4x larger (``hll_sketch`` + ``hll_merge`` in the hops that
   take estimation; each hop's vertex set checked against scipy boolean
   products); ``markov_cluster`` for 4 iterations on one 16x smaller (the
   count kernel once in the first iteration; each iteration checked
   against a scipy expand -> inflate -> normalize ->
   prune step from the same input, the labels against the scipy twin's);
2d. the SpGEMM serving tier (``repro_torch.serving``) at
   ``2**serve_log2_rows`` rows: 3 tenants x 4 requests against one B
   (uniform, banded and power-law patterns interleaved), burst into a
   ``SpGEMMPool`` (2 workers, micro-batches of up to 8, the plan warmer
   run over the queue before the workers start), every kernel's launch
   count set to 0 just before the burst and read just after; each C
   bit-identical to the same product served alone (uncached, serial
   executor), each distinct product as scipy, 9 plans warmed, 12 plan
   hits, the dense and hash kernels once a dense or hash bin and
   ``hll_merge`` as the warmed plans need; a small pool sheds 8 of the 12; k-hop chains (3
   hops, the phase-2c triangle graph) through ``SpGEMMService.run_chain``
   for two tenants, frontiers as scipy, reuse on a tenant's repeat; the
   same 12 requests through a serial service as the yardstick; one more
   burst under a tracer, written to ``chiprun_out/serving_trace.json`` and
   validated;
3. kernels against their plain PyTorch versions, on the card, on real bins
   of the phase-2, 2c and 2d paths at the shapes those paths launch them
   with (the hash kernel on every hash bin of the power-law plan and the
   triangle plan's widest; the dense kernel on the largest bin of each
   rung, and the hash kernel on the largest bin, of each serving pattern's
   plan against the serving B), with times from CUDA events, each kernel's
   bound and, for the dense and hash bins, one ``torch.sparse`` product of
   the same rows (the count kernel on every counted row of the triangle
   and power-law plans, row nnz equal to its plain version and to a
   ``torch.sparse`` product of the same rows, and on banded's W 256 bin
   with the TPU contract's per-slot counts; ``hll_merge`` on banded's whole
   A and on its sampled-CR rows, ``hll_sketch`` on banded's and power-law's
   B at m 32 and on banded's at m 64 and 128, sketches one byte a register,
   with profiler device times (null unless the profiler recorded each
   kernel once a launch) and bounds at one byte and at four a register,
   counting the sketch rows the ids select); then the dense, hash, count and HLL kernels on edge cases the
   paths may not give them (dense: rows past the
   slab's cap, padding, a B row over the stage, a column range wider than
   one shared-memory bitmap; hash: rows that spill or overflow both tables,
   padding, repeated columns, t2048 rows at and past 3,072 columns; count:
   output ranges of 4096 columns, ranges ending at the last column,
   repeated columns, empty rows, rows with more products than a warp's
   stage, each as a row a warp and as a row a block, and a one-row
   launch; HLL: empty, out-of-range, repeated, 12,000-id and largest-rho
   rows, one-row launches, seeds 0 and 7, each branch of the estimate);
4. the small suite (``make_suite(1)``) through ``ocean_spgemm`` on the card
   against scipy, which also drives the ESC and upper-bound paths;
5. one more warm call per phase-2 matrix under torch.profiler gives the
   device's busy time and idle share.

Before the last line come ``{"serving": {...}}`` (phase 2d's numbers) and
``{"kernels": [...]}``; the last line is ``{"ok": true, "device":
{...}}``. Without a CUDA device the script exits
with a non-zero code and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
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


def check_against_scipy(c, a_sp, label: str, b_sp=None) -> float:
    """C of ``A @ A`` (or ``A @ B``) against scipy's product; returns the
    max abs difference."""
    ref = a_sp @ (a_sp if b_sp is None else b_sp)
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
    kd.spgemm_dense_slab.window_launches = 0
    kd.spgemm_dense_slab.longrow_launches = 0
    kd.spgemm_count_rows.launches = 0
    kh.spgemm_hash_bin.launches = 0
    kl.hll_merge.launches = 0
    kl.hll_sketch.launches = 0


def read_counts(kd, kh, kl) -> dict:
    return {"dense_window": kd.spgemm_dense_slab.window_launches,
            "dense_longrow": kd.spgemm_dense_slab.longrow_launches,
            "hash": kh.spgemm_hash_bin.launches,
            "hll_merge": kl.hll_merge.launches,
            "hll_sketch": kl.hll_sketch.launches,
            "count": kd.spgemm_count_rows.launches}


def tuned_load_factors(tuning, dev) -> dict:
    """The load factor the hash tuner chose for each rung it has timed in
    this process (rungs not timed are left out)."""
    out = {}
    for rung in [32 * 2 ** k for k in range(8)]:
        hit = tuning.DEFAULT_TUNING_CACHE.lookup(tuning.tuning_key(rung, dev))
        if hit is not None:
            out[rung] = hit.load_factor
    return out


def log_call(label, rep, wall, launched, peak_gib=None) -> None:
    """One multiply's report, as phases 2 and 2c print it (``wall`` None:
    a step of a chain, whose stages are printed)."""
    peak = "" if peak_gib is None else f" peak_mem {peak_gib:.2f} GiB"
    wall = "" if wall is None else f" wall {wall:.3f} s"
    log(f"{label}:{wall} workflow {rep.workflow} "
        f"hit {rep.plan_cache_hit} nnz_out {rep.nnz_out} "
        f"overflow_rows {rep.overflow_rows} products "
        f"{rep.total_products} er {rep.er:.2f} cr {rep.sampled_cr}{peak}")
    log(f"  stages {json.dumps({k: round(v, 4) for k, v in rep.stage_seconds.items()})}")
    if launched is not None:
        log(f"  launches {json.dumps(launched)}")
    log(f"  bins {json.dumps(rep.bins)}")


def mcl_twin_step(m_sp, power: float):
    """One MCL iteration in scipy from the same input, in f32 as the port
    computes it (the column sums in f64): expand, Hadamard power,
    normalize columns. Returns the product (its structure) with the
    normalized values before the prune."""
    p = (m_sp @ m_sp).tocsr()
    p.sort_indices()
    pre = np.power(np.abs(p.data), power).astype(np.float32)
    colsum = np.bincount(p.indices, weights=pre.astype(np.float64),
                         minlength=p.shape[1])
    denom = colsum[p.indices]
    p.data = (pre / np.where(denom == 0.0, 1.0, denom)).astype(np.float32)
    return p


def csr_keys(x) -> np.ndarray:
    rows = np.repeat(np.arange(x.shape[0], dtype=np.int64),
                     np.diff(x.indptr))
    return rows * x.shape[1] + x.indices.astype(np.int64)


def direct_labels(x) -> np.ndarray:
    """Per column the row of its largest value, lowest row on ties (the
    vertex itself for an empty column): MCL's labels before the attractor
    chains collapse."""
    rows = np.repeat(np.arange(x.shape[0], dtype=np.int64),
                     np.diff(x.indptr))
    cols = x.indices.astype(np.int64)
    label = np.arange(x.shape[1], dtype=np.int64)
    order = np.lexsort((rows, -x.data.astype(np.float64), cols))
    first = np.ones(len(order), bool)
    first[1:] = cols[order][1:] != cols[order][:-1]
    label[cols[order][first]] = rows[order][first]
    return label


def collapse_labels(label: np.ndarray) -> np.ndarray:
    for _ in range(int(np.ceil(np.log2(max(len(label), 2)))) + 1):
        nxt = label[label]
        if np.array_equal(nxt, label):
            break
        label = nxt
    return label


def check_slab(label, got, want) -> float:
    """Slabs (cols, vals, nnz) of the kernel against its plain version:
    cols and nnz equal, vals to 1e-5; returns the max abs difference."""
    import torch
    torch.cuda.synchronize()
    if not torch.equal(got[2], want[2]):
        raise AssertionError(f"{label}: nnz differs from plain")
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"{label}: columns differ from plain")
    return close_enough(got[1], want[1])


def check_hash_slab(label, got, want, width):
    """Hash slabs of the kernel against its plain version: overflow flags
    equal; nnz and cols equal on rows that fit; vals there to 1e-5.
    Returns (max abs difference, overflow rows)."""
    import torch
    torch.cuda.synchronize()
    fits = want[2] <= width
    if not torch.equal(got[2] > width, ~fits):
        raise AssertionError(f"{label}: overflow flags differ from plain")
    if not torch.equal(got[2][fits], want[2][fits]):
        raise AssertionError(f"{label}: row nnz differs from plain")
    if not torch.equal(got[0][fits], want[0][fits]):
        raise AssertionError(f"{label}: columns differ from plain")
    return close_enough(got[1][fits], want[1][fits]), int((~fits).sum())


def library_rows(a, rows, b=None):
    """Median ms of one ``torch.sparse`` CSR @ CSR call of A's ``rows`` by
    B (A when ``b`` is None; cuSPARSE), the library's time for a bin's
    function, and its nnz per row (int64, in the order of ``rows``)."""
    import torch
    from repro_torch.core import planner
    b = a if b is None else b
    sub = planner.gather_rows(a, rows)
    ta = torch.sparse_csr_tensor(sub.indptr, sub.indices[: sub.nnz],
                                 sub.values[: sub.nnz], size=sub.shape,
                                 check_invariants=False)
    tb = torch.sparse_csr_tensor(b.indptr, b.indices[: b.nnz],
                                 b.values[: b.nnz], size=b.shape,
                                 check_invariants=False)
    lib_rows = torch.diff((ta @ tb).crow_indices()).long()
    return time_cuda(lambda: ta @ tb, 3), lib_rows


def ell_of(rng, b_rows, ell):
    """ELL inputs over flat B rows ``b_rows`` (lists of columns; -1 in
    ``ell`` is padding): (a_rows, a_vals, a_starts, a_lens, b_cols,
    b_vals), B padded by 128 slots as the executor pads it."""
    starts = np.cumsum([0] + [len(x) for x in b_rows])
    b_cols = np.concatenate(b_rows + [np.full(128, -1)]).astype(np.int32)
    b_vals = rng.standard_normal(len(b_cols)).astype(np.float32)
    ell = np.asarray(ell, np.int32)
    live = ell >= 0
    a_starts = np.where(live, starts[np.maximum(ell, 0)], 0).astype(np.int32)
    a_lens = np.where(live, np.diff(starts)[np.maximum(ell, 0)],
                      0).astype(np.int32)
    a_vals = np.where(live, rng.standard_normal(ell.shape), 0).astype(
        np.float32)
    return ell, a_vals, a_starts, a_lens, b_cols, b_vals


def dense_edge_cases(kd, dev) -> None:
    """The dense kernel on inputs the main path may not give it, each at a
    cap below its rows' nnz (the slab keeps the first cap columns) and at
    one above: ELL padding between live slots, a row of padding only, a B
    row with a repeated column; windowed, a B row with more products than a
    warp stages and offset windows; long-row, a B row with more products
    than the block stages, and a column range wider than one shared-memory
    bitmap (taken in segments)."""
    import torch
    rng = np.random.default_rng(0)
    ell = [[0, -1, 1, 2, -1, 3, 0, -1], [-1] * 8, [3, 1, 2, 3, 1, 2, 3, 1]]

    def run(label, b_rows, row_lo, window, tiles, caps):
        ar, av, ast, aln, bc, bv = ell_of(rng, b_rows, ell)
        t = [torch.as_tensor(x, device=dev) for x in
             (ar, av, ast, aln, np.asarray(row_lo, np.int32).reshape(-1, 1),
              bc, bv)]
        for cap in caps:
            kw = dict(window=window, col_tiles=tiles, cap=cap)
            got = kd.spgemm_dense_slab(*t, **kw)
            want = kd.dense_slab_plain(*t, **kw)
            err = check_slab(f"{label} cap {cap}", got, want)
            log(f"dense edge case {label} cap {cap}: nnz "
                f"{want[2].tolist()} max_abs_err {err:.3g}")

    w = 4096
    lo = [100, 7, 3000]
    run("windowed", [rng.choice(w, 600, replace=False) + 50,
                     rng.choice(w, 10, replace=False) + 100,
                     np.array([3100, 3100, 3102]),
                     rng.choice(w, 300, replace=False) + 2900],
        lo, w, 1, (100, w))
    width = 2048 * 4
    run("long-row", [rng.choice(width, 6000, replace=False),
                     rng.choice(width, 10, replace=False),
                     np.array([5, 5, 7]),
                     rng.choice(width, 300, replace=False)],
        [0, 0, 0], 2048, 4, (64, 4096))
    # 2^21 columns: one shared-memory bitmap (227 KB, 10 bytes a 64-column
    # word with its rank) holds fewer than 1.49 M, so this takes segments;
    # B row 2 is every column of a run that holds the segment boundary at
    # each cap tried here (near 1.11 M and 1.21 M columns)
    tiles = 1024
    width = 2048 * tiles
    run("long-row wide", [rng.choice(width, 3000, replace=False),
                          np.sort(rng.choice(width, 200, replace=False)),
                          np.arange(1_100_000, 1_220_000),
                          rng.choice(width, 300, replace=False)],
        [0, 0, 0], 2048, tiles, (64, 4096))


def hash_edge_cases(kh, dev) -> None:
    """The hash kernel on inputs the main path may not give it: rows that
    spill, rows that overflow both tables, empty rows, ELL padding between
    live slots, a B row holding a column twice; and t2048 rows at 3,000,
    3,072 (both tables exactly full) and 3,073 distinct columns."""
    import torch
    from repro_torch.core.binning import hash_spill_of
    rng = np.random.default_rng(1)

    def run(label, b_rows, ell, table):
        t = [torch.as_tensor(x, device=dev) for x in ell_of(rng, b_rows, ell)]
        spill = hash_spill_of(table)
        want = kh.hash_bin_plain(*t, table=table, spill=spill)
        got = kh.hash_slab(*t, table=table, spill=spill)
        err, over = check_hash_slab(label, got, want, table + spill)
        log(f"hash edge case {label} t{table}: nnz {want[2].tolist()} "
            f"overflow rows {over} max_abs_err {err:.3g}")

    pad = -1
    run("spill, overflow, padding, repeats",
        [rng.choice(5000, 12, replace=False) for _ in range(5)]
        + [np.array([7, 9, 7, 11, 9, 7])],
        [[0, 1, 2, pad, 3, pad], [0, 1, 2, 3, 4, pad], [pad] * 6,
         [0, pad, 1, pad, pad, 2],
         [5, pad, 5, 0, pad, pad], [pad, 4, pad, pad, pad, 5],
         [0, 1, 2, 3, 4, 5]], 32)
    wide = rng.choice(1 << 20, 3073, replace=False)
    run("near full", [wide[:1000], wide[1000:2000], wide[2000:3000],
                      wide[3000:3072], wide[3072:]],
        [[0, 1, 2, pad, pad], [0, 1, 2, 3, pad], [3, 2, pad, 1, 0],
         [0, 1, 2, 3, 4], [4, 3, 2, 1, 0]], 2048)
    log("hash edge cases: rows of 3,000 / 3,072 / 3,073 distinct columns at "
        "t2048 (the last overflows)")


def count_edge_cases(kd, ops, dev) -> None:
    """The count kernel's row list on rows the main path may not give it:
    an output range of exactly 4096 columns, a range ending at the last
    column, a B row holding a column three times, an empty A row, a row
    whose B rows are empty, and rows of 40, 300 and 2,000 A entries (more
    products than a warp's stage; more chunks of 32 entries than a block
    has warps). The list runs with every row a warp, every row a block, in
    the order the path would launch it, and each row alone, a warp and a
    block; every launch equal to the plain version."""
    import torch
    from repro_torch.core import analysis, formats, planner
    rng = np.random.default_rng(2)
    n = 10000
    b_rows = [np.array([0, 17, 4095]), np.array([n - 3, n - 1]),
              np.array([5, 5, 9, 9, 5]), np.array([], np.int64)]
    b_rows += [np.sort(rng.choice(4096, k, replace=False)) + 3000
               for k in rng.integers(1, 300, 60)]
    rand = np.arange(4, len(b_rows))
    a_rows = [[0], [1], [2, 2], [], [3, 3], rng.choice(rand, 40),
              rng.choice(rand, 300), rng.choice(rand, 2000)]

    def csr(rows, n_cols):
        ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
        idx = np.concatenate([np.asarray(r, np.int64) for r in rows])
        return formats.from_numpy_csr(ptr, idx, np.ones(len(idx), np.float32),
                                      (len(rows), n_cols), device=dev)

    a, b = csr(a_rows, len(b_rows)), csr(b_rows, n)
    prod, lo, hi = (formats.host(x) for x in analysis._fused_stats(a, b))
    rows = planner.counted_rows(lo, hi, prod)
    if list(rows) != [0, 1, 2, 5, 6, 7]:
        raise AssertionError(f"count edge cases: counted rows {rows}")
    csrs = (a.indptr, a.indices, b.indptr, b.indices)

    def run(label, t_rows, t_lo, heavy):
        got = torch.full((a.m,), -1, dtype=torch.int64, device=dev)
        want = got.clone()
        kd.spgemm_count_rows(*csrs, t_rows, t_lo, got, heavy=heavy)
        kd.count_rows_plain(*csrs, t_rows, t_lo, want)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"count edge case {label}: "
                                 f"{got.tolist()}, plain {want.tolist()}")
        return want

    def listed(sel):
        t = torch.from_numpy(np.stack([rows[sel], lo[rows[sel]]]).astype(
            np.int32)).to(dev)
        return t[0], t[1]

    every = np.arange(len(rows))
    want = run("a warp a row", *listed(every), 0)
    run("a block a row", *listed(every[::-1]), len(rows))
    t_rows, t_lo, heavy = ops.count_rows_inputs(rows, lo[rows], prod[rows],
                                                dev)
    run(f"launch order ({heavy} a block)", t_rows, t_lo, heavy)
    for i in every:
        for h in (0, 1):
            run(f"row {rows[i]} alone, heavy {h}", *listed([i]), h)
    log(f"count edge cases: row nnz {want.tolist()} (-1: not listed), "
        f"products {prod[rows].tolist()}, A entries "
        f"{[len(a_rows[r]) for r in rows]}; every launch equal to plain")


def merges_wanted(rep) -> int:
    """``hll_merge`` launches a multiply's planning makes: one for the
    analysis's sampled CR, one for an estimation prediction; none when the
    plan came from a cache."""
    if rep.plan_cache_hit:
        return 0
    return int(rep.sampled_cr is not None) + int(rep.workflow == "estimation")


def max_rho_id(m: int, seed: int) -> int:
    """A column id whose hash has its top 32 - log2(m) bits zero, so that its
    rho is the largest, 32 - log2(m) + 1: the murmur3 finaliser inverted
    from a hash below m."""
    mask = 0xFFFFFFFF
    inv = lambda c: pow(c, -1, 1 << 32)  # noqa: E731
    for target in range(m - 1, -1, -1):
        u = target ^ (target >> 16)
        u = (u * inv(0xC2B2AE35)) & mask
        u ^= (u >> 13) ^ (u >> 26)
        u = (u * inv(0x85EBCA6B)) & mask
        u ^= u >> 16
        x = ((u - seed) * inv(0x9E3779B9)) & mask
        if x < 2**31:
            return x
    raise AssertionError(f"no int32 id of the largest rho at m {m}")


def hll_edge_cases(kl, chll, dev) -> None:
    """``hll_sketch`` and ``hll_merge`` against their plain versions on rows
    the paths may not give them, at m 32, 64 and 128 and seeds 0 and 7: B
    rows empty, of one id of the largest rho, of repeated ids, of 12,000
    ids, 240 short rows, long rows side by side and 3,000 empty rows (the
    sketch kernel's chunks cut rows, or hold empty rows only); A rows
    empty, all out of range, repeated, of 12,000 ids (the merge's block
    path), and rows that merge 1 to 240 B rows, so that the estimate takes
    each branch (small range; raw with zero registers left; raw with none);
    and one-row launches of both. Registers exactly, estimates to rtol
    1e-5."""
    import torch
    rng = np.random.default_rng(11)

    def csr(rows):
        ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
        idx = np.concatenate([np.asarray(r, np.int64) for r in rows])
        return (torch.from_numpy(ptr.astype(np.int32)).to(dev),
                torch.from_numpy(idx.astype(np.int32)).to(dev))

    def same_sketch(label, ptr, idx, m, seed):
        got = kl.hll_sketch(ptr, idx, m_regs=m, seed=seed)
        want = chll.sketch_registers_impl(ptr, idx, m, ptr.shape[0] - 1,
                                          seed)
        torch.cuda.synchronize()
        if got.dtype != torch.uint8 or not torch.equal(got.int(), want):
            raise AssertionError(f"hll_sketch edge case {label}: registers "
                                 "differ from plain")
        return got

    def same_merge(label, ptr, idx, sk):
        got_m, got_e = kl.hll_merge(ptr, idx, sk)
        want_m, want_e = kl.hll_merge_plain(ptr, idx, sk)
        torch.cuda.synchronize()
        if not torch.equal(got_m, want_m):
            raise AssertionError(f"hll_merge edge case {label}: registers "
                                 "differ from plain")
        close_enough(got_e, want_e, rtol=1e-5, atol=0.0)
        return want_m, got_e

    branches = set()
    for m in (32, 64, 128):
        p = m.bit_length() - 1
        for seed in (0, 7):
            top = max_rho_id(m, seed)
            b_rows = [[], [top], [5, 5, 5, 9, 9, 5],
                      rng.choice(1 << 30, 12000, replace=False)]
            b_rows += [rng.choice(1 << 30, k, replace=False)
                       for k in rng.integers(1, 60, 240)]
            # long rows side by side, then 3,000 empty rows: chunks cut
            # rows, hold no ids, or hold only empty rows
            b_rows += [rng.choice(1 << 30, k, replace=False)
                       for k in (5000, 3000, 2047, 1, 2049)]
            b_rows += [[]] * 3000 + [[7]]
            nb = len(b_rows)
            b_ptr, b_idx = csr(b_rows)
            regs = same_sketch(f"m {m} seed {seed}", b_ptr, b_idx, m, seed)
            if int(regs[1].max()) != 33 - p or int(regs[1].sum()) != 33 - p:
                raise AssertionError(f"hll_sketch m {m} seed {seed}: id "
                                     f"{top} gives {regs[1].tolist()}, not "
                                     f"one register of {33 - p}")
            one = same_sketch(f"m {m} one row", *csr([b_rows[3]]), m, seed)
            if not torch.equal(one[0], regs[3]):
                raise AssertionError("hll_sketch: a one-row launch differs")
            sk = torch.zeros((nb + 1, m), dtype=torch.uint8, device=dev)
            sk[:nb] = regs
            a_rows = [[], [nb, nb + 7, 1 << 30], [1], [2, 2, 2, 0, 2],
                      rng.integers(0, nb + 8, 12000), [3]]
            a_rows += [4 + rng.choice(240, j, replace=False)
                       for j in range(1, 240, 2)]
            merged, est = same_merge(f"m {m} seed {seed}", *csr(a_rows), sk)
            if bool((merged[:2] != 0).any()) or float(est[:2].abs().max()):
                raise AssertionError("hll_merge: empty or out-of-range rows "
                                     "are not zero")
            one_m, one_e = same_merge(f"m {m} one row", *csr([a_rows[4]]),
                                      sk)
            if not torch.equal(one_m[0], merged[4]):
                raise AssertionError("hll_merge: a one-row launch differs")
            zeros = (merged == 0).sum(1).float()
            small = m * torch.log(m / zeros.clamp(min=1))
            for z, e_s in zip(zeros.tolist(), small.tolist()):
                branches.add("small" if z > 0 and e_s <= 2.5 * m
                             else "raw, zeros left" if z > 0 else "raw")
    if len(branches) != 3:
        raise AssertionError(f"hll edge cases reach only {branches}")
    log("hll edge cases: sketches and merges equal to plain at m 32/64/128,"
        " seeds 0 and 7 (empty, out-of-range, repeated, 12,000-id and "
        "largest-rho rows, one-row launches); estimate branches "
        f"{sorted(branches)}")


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


TENANTS = ("acme", "globex", "initech")
POOL_SPANS = {"pool.warm", "pool.batch_assembly", "pool.batch",
              "pool.queue_wait"}
SERVE_TIMEOUT = 600.0  # seconds any one wait of phase 2d may take


def same_csr(x, y) -> bool:
    """Two CSRs equal bit for bit (indptr, indices, values on the host)."""
    from repro_torch.core import formats
    return all(np.array_equal(u, v) for u, v in zip(formats.to_numpy(x),
                                                   formats.to_numpy(y)))


def serving_phase(args, dev, adj, kd, kh, kl, path_counts):
    """Phase 2d: the SpGEMM serving tier on the card. Returns the fields of
    the ``{"serving": ...}`` line, and for phase 3 the burst's B and each
    pattern's ``(A, plan)`` by name (the plans the workers ran)."""
    import torch
    from repro_torch import graph, serving
    from repro_torch.core import formats, planner, workflow
    from repro_torch.core.analysis import OceanConfig
    from repro_torch.obs import trace
    from repro_torch.tools import trace_export

    sn = 1 << args.serve_log2_rows
    t0 = time.perf_counter()
    b = formats.random_uniform_csr(900, sn, sn, 5.0, device=dev)
    pats = [formats.random_uniform_csr(901, sn, sn, 6.0, device=dev),
            formats.banded_csr(902, sn, sn, 24, device=dev),
            formats.powerlaw_csr(903, sn, sn, 6.0, device=dev)]
    names = ["uniform", "banded", "powerlaw"]
    log(f"generated in {time.perf_counter() - t0:.1f} s: B nnz {b.nnz}, "
        + ", ".join(f"{k} nnz {a.nnz}" for k, a in zip(names, pats)))
    # 3 tenants x 4 requests, interleaved, all against the one B object
    reqs = [(t, (ti + i) % 3) for i in range(4)
            for ti, t in enumerate(TENANTS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    formats.structure_hash(b)
    hash_s = time.perf_counter() - t0
    log(f"structure_hash(B): {hash_s:.4f} s (host copy of the pattern; the "
        "service takes it for the sketch bucket on every request)")

    # each distinct product served alone, uncached, serial executor: what
    # every pooled C must equal bit for bit
    refs, ref_walls = [], []
    b_sp = to_scipy(b)
    for name, a in zip(names, pats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, rep = workflow.ocean_spgemm(a, b, cache=False, executor="serial")
        torch.cuda.synchronize()
        ref_walls.append(time.perf_counter() - t0)
        log_call(f"serial {name} @ B", rep, ref_walls[-1], None)
        t0 = time.perf_counter()
        err = check_against_scipy(c, to_scipy(a), f"serving {name}", b_sp)
        log(f"serving {name}: C matches scipy (max abs diff {err:.3g}, check"
            f" {time.perf_counter() - t0:.1f} s)")
        refs.append(c)
    del b_sp

    def submit_all(pool):
        futs, shed = [], 0
        for t, p in reqs:
            try:
                futs.append((t, p, pool.submit(pats[p], b, tenant=t)))
            except serving.AdmissionError:
                shed += 1
        return futs, shed

    def collect(futs, label):
        """Every future's result, each C bit-identical to its serial
        product; a future that raises fails the phase."""
        for t, p, f in futs:
            if not same_csr(f.result(SERVE_TIMEOUT)[0], refs[p]):
                raise AssertionError(f"{label}: {t}'s {names[p]} C differs "
                                     "from the serial uncached call")

    # the burst: deferred start, all 12 queued, the warmer over the queue
    pool = serving.SpGEMMPool(serving.PoolConfig(
        workers=2, max_batch=8, max_queue=13, plan_cache_size=64,
        warm_plans=True), autostart=False)
    if hasattr(torch.cuda, "reset_peak_host_memory_stats"):
        torch.cuda.reset_peak_host_memory_stats()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts(kd, kh, kl)
    t0 = time.perf_counter()
    futs, shed = submit_all(pool)
    if not pool.warm_wait(SERVE_TIMEOUT):
        raise AssertionError("burst: the warmer did not finish in time")
    with pool._lock:
        warm_states = [r.warm_state for r in pool._queue]
    t_warm = time.perf_counter() - t0
    pool.start()
    for _, _, f in futs:
        f.result(SERVE_TIMEOUT)
    torch.cuda.synchronize()
    burst_s = time.perf_counter() - t0
    launched = read_counts(kd, kh, kl)
    path_counts["serving"] = launched
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    pinned = ({k: v for k, v in torch.cuda.host_memory_stats().items()
               if "peak" in k and "bytes" in k}
              if hasattr(torch.cuda, "host_memory_stats") else None)
    pool.shutdown(timeout=SERVE_TIMEOUT)
    st = pool.stats
    collect(futs, "burst")
    del futs
    log(f"burst: wall {burst_s:.3f} s for {len(reqs)} requests (warm_wait "
        f"{t_warm:.3f} s), warm states {warm_states}, batches {st.batches} "
        f"occupancy {st.batch_occupancy:.2f}, p50 {st.p50_seconds:.3f} p95 "
        f"{st.p95_seconds:.3f} p99 {st.p99_seconds:.3f} s, peak_mem "
        f"{peak_gib:.2f} GiB, pinned host {json.dumps(pinned)}")
    log(f"  launches {json.dumps(launched)}")
    if shed or st.requests != 12 or st.batched_requests != 12:
        raise AssertionError(f"burst: shed {shed}, requests {st.requests}, "
                             f"batched {st.batched_requests}; want 0, 12, 12")
    if "error" in warm_states:
        raise AssertionError(f"burst: warm states {warm_states}")
    distinct = len(set(reqs))
    if st.plans_warmed != distinct or st.plan_hits != len(reqs):
        raise AssertionError(f"burst: plans warmed {st.plans_warmed} (want "
                             f"{distinct}), plan hits {st.plan_hits} (want "
                             f"{len(reqs)})")
    # the plans the warmer built: the dense kernel once a dense bin in every
    # request, hll_merge once a sampled CR and once an estimation prediction
    # of each plan, every request through the dense or the hash kernel
    key = {p: planner.structure_key(a, b, OceanConfig(), None, True, True)
           for p, a in enumerate(pats)}
    plans = {(t, p): pool.service.plan_cache_for(t).peek(key[p])
             for t, p in set(reqs)}
    want_dense = {"dense_window": 0, "dense_longrow": 0}
    hash_bins = 0
    for t, p in reqs:
        plan = plans[t, p]
        if not plan.dense and not plan.hash:
            raise AssertionError(f"burst: {t}'s {names[p]} plan has no dense"
                                 " or hash bin")
        want_dense["dense_window"] += sum(not be.is_longrow
                                          for be in plan.dense)
        want_dense["dense_longrow"] += sum(be.is_longrow for be in plan.dense)
        hash_bins += len(plan.hash)
    want_merges = sum(int(pl.sampled_cr is not None)
                      + int(pl.workflow == "estimation")
                      for pl in plans.values())
    got_dense = {k: launched[k] for k in want_dense}
    # every rung was tuned by the serial calls above, so the burst measures
    # nothing and launches the hash kernel exactly once a hash bin
    if got_dense != want_dense or launched["hash"] != hash_bins:
        raise AssertionError(f"burst: dense launches {got_dense}, want "
                             f"{want_dense}; hash {launched['hash']}, hash "
                             f"bins {hash_bins}")
    if launched["hll_merge"] != want_merges:
        raise AssertionError(f"burst: hll_merge launches "
                             f"{launched['hll_merge']}, want {want_merges}")
    if sum(launched.values()) == 0:
        raise AssertionError("burst: no kernel of ours was launched")
    workflows = {f"{t}/{names[p]}": pl.workflow for (t, p), pl in
                 sorted(plans.items())}
    log(f"burst: 12 C bit-identical to the serial calls; plans {workflows}"
        f"; warm hits by tenant {json.dumps(st.plan_warm_hits_by_tenant)}, "
        f"sketch warm hits {json.dumps(st.sketch_warm_hits_by_tenant)}")

    # admission: a small pool sheds 8 of the 12 and serves 4
    small = serving.SpGEMMPool(serving.PoolConfig(
        workers=1, max_batch=4, max_queue=4), autostart=False)
    sfuts, sshed = submit_all(small)
    small.start()
    collect(sfuts, "shed pool")
    small.shutdown(timeout=SERVE_TIMEOUT)
    if sshed != 8 or small.stats.shed != 8 or small.stats.requests != 4:
        raise AssertionError(f"shed pool: {sshed} AdmissionErrors, stats "
                             f"shed {small.stats.shed} served "
                             f"{small.stats.requests}; want 8, 8, 4")
    log(f"shed pool: 8 of 12 shed (shed rate {small.stats.shed_rate:.3f}), "
        "4 served bit-identical")

    # chains through the service: k-hop, 3 hops, on the triangle graph
    svc = serving.SpGEMMService()
    seeds = [0, 1, 2]
    f0 = graph.seeds_to_frontier(seeds, adj.n, device=dev)
    chains = []
    for t in ("acme", "acme", "globex"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = svc.run_chain(f0, adj, 3, tenant=t,
                            post=graph.bool_post(adj.n))
        torch.cuda.synchronize()
        chains.append((t, res, time.perf_counter() - t0))
    a_sp = to_scipy(adj)
    cur = np.zeros(adj.n, np.float64)
    cur[seeds] = 1.0
    for _ in range(3):
        cur = (a_sp.T @ cur != 0).astype(np.float64)
    for t, res, _ in chains:
        if not np.array_equal(formats.to_numpy(res.final)[1],
                              np.nonzero(cur)[0]):
            raise AssertionError(f"chain {t}: frontier differs from scipy")
    (_, a1, _), (_, a2, _), (_, g1, _) = chains
    if a2.stats.plan_hits + a2.stats.feed_forward_skips == 0:
        raise AssertionError("chain acme, second run: no plan reuse")
    if (g1.stats.feed_forward_skips
            or svc.size_feed_for(adj, "globex") is svc.size_feed_for(
                adj, "acme")):
        raise AssertionError("chain globex: used acme's size feed")
    chain_out = [{"tenant": t, "wall_s": w, "workflows": r.stats.workflows,
                  "plan_hits": r.stats.plan_hits,
                  "feed_forward_skips": r.stats.feed_forward_skips,
                  "estimated_builds": r.stats.estimated_builds}
                 for t, r, w in chains]
    log(f"chains (k-hop, 3 hops, R-MAT {adj.m} vertices): frontiers as "
        f"scipy; {json.dumps(chain_out)}")

    # yardstick: the same 12 requests one at a time through a fresh service
    svc = serving.SpGEMMService(plan_cache_size=64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t, p in reqs:
        c, _ = svc.multiply(pats[p], b, tenant=t)
        del c
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    log(f"serial service: wall {serial_s:.3f} s for 12 requests; pool / "
        f"serial {burst_s / serial_s:.3f}")

    # one more burst under a tracer, written as a Chrome trace
    tracer = trace.Tracer()
    with trace.tracing(tracer):
        tpool = serving.SpGEMMPool(serving.PoolConfig(
            workers=2, max_batch=8, max_queue=13), autostart=False)
        tfuts, _ = submit_all(tpool)
        if not tpool.warm_wait(SERVE_TIMEOUT):
            raise AssertionError("traced burst: the warmer did not finish")
        tpool.start()
        for _, _, f in tfuts:
            f.result(SERVE_TIMEOUT)
        tpool.shutdown(timeout=SERVE_TIMEOUT)
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "serving_trace.json")
    doc = trace_export.write_chrome_trace(tracer, path)
    with open(path) as fh:
        trace_export.validate_chrome_trace(fh.read())
    span_names = {e["name"] for e in doc["traceEvents"]}
    if not POOL_SPANS <= span_names or tpool.stats.requests != 12:
        raise AssertionError(f"traced burst: pool spans "
                             f"{sorted(span_names & POOL_SPANS)}, served "
                             f"{tpool.stats.requests}")
    log(f"trace: {len(doc['traceEvents'])} spans over "
        f"{len({e['tid'] for e in doc['traceEvents']})} lanes, validated, "
        f"written to {os.path.relpath(path, REPO)}")

    peeked = {"b": b, "mats": {names[p]: (pats[p], plans[TENANTS[0], p])
                               for p in range(len(pats))}}
    return {
        "rows": sn, "requests": len(reqs), "tenants": len(TENANTS),
        "workers": 2, "max_batch": 8,
        "burst_wall_s": burst_s, "burst_warm_wait_s": t_warm,
        "burst_rps": len(reqs) / burst_s,
        "serial_wall_s": serial_s, "serial_rps": len(reqs) / serial_s,
        "serial_uncached_s": dict(zip(names, ref_walls)),
        "p50_s": st.p50_seconds, "p95_s": st.p95_seconds,
        "p99_s": st.p99_seconds, "batches": st.batches,
        "batch_occupancy": st.batch_occupancy,
        "mean_queue_wait_s": st.queue_wait_seconds / max(st.requests, 1),
        "plans_warmed": st.plans_warmed, "plan_hits": st.plan_hits,
        "plan_warm_hits_by_tenant": {str(k): v for k, v in
                                     st.plan_warm_hits_by_tenant.items()},
        "sketch_warm_hits_by_tenant": {str(k): v for k, v in
                                       st.sketch_warm_hits_by_tenant.items()},
        "warm_states": warm_states, "workflows": workflows,
        "shed": small.stats.shed, "launches": launched,
        "peak_mem_gib": peak_gib, "pinned_host_peak": pinned,
        "structure_hash_s": hash_s, "chains": chain_out,
        "trace_spans": len(doc["traceEvents"])}, peeked


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2-rows", type=int, default=20,
                    help="rows (= columns) of the two main-path matrices")
    ap.add_argument("--graph-scale", type=int, default=16,
                    help="R-MAT scale of the triangle graph; k-hop runs at "
                    "this + 2, MCL at this - 4")
    ap.add_argument("--serve-log2-rows", type=int, default=20,
                    help="rows (= columns) of the serving phase's matrices")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    import scipy.sparse as sp
    from repro_torch import graph
    from repro_torch.core import analysis, formats, planner, tuning, workflow
    from repro_torch.core import hll as chll
    from repro_torch.core.analysis import OceanConfig
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import hll as kl
    from repro_torch.kernels import spgemm_dense as kd
    from repro_torch.kernels import spgemm_hash as kh
    from repro_torch.obs import trace
    from repro_torch.tools.time_hll import device_ms

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
    call_counts = {}

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
            call_counts[name, call] = launched
            log_call(f"{name} {call}", rep, wall, launched,
                     torch.cuda.max_memory_allocated() / 2**30)
            log(f"  spans {json.dumps({k: round(v, 4) for k, v in spans.items()})}")
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
    need = {"banded": ["hll_sketch", "hll_merge", "dense_window"],
            "powerlaw": ["hash"]}
    need[long_path] = need.get(long_path, []) + ["dense_longrow"]

    def require(need):
        for path, names in need.items():
            missing = [k for k in names if path_counts[path][k] == 0]
            if missing:
                raise AssertionError(f"{path}: kernels never launched on "
                                     f"its path: {missing}")

    require(need)
    for name, a in mats:  # the dense kernel: one launch per dense bin
        plan = plan_of(name, a)
        want = {"dense_window": sum(not be.is_longrow for be in plan.dense),
                "dense_longrow": sum(be.is_longrow for be in plan.dense)}
        for call in ("cold", "warm"):
            got = {k: call_counts[name, call][k] for k in want}
            if got != want:
                raise AssertionError(f"{name} {call}: dense launches {got}, "
                                     f"dense bins of its plan {want}")
        log(f"{name}: dense launches per call {json.dumps(want)}, one per "
            "bin")
    # the count kernel: one launch per cold symbolic prediction, none warm
    for name, want in (("banded", {"cold": 0, "warm": 0}),
                       ("powerlaw", {"cold": 1, "warm": 0})):
        got = {call: call_counts[name, call]["count"] for call in want}
        if got != want:
            raise AssertionError(f"{name}: count launches {got}, want {want}"
                                 " (one per cold symbolic prediction)")
        log(f"{name}: count kernel launches per call {json.dumps(got)}")
    # hll_merge: one launch per cold call's sampled CR and one per cold
    # estimation prediction, none warm
    for name, outs in results.items():
        got, want, sketch = {}, {}, {}
        for call, (_, rep, _) in zip(("cold", "warm"), outs):
            got[call] = call_counts[name, call]["hll_merge"]
            want[call] = merges_wanted(rep)
            sketch[call] = call_counts[name, call]["hll_sketch"]
        if got != want:
            raise AssertionError(f"{name}: hll_merge launches {got}, want "
                                 f"{want} (sampled CR + estimation)")
        log(f"{name}: hll_merge launches per call {json.dumps(got)} (sampled"
            f" CR + estimation), hll_sketch {json.dumps(sketch)}")
    for name, a in mats:
        log(f"{name}: hash bins (table: rows) " + json.dumps(
            {hb.table: len(hb.rows) for hb in plan_of(name, a).hash}))
    log("tuned hash load factor by rung (timed at this process's first cold "
        f"plan; the reference rung {tuning.REFERENCE_RUNG} sizes the tables): "
        + json.dumps(tuned_load_factors(tuning, dev)))
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

    # ---------------- 2c. graph path ----------------
    gs = args.graph_scale
    done = phase(f"2c. graph path at R-MAT scales {gs}, {gs + 2}, {gs - 4}")

    def gen_rmat(scale):
        t0 = time.perf_counter()
        g = graph.rmat_csr(1, scale, 16, device=dev)
        log(f"rmat_csr(1, {scale}, 16): {g.m} vertices, {g.nnz} entries, "
            f"generated in {time.perf_counter() - t0:.1f} s")
        return g

    # triangles: sum(L .* (L @ L)), the mask fused into the merge
    adj_t = gen_rmat(gs)
    low = graph.lower_triangle(adj_t)
    tri_cache = planner.PlanCache()
    reset_counts(kd, kh, kl)
    tris = []
    tri_count_launches = {}
    for call in ("cold", "warm"):
        before = read_counts(kd, kh, kl)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tri, rep = graph.triangle_count(adj_t, cache=tri_cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: v - before[k]
                    for k, v in read_counts(kd, kh, kl).items()}
        tri_count_launches[call] = launched["count"]
        if launched["hll_merge"] != merges_wanted(rep):
            raise AssertionError(f"triangles {call}: hll_merge launches "
                                 f"{launched['hll_merge']}, want "
                                 f"{merges_wanted(rep)}")
        log_call(f"triangles {call} (L nnz {low.nnz})", rep, wall, launched,
                 torch.cuda.max_memory_allocated() / 2**30)
        log(f"  triangles {tri}")
        tris.append(tri)
    path_counts["triangles"] = read_counts(kd, kh, kl)
    if tri_count_launches != {"cold": 1, "warm": 0}:
        raise AssertionError(f"triangles: count launches "
                             f"{tri_count_launches}, want cold 1, warm 0")
    t0 = time.perf_counter()
    l_sp = to_scipy(low).astype(np.float64)
    want = int(round((l_sp @ l_sp).multiply(l_sp).sum()))
    if tris != [want, want]:
        raise AssertionError(f"triangles {tris}, scipy {want}")
    log(f"triangles: {want} as scipy (check {time.perf_counter() - t0:.1f}"
        " s)")

    class RecordingRunner(graph.ChainRunner):
        """Keeps each step's input, output, report and kernel launches."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.steps = []

        def step(self, c, **kw):
            before = read_counts(kd, kh, kl)
            out, rep = super().step(c, **kw)
            launched = {k: v - before[k]
                        for k, v in read_counts(kd, kh, kl).items()}
            self.steps.append((c, out, rep, launched))
            return out, rep

    # k-hop: boolean chain F_{k+1} = sign(F_k @ A)
    adj_k = gen_rmat(gs + 2)
    t0 = time.perf_counter()
    formats.structure_hash(adj_k)
    log(f"k-hop: structure_hash of the RHS (the chain's sketch-cache key, "
        f"host copy of the pattern) {time.perf_counter() - t0:.3f} s")
    seeds = [0, 1, 2]
    reset_counts(kd, kh, kl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = runner_k = RecordingRunner(adj_k)
    fronts, kres = graph.k_hop_frontier(adj_k, seeds, 3, runner=runner)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path_counts["k-hop"] = read_counts(kd, kh, kl)
    log(f"k-hop: wall {wall:.3f} s for 3 hops, launches "
        f"{json.dumps(path_counts['k-hop'])}")
    a_k = to_scipy(adj_k)
    cur = np.zeros(adj_k.n, np.float64)
    cur[seeds] = 1.0
    for hop, (f, (_, _, rep, launched)) in enumerate(
            zip(fronts, runner.steps), 1):
        log_call(f"k-hop hop {hop} (frontier {len(f)})", rep, None,
                 launched)
        if launched["hll_merge"] != merges_wanted(rep):
            raise AssertionError(f"k-hop hop {hop}: hll_merge launches "
                                 f"{launched['hll_merge']}, want "
                                 f"{merges_wanted(rep)}")
        cur = (a_k.T @ cur != 0).astype(np.float64)
        if not np.array_equal(f, np.nonzero(cur)[0]):
            raise AssertionError(f"k-hop hop {hop}: vertex set differs "
                                 "from scipy")
        if rep.workflow != "estimation":
            log(f"  hop {hop} took {rep.workflow}: er {rep.er:.2f}, sampled"
                f" cr {rep.sampled_cr} (estimation needs er >= 8 and "
                "cr >= 8)")
    log(f"k-hop: vertex sets of every hop as scipy; chain stats "
        f"{json.dumps(dataclasses.asdict(kres.stats))}")
    if "estimation" in kres.stats.workflows:
        require({"k-hop": ["hll_sketch", "hll_merge"]})

    # MCL: one fused expand -> inflate -> normalize -> prune per iteration
    adj_m = gen_rmat(gs - 4)

    runner = RecordingRunner(None)
    reset_counts(kd, kh, kl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mcl = graph.markov_cluster(adj_m, iterations=4, runner=runner)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path_counts["MCL"] = read_counts(kd, kh, kl)
    log(f"MCL: wall {wall:.3f} s for {len(runner.steps)} iterations, "
        f"launches {json.dumps(path_counts['MCL'])}, clusters "
        f"{len(np.unique(mcl.labels))}")
    thr, near_tol = 1e-4, 1e-6
    m0 = (to_scipy(adj_m) + sp.identity(adj_m.n, dtype=np.float32,
                                        format="csr")).tocsr()
    m0.data[:] = 1.0
    m0.sort_indices()
    m0.data = (m0.data / np.bincount(m0.indices, weights=m0.data.astype(
        np.float64), minlength=m0.shape[1])[m0.indices]).astype(np.float32)
    first = to_scipy(runner.steps[0][0])
    if not (np.array_equal(first.indptr, m0.indptr)
            and np.array_equal(first.indices, m0.indices)):
        raise AssertionError("MCL: the first iterate's structure differs "
                             "from scipy's normalize(A + I)")
    np.testing.assert_allclose(first.data, m0.data, rtol=1e-6)
    mcl_err = 0.0
    near_cols = np.zeros(adj_m.n, bool)
    for it, (m_in, m_out, rep, launched) in enumerate(runner.steps, 1):
        twin = mcl_twin_step(to_scipy(m_in), 2.0)
        ours = to_scipy(m_out)
        tkeys, okeys = csr_keys(twin), csr_keys(ours)
        kept = np.abs(twin.data) >= thr
        near = np.abs(np.abs(twin.data) - thr) <= near_tol
        near_cols |= np.bincount(twin.indices[near],
                                 minlength=adj_m.n).astype(bool)
        flips = np.setxor1d(tkeys[kept], okeys)
        pos = np.searchsorted(tkeys, flips)
        ok = (pos < len(tkeys)) & (tkeys[np.minimum(pos, len(tkeys) - 1)]
                                   == flips)
        if not (ok.all() and near[pos[ok]].all()):
            raise AssertionError(f"MCL iteration {it}: {len(flips)} entries"
                                 " differ from scipy, not all within "
                                 f"{near_tol} of the prune threshold")
        common = np.isin(okeys, tkeys[kept])
        tv = twin.data[kept][np.isin(tkeys[kept], okeys)]
        np.testing.assert_allclose(ours.data[common], tv, rtol=1e-4, atol=0,
                                   err_msg=f"MCL iteration {it}")
        err = float(np.abs(ours.data[common] - tv).max()) if len(tv) else 0.0
        mcl_err = max(mcl_err, err)
        log_call(f"MCL iteration {it}", rep, None, launched)
        if launched["hll_merge"] != merges_wanted(rep):
            raise AssertionError(f"MCL iteration {it}: hll_merge launches "
                                 f"{launched['hll_merge']}, want "
                                 f"{merges_wanted(rep)}")
        log(f"  nnz {ours.nnz} as scipy's step but {len(flips)} entries; "
            f"{int(near.sum())} entries within {near_tol} of the threshold; "
            f"max abs diff {err:.3g}")
    twin_last = mcl_twin_step(to_scipy(runner.steps[-1][0]), 2.0)
    twin_last.data[np.abs(twin_last.data) < thr] = 0.0
    twin_last.eliminate_zeros()
    d_ours, d_twin = direct_labels(to_scipy(mcl.matrix)), direct_labels(
        twin_last)
    moved = np.nonzero(d_ours != d_twin)[0]
    unexplained = moved[~near_cols[moved]]
    if len(unexplained):
        raise AssertionError(f"MCL: {len(unexplained)} vertices pick another"
                             " attractor than scipy's twin with no entry "
                             "near the prune threshold in their column")
    if not len(moved) and not np.array_equal(mcl.labels,
                                             collapse_labels(d_twin)):
        raise AssertionError("MCL: labels differ from scipy's twin")
    log(f"MCL: labels as scipy's twin"
        + (f" but {len(moved)} vertices whose column holds an entry near the"
           " prune threshold" if len(moved) else "")
        + f"; max abs diff over the iterations {mcl_err:.3g}")

    require({"triangles": ["count"]})
    mcl_counts = [launched["count"] for _, _, _, launched in runner.steps]
    if mcl_counts[0] != 1:
        raise AssertionError(f"MCL iteration 1: {mcl_counts[0]} count "
                             "launches, want 1 (its symbolic prediction)")
    log(f"count kernel launches: triangles {json.dumps(tri_count_launches)}"
        f", MCL by iteration {mcl_counts}")
    log("hll_merge launches (sampled CR + estimation, checked per call): "
        f"k-hop by hop {[la['hll_merge'] for *_, la in runner_k.steps]}, "
        f"MCL by iteration {[la['hll_merge'] for *_, la in runner.steps]}")
    done()

    # ---------------- 2d. serving tier ----------------
    done = phase(f"2d. serving tier at {1 << args.serve_log2_rows} rows, "
                 f"{len(TENANTS)} tenants x 4 requests")
    serving_line, served = serving_phase(args, dev, adj_t, kd, kh, kl,
                                         path_counts)
    counts = {k: sum(pc[k] for pc in path_counts.values())
              for k in read_counts(kd, kh, kl)}
    by_path = {k: {p: pc[k] for p, pc in path_counts.items()}
               for k in counts}
    log(f"launches on every path: {json.dumps(counts)}")
    log(f"launches by path: {json.dumps(by_path)}")
    done()

    # ---------------- 3. kernels vs plain ----------------
    done = phase("3. kernels against their plain versions")
    kernels = []
    plan_b = plan_of("banded", mats[0][1])
    plan_l = plan_of(*mats[-1])
    a_band = mats[0][1]

    def dense_case(label, a, be, b=None):
        """The dense kernel on a whole bin of A @ B (B = A when ``b`` is
        None), as the path launches it."""
        b = a if b is None else b
        b_cols, b_vals = ops.pad_b_flat(b)
        a_vals = ops.gather_bin_values(a.values, be.pos, be.valid)
        args_ = (be.a_rows, a_vals, be.a_starts, be.a_lens, be.row_lo,
                 b_cols, b_vals)
        kw = dict(window=be.window, col_tiles=be.col_tiles, cap=be.cap)
        got = kd.spgemm_dense_slab(*args_, **kw)
        want = kd.dense_slab_plain(*args_, **kw)
        err = check_slab(label, got, want)
        nnz = int(got[2].long().sum())
        over = int((got[2] > be.cap).sum())
        del got, want
        ms = time_cuda(lambda: kd.spgemm_dense_slab(*args_, **kw),
                       KERNEL_RUNS)
        plain_ms = time_cuda(lambda: kd.dense_slab_plain(*args_, **kw), 3)
        # the library: one torch.sparse product of the bin's rows of A by B
        lib_ms, lib_rows = library_rows(a, be.rows, b)
        lib_nnz = int(lib_rows.sum())
        r, e = be.a_rows.shape
        products = float(torch.where(be.a_rows >= 0, be.a_lens, 0)
                         .long().sum())
        by = (ell_bytes(be.a_rows) + r * 4
              + unique_b_bytes(be.a_rows, be.a_lens) + r * be.cap * 8 + r * 4)
        b_ms, b_by = bound(by, 2 * products, F32_OPS_PER_S)
        log(f"{label}: R {r} E {e} W {be.window}x{be.col_tiles} cap {be.cap}"
            f" products {int(products)} nnz {nnz} (torch.sparse {lib_nnz}) "
            f"rows over cap {over} max_abs_err {err:.3g} kernel {ms:.3f} ms "
            f"plain {plain_ms:.3f} ms torch.sparse {lib_ms:.3f} ms bound "
            f"{b_ms:.3f} ms ({b_by}, {by / 1e9:.4f} GB)")
        return {"bin": label, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms,
                "shape": {"R": r, "E": e, "window": be.window,
                          "col_tiles": be.col_tiles, "cap": be.cap,
                          "products": int(products), "nnz": nnz,
                          "rows_over_cap": over, "library_nnz": lib_nnz}}

    # the serving patterns' bins against the serving B: the largest of each
    # dense rung and the largest hash bin of every pattern's plan
    serve_dense = {"dense_window": [], "dense_longrow": []}
    serve_hash = []
    for sname, (sa, splan) in served["mats"].items():
        for key, longrow in (("dense_window", False),
                             ("dense_longrow", True)):
            rung = [be for be in splan.dense if be.is_longrow == longrow]
            if rung:
                serve_dense[key].append(dense_case(
                    f"{key} serving {sname}", sa,
                    max(rung, key=lambda be: len(be.rows)), served["b"]))

    windowed = [be for be in plan_b.dense if not be.is_longrow]
    be_w = max(windowed, key=lambda be: len(be.rows))
    a_long = mats[-1][1]
    be_l = max((be for be in plan_l.dense if be.is_longrow),
               key=lambda be: len(be.rows))
    for key, a, be in (("dense_window", a_band, be_w),
                       ("dense_longrow", a_long, be_l)):
        top = dense_case(key, a, be)
        kernels.append({
            "name": f"spgemm_dense_bin[{key.split('_')[-1]}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spgemm_dense.cu",
            "replaces": "src/repro/kernels/spgemm_dense.py:178",
            "launches": counts[key], "launches_by_path": by_path[key],
            **{k: v for k, v in top.items() if k != "bin"},
            "also": serve_dense[key]})
    dense_edge_cases(kd, dev)

    # hash: every hash bin of the power-law plan, the triangle plan's
    # widest, then edge cases; the record is the largest bin by rows
    def hash_case(label, a, hb, b=None):
        """The hash kernel on a whole bin of A @ B (B = A when ``b`` is
        None), as the path launches it."""
        b = a if b is None else b
        b_cols, b_vals = ops.pad_b_flat(b)
        a_vals = ops.gather_bin_values(a.values, hb.pos, hb.valid)
        args_ = (hb.a_rows, a_vals, hb.a_starts, hb.a_lens, b_cols, b_vals)
        kw = dict(table=hb.table, spill=hb.spill)
        got = kh.spgemm_hash_bin(*args_, **kw)
        want = kh.hash_bin_plain(*args_, **kw)
        err, over = check_hash_slab(label, got, want, hb.table + hb.spill)
        nnz = int(want[2].long().sum())
        del got, want
        ms = time_cuda(lambda: kh.spgemm_hash_bin(*args_, **kw), KERNEL_RUNS)
        plain_ms = time_cuda(lambda: kh.hash_bin_plain(*args_, **kw), 3)
        lib_ms, lib_rows = library_rows(a, hb.rows, b)
        lib_nnz = int(lib_rows.sum())
        if lib_nnz != nnz:
            raise AssertionError(f"{label}: torch.sparse has {lib_nnz} "
                                 f"entries, the plain version {nnz}")
        r, e = hb.a_rows.shape
        width = hb.table + hb.spill
        products = float(hb.a_lens.long().sum())
        by = (ell_bytes(hb.a_rows) + unique_b_bytes(hb.a_rows, hb.a_lens)
              + r * width * 8 + r * 4)
        b_ms, b_by = bound(by, 4 * products, INT32_OPS_PER_S)
        lanes, rows, _ = kh.launch_shape_on(torch.cuda.current_device(),
                                            hb.table, hb.spill)
        log(f"{label}: R {r} E {e} table {hb.table}+{hb.spill} products "
            f"{int(products)} nnz {nnz} overflow rows {over} lanes a row "
            f"{lanes} rows a block {rows} max_abs_err "
            f"{err:.3g} kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
            f"torch.sparse {lib_ms:.3f} ms bound {b_ms:.4f} ms ({b_by}, "
            f"{by / 1e9:.4f} GB)")
        return {"bin": label, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms,
                "shape": {"R": r, "E": e, "table": hb.table,
                          "spill": hb.spill, "products": int(products),
                          "nnz": nnz, "overflow_rows": over,
                          "lanes_a_row": lanes, "rows_a_block": rows}}

    a_pl = mats[1][1]
    hash_bins = [hash_case(f"hash powerlaw t{hb.table}", a_pl, hb)
                 for hb in sorted(plan_p.hash, key=lambda h: h.table)]
    if len(plan_p.hash) != 7:
        log(f"hash: the power-law plan has {len(plan_p.hash)} hash bins")
    plan_t = tri_cache.peek(planner.structure_key(
        low, low, OceanConfig(), None, True, True))
    if plan_t.hash:
        hb_t = max(plan_t.hash, key=lambda h: h.table)
        hash_bins.append(hash_case(f"hash triangles t{hb_t.table}", low,
                                   hb_t))
    else:
        log("hash: the triangle plan has no hash bin at this scale")
    for sname, (sa, splan) in served["mats"].items():
        if splan.hash:
            hb_s = max(splan.hash, key=lambda h: len(h.rows))
            serve_hash.append(hash_case(
                f"hash serving {sname} t{hb_s.table}", sa, hb_s,
                served["b"]))
    hash_edge_cases(kh, dev)
    top = hash_bins[int(np.argmax([len(h.rows) for h in
                                   sorted(plan_p.hash,
                                          key=lambda h: h.table)]))]
    kernels.append({
        "name": "spgemm_hash_bin", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spgemm_hash.cu",
        "replaces": "src/repro/kernels/spgemm_hash.py:170",
        "launches": counts["hash"], "launches_by_path": by_path["hash"],
        **{k: v for k, v in top.items() if k != "bin"},
        "bins": hash_bins, "also": serve_hash})
    del served  # the serving matrices and plans: nothing after reads them

    # hll_merge: the estimation prediction's merge over all of banded's A,
    # and the analysis's sampled-CR merge, with the sketches the plan holds
    # (B's rows and the zero sentinel row, one byte a register)
    sk = plan_b.b_sketches
    if sk.dtype != torch.uint8 or bool((sk[-1] != 0).any()):
        raise AssertionError(f"banded plan sketches: {sk.dtype}, sentinel "
                             "row not zero")
    try:
        kl.hll_merge(a_band.indptr, a_band.indices[: a_band.nnz], sk.int())
        raise AssertionError("hll_merge took int32 sketches on the card")
    except TypeError:
        pass
    rows_s = analysis._pick_sample_rows(a_band.m, OceanConfig())
    sub_s = planner.gather_rows(a_band, rows_s)

    def merge_case(label, a):
        ind = a.indices[: a.nnz]
        merged, est = kl.hll_merge(a.indptr, ind, sk)
        pmerged, pest = kl.hll_merge_plain(a.indptr, ind, sk)
        torch.cuda.synchronize()
        if merged.dtype != torch.uint8 or not torch.equal(merged, pmerged):
            raise AssertionError(f"hll_merge {label}: registers differ from "
                                 "plain")
        err = close_enough(est, pest, rtol=1e-5, atol=0.0)
        del merged, est, pmerged, pest
        ms = time_cuda(lambda: kl.hll_merge(a.indptr, ind, sk), KERNEL_RUNS)
        dev_ms, events = device_ms(lambda: kl.hll_merge(a.indptr, ind, sk),
                                   KERNEL_RUNS, "hll_merge_kernel")
        plain_ms = time_cuda(lambda: kl.hll_merge_plain(a.indptr, ind, sk),
                             3)
        ra, nb1, m = a.m, sk.shape[0], sk.shape[1]
        # the sketch rows A's ids select (ids outside [0, NB+1) read the
        # sentinel row), each read once
        picked = int(torch.unique(torch.where(
            (ind >= 0) & (ind < nb1), ind, nb1 - 1)).numel())
        # A's offsets and ids, those sketch rows, merged rows and estimates
        by = (ra + 1) * 4 + a.nnz * 4 + picked * m + ra * m + ra * 4
        by32 = by + 3 * (picked * m + ra * m)  # with int32 registers
        b_ms, b_by = bound(by, float(a.nnz) * m, INT32_OPS_PER_S)
        b32_ms, _ = bound(by32, float(a.nnz) * m, INT32_OPS_PER_S)
        log(f"hll_merge {label}: RA {ra} ids {a.nnz} ({picked} sketch rows) "
            f"m {m} max_abs_err {err:.3g} kernel {ms:.4f} ms device {dev_ms} "
            f"ms (profiler events {json.dumps(events)}) plain "
            f"{plain_ms:.3f} ms bound {b_ms:.4f} ms ({b_by}, one byte a "
            f"register; {b32_ms:.4f} ms with int32 registers)")
        return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "bound_int32_ms": b32_ms,
                "shape": {"RA": ra, "ids": a.nnz, "sketch_rows": picked,
                          "m": m, "A": label}}

    mg_band = merge_case("banded", a_band)
    mg_sample = merge_case("banded sampled CR", sub_s)
    kernels.append({
        "name": "hll_merge", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hll_merge.cu",
        "replaces": "src/repro/kernels/hll.py:108",
        "launches": counts["hll_merge"],
        "launches_by_path": by_path["hll_merge"], **mg_band,
        "library_ms": None, "also": mg_sample})

    # hll_sketch: B's sketches, as the analysis builds them
    def sketch_case(label, b, m):
        ind = b.indices[: b.nnz]
        regs = kl.hll_sketch(b.indptr, ind, m_regs=m)
        pregs = chll.sketch_registers_impl(b.indptr, ind, m, b.m)
        torch.cuda.synchronize()
        if regs.dtype != torch.uint8 or not torch.equal(regs.int(), pregs):
            raise AssertionError(f"hll_sketch {label} m {m}: registers "
                                 "differ from plain")
        del regs, pregs
        ms = time_cuda(lambda: kl.hll_sketch(b.indptr, ind, m_regs=m),
                       KERNEL_RUNS)
        # both kernels of a launch: the chunks' bounds and the sketch
        dev_ms, events = device_ms(
            lambda: kl.hll_sketch(b.indptr, ind, m_regs=m), KERNEL_RUNS,
            "hll_sketch")
        plain_ms = time_cuda(
            lambda: chll.sketch_registers_impl(b.indptr, ind, m, b.m), 3)
        by = b.nnz * 4 + (b.m + 1) * 4 + b.m * m
        b_ms, b_by = bound(by, 15.0 * b.nnz, INT32_OPS_PER_S)
        b32_ms, _ = bound(by + 3 * b.m * m, 15.0 * b.nnz, INT32_OPS_PER_S)
        threads = kl.sketch_launch_shape_on(torch.cuda.current_device(), m)
        chunks = kl.sketch_chunks(b.nnz, b.m, threads, m)
        log(f"hll_sketch {label}: R {b.m} ids {b.nnz} m {m} exact; "
            f"{chunks} chunks of {threads} threads; kernel "
            f"{ms:.4f} ms device {dev_ms} ms (profiler events "
            f"{json.dumps(events)}) plain {plain_ms:.3f} ms bound "
            f"{b_ms:.4f} ms ({b_by}, one byte a register; {b32_ms:.4f} ms "
            "with int32 registers)")
        return {"max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "bound_int32_ms": b32_ms,
                "shape": {"R": b.m, "ids": b.nnz, "m": m, "B": label,
                          "threads": threads, "chunks": chunks}}

    sk_band = sketch_case("banded", a_band, plan_b.m_regs)
    sk_more = [sketch_case("powerlaw", a_pl, 32)]
    sk_more += [sketch_case("banded", a_band, m) for m in (64, 128)]
    hll_edge_cases(kl, chll, dev)
    kernels.append({
        "name": "hll_sketch", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hll_sketch.cu",
        "replaces": "src/repro/kernels/hll.py:64",
        "launches": counts["hll_sketch"],
        "launches_by_path": by_path["hll_sketch"], **sk_band,
        "library_ms": None, "also": sk_more})

    # the count kernel: every counted row of the triangle and power-law
    # plans in one launch each, as their symbolic predictions make it; then
    # banded's W 256 bin with the TPU contract's per-slot counts
    def count_rows_case(label, a):
        prod, lo, hi = (formats.host(x)
                        for x in analysis._fused_stats(a, a))
        rows = planner.counted_rows(lo, hi, prod)
        t_rows, t_lo, heavy = ops.count_rows_inputs(rows, lo[rows],
                                                    prod[rows], dev)
        args_ = (a.indptr, a.indices, a.indptr, a.indices, t_rows, t_lo)
        out = torch.zeros(a.m, dtype=torch.int64, device=dev)
        pout = torch.zeros_like(out)
        kd.spgemm_count_rows(*args_, out, heavy=heavy)
        kd.count_rows_plain(*args_, pout)
        torch.cuda.synchronize()
        if not torch.equal(out, pout):
            raise AssertionError(f"count {label}: row nnz differs from "
                                 "plain")
        ms = time_cuda(lambda: kd.spgemm_count_rows(*args_, out,
                                                    heavy=heavy),
                       KERNEL_RUNS)
        plain_ms = time_cuda(lambda: kd.count_rows_plain(*args_, pout), 3)
        # the same launch with every row a warp, in list order: what the
        # heavy rows' blocks gain
        flat = torch.from_numpy(np.stack([rows, lo[rows]]).astype(
            np.int32)).to(dev)
        warp_ms = time_cuda(lambda: kd.spgemm_count_rows(
            a.indptr, a.indices, a.indptr, a.indices, flat[0], flat[1], out),
            KERNEL_RUNS)
        if not torch.equal(out, pout):
            raise AssertionError(f"count {label}: row nnz differs from "
                                 "plain with every row a warp")
        lib_ms, lib_rows = library_rows(a, rows)
        t_sorted = torch.from_numpy(rows).to(dev)
        if not torch.equal(lib_rows, out[t_sorted]):
            raise AssertionError(f"count {label}: torch.sparse row nnz "
                                 "differs")
        # bytes: the row list and row_lo, each row's A offsets and entries,
        # the offsets and columns of the B rows they reference (each once),
        # the row nnz written; operations: one bit set a product
        sub = planner.gather_rows(a, rows)
        k = torch.unique(sub.indices[: sub.nnz].long())
        b_len = (a.indptr[k + 1] - a.indptr[k]).long()
        by = (len(rows) * 8 * 3 + sub.nnz * 4 + k.numel() * 8
              + float(b_len.sum()) * 4)
        products = float(prod[rows].sum())
        b_ms, b_by = bound(by, products, INT32_OPS_PER_S)
        warps, resident = kd.count_rows_launch_shape_on(
            torch.cuda.current_device())
        log(f"count {label}: rows {len(rows)} (of {a.m}; {heavy} a block, "
            f"{warps} warps a block, {resident} warps resident) products "
            f"{int(products)} (max a row {int(prod[rows].max())}) nnz "
            f"{int(out.sum())} exact, torch.sparse row nnz equal; kernel "
            f"{ms:.4f} ms (every row a warp {warp_ms:.4f} ms) plain "
            f"{plain_ms:.3f} ms torch.sparse {lib_ms:.3f} ms bound "
            f"{b_ms:.4f} ms ({b_by}, {by / 1e9:.4f} GB)")
        return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "every_row_a_warp_ms": warp_ms,
                "shape": {"rows": len(rows), "heavy_rows": heavy,
                          "warps_a_block": warps,
                          "products": int(products),
                          "nnz": int(out.sum()), "matrix": label}}

    def count_bin_case(label, a_rows, a_starts, a_lens, row_lo, b_cols,
                       window):
        """The TPU contract: an ELL bin's per-slot counts and row nnz."""
        args_ = (a_rows, a_starts, a_lens, row_lo, b_cols)
        kw = dict(window=window, want_counts=True)
        cnt, nnz = kd.spgemm_count_bin(*args_, **kw)
        pcnt, pnnz = kd.count_bin_plain(*args_, **kw)
        torch.cuda.synchronize()
        if not torch.equal(nnz, pnnz) or not torch.equal(cnt, pcnt):
            raise AssertionError(f"count {label}: differs from plain")
        ms = time_cuda(lambda: kd.spgemm_count_bin(*args_, **kw),
                       KERNEL_RUNS)
        plain_ms = time_cuda(lambda: kd.count_bin_plain(*args_, **kw), 3)
        r, e = a_rows.shape
        products = float(torch.where(a_rows >= 0, a_lens, 0).long().sum())
        live = float((a_rows >= 0).sum())
        by = (a_rows.numel() * 4 + live * 8 + r * 4
              + unique_b_bytes(a_rows, a_lens) / 2 + r * 4 + r * window * 4)
        b_ms, b_by = bound(by, products, INT32_OPS_PER_S)
        log(f"count {label}: R {r} E {e} W {window} products "
            f"{int(products)} counts exact; kernel {ms:.3f} ms plain "
            f"{plain_ms:.3f} ms bound {b_ms:.3f} ms ({b_by}, "
            f"{by / 1e9:.4f} GB)")
        return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by,
                "shape": {"R": r, "E": e, "window": window,
                          "want_counts": True, "bin": label}}

    cnt_tri = count_rows_case("triangles", low)
    cnt_pl = count_rows_case("powerlaw", a_pl)
    cnt_band = count_bin_case("banded W256", be_w.a_rows, be_w.a_starts,
                              be_w.a_lens, be_w.row_lo,
                              ops.pad_b_flat(a_band)[0], be_w.window)
    count_edge_cases(kd, ops, dev)
    kernels.append({
        "name": "spgemm_count_bin", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spgemm_count.cu",
        "replaces": "src/repro/kernels/spgemm_dense.py:148",
        "launches": counts["count"], "launches_by_path": by_path["count"],
        **cnt_tri, "also": [cnt_pl, cnt_band]})
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

    # ---------------- 5. device busy share ----------------
    # last: phase 3 reads device times with short profiler sessions, which
    # recorded only some of their launches when they came after these
    done = phase("5. torch.profiler over one more warm call per matrix")
    for name, a in mats:
        profile_call(name, a, caches[name], workflow)
    done()

    log(f"{smi}")
    serving_line["card"] = smi
    print(json.dumps({"serving": serving_line}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
