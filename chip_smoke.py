#!/usr/bin/env python3
"""Drive the PyTorch port of Ocean SpGEMM on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py                  # 2**20-row matrices (default)
    # a quick run (phases 2f, 2g and 2h at the LM smoke configs):
    python3 chip_smoke.py --log2-rows 14 --graph-scale 12 \
        --serve-log2-rows 14 --lm-smoke

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
   bit-identical to the same product served alone (uncached), each
   distinct product as scipy, 9 plans warmed, 12 plan
   hits, the dense and hash kernels once a dense or hash bin and
   ``hll_merge`` as the warmed plans need; a small pool sheds 8 of the 12; k-hop chains (3
   hops, the phase-2c triangle graph) through ``SpGEMMService.run_chain``
   for two tenants, frontiers as scipy, reuse on a tenant's repeat; the
   same 12 requests through a serial service as the yardstick; one more
   burst under a tracer, written to ``chiprun_out/serving_trace.json`` and
   validated;
2e. the device-partitioned path on ``--shards`` (default 4) logical shards
   of card 0 (the device set ``[cuda:0] * shards``): banded and power-law
   through ``ocean_spgemm(a, a, devices=D)`` cold and warm on a fresh plan
   cache, each C bit-identical to phase 2's; ``analyze(a, a, devices=D)``
   equal to ``analyze(a, a)`` field for field and ``sharded_merge_estimate``
   on banded equal to one device's; triangles and MCL through ``devices=D``
   equal to phase 2c's; an ``SpGEMMService(devices=D)`` answering one phase-2d
   request of each pattern, each C bit-identical to the serial uncached
   call; every call's launches checked exactly (the dense and hash kernels
   once a non-empty (shard, bin) slice, ``hll_sketch`` once a non-empty B
   block and ``hll_merge`` once a non-empty A block of an estimation
   prediction plus the sampled CR's, nothing but the bin kernels when
   warm), with the shard costs, imbalance, partition seconds, analysis
   shard seconds, walls beside phase 2's and peak device memory printed;
2f. the LM serving path (``repro_torch.models``, ``ServingEngine``) at the
   full width of Qwen3-1.7B and OLMoE-1B-7B (``--lm-smoke``: their smoke
   configs), random f32 weights from a seeded generator on the card, bf16
   compute: 8 requests (prompts of 64-512 tokens and one of 1,536, the
   chunked attention path; 16-32 new tokens) through a 4-slot engine of
   max_len 1,600, every request complete, its tokens equal to the request
   served alone and every step's logits within 1e-3 of them (relative to
   the largest |logit|); prefill times, decode ms a step, tokens/s,
   torch.profiler's device idle share of one prefill and one decode step
   and peak device memory printed; a 2-row prefill of 1,024 tokens and 8
   decode steps held to one full forward over the 1,032 tokens in f32 (a
   MoE at capacity E / k, so that no token drops; the bf16 difference
   printed); the phase frees all it allocated; ``attention_core`` at the
   1,536-token shape beside one ``scaled_dot_product_attention`` call;
   the MoE dispatch demo on OLMoE's first MoE layer, with the co-routing
   C = D^T @ D through ``SpGEMMService`` twice (the second a plan-cache
   hit; the path's kernel launches counted), C against scipy; and each
   smoke config's prefill and decode logits on the card held to the same
   seeded params on the CPU in f32; OLMoE's batched against alone under
   the scatter dispatch printed (predicted 0);
2g. the LM training path (``repro_torch.optim``, ``models.lm``'s train
   step, ``data``, ``checkpoint``, ``train``): Qwen3-1.7B at full width
   and depth through the train CLI (``repro_torch.launch.train.main``, 8
   steps of 2 x 1,024 tokens, remat ``dots``) and OLMoE-1B-7B at full
   width cut to 4 of its 16 layers through ``make_train_step`` and
   ``train_loop`` (``--lm-smoke``: their smoke configs), every loss finite
   and the last below the first; median step ms, tokens/s, forward +
   backward against optimizer ms, the step's bound, the optimizer's byte
   bound, torch.profiler's device idle share of one step and peak memory
   printed; at the smoke configs (f32) a train step on the card held to
   the CPU's (1e-4), a loop interrupted at step 4 and resumed to 8 held
   to an uninterrupted one (1e-5), the loss below 0.8x its start in 60
   steps; the bf16 readings of phase 2f and a Qwen3 bf16 train step's
   loss and grad norm with the bf16 reduced-precision-reduction flag on
   and off; the phase frees all it allocated;
2h. the three model families beyond GQA at full width (``--lm-smoke``:
   their smoke configs): serving Falcon-Mamba-7B and MiniCPM3-4B at full
   depth and Jamba-v0.1 at its first 5 of 32 layers (6 requests of
   64-512 tokens and one of 1,536, 16 new each, on the 4-slot engine;
   batched = alone; a 1,024-token prefill + 8 decode steps against one
   full forward within 1e-3 in f32 and within 2x the model's own
   bf16-against-f32 gap in bf16, Jamba's router choices replayed), with
   prefill and decode ms, tokens/s, the decode bound, profiles and peak
   memory; Whisper-base on 2 x 1,500 frames (a 64-token prefill through
   ``apply_encdec(mode="prefill")`` and 32 decode steps, each within
   1e-3 of the full forward in f32; encoder, prefill and decode ms in
   bf16); training Falcon-Mamba at 8 of 64 layers and MiniCPM3 at 16 of
   62 (``make_train_step`` + ``train_loop``) and Whisper-base whole
   (``make_encdec_train_step``, 2 x (1,500 frames, 448 tokens)), 8 steps
   each, losses finite and falling, step ms, bound, idle share and peak;
   each family's smoke config on the card against the CPU (logits and a
   train step, 1e-4); the phase frees all it allocated;
2i. ``launch/``: ``make_local_mesh()`` is a world-size-1 ``DeviceMesh``
   (``nccl``) and ``make_shard_mesh()`` resolves to the card; the dry-run's
   cells on that 1 x 1 mesh for Qwen3-1.7B's decode step at phase 2f's
   engine shape and phase 2g's train step, each step also measured here
   (median ms, peak over the resident), the run failing when a step is
   predicted not to fit 80 GB or its roofline bound is above the measured
   time; then the dry-run CLI in subprocesses (Qwen3-1.7B on every shape,
   Jamba-v0.1 on ``train_4k``, both production meshes, traced on meta)
   while phase 2's banded and power-law matrices and one serving request
   go through ``devices=make_shard_mesh()`` (C bit-identical to the
   unsharded C, the kernels' counts read as the ``mesh`` path): every
   record ``ok`` or ``skipped`` with its config's reason, rendered by the
   report CLI;
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
   counting the sketch rows the ids select; and one phase-2e shard slice of
   banded's window bin, of the long-row bin and of power-law's largest hash
   bin, and banded's first A and B block through ``hll_merge`` and
   ``hll_sketch``); then the dense, hash, count and HLL kernels on edge cases the
   paths may not give them (dense: rows past the
   slab's cap, padding, a B row over the stage, a column range wider than
   one shared-memory bitmap; hash: rows that spill or overflow both tables,
   padding, repeated columns, t2048 rows at and past 3,072 columns; count:
   output ranges of 4096 columns, ranges ending at the last column,
   repeated columns, empty rows, rows with more products than a warp's
   stage, each as a row a warp and as a row a block, and a one-row
   launch; HLL: empty, out-of-range, repeated, 12,000-id and largest-rho
   rows, one-row launches, seeds 0 and 7, each branch of the estimate);
   last, the scatter kernel on every source of one compaction of the
   benchmark's FEM and R-MAT matrices (``perfbench/configs``: the bins'
   slabs, the ESC bin's and the overflow fallback's CSRs, captured as the
   merge hands them over), bit for bit equal to its plain version and to
   the multiply's C, timed beside the plain version and one
   device-to-device copy of C, with its bound in bytes; and the plan key's
   fingerprint kernel on the benchmark's FEM, R-MAT and R·AP patterns, bit
   for bit equal to its plain version, timed beside it and the whole key;
4. the small suite (``make_suite(1)``) through ``ocean_spgemm`` on the card
   against scipy, which also drives the ESC and upper-bound paths; Cohen's
   min-rank estimator on banded's A on the card, its first rows held to
   the CPU;
5. one more warm call per phase-2 matrix under torch.profiler gives the
   device's busy time and idle share.

Before the last line come ``{"serving": {...}}`` (phase 2d's numbers),
``{"sharded": {...}}`` (phase 2e's), ``{"lm": {...}}`` (phase 2f's),
``{"train": {...}}`` (phase 2g's and the Cohen check's),
``{"families": {...}}`` (phase 2h's), ``{"dryrun": {...}}`` (phase 2i's)
and ``{"kernels": [...]}``; the last line is ``{"ok": true, "device":
{...}}``. Without a CUDA device the script exits
with a non-zero code and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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
SCATTER_SEED = 3_141_592_653  # values of phase 3's FEM and R-MAT operands

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


# the kernels' launch counts as this script names them, by the wrappers'
# ``kernel.launches`` label
COUNTED = {"dense_window": "dense_window", "dense_longrow": "dense_longrow",
           "hash": "hash", "hll_merge": "hll_merge",
           "hll_sketch": "hll_sketch", "count": "count_rows",
           "slab_scatter": "slab_scatter",
           "pattern_fingerprint": "pattern_fingerprint"}


# the fingerprint's integer operations an element, in 32-bit units: four
# MurmurHash3 finalisers (two 64-bit multiplies of three multiply-adds,
# three xor-shifts by 33 of two operations) and, for each of the two lanes,
# the xor with the value, the salt's add and the sum's (2 each)
FINGERPRINT_OPS = 4 * (2 * 3 + 3 * 2) + 2 * 3 * 2
FINGERPRINT_CONFIGS = ("fem-q1-elasticity", "graph500-rmat-s15",
                       "fem-q1-gamg-rap")


def fingerprint_rows(dev) -> list:
    """The plan key's fingerprint kernel on the benchmark's FEM, R-MAT and
    R·AP patterns (``perfbench/configs``, int32 as the benchmark hands them
    over): equal to its plain version bit for bit, timed (the launch alone
    and the call with its 16-byte read) beside the plain version and the
    whole ``planner.structure_key``, with its bounds in bytes and in int32
    operations. One row a configuration."""
    import torch
    from perfbench import manifest
    from repro_torch.core import formats, planner
    from repro_torch.core.analysis import OceanConfig
    from repro_torch.kernels import pattern_fingerprint as pf
    rows = []
    for name in FINGERPRINT_CONFIGS:
        cfg = manifest.config(manifest.load(), name)
        ops_ = manifest.module("gen", cfg["generator"]).make(
            cfg, SCATTER_SEED, 1, torch.device(dev))
        mats = [formats.CSR(m.indptr.int(), m.indices.int(), m.values[0],
                            tuple(m.shape), int(m.indices.shape[0]))
                for m in ((ops_.a,) if ops_.b is None else (ops_.a, ops_.b))]
        del ops_
        a, b = mats[0], mats[-1]
        arrays = planner.pattern_arrays(a, b)
        lanes = pf.pattern_fingerprint_cuda(arrays)
        plain = pf.pattern_fingerprint_plain(arrays, chunk=1 << 24)
        if lanes != plain:
            raise AssertionError(f"pattern_fingerprint {name}: kernel "
                                 f"{lanes} != plain {plain}")
        out = torch.empty(pf.LANES, dtype=torch.int64, device=dev)
        ms = time_cuda(lambda: pf.launch(arrays, out), KERNEL_RUNS)
        call_ms = time_cuda(lambda: pf.pattern_fingerprint_cuda(arrays),
                            KERNEL_RUNS)
        plain_ms = time_cuda(
            lambda: pf.pattern_fingerprint_plain(arrays, chunk=1 << 24), 3)
        key_s = []
        for _ in range(KERNEL_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            planner.structure_key(a, b, OceanConfig(), None, True, True)
            key_s.append(time.perf_counter() - t0)
        elements = sum(int(x.numel()) for x in arrays)
        by = float(sum(x.numel() * x.element_size() for x in arrays))
        bytes_ms = by / HBM_BYTES_PER_S * 1e3
        b_ms, b_by = bound(by, float(FINGERPRINT_OPS * elements),
                           INT32_OPS_PER_S)
        log(f"pattern_fingerprint {name}: {elements} elements "
            f"({by / 1e6:.1f} MB); kernel = plain bit for bit; launch "
            f"{ms:.4f} ms, call {call_ms:.4f} ms, plain {plain_ms:.2f} ms, "
            f"structure_key {1e3 * float(np.median(key_s)):.3f} ms; bound "
            f"{b_ms:.4f} ms ({b_by}; bytes {bytes_ms:.4f} ms)")
        rows.append({"bin": name, "max_abs_err": 0.0, "ms": ms,
                     "call_ms": call_ms, "plain_ms": plain_ms,
                     "key_ms": 1e3 * float(np.median(key_s)),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bytes_bound_ms": bytes_ms,
                     "shape": {"elements": elements, "bytes": by,
                               "b_is_a": len(mats) == 1}})
        del mats, a, b, arrays
        torch.cuda.empty_cache()
    return rows


def scatters_wanted(shards, rep) -> int:
    """``slab_scatter`` launches one multiply must make: one a source of
    C's rows, that is one a dense, hash or ESC launch of the plan's bins
    (``shards``: ``[plan]``, or a sharded plan's shards, whose slices are
    never empty), and one for the overflow fallback's result when rows
    overflowed."""
    return (sum(len(sh.dense) + len(sh.hash) + (sh.esc is not None)
                for sh in shards) + int(rep.overflow_rows > 0))


def reset_counts() -> None:
    """Count the kernels' launches afresh, in a new metrics registry that
    the wrappers count into (``kernel.launches{kernel}``)."""
    from repro_torch.obs import metrics
    metrics.install_registry(metrics.MetricsRegistry())


def read_counts() -> dict:
    from repro_torch.obs import metrics
    got = metrics.launch_counts()
    return {k: got.get(label, 0) for k, label in COUNTED.items()}


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


def profile_fn(name, fn):
    """Device busy share of one ``fn()`` call, and the device activities
    (kernels, copies) that took the most time, from torch.profiler. Busy
    time is the union of the device activities' intervals: the host ops
    that launched them are not counted again. None when the profiler
    recorded no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        log(f"{name} profile: no device activity recorded (not measured)")
        return None
    busy_us, end = 0.0, float("-inf")
    by_name = {}
    for s, e, key in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        us, cnt = by_name.get(key, (0.0, 0))
        by_name[key] = (us + e - s, cnt + 1)
    busy_ms = busy_us / 1e3
    idle = 1 - busy_ms / (wall * 1e3)
    log(f"{name} profile: wall {wall * 1e3:.1f} ms device busy "
        f"{busy_ms:.1f} ms idle share {idle:.3f} (profiler on)")
    top = sorted(by_name.items(), key=lambda r: -r[1][0])[:8]
    for key, (us, cnt) in top:
        log(f"  {us / 1e3:9.2f} ms  x{cnt:<5d} {key[:90]}")
    return {"wall_ms": wall * 1e3, "busy_ms": busy_ms, "idle_share": idle,
            "device_activities": len(spans),
            "top": [[key[:90], us / 1e3, cnt] for key, (us, cnt) in top]}


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

    # each distinct product served alone, uncached: what every pooled C
    # must equal bit for bit
    refs, ref_walls = [], []
    b_sp = to_scipy(b)
    for name, a in zip(names, pats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, rep = workflow.ocean_spgemm(a, b, cache=False)
        torch.cuda.synchronize()
        ref_walls.append(time.perf_counter() - t0)
        log_call(f"alone {name} @ B", rep, ref_walls[-1], None)
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
    reset_counts()
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
    launched = read_counts()
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
                               for p in range(len(pats))},
              "refs": dict(zip(names, refs))}
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


def same_csr_on_card(x, y) -> bool:
    """Two CSRs equal bit for bit, compared where they live."""
    import torch
    return (x.shape == y.shape and x.nnz == y.nnz
            and torch.equal(x.indptr, y.indptr)
            and torch.equal(x.indices[: x.nnz], y.indices[: y.nnz])
            and torch.equal(x.values[: x.nnz], y.values[: y.nnz]))


def sharded_wanted(splan, rep, a, b, n, count=None) -> dict:
    """The launches a sharded call must make: the dense and hash kernels
    once a non-empty (shard, bin) slice, ``slab_scatter`` once a source of
    C's rows (:func:`scatters_wanted`); on a cold call ``hll_sketch`` once
    a non-empty B block when the analysis sketched, ``hll_merge`` once for
    the sampled CR and once a non-empty A block of an estimation
    prediction, and the count kernel ``count`` times (None: not checked);
    nothing else on a warm call."""
    from repro_torch.core import analysis, formats
    slices = [s for sh in splan.shards for s in sh.dense]
    want = {"dense_window": sum(not s.is_longrow for s in slices),
            "dense_longrow": sum(s.is_longrow for s in slices),
            "hash": sum(len(sh.hash) for sh in splan.shards),
            "slab_scatter": scatters_wanted(splan.shards, rep)}
    if rep.plan_cache_hit:
        return dict(want, hll_sketch=0, hll_merge=0, count=0)

    def blocks(m):
        return sum(r1 > r0 for r0, r1 in analysis.contiguous_split_rows(
            formats.host(m.indptr), n))

    sketched = rep.sampled_cr is not None
    want["hll_sketch"] = blocks(b) if sketched else 0
    want["hll_merge"] = int(sketched) + (blocks(a) if rep.workflow
                                         == "estimation" else 0)
    if count is not None:
        want["count"] = count
    return want


def sharded_phase(args, device, kd, kh, kl, mats, results, call_counts,
                  graph_runs, served, path_counts):
    """Phase 2e: the device-partitioned path on ``args.shards`` logical
    shards of ``device`` (card 0). Returns the fields of the ``{"sharded": ...}`` line,
    and for phase 3 the sharded plans by name and banded's first A/B block
    as ``(r0, r1)``."""
    import torch
    from repro_torch import graph, serving
    from repro_torch.core import analysis, formats, planner, workflow
    from repro_torch.core.analysis import OceanConfig
    from repro_torch.core.dispatch import topology_key

    n = args.shards
    devs = [device] * n
    topo = topology_key(devs)
    total = {k: 0 for k in read_counts()}
    out = {"shards": n, "topology": topo, "calls": {}}
    splans = {}

    peaks = []

    def counted(fn):
        """``fn()`` with every count set to 0 just before and read just
        after (the launches are added to the phase's path), its wall and
        its peak device memory (appended to ``peaks``)."""
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        got = read_counts()
        for k, v in got.items():
            total[k] += v
        return res, wall, got

    def check(label, got, want):
        if any(got[k] != v for k, v in want.items()):
            raise AssertionError(f"{label}: launches {got}, want {want}")

    def shard_plan(cache, a, b):
        key = planner.structure_key(a, b, OceanConfig(), None, True, True)
        return cache.peek(key + "|" + topo)

    # the earlier phases' tensors still resident: every peak below holds them
    out["resident_at_start_gib"] = torch.cuda.memory_allocated() / 2**30
    log(f"device memory resident at the phase's start "
        f"{out['resident_at_start_gib']:.2f} GiB")
    # banded and power-law (and skewed, where phase 2 needed it): cold, warm
    for name, a in mats:
        cache = planner.PlanCache()
        calls = {}
        for i, call in enumerate(("cold", "warm")):
            (c, rep), wall, got = counted(lambda: workflow.ocean_spgemm(
                a, a, cache=cache, devices=devs))
            peak = peaks[-1]
            splan = shard_plan(cache, a, a)
            want = sharded_wanted(splan, rep, a, a, n,
                                  call_counts[name, call]["count"])
            check(f"sharded {name} {call}", got, want)
            if (rep.n_shards, rep.plan_cache_hit) != (n, call == "warm"):
                raise AssertionError(f"sharded {name} {call}: n_shards "
                                     f"{rep.n_shards}, hit "
                                     f"{rep.plan_cache_hit}")
            c_one = results[name][i][0]
            if not same_csr_on_card(c, c_one):
                raise AssertionError(f"sharded {name} {call}: C differs "
                                     "from phase 2's")
            del c
            wall_one = results[name][i][2]
            log_call(f"sharded {name} {call}", rep, wall, got, peak)
            log(f"  phase 2 wall {wall_one:.3f} s; sharded / phase 2 "
                f"{wall / wall_one:.3f} (logical shards of one card); C "
                "bit-identical to phase 2's")
            calls[call] = {"wall_s": wall, "phase2_wall_s": wall_one,
                           "peak_mem_gib": peak, "launches": got,
                           "stages": rep.stage_seconds}
            if call == "cold":
                calls["cold"]["analysis_shard_seconds"] = \
                    rep.analysis_shard_seconds
                log(f"  partition {rep.stage_seconds['partition']:.4f} s; "
                    f"analysis shard seconds {rep.analysis_shard_seconds}; "
                    f"{json.dumps(splan.describe())}")
                calls["partition"] = splan.describe()
        splans[name] = splan
        out["calls"][name] = calls

        # analysis and the merge estimate: sharded equal to one device
        r0 = analysis.analyze(a, a)
        r1 = analysis.analyze(a, a, devices=devs)
        for f in ("workflow", "total_products", "er", "m_regs",
                  "sampled_cr", "cr_mean", "cr_std"):
            if getattr(r0, f) != getattr(r1, f):
                raise AssertionError(f"sharded analysis {name}: {f} "
                                     f"{getattr(r1, f)} != {getattr(r0, f)}")
        for f in ("products_row", "out_lo", "out_hi"):
            if not np.array_equal(getattr(r0, f), getattr(r1, f)):
                raise AssertionError(f"sharded analysis {name}: {f} differs")
        if (r0.b_sketches is None) != (r1.b_sketches is None) or (
                r0.b_sketches is not None
                and not torch.equal(r0.b_sketches, r1.b_sketches)):
            raise AssertionError(f"sharded analysis {name}: sketches differ")
        log(f"sharded analysis {name}: equal to one device field for field"
            f" (sketches byte for byte); shard seconds {r1.shard_seconds}")
        if name == "banded":
            sk = r0.b_sketches
            one = analysis.sharded_merge_estimate(a, sk, clip_max=a.n)
            est, _, got = counted(lambda: analysis.sharded_merge_estimate(
                a, sk, clip_max=a.n, devices=devs))
            if not np.array_equal(est, one):
                raise AssertionError("sharded merge estimate differs from "
                                     "one device's")
            blocks = [(r0_, r1_) for r0_, r1_ in
                      analysis.contiguous_split_rows(formats.host(a.indptr),
                                                     n) if r1_ > r0_]
            if got["hll_merge"] != len(blocks):
                raise AssertionError(f"sharded merge estimate: "
                                     f"{got['hll_merge']} hll_merge launches"
                                     f", {len(blocks)} A blocks")
            out["band_block"] = blocks[0]
            log(f"sharded merge estimate banded: equal to one device's, "
                f"{len(blocks)} hll_merge launches (A blocks {blocks})")
        del r0, r1

    # the graph path: triangles and MCL through the same device set
    adj_t, tris, adj_m, mcl = graph_runs
    tri_cache = planner.PlanCache()
    low = graph.lower_triangle(adj_t)
    for call in ("cold", "warm"):
        (tri, rep), wall, got = counted(lambda: graph.triangle_count(
            adj_t, cache=tri_cache, devices=devs))
        splan = shard_plan(tri_cache, low, low)
        check(f"sharded triangles {call}", got,
              sharded_wanted(splan, rep, low, low, n))
        if tri != tris[0]:
            raise AssertionError(f"sharded triangles {call}: {tri}, phase "
                                 f"2c {tris[0]}")
        log_call(f"sharded triangles {call}", rep, wall, got)
        out["calls"][f"triangles {call}"] = {"wall_s": wall,
                                             "launches": got}
    log(f"sharded triangles: {tris[0]} as phase 2c")
    mcl_s, wall, got = counted(lambda: graph.markov_cluster(
        adj_m, iterations=4, devices=devs))
    if not np.array_equal(mcl_s.labels, mcl.labels):
        raise AssertionError("sharded MCL: labels differ from phase 2c")
    got_np, want_np = formats.to_numpy(mcl_s.matrix), formats.to_numpy(
        mcl.matrix)
    if not (np.array_equal(got_np[0], want_np[0])
            and np.array_equal(got_np[1], want_np[1])):
        raise AssertionError("sharded MCL: structure differs from phase 2c")
    np.testing.assert_allclose(got_np[2], want_np[2], rtol=1e-5, atol=1e-6,
                               err_msg="sharded MCL")
    same = np.array_equal(got_np[2], want_np[2])
    if any(r.n_shards != n for r in mcl_s.result.reports):
        raise AssertionError("sharded MCL: an iteration ran unsharded")
    log(f"sharded MCL: wall {wall:.3f} s, launches {json.dumps(got)}, "
        f"labels and structure as phase 2c, values "
        f"{'bit-identical' if same else 'within rtol 1e-5'}")
    out["calls"]["MCL"] = {"wall_s": wall, "launches": got,
                           "values_bit_identical": same}

    # the service: one request of each serving pattern
    svc = serving.SpGEMMService(devices=devs)
    b = served["b"]
    for sname, (sa, _) in served["mats"].items():
        (c, rep), wall, got = counted(lambda: svc.multiply(sa, b))
        splan = shard_plan(svc.plan_cache, sa, b)
        check(f"sharded service {sname}", got,
              sharded_wanted(splan, rep, sa, b, n))
        if not same_csr_on_card(c, served["refs"][sname]):
            raise AssertionError(f"sharded service {sname}: C differs from "
                                 "the serial uncached call")
        del c
        log_call(f"sharded service {sname} @ B", rep, wall, got)
        out["calls"][f"service {sname}"] = {"wall_s": wall,
                                            "launches": got}
    log("sharded service: 3 C bit-identical to the serial uncached calls")
    out["peak_mem_gib"] = max(peaks)
    out["launches"] = path_counts["sharded"] = total
    missing = [k for k in ("dense_window", "hash", "hll_sketch",
                           "hll_merge", "count") if not total[k]]
    if any(s.is_longrow for sp in splans.values() for sh in sp.shards
           for s in sh.dense) and not total["dense_longrow"]:
        missing.append("dense_longrow")
    if missing:
        raise AssertionError(f"sharded path: kernels never launched "
                             f"{missing}")
    log(f"sharded path launches {json.dumps(total)}; peak device memory "
        f"{out['peak_mem_gib']:.2f} GiB (logical shards of one card)")
    return out, splans


LM_ARCHS = ("qwen3-1.7b", "olmoe-1b-7b")
LM_SLOTS, LM_MAX_LEN = 4, 1600
LM_LONG_PROMPT = 1536      # 2 x 2 chunks of the chunked attention path
LM_TF_PREFILL, LM_TF_STEPS = 1024, 8
# stated before the first full run (PERF.md section 6): logits max
# abs difference, relative to the largest |logit| of the reference side
LM_BATCH_RTOL = 1e-3       # batched against alone, bf16 (predicted 0)
LM_TF_RTOL = 1e-3          # decode steps against one full forward, f32
# the same in bf16, a MoE config with the full forward's expert choices
# replayed (a flipped top-k choice is a different computation, not error),
# within this many times the full forward's own bf16-against-f32 gap
LM_TF_BF16_FACTOR = 2.0
LM_CPU_RTOL = 1e-4         # card against CPU, smoke configs, f32


def lm_requests(vocab: int, seed: int):
    """8 requests: prompts of 64-512 tokens, the sixth (a slot refill)
    LM_LONG_PROMPT long; 16-32 new tokens each."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 513, 8)
    lens[5] = LM_LONG_PROMPT
    new = rng.integers(16, 33, 8)
    return [(rng.integers(0, vocab, int(n)).astype(np.int32), int(m))
            for n, m in zip(lens, new)]


def serve_logged(cfg, params, specs, keep_logits: bool):
    """Serve ``specs`` on a fresh ``ServingEngine`` (4 slots, max_len
    1600); times each prefill and decode step (the engine waits for the
    device at each) and, with ``keep_logits``, keeps every request's
    logits a step on the host. The engine's model steps are wrapped by
    functions that hold the engine's slot list, not the engine, so the
    engine is freed as soon as it is dropped."""
    import torch
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    eng = ServingEngine(cfg, params, ServeConfig(batch_slots=LM_SLOTS,
                                                 max_len=LM_MAX_LEN))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(specs)]
    logits = {r.uid: [] for r in reqs}
    pre_ms, dec_ms = [], []
    order = iter(reqs)      # slots are filled in submission order
    slots = eng.slot_req    # filled and emptied in place by the engine

    def timed(fn, out, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*a)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        return res

    def wrap_prefill(step):
        def pre(*a):
            lo, row = timed(step, pre_ms, *a)
            uid = next(order).uid
            if keep_logits:
                logits[uid].append(lo[0].float().cpu())
            return lo, row
        return pre

    def wrap_decode(step):
        def dec(*a):
            active = [(i, r.uid) for i, r in enumerate(slots)
                      if r is not None]
            lo, caches = timed(step, dec_ms, *a)
            if keep_logits:
                for i, uid in active:
                    logits[uid].append(lo[i].float().cpu())
            return lo, caches
        return dec

    eng._prefill = wrap_prefill(eng._prefill)
    eng._decode = wrap_decode(eng._decode)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r, (_, m) in zip(reqs, specs):
        if not r.done or len(r.output) != m:
            raise AssertionError(f"request {r.uid}: done {r.done}, "
                                 f"{len(r.output)} tokens, want {m}")
    bytes_read = sum(p.numel() * p.element_size()
                     for p in eng.params.parameters())
    return reqs, logits, pre_ms, dec_ms, wall, bytes_read


def lm_profile(cfg, wparams, specs, label: str) -> dict:
    """torch.profiler over one prefill (the first request's prompt) and
    one decode step of a full engine (4 slots busy), as the engine runs
    them."""
    from repro_torch.serving import Request, ServeConfig, ServingEngine
    eng = ServingEngine(cfg, wparams, ServeConfig(batch_slots=LM_SLOTS,
                                                 max_len=LM_MAX_LEN))
    for i, (p, m) in enumerate(specs[1:LM_SLOTS]):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=m))
    eng.step()      # fills 3 slots, warms the decode step
    eng.submit(Request(uid=9, prompt=specs[0][0], max_new_tokens=8))
    out = {"prefill": profile_fn(f"{label} prefill of {len(specs[0][0])} "
                                 "tokens", eng._fill_slots),
           "decode_step": profile_fn(f"{label} decode step, 4 slots",
                                     eng.step)}
    del eng
    return out


def batched_vs_alone(cfg, wparams, specs, label: str):
    """The requests batched, then each alone: the same tokens, and logits
    within LM_BATCH_RTOL of the largest alone. Returns the batched
    requests and the largest logit difference."""
    import torch
    reqs_b, logits_b, *_ = serve_logged(cfg, wparams, specs, keep_logits=True)
    worst = 0.0
    for i, spec in enumerate(specs):
        alone, logits_a, *_ = serve_logged(cfg, wparams, [spec],
                                           keep_logits=True)
        if alone[0].output != reqs_b[i].output:
            raise AssertionError(f"{label}: request {i} alone emits "
                                 f"{alone[0].output}, batched "
                                 f"{reqs_b[i].output}")
        got, want = torch.stack(logits_b[i]), torch.stack(logits_a[0])
        diff = float((got - want).abs().max())
        if diff > LM_BATCH_RTOL * float(want.abs().max()):
            raise AssertionError(f"{label}: request {i} batched logits "
                                 f"differ from alone by {diff}")
        worst = max(worst, diff)
    return reqs_b, worst


def lm_serve(cfg, params, label: str, specs) -> dict:
    """The requests ``specs`` batched, then each alone: the same tokens
    and logits."""
    import torch
    from repro_torch.models import lm
    wparams = lm.cast_weights(params, cfg.compute_dtype)   # made once
    reqs, _, pre_ms, dec_ms, wall, wbytes = serve_logged(
        cfg, wparams, specs, keep_logits=False)
    tokens = sum(len(r.output) for r in reqs)
    lens = [len(p) for p, _ in specs]
    log(f"{label} serve: {len(specs)} requests, prompts {lens}, new "
        f"{[m for _, m in specs]}; wall {wall:.3f} s, {tokens} tokens, "
        f"{tokens / wall:.1f} tokens/s; prefill ms "
        f"{[round(t, 2) for t in pre_ms]}; decode {len(dec_ms)} steps, median {np.median(dec_ms):.2f} ms (min {min(dec_ms):.2f}, "
        f"max {max(dec_ms):.2f})")
    prof = lm_profile(cfg, wparams, specs, label)
    reqs_b, worst = batched_vs_alone(cfg, wparams, specs, label)
    if [r.output for r in reqs_b] != [r.output for r in reqs]:
        raise AssertionError(f"{label}: two batched runs differ in tokens")
    log(f"{label}: batched = alone for all {len(specs)} requests (tokens "
        f"equal, logits "
        f"max abs diff {worst:.3g}); first tokens "
        f"{[r.output[0] for r in reqs]} (the reference's engine.py:81)")
    scatter = None
    if cfg.moe_num_experts:
        # the einsum combine groups a token's terms by its capacity slot,
        # which the batch's other rows decide; scatter gathers its own rows
        from repro_torch.models import moe
        mode = moe.DISPATCH_MODE
        moe.set_dispatch_mode("scatter")
        try:
            _, scatter = batched_vs_alone(cfg, wparams, specs, label)
        finally:
            moe.set_dispatch_mode(mode)
        log(f"{label}: under the scatter dispatch batched against alone "
            f"max abs diff {scatter:.3g} (predicted 0)")
    del wparams
    torch.cuda.empty_cache()
    return {"prompt_lens": lens, "new_tokens": [m for _, m in specs],
            "prefill_ms": pre_ms, "decode_steps": len(dec_ms),
            "decode_ms_median": float(np.median(dec_ms)),
            "decode_ms_min": min(dec_ms), "decode_ms_max": max(dec_ms),
            "wall_s": wall, "tokens": tokens,
            "tokens_per_s": tokens / wall,
            "batched_vs_alone_max_abs": worst,
            "scatter_batched_vs_alone_max_abs": scatter, "profile": prof,
            "weights_gb": wbytes / 1e9,
            "decode_bound_ms": wbytes / HBM_BYTES_PER_S * 1e3}


class RouteLog:
    """Stands in for ``moe.top_k`` (see ``routed``): records each MoE layer
    call's expert choices in call order or, with ``replay`` set to a
    recorded full forward's choices (one ``(B, S, k)`` tensor a layer),
    returns those at the positions ``cols``, gated by this call's
    probabilities."""

    def __init__(self, real):
        self.real = real
        self.calls, self.replay, self.cols, self.n = [], None, None, 0

    def __call__(self, probs, k):
        if self.replay is None:
            vals, idx = self.real(probs, k)
            self.calls.append(idx)
            return vals, idx
        full = self.replay[self.n % len(self.replay)]
        self.n += 1
        idx = full[:, self.cols].reshape(-1, k)
        return probs.gather(-1, idx), idx


@contextlib.contextmanager
def routed(spy):
    """``spy`` in place of ``moe.top_k`` for the block."""
    from repro_torch.models import moe
    real, moe.top_k = moe.top_k, spy
    try:
        yield spy
    finally:
        moe.top_k = real


def lm_teacher_forced(cfg, params, dev, dtype: str) -> dict:
    """Prefill LM_TF_PREFILL tokens of a 2-row batch, then LM_TF_STEPS
    decode steps of seeded tokens, each step's logits against one full
    forward over all the tokens. A MoE config runs at capacity factor
    E / k (capacity = tokens), so that no token drops: a drop depends on
    which tokens are routed together, and that differs between the
    three calls. For a MoE config also: each layer's tokens whose top-k
    expert set differs between the prefill/decode calls and the full
    forward (flips), the gap on the compared tokens that no layer flipped,
    and the gap when the prefill and decode calls take the full forward's
    expert choices (``replayed_rel``). In bf16 also the full forward in
    bf16 against f32 (``bf16_vs_f32_rel``), the yardstick of the bf16
    gap."""
    import dataclasses
    import torch
    from repro_torch.models import lm, moe
    from repro_torch.models import transformer as tf
    over = {"dtype": dtype}
    if cfg.moe_num_experts:
        over["moe_capacity_factor"] = cfg.moe_num_experts / cfg.moe_top_k
    c = dataclasses.replace(cfg, **over)
    p, n = LM_TF_PREFILL, LM_TF_PREFILL + LM_TF_STEPS
    rng = np.random.default_rng(12)
    toks = torch.as_tensor(rng.integers(0, c.vocab_size, (2, n)), device=dev)
    prefill, decode = lm.make_prefill_step(c), lm.make_decode_step(c)
    spy = RouteLog(moe.top_k)

    @torch.no_grad()
    def stepwise():
        caches = lm.init_caches(c, 2, n, dtype=c.compute_dtype, device=dev)
        spy.cols, spy.n = slice(0, p), 0
        lo, caches = prefill(params, caches, toks[:, :p])
        steps = [lo]
        for j in range(p, n):
            spy.cols = slice(j, j + 1)
            lo, caches = decode(params, caches, toks[:, j:j + 1],
                                torch.full((2,), j, device=dev))
            steps.append(lo)
        return torch.stack(steps, 1)            # (2, 1 + steps, V)

    with routed(spy), torch.no_grad():
        hidden, _, _ = tf.apply_decoder(params, toks, c, return_hidden=True)
        want = tf.unembed(params, hidden[:, p - 1:], c)
        del hidden
        full = [idx.reshape(2, n, -1) for idx in spy.calls]
        spy.calls = []
        got = stepwise()
        scale = float(want.abs().max())
        gap = (got - want).abs().amax(-1) / scale   # (2, 1 + steps)
        out = {"max_abs": float((got - want).abs().max()),
               "max_logit": scale, "rel": float(gap.max())}
        if full:
            layers = len(full)
            pre, dec = spy.calls[:layers], spy.calls[layers:]
            mine = [torch.cat([pre[l].reshape(2, p, -1)]
                              + [dec[s * layers + l].reshape(2, 1, -1)
                                 for s in range(LM_TF_STEPS)], 1)
                    for l in range(layers)]
            flips = torch.stack([(a.sort(-1).values != b.sort(-1).values)
                                 .any(-1) for a, b in zip(mine, full)])
            hit = flips[:, :, p - 1:].any(0)        # (2, 1 + steps)
            spy.replay = full
            replayed = (stepwise() - want).abs().max()
            spy.replay = None
            out.update(
                flips_by_layer=flips.sum((1, 2)).tolist(),
                flips_by_layer_compared=flips[:, :, p - 1:].sum((1, 2))
                .tolist(),
                tokens_compared=hit.numel(), tokens_flipped=int(hit.sum()),
                no_flip_rel=float(gap[~hit].max()) if (~hit).any() else None,
                flip_rel=float(gap[hit].max()) if hit.any() else None,
                replayed_rel=float(replayed) / scale)
        if dtype == "bfloat16":
            # bf16's own reach: the full forward in bf16 against f32 (a MoE
            # config's bf16 run on the f32 run's expert choices)
            c32 = dataclasses.replace(c, dtype="float32")
            spy.calls = []
            hidden, _, _ = tf.apply_decoder(params, toks, c32,
                                            return_hidden=True)
            w32 = tf.unembed(params, hidden[:, p - 1:], c32)
            spy.replay = [idx.reshape(2, n, -1) for idx in spy.calls] or None
            spy.cols, spy.n = slice(0, n), 0
            if spy.replay:
                hidden, _, _ = tf.apply_decoder(params, toks, c,
                                                return_hidden=True)
                want = tf.unembed(params, hidden[:, p - 1:], c)
            del hidden
            out["bf16_vs_f32_rel"] = (float((want - w32).abs().max())
                                      / float(w32.abs().max()))
    del got, want
    return out


def lm_card_vs_cpu(arch: str, dev) -> dict:
    """The smoke config with the same seeded params on the CPU and the
    card: prefill (1100 tokens, the chunked path) and 8 decode steps. An
    encoder-decoder prefills 16 tokens over 1,100 seeded frames (the
    chunked core) through ``apply_encdec(mode="prefill")``."""
    import torch
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf
    cfg = configs.get_config(arch, smoke=True)
    encdec = cfg.is_encoder_decoder
    rng = np.random.default_rng(21 if encdec else 13)
    if encdec:
        audio = rng.standard_normal((2, 1100, cfg.d_model)).astype(
            np.float32)
    p = 16 if encdec else 1100
    toks = rng.integers(0, cfg.vocab_size, (2, p + 8))
    decode = (lm.make_encdec_decode_step if encdec
              else lm.make_decode_step)(cfg)
    out = {}
    for where in ("cpu", "card"):
        d = dev if where == "card" else torch.device("cpu")
        model = lm.init_model(cfg, seed=0, device="cpu").to(d)
        t = torch.as_tensor(toks, device=d)
        caches = lm.init_caches(cfg, 2, p + 8, dtype=torch.float32, device=d,
                                src_len=1100 if encdec else 0)
        if encdec:
            with torch.no_grad():
                lo, caches, _ = tf.apply_encdec(
                    model, torch.as_tensor(audio, device=d), t[:, :p], cfg,
                    mode="prefill", caches=caches)
            lo = lo[:, -1]
        else:
            lo, caches = lm.make_prefill_step(cfg)(model, caches, t[:, :p])
        steps = [lo.cpu()]
        for j in range(p, p + 8):
            lo, caches = decode(model, caches, t[:, j:j + 1],
                                torch.full((2,), j, device=d))
            steps.append(lo.cpu())
        out[where] = torch.stack(steps, 1)
    scale = float(out["cpu"].abs().max())
    diff = close_enough(out["card"], out["cpu"], rtol=LM_CPU_RTOL,
                        atol=LM_CPU_RTOL * scale)
    return {"max_abs": diff, "max_logit": scale}


def lm_attention_yardstick(cfg, dev) -> dict:
    """attention_core at the long prefill's shape (causal, no window, as
    Qwen3 and OLMoE) beside one scaled_dot_product_attention call on the
    same q/k/v (KV heads repeated to the query heads' grouping)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import attention
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    q, k, v = (torch.randn((1, LM_LONG_PROMPT, h, dh), generator=gen,
                           device=dev).to(cfg.compute_dtype)
               for h in (hq, hkv, hkv))
    g = hq // hkv
    qt, kt, vt = (x.transpose(1, 2) for x in
                  (q, k.repeat_interleave(g, dim=2),
                   v.repeat_interleave(g, dim=2)))

    def core():
        return attention.attention_core(q, k, v, causal=True)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    with torch.no_grad():
        diff = float((core().float() - sdpa().transpose(1, 2).float())
                     .abs().max())
        core_ms, sdpa_ms = time_cuda(core, 5), time_cuda(sdpa, 10)
    return {"shape": [1, LM_LONG_PROMPT, hq, hkv, dh], "core_ms": core_ms,
            "sdpa_ms": sdpa_ms, "max_abs_vs_sdpa": diff}


def lm_moe_demo(cfg, params, dev, kd, kh, kl, path_counts):
    """The MoE dispatch demo on the OLMoE model's first MoE layer:
    capacity plans (exact, sampled) for the demo's 32k-token 64-expert
    top-8 router, the layer under both capacities, scatter against
    einsum, and C = D^T @ D twice through SpGEMMService (a plan-cache hit
    the second time), C against scipy. Returns the fields of the demo's
    entry in the ``{"lm": ...}`` line and ``(D^T, D, plan)`` for phase 3."""
    import torch
    from repro_torch.core import planner
    from repro_torch.tools import moe_dispatch
    logits = moe_dispatch.router_logits(32_768, 64)
    plans = moe_dispatch.plan_capacity(logits, 8)
    sampled = plans["sampled"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    x = torch.randn((8, 128, cfg.d_model), generator=gen, device=dev)
    with torch.no_grad():
        res = moe_dispatch.run_dispatch(params.layers[0].ff, cfg, x,
                                        sampled.capacity_factor)
    torch.cuda.synchronize()
    reset_counts()
    c1, rep1, c2, rep2, service, d, dt = moe_dispatch.co_routing(logits, 8,
                                                                 dev)
    torch.cuda.synchronize()
    launched = path_counts["lm"] = read_counts()
    if not rep2.plan_cache_hit or rep1.plan_cache_hit:
        raise AssertionError("MoE demo: the second multiply missed the "
                             "plan cache")
    plan = service.plan_cache.peek(planner.structure_key(
        dt, d, service.cfg, None, True, True))
    # both calls run the plan's bins, one launch a bin; the cold call's
    # planning merges once a sampled CR and once an estimation prediction,
    # sketching D once for them
    merges = merges_wanted(rep1) + merges_wanted(rep2)
    want = {"dense_window": 2 * sum(not be.is_longrow for be in plan.dense),
            "dense_longrow": 2 * sum(be.is_longrow for be in plan.dense),
            "hash": 2 * len(plan.hash), "hll_merge": merges,
            "hll_sketch": int(merges > 0),
            "count": sum(int(r.workflow == "symbolic"
                             and not r.plan_cache_hit) for r in (rep1, rep2)),
            "slab_scatter": sum(scatters_wanted([plan], r)
                                for r in (rep1, rep2)),
            # the service keys both calls through its plan cache
            "pattern_fingerprint": 2}
    if launched != want or not sum(launched.values()):
        raise AssertionError(f"MoE demo: launches {launched}, want {want} "
                             f"(bins {rep1.bins})")
    d_sp = to_scipy(d)
    err = check_against_scipy(c1, d_sp.T.tocsr(), "co-routing C", d_sp)
    log(f"MoE demo: cf exact {plans['exact'].capacity_factor:.3f} "
        f"({plans['exact_s'] * 1e3:.1f} ms), sampled "
        f"{sampled.capacity_factor:.3f} ({plans['sampled_s'] * 1e3:.1f} ms, "
        f"{sampled.sample_fraction:.1%} of tokens); drops "
        f"{json.dumps(res['drops'])}; scatter vs einsum max abs "
        f"{res['scatter_vs_einsum']:.3g}; C (64x64, nnz {c1.nnz}) = scipy "
        f"(max abs diff {err:.3g}), workflow {rep1.workflow} bins "
        f"{json.dumps(rep1.bins)}, launches {json.dumps(launched)} as "
        "wanted; second call plan hit, setup "
        f"{rep1.setup_seconds * 1e3:.1f} -> {rep2.setup_seconds * 1e3:.1f} "
        "ms")
    line = {"cf_exact": plans["exact"].capacity_factor,
            "cf_sampled": sampled.capacity_factor,
            "exact_ms": plans["exact_s"] * 1e3,
            "sampled_ms": plans["sampled_s"] * 1e3,
            "drops": res["drops"],
            "scatter_vs_einsum_max_abs": res["scatter_vs_einsum"],
            "c_max_abs_vs_scipy": err, "bins": rep1.bins,
            "launches": launched,
            "plan_cache_hit": rep2.plan_cache_hit,
            "setup_ms": [rep1.setup_seconds * 1e3,
                         rep2.setup_seconds * 1e3]}
    del c1, c2, service
    return line, (dt, d, plan)


def serve_and_check(cfg, params, dev, arch: str, pbytes: int, specs) -> dict:
    """A model's serving checks: ``specs`` served batched and alone
    (``lm_serve``), then prefill + decode against one full forward in bf16
    and in f32 (``lm_teacher_forced``), each held to its limit. Each
    step's peak memory is read alone (``peaks_gib``; this resets the peak
    counter, so a caller reads its peak with ``overall_peak``)."""
    import torch
    m = {"params": cfg.param_count(), "param_gb": pbytes / 1e9,
         "f32_decode_bound_ms": pbytes / HBM_BYTES_PER_S * 1e3,
         "peaks_gib": {"before": torch.cuda.max_memory_allocated() / 2**30}}

    def peak_of(name, fn):
        """fn(); its start's allocated memory and its peak, in GiB."""
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated() / 2**30
        res = fn()
        m["peaks_gib"][name] = [start,
                                torch.cuda.max_memory_allocated() / 2**30]
        return res

    m["serve"] = peak_of("serve", lambda: lm_serve(cfg, params, arch, specs))
    m["teacher_forced"] = {}
    for dtype in ("bfloat16", "float32"):
        tf_ = peak_of(f"teacher_forced_{dtype}", lambda: lm_teacher_forced(
            cfg, params, dev, dtype))
        m["teacher_forced"][dtype] = tf_
        log(f"{arch} teacher-forced {dtype}: {LM_TF_STEPS} decode steps "
            f"and the prefill's last against one full forward of "
            f"{LM_TF_PREFILL + LM_TF_STEPS} tokens: max abs diff "
            f"{tf_['max_abs']:.3g} (max |logit| {tf_['max_logit']:.3g})")
        if "replayed_rel" in tf_:
            log(f"  router top-{cfg.moe_top_k} sets flipped against the "
                f"full forward, by layer: {tf_['flips_by_layer']} of "
                f"{2 * LM_TF_PREFILL + 2 * LM_TF_STEPS} tokens, "
                f"{tf_['flips_by_layer_compared']} of the "
                f"{tf_['tokens_compared']} compared; compared tokens "
                f"flipped in some layer {tf_['tokens_flipped']}, gap "
                f"relative to max |logit| on them {tf_['flip_rel']}, on "
                f"the others {tf_['no_flip_rel']}; with the full "
                f"forward's choices replayed {tf_['replayed_rel']:.3g}")
        if "bf16_vs_f32_rel" in tf_:
            log(f"  the full forward in bf16 against f32 (f32's expert "
                f"choices): {tf_['bf16_vs_f32_rel']:.3g} of max |logit|")
    log(f"{arch}: allocated at the start and peak of each step, GiB: "
        f"{json.dumps(m['peaks_gib'])}")
    tf32, tf16 = (m["teacher_forced"][k] for k in ("float32", "bfloat16"))
    if tf32["rel"] > LM_TF_RTOL:
        raise AssertionError(f"{arch}: f32 decode differs from the full "
                             f"forward: {tf32}")
    if (tf16.get("replayed_rel", tf16["rel"])
            > LM_TF_BF16_FACTOR * tf16["bf16_vs_f32_rel"]):
        raise AssertionError(f"{arch}: bf16 decode differs from the full "
                             "forward (expert choices replayed) by more "
                             f"than {LM_TF_BF16_FACTOR} x bf16's own "
                             f"reach: {tf16}")
    return m


def overall_peak(m) -> float:
    """The peak device memory (GiB) since the caller's reset, across the
    steps of ``serve_and_check`` that returned ``m``."""
    import torch
    return max([torch.cuda.max_memory_allocated() / 2**30,
                m["peaks_gib"]["before"]]
               + [v[1] for k, v in m["peaks_gib"].items() if k != "before"])


def lm_phase(args, dev, kd, kh, kl, path_counts) -> dict:
    """Phase 2f: the LM serving path at the full width of Qwen3-1.7B and
    OLMoE-1B-7B (smoke configs with ``--lm-smoke``). Returns the fields of
    the ``{"lm": ...}`` line and the MoE demo's ``(D^T, D, plan)``."""
    import torch
    from repro_torch import configs
    from repro_torch.models import lm
    out, demo = {"models": {}}, None
    out["bf16_reduced_precision_reduction"] = bf16_reduction_flag()
    # the phase's large segments are its own, and are all released at its
    # end: a cached segment that the next phase splits can keep it from
    # finding room (phase 3's torch.sparse product needs 27.6 GiB at once)
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2**30
    log(f"device memory resident at the phase's start {resident:.2f} GiB")
    for arch in LM_ARCHS:
        cfg = configs.get_config(arch, smoke=args.lm_smoke)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init_model(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        pbytes = sum(p.numel() * p.element_size() for p in params.parameters())
        log(f"{arch}{' (smoke)' if args.lm_smoke else ''}: "
            f"{cfg.param_count():,} params by the config's count, "
            f"{pbytes / 1e9:.2f} GB in f32, drawn in "
            f"{time.perf_counter() - t0:.2f} s")
        m = serve_and_check(cfg, params, dev, arch, pbytes,
                            lm_requests(cfg.vocab_size, seed=11))
        m["attention"] = lm_attention_yardstick(cfg, dev)
        log(f"{arch} attention at {m['attention']['shape']}: attention_core "
            f"{m['attention']['core_ms']:.3f} ms, one "
            f"scaled_dot_product_attention {m['attention']['sdpa_ms']:.3f} ms"
            f" (max abs diff {m['attention']['max_abs_vs_sdpa']:.3g})")
        if cfg.moe_num_experts:
            out["moe_demo"], demo = lm_moe_demo(cfg, params, dev, kd, kh,
                                                kl, path_counts)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        m["peak_gib"] = overall_peak(m)
        log(f"{arch}: peak device memory {m['peak_gib']:.2f} GiB (with "
            f"{resident:.2f} GiB of earlier phases resident); decode bound "
            f"{m['serve']['decode_bound_ms']:.3f} ms a step at the engine's "
            f"{m['serve']['weights_gb']:.2f} GB of weights, "
            f"{m['f32_decode_bound_ms']:.3f} ms at f32")
        out["models"][arch] = m
    out["card_vs_cpu"] = {}
    for arch in LM_ARCHS:
        r = out["card_vs_cpu"][arch] = lm_card_vs_cpu(arch, dev)
        log(f"{arch} smoke, card against CPU (f32, prefill 1100 + 8 decode "
            f"steps): max abs diff {r['max_abs']:.3g} (max |logit| "
            f"{r['max_logit']:.3g})")
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30 - resident
    log(f"device memory left allocated by the phase {left:.3f} GiB, "
        f"reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    if left > 0.25:
        raise AssertionError(f"phase 2f left {left:.2f} GiB allocated")
    out["tolerances"] = {"batched_vs_alone_rel": LM_BATCH_RTOL,
                         "teacher_forced_f32_rel": LM_TF_RTOL,
                         "teacher_forced_bf16_replayed_over_bf16_vs_f32":
                         LM_TF_BF16_FACTOR,
                         "card_vs_cpu_rel": LM_CPU_RTOL}
    return out, demo


TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 2, 1024
TRAIN_OLMOE_LAYERS = 4       # of 16: 4 x 27.26 GB of f32 train state at 16
TRAIN_RESTART_TOL = 1e-5     # resumed against uninterrupted, on the card
BF16_PEAK_OPS_PER_S = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)


def bf16_reduction_flag(value=None) -> bool:
    """``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    (set first when ``value`` is given)."""
    import torch
    if value is not None:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            value
    return torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def train_flops(cfg, batch: int, seq: int) -> float:
    """Matmul operations of one train step: the forward's products (MoE
    layers at each token's top-k experts, causal attention at the (query,
    key) pairs on or below the diagonal, an MLA layer's low-rank
    projections, a Mamba layer's projections; the Mamba scan's
    elementwise operations not counted) and the backward's at twice the
    forward's."""
    d, dh, hq, hkv = cfg.d_model, cfg.head_dim_, cfg.num_heads, \
        cfg.num_kv_heads
    t = batch * seq
    pairs = batch * seq * (seq + 1) / 2
    fwd = 2 * t * d * cfg.vocab_size                       # unembed
    for i in range(cfg.num_layers):
        if not cfg.is_attn_layer(i):
            di, ds, dtr = (cfg.mamba_d_inner, cfg.mamba_d_state,
                           cfg.mamba_dt_rank_)
            fwd += 2 * t * (d * 2 * di + di * (dtr + 2 * ds) + dtr * di
                            + di * d)
        elif cfg.attention_type == "mla":
            r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim,
                             cfg.qk_rope_dim, cfg.v_head_dim)
            fwd += 2 * t * (d * cfg.q_lora_rank
                            + cfg.q_lora_rank * hq * (dn + dr)
                            + d * (r + dr) + r * hq * (dn + dv)
                            + hq * dv * d)
            fwd += 2 * hq * (dn + dr + dv) * pairs
        else:
            fwd += 2 * t * (2 * d * hq * dh + 2 * d * hkv * dh)
            fwd += 2 * 2 * hq * dh * pairs
        if cfg.is_moe_layer(i):
            ff = cfg.moe_d_ff or cfg.d_ff
            fwd += 2 * t * (d * cfg.moe_num_experts
                            + cfg.moe_top_k * 3 * d * ff)
        elif cfg.d_ff:
            fwd += 2 * t * 3 * d * cfg.d_ff
    return 3 * fwd


def encdec_train_flops(cfg, batch: int, src: int, tgt: int) -> float:
    """``train_flops`` of the encoder-decoder: encoder layers over ``src``
    frames (attention not causal), decoder layers over ``tgt`` tokens
    (causal self-attention, cross-attention to the frames, the cross K/V
    projected from them), the unembed."""
    d, dh, h, hkv = cfg.d_model, cfg.head_dim_, cfg.num_heads, \
        cfg.num_kv_heads
    qo, kv, mlp = 2 * d * h * dh, 2 * d * hkv * dh, 3 * d * cfg.d_ff
    enc = 2 * batch * src * (qo + kv + mlp) + 4 * h * dh * batch * src * src
    dec = (2 * batch * tgt * (2 * qo + kv + mlp) + 2 * batch * src * kv
           + 4 * h * dh * batch * tgt * (tgt + 1) / 2
           + 4 * h * dh * batch * tgt * src)
    fwd = (cfg.encoder_layers * enc + cfg.decoder_layers * dec
           + 2 * batch * tgt * d * cfg.vocab_size)
    return 3 * fwd


def host_ms(fn, runs: int) -> list:
    """Milliseconds of each of ``runs`` calls of ``fn``, host clock between
    device synchronisations."""
    import torch
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def step_readings(label, hist, times, n: int, flops: float, tokens: int,
                  step) -> dict:
    """The numbers every full-width training run reports: every loss of
    ``hist`` finite and the last below the first; the median of the step
    ms ``times`` after the first, tokens/s at ``tokens`` a step, the bound
    of ``n`` parameters at 28 B and ``flops`` at bf16's peak (the
    larger), and torch.profiler's device idle share of one more call of
    ``step``."""
    losses = [h["loss"] for h in hist]
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses}")
    step_ms = float(np.median(times[1:]))
    prof = profile_fn(f"{label} train step", step)
    b_ms, b_by = bound(28 * n, flops, BF16_PEAK_OPS_PER_S)
    out = {"losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
           "step_ms": times, "step_ms_median": step_ms,
           "tokens_per_s": tokens / step_ms * 1e3, "params": n,
           "step_flops": flops, "bound_ms": b_ms, "bound_by": b_by,
           "profile": prof}
    log(f"{label} train: losses {[round(x, 4) for x in losses]}; step ms "
        f"{[round(t, 1) for t in times]}, median after the first "
        f"{step_ms:.1f} ({out['tokens_per_s']:.0f} tokens/s); bound "
        f"{b_ms:.2f} ms by {b_by} ({flops:.3g} operations at bf16's peak, "
        f"{n:,} parameters)")
    return out


def train_readings(label, cfg, res, dev, lr: float) -> dict:
    """A decoder's full-width run: ``step_readings`` of the loop's history
    and step times, then its aux losses, and forward + backward against
    optimizer ms. Further steps train the run's own state."""
    import torch
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_update
    params, state = res["params"], res["opt_state"]
    toks = torch.as_tensor(train_tokens(cfg, TRAIN_STEPS), device=dev)
    opt_cfg = AdamWConfig(lr=lr)
    step = lm.make_train_step(cfg, opt_cfg,
                              schedule_kwargs=train.schedule_for(TRAIN_STEPS))
    n = sum(p.numel() for p in params.parameters())
    out = step_readings(label, res["metrics_history"],
                        [t * 1e3 for t in res["step_times_s"]], n,
                        train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ),
                        TRAIN_BATCH * TRAIN_SEQ,
                        lambda: step(params, state, {"tokens": toks}))
    box = {}

    def fwd_bwd():
        box["g"] = lm.grads_of(params, toks, cfg)[0]

    fb_ms = host_ms(fwd_bwd, 2)
    opt_ms = host_ms(lambda: adamw_update(params, box["g"], state, opt_cfg,
                                          0.5), 2)
    box.clear()
    opt_bound = 28 * n / HBM_BYTES_PER_S * 1e3
    out.update(aux_losses=[h["aux_loss"] for h in res["metrics_history"]],
               fwd_bwd_ms=fb_ms, optimizer_ms=opt_ms,
               optimizer_bound_ms=opt_bound)
    log(f"{label} train: aux {[round(x, 4) for x in out['aux_losses']]}; "
        f"forward + backward {[round(t, 1) for t in fb_ms]} ms, optimizer "
        f"{[round(t, 1) for t in opt_ms]} ms (bound {opt_bound:.2f} ms at "
        f"28 B a parameter)")
    return out


def data_config(cfg, batch=None, seq=None, seed=0):
    """The full-width runs' data (TRAIN_BATCH x TRAIN_SEQ unless given)."""
    from repro_torch.data import DataConfig
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=seq or TRAIN_SEQ,
                      global_batch=batch or TRAIN_BATCH, seed=seed)


def train_tokens(cfg, step: int) -> np.ndarray:
    """The full-width runs' batch of ``step`` (the CLI's data, seed 0)."""
    from repro_torch.data import SyntheticLM
    return SyntheticLM(data_config(cfg)).batch(step)


def free_device():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_qwen3(args, dev) -> dict:
    """Qwen3-1.7B at full width and depth through the port's train CLI."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import train
    cfg = configs.get_config("qwen3-1.7b", smoke=args.lm_smoke)
    argv = ["--arch", "qwen3-1.7b", "--steps", str(TRAIN_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--remat", "dots", "--log-every", "1", "--device", str(dev)]
    if args.lm_smoke:
        argv.append("--smoke")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.main(argv)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = train_readings("qwen3-1.7b", cfg, res, dev, lr=3e-4)
    out.update(cli=" ".join(["python -m repro_torch.launch.train"] + argv),
               wall_s=wall, peak_gib=peak,
               peak_gib_with_readings=torch.cuda.max_memory_allocated()
               / 2**30)
    log(f"qwen3-1.7b: the CLI's {TRAIN_STEPS} steps in {wall:.2f} s, peak "
        f"device memory {peak:.2f} GiB")
    del res
    free_device()
    return out


def train_cut(args, dev, arch: str, layers: int) -> dict:
    """``arch`` at full width, cut to its first ``layers`` layers, through
    make_train_step and train_loop."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainLoopConfig, train_loop
    full = configs.get_config(arch, smoke=args.lm_smoke)
    cfg = dataclasses.replace(full, num_layers=min(layers, full.num_layers))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_model(cfg, seed=0, device=dev)
    step = lm.make_train_step(cfg, AdamWConfig(lr=3e-4), remat="dots",
                              schedule_kwargs=train.schedule_for(
                                  TRAIN_STEPS))
    res = train_loop(step, params, adamw_init(params), data_config(cfg),
                     TrainLoopConfig(total_steps=TRAIN_STEPS, log_every=1),
                     log_fn=log)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params
    out = train_readings(arch, cfg, res, dev, lr=3e-4)
    out.update(wall_s=wall, peak_gib=peak,
               peak_gib_with_readings=torch.cuda.max_memory_allocated()
               / 2**30,
               reduced={"num_layers": [full.num_layers, cfg.num_layers]})
    log(f"{arch} ({cfg.num_layers} of {full.num_layers} layers): "
        f"{TRAIN_STEPS} steps in {wall:.2f} s, peak device memory "
        f"{peak:.2f} GiB")
    del res
    free_device()
    return out


def card_vs_cpu_step(arch: str, dev) -> dict:
    """At the smoke config (f32): the gradients and one train step on the
    card against the same on the CPU, from the same seeded parameters:
    loss, aux, grad norm within LM_CPU_RTOL, each gradient leaf within
    LM_CPU_RTOL of its largest |g|. An encoder-decoder takes its own
    step on seeded frames (aux 0)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = configs.get_config(arch, smoke=True)
    rng = np.random.default_rng(16)
    toks = rng.integers(0, cfg.vocab_size, (4, 33))
    opt, sched = AdamWConfig(lr=1e-3), {"warmup": 2, "total": 20}
    if cfg.is_encoder_decoder:
        audio = rng.standard_normal((4, 48, cfg.d_model)).astype(np.float32)
        step = lm.make_encdec_train_step(cfg, opt, schedule_kwargs=sched)
    else:
        step = lm.make_train_step(cfg, opt, schedule_kwargs=sched)
    ran = {}
    for where in ("cpu", "card"):
        model = lm.init_model(cfg, seed=0, device="cpu")
        d = dev if where == "card" else torch.device("cpu")
        model = model.to(d)
        t = torch.as_tensor(toks, device=d)
        if cfg.is_encoder_decoder:
            batch = {"audio_embeds": torch.as_tensor(audio, device=d),
                     "tokens": t}
            grads, _, _ = lm.encdec_grads_of(model, batch, cfg)
        else:
            batch = {"tokens": t}
            grads, _, _ = lm.grads_of(model, t, cfg)
        _, _, metrics = step(model, adamw_init(model), batch)
        ran[where] = ({n: g.cpu() for n, g in grads.items()},
                      {k: float(v) for k, v in metrics.items()})
    out = {"grad_max_rel": 0.0}
    for k in ran["cpu"][1]:
        if k == "lr_scale":
            continue
        got, want = ran["card"][1][k], ran["cpu"][1][k]
        if abs(got - want) > LM_CPU_RTOL * abs(want):
            raise AssertionError(f"{arch} smoke: card {k} {got}, CPU {want}")
        out[f"{k}_rel"] = abs(got - want) / max(abs(want), 1e-30)
    for n, want in ran["cpu"][0].items():
        scale = float(want.abs().max())
        err = float((ran["card"][0][n] - want).abs().max())
        if err > LM_CPU_RTOL * scale:
            raise AssertionError(f"{arch} smoke: grad {n} differs by {err} "
                                 f"(max |g| {scale})")
        out["grad_max_rel"] = max(out["grad_max_rel"], err / max(scale,
                                                                 1e-30))
    return out


def train_smoke_checks(arch: str, dev) -> dict:
    """At the smoke config (f32): one train step on the card against the
    same step on the CPU; a loop interrupted at step 4 and resumed to 8
    against an uninterrupted one, on the card; the loss below 0.8x its
    start in 60 steps."""
    import shutil
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import TrainLoopConfig, train_loop
    cfg = configs.get_config(arch, smoke=True)
    step = lm.make_train_step(cfg, AdamWConfig(lr=1e-3),
                              schedule_kwargs={"warmup": 2, "total": 20})
    out = card_vs_cpu_step(arch, dev)
    data = data_config(cfg, batch=4, seq=16, seed=1)
    ck = tempfile.mkdtemp(prefix="train_smoke_")
    try:
        def fresh():
            model = lm.init_model(cfg, seed=0, device=dev)
            return model, adamw_init(model)

        quiet = dict(log_fn=lambda *_: None)
        whole = train_loop(step, *fresh(), data,
                           TrainLoopConfig(total_steps=8, log_every=100),
                           **quiet)
        train_loop(step, *fresh(), data,
                   TrainLoopConfig(total_steps=4, checkpoint_dir=ck,
                                   checkpoint_every=4, log_every=100),
                   **quiet)
        resumed = train_loop(step, *fresh(), data,
                             TrainLoopConfig(total_steps=8,
                                             checkpoint_dir=ck,
                                             checkpoint_every=4,
                                             log_every=100), **quiet)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    if resumed["resumed_from"] != 4:
        raise AssertionError(f"{arch} smoke: resumed from "
                             f"{resumed['resumed_from']}")
    out["restart_max_abs"] = max(
        close_enough(b.detach(), a.detach(), rtol=TRAIN_RESTART_TOL,
                     atol=TRAIN_RESTART_TOL)
        for a, b in zip(whole["params"].parameters(),
                        resumed["params"].parameters()))
    model = lm.init_model(cfg, seed=0, device=dev)
    fall = train_loop(lm.make_train_step(cfg, AdamWConfig(lr=3e-3),
                                         remat="none",
                                         schedule_kwargs={"warmup": 5,
                                                          "total": 60}),
                      model, adamw_init(model),
                      data_config(cfg, batch=8, seq=32, seed=2),
                      TrainLoopConfig(total_steps=60, log_every=10),
                      log_fn=lambda *_: None)["metrics_history"]
    out["loss_60"] = [fall[0]["loss"], fall[-1]["loss"]]
    if not fall[-1]["loss"] < 0.8 * fall[0]["loss"]:
        raise AssertionError(f"{arch} smoke: loss {out['loss_60']} did not "
                             "fall below 0.8x its start in 60 steps")
    log(f"{arch} smoke (f32): card against CPU loss / aux / grad norm "
        f"rel {out['loss_rel']:.3g} / {out['aux_loss_rel']:.3g} / "
        f"{out['grad_norm_rel']:.3g}, gradients {out['grad_max_rel']:.3g} of "
        f"each leaf's max; restart at 4 of 8 = uninterrupted (max abs "
        f"{out['restart_max_abs']:.3g}); loss {out['loss_60'][0]:.4f} -> "
        f"{out['loss_60'][1]:.4f} in 60 steps")
    return out


def bf16_flag_readings(args, dev) -> dict:
    """Phase 2f's bf16 readings (each model's bf16-against-f32 gap of the
    full forward, the stepwise gap, replayed for a MoE) and a Qwen3 bf16
    train step's loss and grad norm with the bf16 reduced-precision-
    reduction flag on, then off; then decode ms of a 4-slot engine on,
    off, on, off; the flag is then set back to what it was."""
    import torch
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.optim.adamw import global_norm
    was = bf16_reduction_flag()
    out = {}
    try:
        for arch in LM_ARCHS:
            cfg = configs.get_config(arch, smoke=args.lm_smoke)
            params = lm.init_model(cfg, seed=0, device=dev)
            wparams = lm.cast_weights(params, cfg.compute_dtype)
            toks = torch.as_tensor(train_tokens(cfg, 0), device=dev)
            specs = [(p[:64], 16) for p, _ in
                     lm_requests(cfg.vocab_size, seed=17)[:LM_SLOTS]]
            out[arch] = {}
            for flag in (True, False):
                r = {"flag_read_back": bf16_reduction_flag(flag)}
                tf_ = lm_teacher_forced(cfg, params, dev, "bfloat16")
                r.update(bf16_vs_f32_rel=tf_["bf16_vs_f32_rel"],
                         stepwise_rel=tf_["rel"],
                         replayed_rel=tf_.get("replayed_rel"))
                if arch == "qwen3-1.7b":
                    grads, loss, _ = lm.grads_of(params, toks, cfg)
                    r["train_loss"] = float(loss)
                    r["train_grad_norm"] = float(global_norm(grads))
                    del grads
                out[arch][str(flag).lower()] = r
            for flag in (True, False, True, False):
                bf16_reduction_flag(flag)
                *_, dec_ms, _, _ = serve_logged(cfg, wparams, specs,
                                                keep_logits=False)
                out[arch][str(flag).lower()].setdefault(
                    "decode_ms_median", []).append(float(np.median(dec_ms)))
            for flag in ("true", "false"):
                log(f"{arch} bf16 with reduced-precision reductions "
                    f"{'on' if flag == 'true' else 'off'}: "
                    f"{json.dumps(out[arch][flag])}")
            del params, wparams
            free_device()
    finally:
        bf16_reduction_flag(was)
    return out


COHEN_K = 16
COHEN_CPU_ROWS = 1 << 15    # the CPU's share: 29 s for all 2^20 rows


def cohen_check(a, chll) -> dict:
    """Cohen's min-rank estimator (``cohen_build``, ``cohen_merge``,
    ``cohen_estimate``) on ``a @ a`` on the card, the first
    COHEN_CPU_ROWS rows held to the CPU (one thread) within 1e-6
    relative: the minima of B's rows and, for the A rows whose columns
    those B rows cover, the merged minima and the estimates."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mins = chll.cohen_build(a.indptr, a.indices, k=COHEN_K, num_rows=a.m,
                            n_cols=a.n)
    merged = chll.cohen_merge(a.indptr, a.indices, mins, num_rows_a=a.m)
    est = chll.cohen_estimate(merged, clip_max=a.n)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    r = COHEN_CPU_ROWS
    indptr = a.indptr[: r + 1].cpu()
    indices = a.indices[: int(indptr[-1])].cpu()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        want_mins = chll.cohen_build(indptr, indices, k=COHEN_K,
                                     num_rows=r, n_cols=a.n)
        # A rows whose every column is a B row computed here
        last_col = torch.zeros(r, dtype=torch.long)
        rows = chll.row_ids_from_indptr(indptr)
        last_col.scatter_reduce_(0, rows, indices.long(), "amax")
        keep = int((last_col < r).long().cumprod(0).sum())
        want_merged = chll.cohen_merge(indptr[: keep + 1], indices, want_mins,
                                       num_rows_a=keep)
        want_est = chll.cohen_estimate(want_merged, clip_max=a.n)
        cpu_s = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    errs = [close_enough(g.cpu(), w, rtol=1e-6, atol=0) for g, w in (
        (mins[:r], want_mins), (merged[:keep], want_merged),
        (est[:keep], want_est))]
    line = {"k": COHEN_K, "rows": a.m, "nnz": a.nnz, "cpu_rows": r,
            "cpu_merged_rows": keep, "max_abs": errs, "card_s": card_s,
            "cpu_s": cpu_s, "estimate_mean": float(est.mean())}
    log(f"Cohen estimator on banded A @ A (k {COHEN_K}, {a.m} rows, "
        f"{card_s:.3f} s on the card): the first {r} rows' minima and "
        f"{keep} rows' merged minima and estimates = CPU ({cpu_s:.2f} s, "
        f"one thread; max abs diff {errs}); mean estimate "
        f"{line['estimate_mean']:.2f}")
    del mins, merged, est
    return line


def train_phase(args, dev) -> dict:
    """Phase 2g: the LM training path. Returns the ``{"train": ...}``
    line."""
    import torch
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2**30
    log(f"device memory resident at the phase's start {resident:.2f} GiB; "
        f"bf16 reduced-precision reductions {bf16_reduction_flag()}")
    out = {"resident_gib": resident, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "remat": "dots",
           "bf16_reduced_precision_reduction": bf16_reduction_flag()}
    out["qwen3-1.7b"] = train_qwen3(args, dev)
    out["olmoe-1b-7b"] = train_cut(args, dev, "olmoe-1b-7b",
                                   TRAIN_OLMOE_LAYERS)
    out["smoke"] = {arch: train_smoke_checks(arch, dev) for arch in LM_ARCHS}
    out["bf16_flag"] = bf16_flag_readings(args, dev)
    free_device()
    left = torch.cuda.memory_allocated() / 2**30 - resident
    log(f"device memory left allocated by the phase {left:.3f} GiB, "
        f"reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    if left > 0.25:
        raise AssertionError(f"phase 2g left {left:.2f} GiB allocated")
    out["tolerances"] = {"card_vs_cpu_rel": LM_CPU_RTOL,
                         "restart_abs": TRAIN_RESTART_TOL}
    return out


# phase 2h: the three model families beyond GQA. Serving: Falcon-Mamba-7B
# and MiniCPM3-4B at full depth, Jamba-v0.1 at its first 5 of 32 layers
# (every layer kind it has: Mamba with a dense FF, Mamba with the 16-expert
# MoE, GQA with a dense FF at layer 4; the whole model's 51.3 B parameters
# do not fit); training: Falcon-Mamba at 8 of 64 layers and MiniCPM3 at 16
# of 62 (their train state beside the earlier phases' resident memory),
# Whisper-base whole
FAM_SERVE = (("falcon-mamba-7b", 0), ("minicpm3-4b", 0),
             ("jamba-v0.1-52b", 5))          # (arch, layers; 0 = all)
FAM_TRAIN = (("falcon-mamba-7b", 8), ("minicpm3-4b", 16))
FAM_REQUESTS, FAM_NEW = 6, 16
WHISPER_FRAMES, WHISPER_MAX_LEN = 1500, 448   # 30 s of audio; max target
WHISPER_PREFILL, WHISPER_STEPS = 64, 32


def fam_requests(vocab: int, seed: int):
    """FAM_REQUESTS requests of FAM_NEW new tokens: prompts of 64-512
    tokens, the fifth (a slot refill) LM_LONG_PROMPT long (six scan
    chunks; MLA's chunked attention)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 513, FAM_REQUESTS)
    lens[4] = LM_LONG_PROMPT
    return [(rng.integers(0, vocab, int(n)).astype(np.int32), FAM_NEW)
            for n in lens]


def cut_config(cfg, layers: int):
    return dataclasses.replace(cfg, num_layers=min(layers, cfg.num_layers)) \
        if layers else cfg


def serve_family(args, dev, arch: str, layers: int) -> dict:
    """One decoder family's serving checks at full width (``serve_and_check``
    on FAM_REQUESTS requests), the profile of its decode step and its peak
    memory."""
    import torch
    from repro_torch import configs
    from repro_torch.models import lm
    full = configs.get_config(arch, smoke=args.lm_smoke)
    cfg = cut_config(full, layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    pbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"{arch}{' (smoke)' if args.lm_smoke else ''}, {cfg.num_layers} of "
        f"{full.num_layers} layers: {cfg.param_count():,} params by the "
        f"config's count, {pbytes / 1e9:.2f} GB in f32, drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    m = serve_and_check(cfg, params, dev, arch, pbytes,
                        fam_requests(cfg.vocab_size, seed=18))
    m["reduced"] = {"num_layers": [full.num_layers, cfg.num_layers]}
    del params
    free_device()
    m["peak_gib"] = overall_peak(m)
    log(f"{arch}: peak device memory {m['peak_gib']:.2f} GiB; decode bound "
        f"{m['serve']['decode_bound_ms']:.3f} ms a step at the engine's "
        f"{m['serve']['weights_gb']:.2f} GB of weights")
    return m


def whisper_audio(cfg, dev, batch: int, seed: int):
    """Seeded frame embeddings (the stub frontend's input)."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn((batch, WHISPER_FRAMES, cfg.d_model), generator=gen,
                       device=dev)


def whisper_decode_bytes(cfg, wparams, batch: int, positions) -> float:
    """The bytes a decode step at ``positions`` (their mean) must move:
    the decoder's weights and the embedding table (it embeds and
    unembeds; the encoder's weights are not read), every layer's self
    K/V up to the step's position and cross K/V of WHISPER_FRAMES
    frames in the compute dtype, and the f32 logits."""
    import torch
    weights = sum(q.numel() * q.element_size()
                  for name, q in wparams.named_parameters()
                  if not name.startswith(("encoder.", "enc_final")))
    per_pos = (2 * batch * cfg.num_kv_heads * cfg.head_dim_
               * torch.finfo(cfg.compute_dtype).bits // 8
               * (cfg.decoder_layers or cfg.num_layers))
    self_len = float(np.mean([j + 1 for j in positions]))
    return (weights + per_pos * (self_len + WHISPER_FRAMES)
            + batch * cfg.vocab_size * 4)


def whisper_serve(args, dev) -> dict:
    """Whisper-base at full width and depth on 2 x 1,500 frames: in f32 a
    prefill of WHISPER_PREFILL tokens (``apply_encdec(mode="prefill")``)
    into a 448-token cache, then WHISPER_STEPS decode steps, each step's
    logits within LM_TF_RTOL of one full forward (``mode="train"``); then
    in bf16 on the engine's weights the encoder, prefill and decode ms and
    torch.profiler's idle share of one decode step."""
    import torch
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf
    cfg = configs.get_config("whisper-base", smoke=args.lm_smoke)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_model(cfg, seed=0, device=dev)
    audio = whisper_audio(cfg, dev, 2, seed=19)
    p, n = WHISPER_PREFILL, WHISPER_PREFILL + WHISPER_STEPS
    toks = torch.as_tensor(np.random.default_rng(20).integers(
        0, cfg.vocab_size, (2, n)), device=dev)

    def prefill_then_decode(c, model, times=None):
        caches = lm.init_caches(c, 2, WHISPER_MAX_LEN, dtype=c.compute_dtype,
                                device=dev, src_len=WHISPER_FRAMES)
        lo, caches, _ = tf.apply_encdec(model, audio, toks[:, :p], c,
                                        mode="prefill", caches=caches)
        steps = [lo[:, -1]]
        decode = lm.make_encdec_decode_step(c)
        for j in range(p, n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lo, caches = decode(model, caches, toks[:, j:j + 1],
                                torch.full((2,), j, device=dev))
            torch.cuda.synchronize()
            if times is not None:
                times.append((time.perf_counter() - t0) * 1e3)
            steps.append(lo)
        return torch.stack(steps, 1), caches

    c32 = dataclasses.replace(cfg, dtype="float32")
    with torch.no_grad():
        want = tf.apply_encdec(params, audio, toks, c32)[0][:, p - 1:]
        got, _ = prefill_then_decode(c32, params)
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / scale
    del got, want
    if rel > LM_TF_RTOL:
        raise AssertionError(f"whisper-base: f32 decode differs from the "
                             f"full forward by {rel} of max |logit|")
    wparams = lm.cast_weights(params, cfg.compute_dtype)
    with torch.no_grad():
        enc_ms = host_ms(lambda: tf.apply_encoder(wparams, audio, cfg,
                                                  remat="none"), 3)
        caches = lm.init_caches(cfg, 2, WHISPER_MAX_LEN,
                                dtype=cfg.compute_dtype, device=dev,
                                src_len=WHISPER_FRAMES)
        pre_ms = host_ms(lambda: tf.apply_encdec(
            wparams, audio, toks[:, :p], cfg, mode="prefill",
            caches=caches), 3)
        dec_ms = []
        _, caches = prefill_then_decode(cfg, wparams, dec_ms)
        decode = lm.make_encdec_decode_step(cfg)
        prof = profile_fn("whisper-base decode step, batch 2",
                          lambda: decode(wparams, caches, toks[:, -1:],
                                         torch.full((2,), n - 1,
                                                    device=dev)))
    dbytes = whisper_decode_bytes(cfg, wparams, 2, range(p, n))
    del params, wparams, caches, audio
    free_device()
    out = {"frames": WHISPER_FRAMES, "prefill_tokens": p,
           "decode_steps": WHISPER_STEPS, "max_len": WHISPER_MAX_LEN,
           "teacher_forced_f32_rel": rel, "max_logit": scale,
           "encoder_ms": enc_ms, "prefill_ms": pre_ms,
           "decode_ms": dec_ms, "decode_ms_median": float(np.median(dec_ms)),
           "decode_bytes": dbytes,
           "decode_bound_ms": dbytes / HBM_BYTES_PER_S * 1e3,
           "profile": prof,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"whisper-base serve: {WHISPER_STEPS} decode steps after a "
        f"{p}-token prefill against one full forward (f32): "
        f"{rel:.3g} of max |logit| {scale:.3g}; bf16 encoder ms "
        f"{[round(t, 2) for t in enc_ms]}, prefill (encoder included) ms "
        f"{[round(t, 2) for t in pre_ms]}, decode median "
        f"{out['decode_ms_median']:.2f} ms (bound "
        f"{out['decode_bound_ms']:.4f}); peak {out['peak_gib']:.2f} GiB")
    return out


def whisper_train(args, dev) -> dict:
    """Whisper-base at full width and depth through
    ``make_encdec_train_step``: TRAIN_STEPS steps of 2 x (1,500 frames,
    448 tokens of the synthetic stream), AdamW lr 3e-4 with the train
    CLI's schedule; every loss finite and the last below the first."""
    import torch
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = configs.get_config("whisper-base", smoke=args.lm_smoke)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_model(cfg, seed=0, device=dev)
    state = adamw_init(params)
    step = lm.make_encdec_train_step(
        cfg, AdamWConfig(lr=3e-4),
        schedule_kwargs=train.schedule_for(TRAIN_STEPS))
    data = SyntheticLM(data_config(cfg, seq=WHISPER_MAX_LEN))

    def batch(i):
        return {"audio_embeds": whisper_audio(cfg, dev, TRAIN_BATCH, 30 + i),
                "tokens": torch.as_tensor(data.batch(i), device=dev)}

    hist, times = [], []
    for i in range(TRAIN_STEPS):
        b = batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, metrics = step(params, state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        hist.append({k: float(v) for k, v in metrics.items()})
    peak = torch.cuda.max_memory_allocated() / 2**30
    b = batch(TRAIN_STEPS)
    out = step_readings(
        "whisper-base", hist, times,
        sum(p.numel() for p in params.parameters()),
        encdec_train_flops(cfg, TRAIN_BATCH, WHISPER_FRAMES, WHISPER_MAX_LEN),
        TRAIN_BATCH * WHISPER_MAX_LEN, lambda: step(params, state, b))
    del params, state, b
    free_device()
    out.update(frames_per_s=TRAIN_BATCH * WHISPER_FRAMES
               / out["step_ms_median"] * 1e3, peak_gib=peak)
    log(f"whisper-base train: {out['frames_per_s']:.0f} frames/s; peak "
        f"{peak:.2f} GiB")
    return out


def families_phase(args, dev) -> dict:
    """Phase 2h: Mamba, MLA and the encoder-decoder through serving and
    training at full width (smoke configs with ``--lm-smoke``), and every
    family's smoke config on the card against the CPU. Returns the
    ``{"families": ...}`` line."""
    import torch
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2**30
    log(f"device memory resident at the phase's start {resident:.2f} GiB")
    out = {"resident_gib": resident, "serve": {}, "train": {},
           "card_vs_cpu": {}}
    for arch, layers in FAM_SERVE:
        out["serve"][arch] = serve_family(args, dev, arch, layers)
    out["serve"]["whisper-base"] = whisper_serve(args, dev)
    for arch, layers in FAM_TRAIN:
        out["train"][arch] = train_cut(args, dev, arch, layers)
    out["train"]["whisper-base"] = whisper_train(args, dev)
    for arch in [a for a, _ in FAM_SERVE] + ["whisper-base"]:
        r = out["card_vs_cpu"][arch] = {
            "serve": lm_card_vs_cpu(arch, dev),
            "train_step": card_vs_cpu_step(arch, dev)}
        log(f"{arch} smoke, card against CPU (f32): prefill + 8 decode "
            f"steps max abs diff {r['serve']['max_abs']:.3g} (max |logit| "
            f"{r['serve']['max_logit']:.3g}); train step "
            f"{json.dumps(r['train_step'])}")
    card = torch.cuda.mem_get_info(dev)[1] / 2**30
    top = max(m["peak_gib"] for part in ("serve", "train")
              for m in out[part].values())
    out.update(card_gib=card, headroom_gib=card - top)
    log(f"the phase's highest peak {top:.2f} GiB of the card's {card:.2f} "
        f"GiB: {card - top:.2f} GiB of headroom")
    free_device()
    left = torch.cuda.memory_allocated() / 2**30 - resident
    log(f"device memory left allocated by the phase {left:.3f} GiB, "
        f"reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    if left > 0.25:
        raise AssertionError(f"phase 2h left {left:.2f} GiB allocated")
    out["tolerances"] = {"batched_vs_alone_rel": LM_BATCH_RTOL,
                         "teacher_forced_f32_rel": LM_TF_RTOL,
                         "teacher_forced_bf16_replayed_over_bf16_vs_f32":
                         LM_TF_BF16_FACTOR,
                         "card_vs_cpu_rel": LM_CPU_RTOL}
    return out

# phase 2i: launch/ (meshes, the sharding policy, the dry-run) on the card.
# (a) the meshes as device sets; (b) the dry-run CLI in subprocesses, full
# width on meta (it never touches the card); (c) the dry-run's cells for
# two steps this smoke runs (Qwen3-1.7B's decode at phase 2f's engine
# shape, phase 2g's train step) on a 1 x 1 local mesh, against the same
# steps measured here
DRYRUN_RUNS = (("qwen3-1.7b", "all", 6), ("jamba-v0.1-52b", "train_4k", 2))
DRYRUN_TIMEOUT = 300        # seconds a dry-run subprocess may take
DRYRUN_STEPS = 10           # timed decode steps (train: TRAIN_STEPS // 2)


def start_dryruns(outdir: str) -> list:
    """The dry-run CLI for each of DRYRUN_RUNS, on both production meshes,
    each in a process group of its own (its cell workers with it)."""
    procs = []
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    for arch, shape, jobs in DRYRUN_RUNS:
        out = os.path.join(outdir, f"dryrun_{arch}_{shape}.json")
        if os.path.exists(out):
            os.remove(out)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", "both", "--jobs", str(jobs),
               "--out", out]
        procs.append((out, cmd, time.perf_counter(), subprocess.Popen(
            cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)))
    return procs


def stop_dryruns(procs) -> None:
    """Kill the process group of every dry-run still running."""
    import signal
    for *_, p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()


def finish_dryruns(procs) -> dict:
    """Wait for the dry-runs (killing a process group that overruns), hold
    every record to ``ok`` or to ``skipped`` with its config's reason, and
    render them with the report CLI."""
    from repro_torch import configs
    out = {}
    for path, cmd, t0, p in procs:
        try:
            text, _ = p.communicate(
                timeout=max(1.0, t0 + DRYRUN_TIMEOUT - time.perf_counter()))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"{' '.join(cmd[2:])}: over "
                                 f"{DRYRUN_TIMEOUT} s") from None
        wall = time.perf_counter() - t0
        if p.returncode:
            raise AssertionError(f"{' '.join(cmd[2:])} exited "
                                 f"{p.returncode}:\n{text[-3000:]}")
        with open(path) as f:
            recs = json.load(f)
        for r in recs:
            label = f"{r['arch']} x {r['shape']} x {r['mesh']}"
            if r["status"] == "skipped":
                want = configs.shape_skips(r["arch"]).get(r["shape"])
                if r["reason"] != want:
                    raise AssertionError(f"{label}: skipped for "
                                         f"{r['reason']!r}, want {want!r}")
            elif r["status"] != "ok":
                raise AssertionError(f"{label}: {r['status']} "
                                     f"{r.get('error')}\n"
                                     f"{r.get('traceback', '')}")
        out[os.path.basename(path)] = {
            "wall_s": wall, "records": len(recs),
            "ok": sum(r["status"] == "ok" for r in recs),
            "skipped": sum(r["status"] == "skipped" for r in recs),
            "cells": {f"{r['shape']} {r['mesh']}": {
                "per_device_gb": r["per_device_bytes"] / 1e9,
                "fits_80g": r["fits_80g"], "wall_s": r["wall_s"],
                "bound_s": max(r["roofline"][k] for k in
                               ("compute_s", "memory_s", "collective_s")),
                "bottleneck": r["roofline"]["bottleneck"]}
                for r in recs if r["status"] == "ok"}}
        log(f"{' '.join(cmd[2:])}: {len(recs)} records, "
            f"{out[os.path.basename(path)]['ok']} ok, "
            f"{out[os.path.basename(path)]['skipped']} skipped, in "
            f"{wall:.1f} s")
    rendered = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report"]
        + [path for path, *_ in procs], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    for line in rendered.stdout.splitlines():
        log("  " + line)
    return out


def local_meshes(dev):
    """(a), first half: ``make_local_mesh()`` is a world-size-1
    ``DeviceMesh`` and ``make_shard_mesh()`` resolves to the card.
    Returns the line's fields, the local mesh and the shard mesh."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core import dispatch
    from repro_torch.launch import mesh as lmesh
    local = lmesh.make_local_mesh(device_type=dev.type)
    if not isinstance(local, DeviceMesh) or tuple(local.mesh.shape) != (1, 1) \
            or torch.distributed.get_world_size() != 1:
        raise AssertionError(f"make_local_mesh: {local}")
    backend = torch.distributed.get_backend()
    shard = lmesh.make_shard_mesh(device_type=dev.type)
    devs = dispatch.resolve_devices(shard)
    want = (torch.device("cuda", 0),) if dev.type == "cuda" else (dev,)
    if devs != want or dispatch.resolve_devices(local) != want:
        raise AssertionError(f"make_shard_mesh() resolves to {devs}, the "
                             f"local mesh to "
                             f"{dispatch.resolve_devices(local)}")
    log(f"make_local_mesh(): {local} (backend {backend}); "
        f"make_shard_mesh(): {shard.shape} -> {devs}")
    return {"local_mesh": str(local), "backend": backend,
            "shard_mesh": [str(d) for d in devs], "calls": {}}, local, shard


def mesh_calls(out, shard, kd, kh, kl, mats, results, served) -> dict:
    """(a), second half: ``ocean_spgemm`` on phase 2's banded and
    power-law matrices and one ``SpGEMMService`` request through
    ``devices=`` the shard mesh, each C bit-identical to its unsharded C
    (phase 2's cold call, phase 2d's serial uncached call), with the
    kernels' counts set to 0 just before and read just after. Returns the
    path's launches."""
    import torch
    from repro_torch import serving
    from repro_torch.core import planner, workflow
    devs = out["shard_mesh"]
    reset_counts()
    for name, a in mats[:2]:
        t0 = time.perf_counter()
        c, rep = workflow.ocean_spgemm(a, a, cache=planner.PlanCache(),
                                       devices=shard)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rep.n_shards != len(devs) or not same_csr_on_card(
                c, results[name][0][0]):
            raise AssertionError(f"{name} on the shard mesh: n_shards "
                                 f"{rep.n_shards}, C differs from phase 2's")
        log(f"{name} on make_shard_mesh(): C bit-identical to phase 2's "
            f"({rep.workflow}, {rep.n_shards} shard, {wall:.2f} s)")
        out["calls"][name] = {"wall_s": wall, "n_shards": rep.n_shards}
        del c
    sname, (sa, _) = next(iter(served["mats"].items()))
    svc = serving.SpGEMMService(devices=shard)
    c, rep = svc.multiply(sa, served["b"])
    if not same_csr_on_card(c, served["refs"][sname]):
        raise AssertionError(f"SpGEMMService(devices=mesh) {sname}: C "
                             "differs from the serial uncached call")
    log(f"SpGEMMService(devices=make_shard_mesh()) {sname} @ B: C "
        "bit-identical to phase 2d's serial uncached call")
    del c, svc
    launched = read_counts()
    if not launched["dense_window"]:
        raise AssertionError(f"mesh path: launches {launched}")
    log(f"mesh path launches {json.dumps(launched)}")
    return launched


def local_cell(label, cfg, shape, policy, measure, smi) -> dict:
    """The dry-run's cell for ``shape`` on the local mesh, and ``measure()``
    (median ms, peak GiB over the resident) of the same step on the card:
    fails when the step is predicted not to fit or its bound is above the
    measured time."""
    from repro_torch.launch import dryrun
    rec = dryrun.evaluate({"arch": cfg.name, "shape": shape.name,
                           "mesh": "1x1", "chips": 1}, cfg, shape, policy,
                          remat="dots", microbatch=0)
    if rec["status"] != "ok":
        raise AssertionError(f"{label}: {rec['error']}\n{rec['traceback']}")
    rf = rec["roofline"]
    bound_ms = max(rf[k] for k in ("compute_s", "memory_s",
                                   "collective_s")) * 1e3
    ms, peak = measure()
    mem = rec["artifacts"]["full"]["mem"]
    log(f"{label}: predicted {rec['per_device_bytes'] / 1e9:.2f} GB a "
        f"device (argument {mem['argument_bytes'] / 1e9:.2f}, output "
        f"{mem['output_bytes'] / 1e9:.2f}, temp "
        f"{mem['temp_bytes'] / 1e9:.2f}), fits 80 GB {rec['fits_80g']}; "
        f"bound {bound_ms:.3f} ms ({rf['bottleneck']}: compute "
        f"{rf['compute_s'] * 1e3:.3f}, memory {rf['memory_s'] * 1e3:.3f}, "
        f"collective {rf['collective_s'] * 1e3:.3f}); measured median "
        f"{ms:.2f} ms, peak {peak:.2f} GiB over the resident; {smi}")
    if not rec["fits_80g"]:
        raise AssertionError(f"{label} ran on the card but is predicted not "
                             "to fit")
    if bound_ms > ms:
        raise AssertionError(f"{label}: bound {bound_ms:.3f} ms above the "
                             f"measured {ms:.3f} ms")
    return {"predicted_bytes": rec["per_device_bytes"], "mem": mem,
            "fits_80g": rec["fits_80g"], "bound_ms": bound_ms,
            "bottleneck": rf["bottleneck"],
            "terms_ms": {k: rf[k] * 1e3 for k in ("compute_s", "memory_s",
                                                   "collective_s")},
            "measured_ms_median": ms, "measured_peak_gib_over_resident": peak,
            "trace_s": rec["wall_s"]}


def measured(fn, runs: int):
    """``fn`` once to warm, then ``runs`` times: the median ms (host clock
    between synchronisations) and the peak GiB over what was allocated
    before."""
    import torch
    fn()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = float(np.median(host_ms(fn, runs)))
    return ms, (torch.cuda.max_memory_allocated() - resident) / 2**30


def dryrun_phase(args, dev, kd, kh, kl, mats, results, served, path_counts,
                 smi) -> dict:
    """Phase 2i. Returns the fields of the ``{"dryrun": ...}`` line."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import sharding
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    out = {"card": smi}
    free_device()
    resident = torch.cuda.memory_allocated() / 2**30
    outdir = os.path.join(REPO, "chiprun_out")
    os.makedirs(outdir, exist_ok=True)

    out["mesh"], local, shard = local_meshes(dev)
    # (c) before the dry-run subprocesses start, so that their tracing does
    # not share the host with the timed steps
    cfg = configs.get_config("qwen3-1.7b", smoke=args.lm_smoke)
    params = lm.cast_weights(lm.init_model(cfg, seed=0, device=dev),
                             cfg.compute_dtype)
    caches = lm.init_caches(cfg, LM_SLOTS, LM_MAX_LEN,
                            dtype=cfg.compute_dtype, device=dev)
    token = torch.randint(0, cfg.vocab_size, (LM_SLOTS, 1), device=dev)
    lens = torch.full((LM_SLOTS,), LM_MAX_LEN // 2, dtype=torch.int32,
                      device=dev)
    decode = lm.make_decode_step(cfg)
    tp = sharding.ShardingPolicy(local, "tp")
    out["decode"] = local_cell(
        f"2i {cfg.name} decode, {LM_SLOTS} slots x {LM_MAX_LEN}", cfg,
        ShapeSpec("engine_decode", "decode", LM_MAX_LEN, LM_SLOTS), tp,
        lambda: measured(lambda: decode(params, caches, token, lens),
                         DRYRUN_STEPS), smi)
    del params, caches
    free_device()
    params = lm.init_model(cfg, seed=0, device=dev)
    state = adamw_init(params)
    step = lm.make_train_step(cfg, AdamWConfig(), remat="dots")
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (TRAIN_BATCH, TRAIN_SEQ + 1),
                                     device=dev)}
    fsdp = sharding.ShardingPolicy(local, "fsdp")
    out["train"] = local_cell(
        f"2i {cfg.name} train step, {TRAIN_BATCH} x {TRAIN_SEQ}, remat dots",
        cfg, ShapeSpec("train_step", "train", TRAIN_SEQ, TRAIN_BATCH), fsdp,
        lambda: measured(lambda: step(params, state, batch),
                         TRAIN_STEPS // 2), smi)
    del params, state, batch
    free_device()

    # (b) the dry-run CLI in subprocesses, the rest of (a) meanwhile
    procs = start_dryruns(outdir)
    try:
        path_counts["mesh"] = out["mesh"]["launches"] = mesh_calls(
            out["mesh"], shard, kd, kh, kl, mats, results, served)
        out["cli"] = finish_dryruns(procs)
    finally:
        stop_dryruns(procs)
    torch.distributed.destroy_process_group()
    left = torch.cuda.memory_allocated() / 2**30 - resident
    if left > 0.25:
        raise AssertionError(f"phase 2i left {left:.2f} GiB allocated")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2-rows", type=int, default=20,
                    help="rows (= columns) of the two main-path matrices")
    ap.add_argument("--graph-scale", type=int, default=16,
                    help="R-MAT scale of the triangle graph; k-hop runs at "
                    "this + 2, MCL at this - 4")
    ap.add_argument("--serve-log2-rows", type=int, default=20,
                    help="rows (= columns) of the serving phase's matrices")
    ap.add_argument("--shards", type=int, default=4,
                    help="logical shards of card 0 in phase 2e")
    ap.add_argument("--lm-smoke", action="store_true",
                    help="run phases 2f, 2g and 2h at the smoke configs of "
                    "their models instead of their full width")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    import scipy.sparse as sp
    from repro_torch import graph
    from repro_torch.core import analysis, formats, planner, workflow
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
        reset_counts()
        for call in ("cold", "warm"):
            before = read_counts()
            tracer = trace.Tracer()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with trace.tracing(tracer):
                c, rep = workflow.ocean_spgemm(a, a, cache=cache)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {k: v - before[k]
                        for k, v in read_counts().items()}
            spans = {}
            for ev in tracer.events():
                spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"]
            call_counts[name, call] = launched
            log_call(f"{name} {call}", rep, wall, launched,
                     torch.cuda.max_memory_allocated() / 2**30)
            log(f"  spans {json.dumps({k: round(v, 4) for k, v in spans.items()})}")
            outs.append((c, rep, wall))
        path_counts[name] = read_counts()
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
    need = {"banded": ["hll_sketch", "hll_merge", "dense_window",
                       "slab_scatter"],
            "powerlaw": ["hash", "slab_scatter"]}
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
        # the scatter: one launch a source of C's rows, every call
        got = {call: call_counts[name, call]["slab_scatter"]
               for call in ("cold", "warm")}
        want = {call: scatters_wanted([plan], rep) for call, (_, rep, _)
                in zip(("cold", "warm"), results[name])}
        if got != want:
            raise AssertionError(f"{name}: slab_scatter launches {got}, "
                                 f"want {want} (one a source of C's rows)")
        log(f"{name}: slab_scatter launches per call {json.dumps(got)}, one"
            " a source of C's rows")
    # the count kernel: one launch per cold symbolic prediction, none warm
    for name, want in (("banded", {"cold": 0, "warm": 0}),
                       ("powerlaw", {"cold": 1, "warm": 0})):
        got = {call: call_counts[name, call]["count"] for call in want}
        if got != want:
            raise AssertionError(f"{name}: count launches {got}, want {want}"
                                 " (one per cold symbolic prediction)")
        log(f"{name}: count kernel launches per call {json.dumps(got)}")
    # the plan key's fingerprint: one launch a keyed call, cold or warm
    for name in results:
        got = {call: call_counts[name, call]["pattern_fingerprint"]
               for call in ("cold", "warm")}
        if got != {"cold": 1, "warm": 1}:
            raise AssertionError(f"{name}: pattern_fingerprint launches "
                                 f"{got}, want 1 a keyed call")
    log("pattern_fingerprint: one launch a keyed call, cold and warm, on "
        + ", ".join(results))
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
    reset_counts()
    tris = []
    tri_count_launches = {}
    for call in ("cold", "warm"):
        before = read_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tri, rep = graph.triangle_count(adj_t, cache=tri_cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: v - before[k]
                    for k, v in read_counts().items()}
        tri_count_launches[call] = launched["count"]
        if launched["hll_merge"] != merges_wanted(rep):
            raise AssertionError(f"triangles {call}: hll_merge launches "
                                 f"{launched['hll_merge']}, want "
                                 f"{merges_wanted(rep)}")
        t_plan = tri_cache.peek(planner.structure_key(
            low, low, OceanConfig(), None, True, True))
        if t_plan is None:
            raise AssertionError(f"triangles {call}: no plan cached")
        if launched["slab_scatter"] != scatters_wanted([t_plan], rep):
            raise AssertionError(
                f"triangles {call}: slab_scatter launches "
                f"{launched['slab_scatter']}, want "
                f"{scatters_wanted([t_plan], rep)} (one a source of C's "
                "rows)")
        log_call(f"triangles {call} (L nnz {low.nnz})", rep, wall, launched,
                 torch.cuda.max_memory_allocated() / 2**30)
        log(f"  triangles {tri}")
        tris.append(tri)
    path_counts["triangles"] = read_counts()
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
            before = read_counts()
            out, rep = super().step(c, **kw)
            launched = {k: v - before[k]
                        for k, v in read_counts().items()}
            self.steps.append((c, out, rep, launched))
            return out, rep

    # k-hop: boolean chain F_{k+1} = sign(F_k @ A)
    adj_k = gen_rmat(gs + 2)
    t0 = time.perf_counter()
    formats.structure_hash(adj_k)
    log(f"k-hop: structure_hash of the RHS (the chain's sketch-cache key, "
        f"host copy of the pattern) {time.perf_counter() - t0:.3f} s")
    seeds = [0, 1, 2]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = runner_k = RecordingRunner(adj_k)
    fronts, kres = graph.k_hop_frontier(adj_k, seeds, 3, runner=runner)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path_counts["k-hop"] = read_counts()
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
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mcl = graph.markov_cluster(adj_m, iterations=4, runner=runner)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path_counts["MCL"] = read_counts()
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
    done()

    # ---------------- 2e. sharded path ----------------
    done = phase(f"2e. sharded path on {args.shards} logical shards of "
                 "card 0")
    sharded_line, splans = sharded_phase(
        args, torch.device("cuda", 0), kd, kh, kl, mats, results, call_counts,
        (adj_t, tris, adj_m, mcl), served, path_counts)
    done()

    # ---------------- 2f. LM serving ----------------
    done = phase("2f. LM serving at "
                 + ("the smoke configs" if args.lm_smoke else "full width")
                 + " of " + " and ".join(LM_ARCHS))
    lm_line, lm_demo = lm_phase(args, torch.device("cuda", 0), kd, kh, kl,
                                path_counts)
    done()

    # ---------------- 2g. LM training ----------------
    done = phase("2g. LM training at "
                 + ("the smoke configs" if args.lm_smoke else "full width")
                 + " of " + " and ".join(LM_ARCHS))
    train_line = train_phase(args, torch.device("cuda", 0))
    done()

    # ---------------- 2h. Mamba, MLA, encoder-decoder ----------------
    done = phase("2h. Mamba, MLA and the encoder-decoder at "
                 + ("the smoke configs" if args.lm_smoke else "full width")
                 + " of " + ", ".join(a for a, _ in FAM_SERVE)
                 + " and whisper-base")
    families_line = families_phase(args, torch.device("cuda", 0))
    done()

    # ---------------- 2i. launch/: meshes and the dry-run ----------------
    done = phase("2i. meshes, the dry-run CLI, and the dry-run's cells "
                 "against the card")
    dryrun_line = dryrun_phase(args, torch.device("cuda", 0), kd, kh, kl,
                               mats, results, served, path_counts, smi)
    counts = {k: sum(pc[k] for pc in path_counts.values())
              for k in read_counts()}
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
    also_dense = {"dense_window": [], "dense_longrow": []}
    also_hash = []
    for sname, (sa, splan) in served["mats"].items():
        for key, longrow in (("dense_window", False),
                             ("dense_longrow", True)):
            rung = [be for be in splan.dense if be.is_longrow == longrow]
            if rung:
                also_dense[key].append(dense_case(
                    f"{key} serving {sname}", sa,
                    max(rung, key=lambda be: len(be.rows)), served["b"]))
    # one shard slice of each dense rung phase 2e launched: the largest
    # slice of banded's window bins and of the long-row bins
    for key, (sname, sa) in (("dense_window", mats[0]),
                             ("dense_longrow", mats[-1])):
        for sh in splans[sname].shards:
            rung = [be for be in sh.dense
                    if be.is_longrow == (key == "dense_longrow")]
            if rung:
                also_dense[key].append(dense_case(
                    f"{key} shard {sh.index} of {sname}", sa,
                    max(rung, key=lambda be: len(be.rows))))
                break
    # phase 2f's co-routing C = D^T @ D: the largest bin of each dense rung
    # its plan holds, and its hash bins (below)
    lm_dt, lm_d, lm_plan = lm_demo
    for key, longrow in (("dense_window", False), ("dense_longrow", True)):
        rung = [be for be in lm_plan.dense if be.is_longrow == longrow]
        if rung:
            also_dense[key].append(dense_case(
                f"{key} LM co-routing D^T @ D", lm_dt,
                max(rung, key=lambda be: len(be.rows)), lm_d))

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
            "also": also_dense[key]})
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
            also_hash.append(hash_case(
                f"hash serving {sname} t{hb_s.table}", sa, hb_s,
                served["b"]))
    # phase 2e: power-law's largest hash bin, one shard's slice of it
    hb_big = max(splans["powerlaw"].plan.hash, key=lambda h: len(h.rows))
    hb_slice = next(s for sh in splans["powerlaw"].shards for s in sh.hash
                    if s.bin_id == hb_big.bin_id)
    also_hash.append(hash_case(
        f"hash shard slice of powerlaw t{hb_big.table} ({len(hb_slice.rows)}"
        f" of {len(hb_big.rows)} rows)", a_pl, hb_slice))
    for hb in lm_plan.hash:
        also_hash.append(hash_case(f"hash LM co-routing t{hb.table}", lm_dt,
                                   hb, lm_d))
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
        "bins": hash_bins, "also": also_hash})
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

    def merge_case(label, a, sketches=None):
        """hll_merge of A's rows over ``sketches`` (banded's plan's when
        None)."""
        skt = sk if sketches is None else sketches
        ind = a.indices[: a.nnz]
        merged, est = kl.hll_merge(a.indptr, ind, skt)
        pmerged, pest = kl.hll_merge_plain(a.indptr, ind, skt)
        torch.cuda.synchronize()
        if merged.dtype != torch.uint8 or not torch.equal(merged, pmerged):
            raise AssertionError(f"hll_merge {label}: registers differ from "
                                 "plain")
        err = close_enough(est, pest, rtol=1e-5, atol=0.0)
        del merged, est, pmerged, pest
        ms = time_cuda(lambda: kl.hll_merge(a.indptr, ind, skt), KERNEL_RUNS)
        dev_ms, events = device_ms(lambda: kl.hll_merge(a.indptr, ind, skt),
                                   KERNEL_RUNS, "hll_merge_kernel")
        plain_ms = time_cuda(lambda: kl.hll_merge_plain(a.indptr, ind, skt),
                             3)
        ra, nb1, m = a.m, skt.shape[0], skt.shape[1]
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
    # phase 2e's first A block (= B block) of banded
    r0, r1 = sharded_line["band_block"]
    band_block = planner.gather_rows(a_band, np.arange(r0, r1))
    mg_block = merge_case(f"banded A block [{r0}, {r1})", band_block)
    mg_lm = merge_case("LM co-routing D^T over D's sketches", lm_dt,
                       lm_plan.b_sketches)
    kernels.append({
        "name": "hll_merge", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hll_merge.cu",
        "replaces": "src/repro/kernels/hll.py:108",
        "launches": counts["hll_merge"],
        "launches_by_path": by_path["hll_merge"], **mg_band,
        "library_ms": None, "also": [mg_sample, mg_block, mg_lm]})

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
    sk_more.append(sketch_case(f"banded B block [{r0}, {r1})", band_block,
                               plan_b.m_regs))
    sk_more.append(sketch_case("LM co-routing D", lm_d, lm_plan.m_regs))
    del lm_dt, lm_d, lm_plan, lm_demo
    del band_block
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

    def scatter_case(cfg_name):
        """The scatter kernel on every source of one compaction: the
        benchmark configuration's A = A through ``ocean_spgemm``, with the
        sources the merge hands to ``_compact_slabs`` captured (the bins'
        slabs, the ESC bin's and the overflow fallback's CSRs), each
        scattered again into fresh arrays by the kernel and by the plain
        version, both equal to the multiply's C bit for bit; both timed
        over the whole set, beside one device-to-device copy of C's
        arrays, and the bound of the bytes the copy moves."""
        from perfbench import manifest
        from repro_torch.core import executor
        from repro_torch.kernels import slab_scatter as ks
        with open(os.path.join(REPO, "perfbench", "configs",
                               f"{cfg_name}.json")) as f:
            cfg = json.load(f)
        ops_ = manifest.module("gen", cfg["generator"]).make(
            cfg, SCATTER_SEED, 1, torch.device(dev))
        ptr, idx = ops_.a.indptr.int(), ops_.a.indices.int()
        a = formats.CSR(ptr, idx, ops_.a.values[0], tuple(ops_.a.shape),
                        int(idx.shape[0]))
        del ops_
        seen = {}
        real = executor._compact_slabs

        def spy(state, shape, dtype, device):
            seen["sources"] = state.finalize()
            return real(state, shape, dtype, device)

        executor._compact_slabs = spy
        try:
            c, rep = workflow.ocean_spgemm(a, a, cache=False)
        finally:
            executor._compact_slabs = real
        del a, ptr, idx
        sources = [s for s in seen.pop("sources") if s.rows.shape[0]]

        def scatter(fn, cols, vals):
            for s in sources:
                fn(c.indptr, cols, vals, s.rows, s.cols, s.vals, nnz=s.nnz,
                   indptr=s.indptr)

        def bits(v):
            return v.view(torch.int32)

        got = (torch.full_like(c.indices, -1),
               torch.full_like(c.values, float("nan")))
        want = (torch.full_like(c.indices, -1),
                torch.full_like(c.values, float("nan")))
        scatter(ks.slab_scatter_cuda, *got)
        scatter(ks.slab_scatter_plain, *want)
        if not (torch.equal(got[0], want[0])
                and torch.equal(bits(got[1]), bits(want[1]))):
            raise AssertionError(f"slab_scatter {cfg_name}: the kernel "
                                 "differs from the plain version")
        if not (torch.equal(want[0], c.indices)
                and torch.equal(bits(want[1]), bits(c.values))):
            raise AssertionError(f"slab_scatter {cfg_name}: the plain "
                                 "version differs from the multiply's C")
        del want
        ms = time_cuda(lambda: scatter(ks.slab_scatter_cuda, *got),
                       KERNEL_RUNS)
        plain_ms = time_cuda(lambda: scatter(ks.slab_scatter_plain, *got),
                             3)
        lib_ms = time_cuda(lambda: (got[0].copy_(c.indices),
                                    got[1].copy_(c.values)), KERNEL_RUNS)
        rows = sum(int(s.rows.shape[0]) for s in sources)
        kinds = {"slab": sum(s.nnz is not None for s in sources),
                 "csr": sum(s.indptr is not None for s in sources)}
        # each entry read and written, 4 + 4 bytes each way; a row's dest,
        # count or offsets and C's offset, 16 bytes
        by = 16.0 * c.nnz + 16.0 * rows
        b_ms, b_by = bound(by, 0.0, F32_OPS_PER_S)
        log(f"slab_scatter {cfg_name}: {len(sources)} sources "
            f"{json.dumps(kinds)} rows {rows} entries {c.nnz} (overflow "
            f"rows {rep.overflow_rows}); kernel = plain = C bit for bit; "
            f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms device copy of C "
            f"{lib_ms:.3f} ms bound {b_ms:.3f} ms ({b_by}, "
            f"{by / 1e9:.4f} GB)")
        out = {"bin": cfg_name, "max_abs_err": 0.0, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms,
               "library": "one device-to-device copy of C's cols and vals",
               "shape": {"sources": len(sources), "kinds": kinds,
                         "rows": rows, "entries": c.nnz,
                         "overflow_rows": rep.overflow_rows}}
        del sources, got, c, rep
        torch.cuda.empty_cache()
        return out

    sc_fem = scatter_case("fem-q1-elasticity")
    sc_rmat = scatter_case("graph500-rmat-s15")
    kernels.append({
        "name": "slab_scatter", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/slab_scatter.cu",
        "replaces": "none (the reference scatters on the host: "
                    "src/repro/core/executor.py:287)",
        "launches": counts["slab_scatter"],
        "launches_by_path": by_path["slab_scatter"],
        **{k: v for k, v in sc_fem.items() if k != "bin"},
        "matrix": sc_fem["bin"], "also": [sc_rmat]})
    fp = fingerprint_rows(dev)
    kernels.append({
        "name": "pattern_fingerprint", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pattern_fingerprint.cu",
        "replaces": "none (the reference hashes both patterns on the host "
                    "with blake2b: src/repro/core/planner.py:304)",
        "launches": counts["pattern_fingerprint"],
        "launches_by_path": by_path["pattern_fingerprint"],
        **{k: v for k, v in fp[0].items() if k != "bin"},
        "matrix": fp[0]["bin"], "also": fp[1:]})
    done()

    # ---------------- 4. small suite on the card ----------------
    done = phase("4. make_suite(1) through ocean_spgemm on the card")
    for name, a in formats.make_suite(1, device=dev):
        c, rep = workflow.ocean_spgemm(a, a, cache=False)
        err = check_against_scipy(c, to_scipy(a), f"suite {name}")
        log(f"suite {name}: {rep.workflow} bins {json.dumps(rep.bins)} "
            f"max abs diff {err:.3g}")
    cohen_line = cohen_check(a_band, chll)
    done()

    # ---------------- 5. device busy share ----------------
    # last: phase 3 reads device times with short profiler sessions, which
    # recorded only some of their launches when they came after these
    done = phase("5. torch.profiler over one more warm call per matrix")
    for name, a in mats:
        profile_fn(name, lambda: workflow.ocean_spgemm(a, a,
                                                       cache=caches[name]))
    done()

    log(f"{smi}")
    serving_line["card"] = smi
    sharded_line["card"] = smi
    lm_line["card"] = smi
    train_line["card"] = smi
    families_line["card"] = smi
    print(json.dumps({"serving": serving_line}))
    print(json.dumps({"sharded": sharded_line}))
    print(json.dumps({"lm": lm_line}))
    train_line["cohen"] = cohen_line
    print(json.dumps({"train": train_line}))
    print(json.dumps({"families": families_line}))
    print(json.dumps({"dryrun": dryrun_line}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
