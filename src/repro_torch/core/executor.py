"""Async SpGEMM executor: one dispatch -> collect -> merge pipeline.

PyTorch port of the single-device ``repro.core.executor``:

* **dispatch** enqueues every bin's kernel launch on the current stream
  without blocking and starts async copies of each result slab into pinned
  host memory (``core.dispatch``);
* **collect** pulls slabs back in completion order (per-launch CUDA
  events, no global barrier);
* **merge** runs each slab's overflow scan and the incremental half of
  compaction on the host while later slabs are still computing or copying;
  the exact-ESC overflow fallback and the final scatter wait for the set.

Slabs are row-disjoint and every kernel's per-row output is independent of
the other rows of its launch, so the ``serial``, ``pipelined`` and
``threaded`` collect modes give the same CSR bit for bit, fused
:class:`MergePostOps` included (column-sum partials fold in dispatch
order). The post-ops run on the host slabs, in numpy, as the reference's
do. The sharded executor is not ported yet (ROADMAP queue 1, item 5).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..obs import accuracy as obs_accuracy
from ..obs import trace
from . import esc as esc_mod
from .dispatch import (Launch, collect_in_completion_order, device_context,
                       host_arrays, start_async_host_copies)
from .formats import CSR, PAD_COL, csr_from_arrays, csr_rows_to_ell
from .planner import (DenseBinExec, EscExec, ExecutionPlan, HashBinExec,
                      OceanReport, gather_rows)

SERIAL = "serial"
PIPELINED = "pipelined"
THREADED = "threaded"
EXECUTORS = (PIPELINED, THREADED, SERIAL)


class _Slab:
    """Per-row output fragments: row ids + fixed-width (cols, vals, nnz)."""

    def __init__(self, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 nnz: np.ndarray):
        self.rows, self.cols, self.vals, self.nnz = rows, cols, vals, nnz


# ---------------------------------------------------------------------------
# Fused merge post-processing (graph workloads: mask / inflate / prune)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MergePostOps:
    """Post-processing fused into the executor's merge, applied to each
    result slab as it lands on the host (``repro_torch.graph.ops`` builds
    these):

    * ``mask_indptr``/``mask_indices``: keep only entries whose (row, col)
      is in the mask pattern — ``mask .* (A @ B)``.
    * ``transform``: elementwise value map (Hadamard power for MCL
      inflation, ``sign`` for boolean semirings); sound per slab because
      each (row, col) entry is accumulated within exactly one slab.
    * ``col_normalize``: divide every entry by its column's total of
      post-transform values; each slab contributes a column-sum partial and
      the partials fold in dispatch order at compaction time.
    * ``threshold``: drop entries with ``|value| < threshold`` (after
      normalization when ``col_normalize`` is set, else per slab).

    Stage order: mask -> transform -> [colsum partial] -> prune/normalize.
    Overflow scanning runs on the unfiltered per-row counts, so post-ops
    never change which rows take the exact-ESC fallback.
    """
    n_cols: int
    mask_indptr: Optional[np.ndarray] = None
    mask_indices: Optional[np.ndarray] = None
    transform: Optional[Callable[[np.ndarray], np.ndarray]] = None
    threshold: float = 0.0
    col_normalize: bool = False

    def __post_init__(self):
        self._mask_keys = None
        if self.mask_indptr is not None:
            ptr = np.asarray(self.mask_indptr, np.int64)
            nnz = int(ptr[-1])
            idx = np.asarray(self.mask_indices, np.int64)[:nnz]
            rows = np.repeat(np.arange(len(ptr) - 1, dtype=np.int64),
                             np.diff(ptr))
            # sorted already for a canonical CSR; sort for caller-built masks
            self._mask_keys = np.sort(rows * np.int64(self.n_cols) + idx)


def _compact_rows(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                  keep: np.ndarray) -> _Slab:
    """Shift kept entries left into a fresh fixed-width slab (order, and so
    the column sorting within a row, preserved)."""
    new_nnz = keep.sum(axis=1).astype(np.int64)
    w2 = max(int(new_nnz.max()) if len(new_nnz) else 0, 1)
    out_cols = np.full((keep.shape[0], w2), PAD_COL, np.int32)
    out_vals = np.zeros((keep.shape[0], w2), vals.dtype)
    ri, ci = np.nonzero(keep)
    dest = (np.cumsum(keep, axis=1) - 1)[ri, ci]
    out_cols[ri, dest] = cols[ri, ci]
    out_vals[ri, dest] = vals[ri, ci]
    return _Slab(rows, out_cols, out_vals, new_nnz)


def _filter_slab(slab: _Slab, post: MergePostOps
                 ) -> Tuple[_Slab, Optional[np.ndarray]]:
    """The per-slab half of the post-ops (mask, transform, eager prune):
    the filtered slab and its column-sum partial."""
    r, w = slab.cols.shape
    if r == 0:
        return slab, (np.zeros(post.n_cols, np.float64)
                      if post.col_normalize else None)
    slot = np.arange(w, dtype=np.int64)[None, :]
    keep = (slot < slab.nnz[:, None]) & (slab.cols != PAD_COL)
    vals = slab.vals
    if post._mask_keys is not None:
        keys = (slab.rows[:, None].astype(np.int64) * np.int64(post.n_cols)
                + slab.cols.astype(np.int64))
        pos = np.searchsorted(post._mask_keys, keys)
        member = np.zeros(keys.shape, bool)
        in_rng = pos < len(post._mask_keys)
        member[in_rng] = post._mask_keys[pos[in_rng]] == keys[in_rng]
        keep &= member
    if post.transform is not None:
        # zero the dropped slots first so transforms need not map 0 -> 0
        vals = np.where(keep, post.transform(np.where(keep, vals, 0)), 0)
        vals = vals.astype(slab.vals.dtype, copy=False)
    eager_prune = post.threshold > 0.0 and not post.col_normalize
    if eager_prune:
        keep &= np.abs(vals) >= post.threshold
    colsum = None
    if post.col_normalize:
        colsum = np.zeros(post.n_cols, np.float64)
        np.add.at(colsum, slab.cols[keep].astype(np.int64),
                  vals[keep].astype(np.float64))
    if post._mask_keys is None and not eager_prune:
        # values-only post: no entry drops, so no re-compaction
        return _Slab(slab.rows, slab.cols, vals, slab.nnz), colsum
    return _compact_rows(slab.rows, slab.cols, vals, keep), colsum


def _esc_to_slab(indptr: np.ndarray, indices: np.ndarray,
                 values: np.ndarray, nnz: int, rows: np.ndarray,
                 out_cap: int) -> _Slab:
    """An ESC result over a row subset (host arrays) as a slab."""
    esc_mod.ensure_esc_capacity(nnz, out_cap, where="ESC shard")
    counts = (indptr[1:] - indptr[:-1])[: len(rows)].astype(np.int64)
    width = max(int(counts.max()) if len(counts) else 1, 1)
    ell_i, ell_v = csr_rows_to_ell(
        torch.from_numpy(indptr), torch.from_numpy(indices),
        torch.from_numpy(values), num_rows=len(rows), ell_width=width,
        pad_index=PAD_COL)
    return _Slab(rows, ell_i.numpy(), ell_v.numpy(), counts)


def _run_dense_bin(be: DenseBinExec, a_values: torch.Tensor, b_cols_pad,
                   b_vals_pad):
    """Dispatch one dense bin; returns device tensors (cols, vals, nnz)."""
    a_vals = kops.gather_bin_values(a_values, be.pos, be.valid)
    return kops.dense_bin_op(
        be.a_rows, a_vals, be.a_starts, be.a_lens, be.row_lo, b_cols_pad,
        b_vals_pad, window=be.window, col_tiles=be.col_tiles, cap=be.cap)


def _run_hash_bin(hb: HashBinExec, a_values: torch.Tensor, b_cols_pad,
                  b_vals_pad):
    """Dispatch one hash bin; returns device tensors (cols, vals, nnz)."""
    a_vals = kops.gather_bin_values(a_values, hb.pos, hb.valid)
    return kops.hash_bin_op(
        hb.a_rows, a_vals, hb.a_starts, hb.a_lens, b_cols_pad, b_vals_pad,
        table=hb.table, spill=hb.spill, f_chunk=hb.f_chunk, tile=hb.tile)


def _run_esc_bin(ex: EscExec, a_values: torch.Tensor, b: CSR):
    """Dispatch the ESC bin; returns the ESCResult."""
    return esc_mod.esc_spgemm(
        ex.sub_indptr, ex.sub_indices, a_values[ex.src], b.indptr,
        b.indices, b.values, num_rows_a=ex.sub_indptr.shape[0] - 1,
        n_cols_b=b.n)


def _compact_slabs(slabs: List[_Slab], shape: Tuple[int, int],
                   dtype: torch.dtype, device) -> Tuple[CSR, int]:
    """Scatter row-disjoint slabs into one CSR on ``device``."""
    dtype = torch.empty((), dtype=dtype).numpy().dtype
    m = shape[0]
    counts = np.zeros(m, np.int64)
    for s in slabs:
        counts[s.rows] = s.nnz
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    total = int(indptr[-1])
    out_cols = np.full(total, PAD_COL, np.int32)
    out_vals = np.zeros(total, dtype)
    for s in slabs:
        if not len(s.rows):
            continue
        capw = s.cols.shape[1]
        slot = np.arange(capw)[None, :]
        valid = slot < s.nnz[:, None]
        pos = indptr[s.rows][:, None] + slot
        out_cols[pos[valid]] = s.cols[valid]
        out_vals[pos[valid]] = s.vals[valid]
    return csr_from_arrays(indptr, out_cols, out_vals, shape,
                           device=device), total


def _dispatch(plan: ExecutionPlan, a_values: torch.Tensor,
              b: CSR) -> List[Launch]:
    """Enqueue every bin's launch without blocking and start the async
    copies of its results. Tags are ``(kind, exec)``; ESC launches carry
    their exact nnz as a third tag field."""
    items: List[Launch] = []
    order = 0
    with device_context(b.device):
        b_cols_pad, b_vals_pad = kops.pad_b_flat(b)
        for be in plan.dense:
            arrays = _run_dense_bin(be, a_values, b_cols_pad, b_vals_pad)
            items.append(Launch(("dense", be), order, tuple(arrays)))
            order += 1
        for hb in plan.hash:
            arrays = _run_hash_bin(hb, a_values, b_cols_pad, b_vals_pad)
            items.append(Launch(("hash", hb), order, tuple(arrays)))
            order += 1
        if plan.esc is not None:
            res = _run_esc_bin(plan.esc, a_values, b)
            items.append(Launch(("esc", plan.esc, res.nnz), order,
                                (res.indptr, res.indices, res.values)))
            order += 1
        start_async_host_copies(items)
    return items


def _materialize(it: Launch) -> _Slab:
    """Pull one launch to the host (blocks only on this launch)."""
    kind, exec_ = it.tag[:2]
    arrays = host_arrays(it)
    if kind in ("dense", "hash"):
        cols, vals, nnz = arrays
        return _Slab(exec_.rows, cols, vals, nnz.astype(np.int64))
    indptr, indices, values = arrays
    return _esc_to_slab(indptr, indices, values, it.tag[2], exec_.rows,
                        exec_.out_cap)


# the overflow-fallback slab's position in the merge order: after every
# dispatched launch
_FALLBACK_ORDER = 1 << 31


class _MergeState:
    """Incremental host merge: overflow scanning, fused post-ops and the
    counting half of compaction, fed one slab at a time (add-order
    independent)."""

    def __init__(self, m_rows: int, post: Optional[MergePostOps] = None):
        self.kept: List[Tuple[int, _Slab]] = []
        self.overflow: Dict[int, np.ndarray] = {}
        # which bin family's capacity the overflowed rows broke
        self.overflow_causes: Dict[str, int] = {}
        self.post = post
        self.colsum_parts: List[Tuple[int, np.ndarray]] = []
        # exact per-row nnz of the raw (unfiltered) product, which graph
        # chains feed forward; only kept when post-ops may filter it
        self.raw_counts = (np.zeros(m_rows, np.int64)
                           if post is not None else None)

    def _admit(self, order: int, slab: _Slab) -> None:
        if self.post is not None:
            slab, colsum = _filter_slab(slab, self.post)
            if colsum is not None:
                self.colsum_parts.append((order, colsum))
        self.kept.append((order, slab))

    def add(self, it: Launch, slab: _Slab) -> None:
        if self.raw_counts is not None:
            # dense counts are exact past the slab width; a hash row that
            # overflowed counts failed inserts, but the fallback slab
            # rewrites every overflowed row's count before finalize
            self.raw_counts[slab.rows] = slab.nnz
        kind, exec_ = it.tag[:2]
        if kind in ("dense", "hash"):  # ESC caps are upper bounds
            over = slab.nnz > slab.cols.shape[1]
            if over.any():
                self.overflow[it.order] = slab.rows[over]
                cause = ("hash_spill" if kind == "hash"
                         else "longrow_slab" if exec_.is_longrow
                         else "dense_window")
                self.overflow_causes[cause] = (
                    self.overflow_causes.get(cause, 0) + int(over.sum()))
                keep = ~over
                slab = _Slab(slab.rows[keep], slab.cols[keep],
                             slab.vals[keep], slab.nnz[keep])
        self._admit(it.order, slab)

    def add_fallback(self, slab: _Slab) -> None:
        if self.raw_counts is not None:
            self.raw_counts[slab.rows] = slab.nnz
        self._admit(_FALLBACK_ORDER, slab)

    def fallback_rows(self) -> Optional[np.ndarray]:
        """Overflowed rows in dispatch order."""
        if not self.overflow:
            return None
        return np.concatenate(
            [self.overflow[k] for k in sorted(self.overflow)])

    def finalize(self) -> List[_Slab]:
        """The deferred half of the post-ops: fold the column-sum partials
        in dispatch order, then normalize (and prune after it). Without
        ``col_normalize`` the slabs in dispatch order."""
        kept = [s for _, s in sorted(self.kept, key=lambda t: t[0])]
        post = self.post
        if post is None or not post.col_normalize:
            return kept
        colsum = np.zeros(post.n_cols, np.float64)
        for _, part in sorted(self.colsum_parts, key=lambda t: t[0]):
            colsum += part
        out: List[_Slab] = []
        for s in kept:
            if not len(s.rows):
                out.append(s)
                continue
            slot = np.arange(s.cols.shape[1], dtype=np.int64)[None, :]
            valid = slot < s.nnz[:, None]
            denom = colsum[np.clip(s.cols, 0, post.n_cols - 1)
                           .astype(np.int64)]
            # a zero column sum means every value in the column is zero
            vals = s.vals.astype(np.float64) / np.where(denom == 0.0, 1.0,
                                                        denom)
            vals = np.where(valid, vals, 0.0).astype(s.vals.dtype)
            if post.threshold > 0.0:
                out.append(_compact_rows(
                    s.rows, s.cols, vals,
                    valid & (np.abs(vals) >= post.threshold)))
            else:
                out.append(_Slab(s.rows, s.cols, vals, s.nnz))
        return out


def _run_overflow_fallback(state: _MergeState, products: np.ndarray,
                           a: CSR, b: CSR) -> int:
    """Re-run overflowed rows through the exact ESC pass (paper §3.2)."""
    rows = state.fallback_rows()
    if rows is None:
        return 0
    with trace.span("exec.overflow_fallback") as sp:
        sub = gather_rows(a, rows)
        res = esc_mod.esc_spgemm(
            sub.indptr, sub.indices, sub.values, b.indptr, b.indices,
            b.values, num_rows_a=sub.m, n_cols_b=b.n)
        p_cap = int(products[rows].sum())
        host = [x.cpu().numpy() for x in (res.indptr, res.indices,
                                          res.values)]
        state.add_fallback(_esc_to_slab(*host, res.nnz, rows, p_cap))
        sp.set(rows=len(rows))
    return len(rows)


# ---------------------------------------------------------------------------
# The collect policies
# ---------------------------------------------------------------------------

def _collect_serial(items, plan, a, b, stage, dispatch_s, state):
    """One global barrier, then merge (stage keys numeric/overflow/
    postprocess)."""
    t0 = time.perf_counter()
    slabs = [(it, _materialize(it)) for it in items]
    stage["numeric"] = dispatch_s + (time.perf_counter() - t0)
    trace.add_span("exec.collect", t0, time.perf_counter() - t0)
    t0 = time.perf_counter()
    for it, slab in slabs:
        state.add(it, slab)
    n_overflow = _run_overflow_fallback(state, plan.products, a, b)
    stage["overflow"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c, total = _compact_slabs(state.finalize(), (a.m, b.n), a.values.dtype,
                              a.device)
    stage["postprocess"] = time.perf_counter() - t0
    trace.add_span("exec.compact", t0, stage["postprocess"])
    return c, total, n_overflow, 0.0


def _finish_merge(state, plan, a, b, stage, dispatch_s, collect_s, merge_s):
    t0 = time.perf_counter()
    n_overflow = _run_overflow_fallback(state, plan.products, a, b)
    t1 = time.perf_counter()
    c, total = _compact_slabs(state.finalize(), (a.m, b.n), a.values.dtype,
                              a.device)
    t2 = time.perf_counter()
    trace.add_span("exec.compact", t1, t2 - t1)
    stage["dispatch"] = dispatch_s
    stage["collect"] = collect_s
    stage["merge"] = merge_s + (t2 - t0)
    return c, total, n_overflow


def _collect_pipelined(items, plan, a, b, stage, dispatch_s, state):
    """Slabs are pulled in completion order and each one's overflow scan,
    post-ops and count accumulation run while later slabs are still in
    flight."""
    collect_s = merge_s = overlap_s = 0.0
    n_left = len(items)
    traced = trace.enabled()
    for it in collect_in_completion_order(items):
        n_left -= 1
        t0 = time.perf_counter()
        slab = _materialize(it)
        dt_c = time.perf_counter() - t0
        collect_s += dt_c
        if traced:
            trace.add_span("exec.collect", t0, dt_c, order=it.order,
                           kind=it.tag[0])
        t0 = time.perf_counter()
        state.add(it, slab)
        dt = time.perf_counter() - t0
        if traced:
            trace.add_span("exec.merge", t0, dt, order=it.order,
                           overlapped=bool(n_left))
        merge_s += dt
        if n_left:
            overlap_s += dt
    c, total, n_overflow = _finish_merge(state, plan, a, b, stage,
                                         dispatch_s, collect_s, merge_s)
    return c, total, n_overflow, overlap_s


def _collect_threaded(items, plan, a, b, stage, dispatch_s, state):
    """Collect on this thread, merge on a dedicated worker thread (the sole
    mutator of the merge state), so merging proceeds while the collect loop
    blocks on a device copy."""
    slabs: "queue.Queue[Optional[Tuple[Launch, _Slab]]]" = queue.Queue()
    spans: List[Tuple[float, float]] = []
    errors: List[BaseException] = []
    worker_tid: List[int] = []

    def worker():
        worker_tid.append(threading.get_ident())
        while True:
            item = slabs.get()
            if item is None:
                return
            it, slab = item
            t0 = time.perf_counter()
            try:
                state.add(it, slab)
            except BaseException as e:  # re-raised on the main thread
                errors.append(e)
                return
            spans.append((t0, time.perf_counter() - t0))

    th = threading.Thread(target=worker, name="ocean-merge-worker",
                          daemon=True)
    th.start()
    collect_s = 0.0
    traced = trace.enabled()
    try:
        for it in collect_in_completion_order(items):
            t0 = time.perf_counter()
            slab = _materialize(it)
            dt_c = time.perf_counter() - t0
            collect_s += dt_c
            if traced:
                trace.add_span("exec.collect", t0, dt_c, order=it.order,
                               kind=it.tag[0])
            slabs.put((it, slab))
    finally:
        collect_end = time.perf_counter()
        slabs.put(None)
        th.join()
    if errors:
        raise errors[0]
    if traced and worker_tid:
        for w0, wdt in spans:
            trace.add_span("exec.merge_worker", w0, wdt,
                           tid=worker_tid[0], thread="ocean-merge-worker")
    merge_s = sum(dt for _, dt in spans)
    overlap_s = sum(min(max(collect_end - t0, 0.0), dt) for t0, dt in spans)
    c, total, n_overflow = _finish_merge(state, plan, a, b, stage,
                                         dispatch_s, collect_s, merge_s)
    return c, total, n_overflow, overlap_s


_COLLECT_OF = {PIPELINED: _collect_pipelined, THREADED: _collect_threaded,
               SERIAL: _collect_serial}


def execute_plan(plan: ExecutionPlan, a: CSR, b: CSR, *,
                 stage: Optional[Dict[str, float]] = None,
                 cache_hit: bool = False,
                 executor: str = PIPELINED,
                 post: Optional[MergePostOps] = None,
                 ) -> Tuple[CSR, OceanReport]:
    """Run a frozen plan against (possibly new) values of A and B.

    ``post`` fuses mask/transform/prune/normalize stages into the merge;
    plans are post-independent, so one plan serves masked and unmasked
    calls alike."""
    if executor not in EXECUTORS:
        raise ValueError(f"unknown executor {executor!r}; expected one of "
                         f"{EXECUTORS}")
    if a.shape != plan.shape_a or b.shape != plan.shape_b:
        raise ValueError(
            f"plan built for {plan.shape_a} @ {plan.shape_b}, "
            f"got {a.shape} @ {b.shape}")
    if a.device != b.device:
        raise ValueError(f"A on {a.device}, B on {b.device}")
    if post is not None and post.n_cols != b.n:
        raise ValueError(f"post-ops built for {post.n_cols} columns, "
                         f"product has {b.n}")
    stage = dict(stage) if stage else {"analysis": 0.0, "prediction": 0.0,
                                       "binning": 0.0}

    t0 = time.perf_counter()
    items = _dispatch(plan, a.values, b)
    dispatch_s = time.perf_counter() - t0
    trace.add_span("exec.dispatch", t0, dispatch_s, launches=len(items))

    state = _MergeState(a.m, post)
    c, total, n_overflow, overlap_s = _COLLECT_OF[executor](
        items, plan, a, b, stage, dispatch_s, state)
    overlap_s = min(max(overlap_s, 0.0), stage.get("merge", 0.0))
    causes = state.overflow_causes

    # estimation-accuracy telemetry on the raw product's row nnz (the merge
    # state's pre-filter counts when post-ops may have pruned the output)
    exact_nnz = (state.raw_counts if state.raw_counts is not None
                 else np.diff(np.asarray(c.indptr.cpu().numpy(), np.int64)))
    if plan.feed_forward and causes:
        causes = {f"{k}+stale_feed": v for k, v in causes.items()}
    accuracy = obs_accuracy.measure_accuracy(plan, exact_nnz, causes)

    report = OceanReport(
        workflow=plan.workflow, er=plan.er, sampled_cr=plan.sampled_cr,
        nproducts_avg=plan.nproducts_avg,
        total_products=plan.total_products, m_regs=plan.m_regs,
        stage_seconds=stage, bins=dict(plan.bins_describe),
        overflow_rows=n_overflow, nnz_out=total, plan_cache_hit=cache_hit,
        feed_forward=plan.feed_forward, executor=executor,
        overlap_seconds=overlap_s, raw_row_nnz=state.raw_counts,
        wave2_overlap_seconds=plan.wave2_overlap_seconds,
        wave2_overlapped=plan.wave2_overlapped,
        estimation_accuracy=accuracy, decision=plan.decision)
    return c, report
