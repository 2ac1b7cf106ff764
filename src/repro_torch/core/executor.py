"""Async SpGEMM executor: one dispatch -> collect -> merge pipeline.

PyTorch port of ``repro.core.executor``:

* **dispatch** enqueues every (shard, bin) kernel launch on its device's
  current stream without blocking, with an event behind each
  (``core.dispatch``);
* **collect** takes launches in completion order (per-launch CUDA events,
  no global barrier);
* **merge** enqueues each slab's overflow scan and post-ops on the merge's
  device, A's, as its launch is collected, while later launches are still
  in flight; the exact-ESC overflow fallback and the compaction wait for
  the set.

The merge stays on A's device: no slab goes to the host and C is not
uploaded. Compaction sums every source's row counts into C's ``indptr``,
allocates C once and copies each source (a bin's slab, an ESC result)
into it with one ``kernels.slab_scatter`` launch. The host reads only the
slabs' counts of overflowed rows (once, for all slabs, after collection),
the overflowed rows themselves, C's size and one m-entry copy of the row
counts for the report. Slabs are row-disjoint and compaction takes them in
dispatch order, so the order in which launches complete does not change C,
fused :class:`MergePostOps` included (column-sum partials fold in dispatch
order). A device-partitioned plan (``core.partition.ShardedPlan``) runs
through the same pipeline: its shards' slabs are row subsets of the bins,
moved to A's device, so :func:`execute_sharded_plan` gives the
single-device C bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..obs import accuracy as obs_accuracy
from ..obs import metrics as obs_metrics
from ..obs import trace
from . import esc as esc_mod
from .dispatch import (Launch, collect_in_completion_order, device_context,
                       mark_in_flight)
from .formats import CSR, PAD_COL
from .planner import (DenseBinExec, EscExec, ExecutionPlan, HashBinExec,
                      OceanReport, gather_rows)

class _Slab:
    """One source of C's rows, on the merge's device: ``rows`` (R,) int64,
    the C row of each source row, and either a fixed-width slab
    ``cols``/``vals`` (R, W) with per-row counts ``nnz`` (a row whose
    count passes W overflowed and puts nothing in C), or a CSR
    ``indptr`` (R+1,) over flat ``cols``/``vals``."""

    def __init__(self, rows: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor, nnz: Optional[torch.Tensor] = None,
                 indptr: Optional[torch.Tensor] = None):
        self.rows, self.cols, self.vals = rows, cols, vals
        self.nnz, self.indptr = nnz, indptr

    def spans(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(start, lens)`` of each row in the flat source arrays."""
        return kops.row_spans(self.cols, self.nnz, self.indptr)

    def raw_counts(self) -> torch.Tensor:
        """Each row's count as its kernel reported it, overflow included."""
        return (self.nnz.long() if self.nnz is not None
                else self.spans()[1])

    def entries(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(row, cols, vals)`` of every entry the source puts in C, in
        row order (so each row's column order)."""
        row, pos = kops.row_entries(*self.spans())
        return (row, self.cols.reshape(-1)[pos],
                self.vals.reshape(-1)[pos])


def _kept(rows: torch.Tensor, row: torch.Tensor, cols: torch.Tensor,
          vals: torch.Tensor, keep: torch.Tensor) -> _Slab:
    """The kept entries of a source's ``entries()`` as a CSR source (row
    order, and so the column sorting within a row, preserved)."""
    lens = torch.bincount(row[keep], minlength=rows.shape[0])
    indptr = torch.zeros(rows.shape[0] + 1, dtype=torch.int32,
                         device=rows.device)
    indptr[1:] = torch.cumsum(lens, 0)
    return _Slab(rows, cols[keep], vals[keep], indptr=indptr)


# ---------------------------------------------------------------------------
# Fused merge post-processing (graph workloads: mask / inflate / prune)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MergePostOps:
    """Post-processing fused into the executor's merge, applied in torch
    to each result slab on the merge's device as it is collected
    (``repro_torch.graph.ops`` builds these):

    * ``mask_indptr``/``mask_indices``: keep only entries whose (row, col)
      is in the mask pattern — ``mask .* (A @ B)``.
    * ``transform``: elementwise value map on a tensor (Hadamard power for
      MCL inflation, ``sign`` for boolean semirings); sound per slab
      because each (row, col) entry is accumulated within exactly one slab.
    * ``col_normalize``: divide every entry by its column's total of
      post-transform values; each slab contributes a float64 column-sum
      partial and the partials fold in dispatch order at compaction time.
    * ``threshold``: drop entries with ``|value| < threshold`` (after
      normalization when ``col_normalize`` is set, else per slab).

    Stage order: mask -> transform -> [colsum partial] -> prune/normalize.
    Overflow scanning runs on the unfiltered per-row counts, so post-ops
    never change which rows take the exact-ESC fallback.
    """
    n_cols: int
    mask_indptr: Optional[np.ndarray] = None
    mask_indices: Optional[np.ndarray] = None
    transform: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
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
            self._mask_keys = torch.from_numpy(
                np.sort(rows * np.int64(self.n_cols) + idx))

    def mask_keys(self, device) -> Optional[torch.Tensor]:
        """The mask's sorted ``row * n_cols + col`` keys on ``device``
        (moved there once)."""
        if self._mask_keys is not None and self._mask_keys.device != device:
            self._mask_keys = self._mask_keys.to(device)
        return self._mask_keys


def _column_sums(cols: torch.Tensor, vals: torch.Tensor,
                 n_cols: int) -> torch.Tensor:
    """(n_cols,) float64 sums of ``vals`` by column, each column's values
    added in their order: a stable sort, then ``esc.segment_sum`` (no
    atomics, so the same on every run)."""
    key, perm = torch.sort(cols.long(), stable=True)
    uniq, per_col = torch.unique_consecutive(key, return_counts=True)
    out = torch.zeros(n_cols, dtype=torch.float64, device=cols.device)
    out[uniq] = esc_mod.segment_sum(vals.double()[perm], per_col)
    return out


def _filter_slab(slab: _Slab, post: MergePostOps
                 ) -> Tuple[_Slab, Optional[torch.Tensor]]:
    """The per-slab half of the post-ops (mask, transform, eager prune):
    the filtered source, as a CSR, and its column-sum partial."""
    row, cols, vals = slab.entries()
    keep = cols != PAD_COL
    keys = post.mask_keys(cols.device)
    if keys is not None:
        key = slab.rows[row] * post.n_cols + cols.long()
        pos = torch.searchsorted(keys, key)
        member = torch.zeros_like(keep)
        in_rng = pos < keys.shape[0]
        member[in_rng] = keys[pos[in_rng]] == key[in_rng]
        keep &= member
    if post.transform is not None:
        # zero the dropped entries first so transforms need not map 0 -> 0
        zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
        vals = torch.where(keep, post.transform(torch.where(keep, vals, zero)),
                           zero).to(vals.dtype)
    if post.threshold > 0.0 and not post.col_normalize:
        keep &= vals.abs() >= post.threshold
    colsum = (_column_sums(cols[keep], vals[keep], post.n_cols)
              if post.col_normalize else None)
    return _kept(slab.rows, row, cols, vals, keep), colsum


def _gather_ell_values(exec_, a_values: torch.Tensor) -> torch.Tensor:
    """A bin's ELL values: gathered where A's values live (the bin's value
    map is kept there), then moved to the device of its kernel inputs."""
    return kops.gather_bin_values(a_values, exec_.pos, exec_.valid).to(
        exec_.a_rows.device)


def _run_dense_bin(be: DenseBinExec, a_values: torch.Tensor, b_cols_pad,
                   b_vals_pad):
    """Dispatch one dense bin; returns device tensors (cols, vals, nnz).
    Any row subset of a bin gives the whole bin's per-row output."""
    a_vals = _gather_ell_values(be, a_values)
    return kops.dense_bin_op(
        be.a_rows, a_vals, be.a_starts, be.a_lens, be.row_lo, b_cols_pad,
        b_vals_pad, window=be.window, col_tiles=be.col_tiles, cap=be.cap)


def _run_hash_bin(hb: HashBinExec, a_values: torch.Tensor, b_cols_pad,
                  b_vals_pad):
    """Dispatch one hash bin; returns device tensors (cols, vals, nnz)."""
    a_vals = _gather_ell_values(hb, a_values)
    return kops.hash_bin_op(
        hb.a_rows, a_vals, hb.a_starts, hb.a_lens, b_cols_pad, b_vals_pad,
        table=hb.table, spill=hb.spill, f_chunk=hb.f_chunk, tile=hb.tile)


def _run_esc_bin(ex: EscExec, a_values: torch.Tensor, b_arrays,
                 n_cols: int):
    """Dispatch the ESC bin against B's ``(indptr, indices, values)`` on
    the bin's device; returns the ESCResult."""
    b_indptr, b_indices, b_values = b_arrays
    return esc_mod.esc_spgemm(
        ex.sub_indptr, ex.sub_indices,
        a_values[ex.src].to(ex.sub_indptr.device), b_indptr, b_indices,
        b_values, num_rows_a=ex.sub_indptr.shape[0] - 1, n_cols_b=n_cols)


def _compact_slabs(state: "_MergeState", shape: Tuple[int, int],
                   dtype: torch.dtype, device) -> CSR:
    """The merge state's sources as one CSR on ``device``: their row counts
    scattered into ``state.counts``, ``indptr`` its cumsum (C's size read
    once), C allocated once and each source copied in by one
    ``slab_scatter`` launch, its arrays released after; timed into the
    state's ``span_seconds``."""
    m = shape[0]
    with trace.timed("exec.compact.scatter", state.span_seconds) as span:
        sources = state.finalize()
        counts = torch.zeros(m, dtype=torch.int64, device=device)
        for s in sources:
            counts[s.rows] = s.spans()[1]
        ends = torch.cumsum(counts, 0)
        total = int(ends[-1]) if m else 0
        if total >= 2**31:
            raise ValueError(f"C has {total} entries; its int32 indptr "
                             "holds fewer than 2**31")
        indptr = torch.zeros(m + 1, dtype=torch.int32, device=device)
        indptr[1:] = ends
        del ends
        cols = torch.empty(total, dtype=torch.int32, device=device)
        vals = torch.empty(total, dtype=dtype, device=device)
        launches = 0
        for s in sources:
            if s.rows.shape[0]:
                kops.slab_scatter(indptr, cols, vals, s.rows, s.cols,
                                  s.vals, nnz=s.nnz, indptr=s.indptr)
                launches += 1
        span.set(entries=total, launches=launches)
    state.counts = counts
    return CSR(indptr, cols, vals, shape, total)


@dataclasses.dataclass
class _ShardWork:
    """One device's slice of the launch schedule (the whole plan, on the
    inputs' device, when executing unsharded)."""
    device: Optional[torch.device]
    dense: List[DenseBinExec]
    esc: Optional[EscExec]
    hash: List[HashBinExec] = dataclasses.field(default_factory=list)


def _shards_of_plan(plan: ExecutionPlan) -> List[_ShardWork]:
    return [_ShardWork(device=None, dense=plan.dense, esc=plan.esc,
                       hash=plan.hash)]


def _dispatch(shards: List[_ShardWork], a_values: torch.Tensor,
              b: CSR) -> List[Launch]:
    """Enqueue every (shard, bin) launch without blocking, each with an
    event behind its work. B is padded once on its device and moved to
    each shard's (``.to`` is a no-op on the same device). Tags are
    ``(kind, exec)``; ESC launches carry their exact nnz as a third tag
    field. While tracing, each launch's ``timing`` brackets its gather,
    kernel and epilogue on the device."""
    items: List[Launch] = []
    order = 0
    with device_context(b.device):
        b_pad = kops.pad_b_flat(b)
    for shard in shards:
        if not shard.dense and not shard.hash and shard.esc is None:
            continue
        dev = b.device if shard.device is None else shard.device
        with device_context(dev):
            b_cols_pad, b_vals_pad = (x.to(dev) for x in b_pad)
            for be in shard.dense:
                timer = trace.device_timer(dev)
                arrays = _run_dense_bin(be, a_values, b_cols_pad, b_vals_pad)
                items.append(mark_in_flight(Launch(
                    ("dense", be), order, tuple(arrays),
                    timing=timer and timer.stop())))
                order += 1
            for hb in shard.hash:
                timer = trace.device_timer(dev)
                arrays = _run_hash_bin(hb, a_values, b_cols_pad, b_vals_pad)
                items.append(mark_in_flight(Launch(
                    ("hash", hb), order, tuple(arrays),
                    timing=timer and timer.stop())))
                order += 1
            if shard.esc is not None:
                b_esc = tuple(x.to(dev) for x in (b.indptr, b.indices,
                                                  b.values))
                timer = trace.device_timer(dev)
                res = _run_esc_bin(shard.esc, a_values, b_esc, b.n)
                items.append(mark_in_flight(Launch(
                    ("esc", shard.esc, res.nnz), order,
                    (res.indptr, res.indices, res.values),
                    timing=timer and timer.stop())))
                order += 1
    return items


def _rung(kind: str, exec_) -> str:
    """A bin's name as ``plan.bins_describe`` gives it."""
    if kind == "dense":
        return f"dense_w{exec_.window}x{exec_.col_tiles}"
    return f"hash_t{exec_.table}" if kind == "hash" else "esc"


def _record_device_spans(items: List[Launch]) -> Dict[str, float]:
    """Each materialised launch's device span (``device.bin``) on the
    tracer's device lane; the device seconds by kind."""
    out: Dict[str, float] = {}
    for it in items:
        if it.timing is None:
            continue
        kind, exec_ = it.tag[:2]
        dt = it.timing.record("device.bin", kind=kind,
                              rung=_rung(kind, exec_), rows=exec_.n_valid,
                              order=it.order)
        out[kind] = out.get(kind, 0.0) + dt
    return out


def _materialize(it: Launch, device) -> _Slab:
    """One launch as a source of C's rows on ``device`` (blocks only on
    this launch; ``.to`` is a no-op on the launch's own device)."""
    if it.event is not None:
        it.event.synchronize()
    kind, exec_ = it.tag[:2]
    arrays = [x.to(device) for x in it.arrays]
    if kind in ("dense", "hash"):
        nv = exec_.n_valid
        cols, vals, nnz = arrays
        return _Slab(exec_.out_rows, cols[:nv], vals[:nv], nnz=nnz[:nv])
    indptr, indices, values = arrays
    esc_mod.ensure_esc_capacity(it.tag[2], exec_.out_cap, where="ESC shard")
    return _Slab(exec_.out_rows, indices, values, indptr=indptr)


# the overflow-fallback source's position in the merge order: after every
# dispatched launch
_FALLBACK_ORDER = 1 << 31


class _MergeState:
    """Incremental merge on the merge's device: overflow scanning and
    fused post-ops, fed one source at a time (add-order independent);
    compaction takes the sources in merge order."""

    def __init__(self, m_rows: int, device,
                 post: Optional[MergePostOps] = None,
                 span_seconds: Optional[Dict[str, float]] = None):
        self.kept: List[Tuple[int, _Slab]] = []
        # each slab's overflow scan on the device: (dispatch order, cause,
        # rows, overflowed mask, its count)
        self.overflow: List[Tuple[int, str, torch.Tensor, torch.Tensor,
                                  torch.Tensor]] = []
        # which bin family's capacity the overflowed rows broke
        self.overflow_causes: Dict[str, int] = {}
        self.post = post
        self.colsum_parts: List[Tuple[int, torch.Tensor]] = []
        # exact per-row nnz of the raw (unfiltered) product, which graph
        # chains feed forward; only kept when post-ops may filter it
        self.raw_counts = (torch.zeros(m_rows, dtype=torch.int64,
                                       device=device)
                           if post is not None else None)
        # C's row counts, once compacted
        self.counts: Optional[torch.Tensor] = None
        # seconds of the multiply's timed steps, by span name (the plan
        # lookup's, timed before, are already in a caller's dict)
        self.span_seconds: Dict[str, float] = (
            {} if span_seconds is None else span_seconds)

    def _admit(self, order: int, slab: _Slab) -> None:
        if self.post is not None:
            slab, colsum = _filter_slab(slab, self.post)
            if colsum is not None:
                self.colsum_parts.append((order, colsum))
        self.kept.append((order, slab))

    def add(self, it: Launch, slab: _Slab) -> None:
        if self.raw_counts is not None:
            # dense counts are exact past the slab width; a hash row that
            # overflowed counts failed inserts, but the fallback source
            # rewrites every overflowed row's count before finalize
            self.raw_counts[slab.rows] = slab.raw_counts()
        kind, exec_ = it.tag[:2]
        if kind in ("dense", "hash"):  # ESC caps are upper bounds
            # enqueued only: the host reads the scan once, for every slab
            over = slab.nnz > slab.cols.shape[1]
            cause = ("hash_spill" if kind == "hash"
                     else "longrow_slab" if exec_.is_longrow
                     else "dense_window")
            self.overflow.append((it.order, cause, slab.rows, over,
                                  over.sum()))
        self._admit(it.order, slab)

    def add_fallback(self, slab: _Slab) -> None:
        if self.raw_counts is not None:
            self.raw_counts[slab.rows] = slab.raw_counts()
        self._admit(_FALLBACK_ORDER, slab)

    def fallback_rows(self) -> Optional[Tuple[np.ndarray, torch.Tensor]]:
        """Overflowed rows in dispatch order, on the host and the device,
        and ``overflow_causes`` counted: one host copy of every slab's
        count of overflowed rows, then one of the overflowed rows, where
        there are any."""
        if not self.overflow:
            return None
        parts = sorted(self.overflow, key=lambda t: t[0])
        n_over = torch.stack([p[4] for p in parts]).tolist()
        dev_rows = []
        for (_, cause, rows, over, _), n in zip(parts, n_over):
            if n:
                dev_rows.append(rows[over])
                self.overflow_causes[cause] = (
                    self.overflow_causes.get(cause, 0) + n)
        if not dev_rows:
            return None
        dev_rows = torch.cat(dev_rows)
        return dev_rows.cpu().numpy(), dev_rows

    def finalize(self) -> List[_Slab]:
        """The sources in merge order. With ``col_normalize``, the deferred
        half of the post-ops first: fold the column-sum partials in
        dispatch order, then normalize (and prune after it)."""
        kept = [s for _, s in sorted(self.kept, key=lambda t: t[0])]
        post = self.post
        if post is None or not post.col_normalize:
            return kept
        colsum = None
        for _, part in sorted(self.colsum_parts, key=lambda t: t[0]):
            colsum = part if colsum is None else colsum + part
        out: List[_Slab] = []
        for s in kept:
            row, cols, vals = s.entries()
            denom = colsum[cols.long()]
            # a zero column sum means every value in the column is zero
            vals = (vals.double() / torch.where(denom == 0.0, 1.0, denom)
                    ).to(s.vals.dtype)
            keep = (vals.abs() >= post.threshold if post.threshold > 0.0
                    else torch.ones_like(vals, dtype=torch.bool))
            out.append(_kept(s.rows, row, cols, vals, keep))
        return out


def _run_overflow_fallback(state: _MergeState, products: np.ndarray,
                           a: CSR, b: CSR) -> int:
    """Re-run overflowed rows through the exact ESC pass (paper §3.2) on
    A's device: gather, then ESC, each step timed; its CSR is the merge's
    last source."""
    fb = state.fallback_rows()
    if fb is None:
        return 0
    rows, dev_rows = fb
    secs = state.span_seconds
    with trace.timed("exec.overflow_fallback", secs, rows=len(rows)):
        with trace.timed("exec.fallback.gather", secs):
            sub = gather_rows(a, rows)
        with trace.timed("exec.fallback.esc", secs):
            res = esc_mod.esc_spgemm(
                sub.indptr, sub.indices, sub.values, b.indptr, b.indices,
                b.values, num_rows_a=sub.m, n_cols_b=b.n)
            esc_mod.ensure_esc_capacity(res.nnz, int(products[rows].sum()),
                                        where="ESC shard")
        del sub
        state.add_fallback(_Slab(dev_rows.to(a.device), res.indices,
                                 res.values, indptr=res.indptr))
    return len(rows)


def _collect(items, plan, a, b, stage, dispatch_s, state):
    """Launches are taken in completion order and each one's overflow scan
    and post-ops are enqueued while later launches are still in flight;
    then the merge's tail, the overflow fallback and the compaction (stage
    keys dispatch, collect, merge)."""
    collect_s = merge_s = overlap_s = 0.0
    n_left = len(items)
    traced = trace.enabled()
    for it in collect_in_completion_order(items):
        n_left -= 1
        t0 = time.perf_counter()
        slab = _materialize(it, a.device)
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
    t0 = time.perf_counter()
    n_overflow = _run_overflow_fallback(state, plan.products, a, b)
    with trace.timed("exec.compact", state.span_seconds):
        c = _compact_slabs(state, (a.m, b.n), a.values.dtype, a.device)
    stage["dispatch"] = dispatch_s
    stage["collect"] = collect_s
    stage["merge"] = merge_s + (time.perf_counter() - t0)
    return c, n_overflow, overlap_s


def _execute(plan: ExecutionPlan, shards: List[_ShardWork], a: CSR, b: CSR,
             *, stage: Optional[Dict[str, float]], cache_hit: bool,
             n_shards: int, shard_imbalance: float,
             post: Optional[MergePostOps],
             span_seconds: Optional[Dict[str, float]]
             ) -> Tuple[CSR, OceanReport]:
    """The pipeline behind :func:`execute_plan` and
    :func:`execute_sharded_plan`; ``span_seconds`` (the report's, which
    may hold the plan lookup's steps) collects the merge's timed steps."""
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
    items = _dispatch(shards, a.values, b)
    dispatch_s = time.perf_counter() - t0
    trace.add_span("exec.dispatch", t0, dispatch_s, launches=len(items))

    state = _MergeState(a.m, a.device, post, span_seconds)
    c, n_overflow, overlap_s = _collect(items, plan, a, b, stage,
                                        dispatch_s, state)
    device_s = _record_device_spans(items) if trace.enabled() else None
    causes = state.overflow_causes

    # estimation-accuracy telemetry on the raw product's row nnz (the merge
    # state's pre-filter counts when post-ops may have pruned the output):
    # the multiply's one m-entry copy to the host
    exact_nnz = (state.counts if state.raw_counts is None
                 else state.raw_counts).cpu().numpy()
    if plan.feed_forward and causes:
        causes = {f"{k}+stale_feed": v for k, v in causes.items()}
    accuracy = obs_accuracy.measure_accuracy(plan, exact_nnz, causes)

    report = OceanReport(
        workflow=plan.workflow, er=plan.er, sampled_cr=plan.sampled_cr,
        nproducts_avg=plan.nproducts_avg,
        total_products=plan.total_products, m_regs=plan.m_regs,
        stage_seconds=stage, bins=dict(plan.bins_describe),
        overflow_rows=n_overflow, nnz_out=c.nnz, plan_cache_hit=cache_hit,
        feed_forward=plan.feed_forward, n_shards=n_shards,
        shard_imbalance=shard_imbalance, overlap_seconds=overlap_s, analysis_shards=plan.analysis_shards,
        analysis_shard_seconds=plan.analysis_shard_seconds,
        raw_row_nnz=exact_nnz if state.raw_counts is not None else None,
        wave2_overlap_seconds=plan.wave2_overlap_seconds,
        wave2_overlapped=plan.wave2_overlapped,
        estimation_accuracy=accuracy, decision=plan.decision,
        span_seconds=state.span_seconds, device_seconds=device_s,
        pred_entries=plan.pred_entries, alloc_entries=plan.alloc_entries,
        exact_wide_rows=plan.exact_wide_rows,
        esc_routed_rows=plan.esc_routed_rows)
    obs_metrics.count("plan.pred_entries", report.pred_entries)
    obs_metrics.count("plan.alloc_entries", report.alloc_entries)
    obs_metrics.count("plan.exact_wide_rows", report.exact_wide_rows)
    obs_metrics.count("plan.esc_routed_rows", report.esc_routed_rows)
    return c, report


def execute_plan(plan: ExecutionPlan, a: CSR, b: CSR, *,
                 stage: Optional[Dict[str, float]] = None,
                 cache_hit: bool = False,
                 post: Optional[MergePostOps] = None,
                 span_seconds: Optional[Dict[str, float]] = None,
                 ) -> Tuple[CSR, OceanReport]:
    """Run a frozen plan against (possibly new) values of A and B.

    ``post`` fuses mask/transform/prune/normalize stages into the merge;
    plans are post-independent, so one plan serves masked and unmasked
    calls alike."""
    return _execute(plan, _shards_of_plan(plan), a, b, stage=stage,
                    cache_hit=cache_hit, n_shards=1,
                    shard_imbalance=1.0, post=post,
                    span_seconds=span_seconds)


def execute_sharded_plan(splan, a: CSR, b: CSR, *,
                         stage: Optional[Dict[str, float]] = None,
                         cache_hit: bool = False,
                         post: Optional[MergePostOps] = None,
                         span_seconds: Optional[Dict[str, float]] = None,
                         ) -> Tuple[CSR, OceanReport]:
    """Run a :class:`~repro_torch.core.partition.ShardedPlan` across its
    devices: each shard's bins launch on its device, and the slabs merge
    through the same pipeline as :func:`execute_plan` (post-ops included),
    on A's device, so C is the single-device C bit for bit."""
    if stage is None:
        stage = {"analysis": 0.0, "prediction": 0.0, "binning": 0.0,
                 "partition": 0.0}
    shards = [_ShardWork(device=sh.device, dense=sh.dense, esc=sh.esc,
                         hash=sh.hash)
              for sh in splan.shards]
    return _execute(splan.plan, shards, a, b, stage=stage,
                    cache_hit=cache_hit, n_shards=splan.n_shards,
                    shard_imbalance=splan.imbalance, post=post,
                    span_seconds=span_seconds)
