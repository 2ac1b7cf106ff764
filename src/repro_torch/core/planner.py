"""Planner/executor split for Ocean SpGEMM (plan caching, paper Fig. 4).

PyTorch port of ``repro.core.planner``. Analysis, size prediction and
binning depend only on the sparsity patterns, so :func:`build_plan` freezes
them into an :class:`ExecutionPlan` — bin ladder, per-bin ELL blocks on the
device, ESC structure — that :func:`execute_plan` runs against any values
of the same patterns, and :class:`PlanCache` keys plans by a hash of both
patterns plus every planning knob (a device-partitioned plan,
``core.partition.ShardedPlan``, under that key and the device topology).
The binning ladders are the reference's, so plans match it bin for bin.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels import spgemm_dense as kdense
from ..kernels.pattern_fingerprint import path as fingerprint_path
from ..kernels.pattern_fingerprint import pattern_fingerprint
from ..obs import accuracy as obs_accuracy
from ..obs import trace
from . import esc as esc_mod
from . import tuning as tuning_mod
from .analysis import (AnalysisResult, OceanConfig, analyze,
                       sharded_merge_estimate, sketches_for)
from .binning import CAP_LADDER, WINDOW_LADDER, BinPlan, DenseBin, plan_bins
from .formats import (CSR, csr_from_arrays, flat_gather_index, host,
                      pow2_at_least)


@dataclasses.dataclass
class OceanReport:
    workflow: str
    er: float
    sampled_cr: Optional[float]
    nproducts_avg: float
    total_products: int
    m_regs: int
    stage_seconds: Dict[str, float]
    bins: Dict[str, int]
    overflow_rows: int
    nnz_out: int
    plan_cache_hit: bool = False
    feed_forward: bool = False
    n_shards: int = 1
    shard_imbalance: float = 1.0
    # host-merge work done before the final slab was collected
    overlap_seconds: float = 0.0
    analysis_shards: int = 1
    analysis_shard_seconds: Optional[List[float]] = None
    raw_row_nnz: Optional[np.ndarray] = None
    # host prework the planner ran while analysis launches were in flight
    wave2_overlap_seconds: float = 0.0
    wave2_overlapped: bool = False
    # estimate-vs-exact telemetry measured after the numeric pass
    estimation_accuracy: Optional[object] = None
    # workflow-decision audit record captured at plan-build time
    decision: Optional[Dict] = None
    # seconds of the timed steps (``trace.SUB_SPANS`` and their parents),
    # by span name, summed within the multiply; apart from stage_seconds
    span_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # device seconds of the bin launches by kind (dense, hash, esc); only
    # measured while tracing is on
    device_seconds: Optional[Dict[str, float]] = None
    # the plan's sizing: its predicted entries and the entries its slabs
    # reserve (``ExecutionPlan.pred_entries``, ``.alloc_entries``)
    pred_entries: float = 0.0
    alloc_entries: int = 0
    # rows of long-row launches sized past ``CAP_LADDER[-1]`` from their
    # exact sizes, and rows put in the ESC bin at plan time because no
    # long-row launch holds them (``ExecutionPlan.exact_wide_rows``,
    # ``.esc_routed_rows``)
    exact_wide_rows: int = 0
    esc_routed_rows: int = 0

    @property
    def total_seconds(self) -> float:
        return sum(self.stage_seconds.values())

    @property
    def setup_seconds(self) -> float:
        """Host-side planning time: analysis + prediction + binning, plus
        the plan-cache key hash/lookup when a cache was consulted."""
        return sum(self.stage_seconds.get(k, 0.0)
                   for k in ("plan_lookup", "analysis", "prediction",
                             "binning", "partition"))

    @property
    def merge_overlap_frac(self) -> float:
        """Overlapped merge work as a fraction of all merge work, in
        [0, 1]."""
        merge_s = self.stage_seconds.get("merge", 0.0)
        if merge_s <= 0.0 or self.overlap_seconds <= 0.0:
            return 0.0
        return min(1.0, self.overlap_seconds / merge_s)

    def audit(self) -> List[str]:
        """Timing-field consistency audit; empty when consistent."""
        bad: List[str] = []
        for k, v in self.stage_seconds.items():
            if v < 0.0:
                bad.append(f"stage_seconds[{k!r}] negative: {v}")
        if self.overlap_seconds < 0.0:
            bad.append(f"overlap_seconds negative: {self.overlap_seconds}")
        if self.wave2_overlap_seconds < 0.0:
            bad.append("wave2_overlap_seconds negative: "
                       f"{self.wave2_overlap_seconds}")
        if not 0.0 <= self.merge_overlap_frac <= 1.0:
            bad.append(f"merge_overlap_frac out of [0, 1]: "
                       f"{self.merge_overlap_frac}")
        merge_s = self.stage_seconds.get("merge")
        if merge_s is not None and self.overlap_seconds > merge_s * (
                1.0 + 1e-9):
            bad.append(f"overlap_seconds {self.overlap_seconds} exceeds "
                       f"parent merge time {merge_s}")
        for s in self.analysis_shard_seconds or ():
            if s < 0.0:
                bad.append(f"analysis_shard_seconds entry negative: {s}")
        if self.setup_seconds > self.total_seconds * (1.0 + 1e-9):
            bad.append(f"setup_seconds {self.setup_seconds} exceeds "
                       f"total_seconds {self.total_seconds}")
        for parent, children in trace.SUB_SPANS.items():
            inner = sum(self.span_seconds.get(c, 0.0) for c in children)
            outer = self.span_seconds.get(parent, 0.0)
            if inner > outer * (1.0 + 1e-9):
                bad.append(f"span_seconds of {children} sum to {inner}, "
                           f"over their parent {parent!r}'s {outer}")
        return bad


def gather_rows(a: CSR, rows: np.ndarray) -> CSR:
    """Sub-CSR of the selected rows (order preserved), on A's device."""
    new_ptr, src = flat_gather_index(host(a.indptr), rows)
    src_t = torch.from_numpy(src).to(a.device)
    return csr_from_arrays(new_ptr, a.indices[src_t], a.values[src_t],
                           (len(rows), a.n), device=a.device)


# ---------------------------------------------------------------------------
# Symbolic prediction
# ---------------------------------------------------------------------------

def _counted_mask(out_lo, out_hi, live) -> np.ndarray:
    """``live`` rows whose output column range fits the widest dense window
    (``WINDOW_LADDER[-1]`` columns, the width of the count kernel's per-row
    bitmap). Rows that are not live carry sentinel ranges, which the
    subtraction may wrap; they are masked out."""
    return live & (np.asarray(out_hi) - np.asarray(out_lo)
                   < WINDOW_LADDER[-1])


def counted_rows(out_lo, out_hi, products) -> np.ndarray:
    """The rows the count kernel takes, ascending: rows with products whose
    output column range fits the widest dense window."""
    live = np.asarray(products) > 0
    return np.nonzero(_counted_mask(out_lo, out_hi, live))[0]


def symbolic_row_nnz(a: CSR, b: CSR, out_lo, out_hi,
                     products) -> np.ndarray:
    """Exact output nnz of every row of A @ B: (m,) int64, equal to
    ``esc.symbolic_exact``. The rows of :func:`counted_rows` go through the
    count kernel in one launch; the other rows with products through
    ``esc.symbolic_exact`` on their gathered sub-A."""
    dev = a.device
    products = np.asarray(products)
    pred = torch.zeros(a.m, dtype=torch.int64, device=dev)
    live = products > 0
    counted = _counted_mask(out_lo, out_hi, live)
    rows = np.nonzero(counted)[0]
    if len(rows):
        kops.count_rows_op(a, b, rows, np.asarray(out_lo)[rows],
                           products[rows], pred)
    rest = np.nonzero(live & ~counted)[0]
    if len(rest):
        new_ptr, src = flat_gather_index(host(a.indptr).astype(np.int64),
                                         rest)
        sub_ptr = torch.from_numpy(new_ptr).to(dev)
        sub_idx = a.indices[torch.from_numpy(src).to(dev)]
        pred[torch.from_numpy(rest).to(dev)] = esc_mod.symbolic_exact(
            sub_ptr, sub_idx, b.indptr, b.indices, num_rows_a=len(rest),
            n_cols_b=b.n)
    return host(pred)


# ---------------------------------------------------------------------------
# Plan containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DenseBinExec:
    """One dense-accumulator bin with its structure-only kernel inputs
    (tensors on the plan's device)."""
    window: int
    col_tiles: int
    cap: int
    rows: np.ndarray
    out_rows: torch.Tensor     # (R,) int64 ``rows`` on the plan's device
    ell_width: int
    is_longrow: bool
    pos: torch.Tensor          # (R, ell) int64 gather into A's nnz arrays
    valid: torch.Tensor        # (R, ell) bool
    a_rows: torch.Tensor       # (R, ell) int32 B-row ids
    a_starts: torch.Tensor     # (R, ell) int32
    a_lens: torch.Tensor       # (R, ell) int32
    row_lo: torch.Tensor       # (R, 1) int32
    cost: np.ndarray           # (R,) int64 per-row estimated products
    bin_id: int                # position in the plan's bin ladder (shard
                               # slices keep it, and so do the launches
                               # of a long-row bin split by exact size)
    n_valid: int               # real rows (slices are not padded: == R)


@dataclasses.dataclass
class HashBinExec:
    """One hash-accumulator bin with its structure-only kernel inputs.
    ``f_chunk``/``tile`` are the reference's fixed knobs, carried and
    ignored by the CUDA kernel."""
    table: int
    spill: int
    rows: np.ndarray
    out_rows: torch.Tensor     # (R,) int64 ``rows`` on the plan's device
    ell_width: int
    pos: torch.Tensor
    valid: torch.Tensor
    a_rows: torch.Tensor
    a_starts: torch.Tensor
    a_lens: torch.Tensor
    cost: np.ndarray
    bin_id: int
    n_valid: int
    f_chunk: int = 128
    tile: int = 8


@dataclasses.dataclass
class EscExec:
    """The ESC bin: sub-CSR structure (on the plan's device) + capacity."""
    rows: np.ndarray
    out_rows: torch.Tensor     # (R,) int64 ``rows`` on the plan's device
    sub_indptr: torch.Tensor   # (rows+1,) int32
    sub_indices: torch.Tensor  # gathered column ids
    src: torch.Tensor          # int64 gather into A's values (A's device)
    out_cap: int               # the bin's exact product count
    cost: np.ndarray           # per-row product counts
    n_valid: int


@dataclasses.dataclass
class ExecutionPlan:
    """Everything value-independent about one (A-pattern, B-pattern) pair."""
    key: Optional[str]
    shape_a: Tuple[int, int]
    shape_b: Tuple[int, int]
    workflow: str
    assisted: bool
    hybrid: bool
    cfg: OceanConfig
    products: np.ndarray       # (m,) int64 per-row intermediate products
    out_lo: np.ndarray
    dense: List[DenseBinExec]
    esc: Optional[EscExec]
    empty_rows: np.ndarray
    bins_describe: Dict[str, int]
    er: float
    sampled_cr: Optional[float]
    nproducts_avg: float
    total_products: int
    m_regs: int
    b_sketches: Optional[torch.Tensor]
    hash: List[HashBinExec] = dataclasses.field(default_factory=list)
    build_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # how the analysis stage ran when this plan was built
    analysis_shards: int = 1
    analysis_shard_seconds: Optional[List[float]] = None
    feed_forward: bool = False
    wave2_overlap_seconds: float = 0.0
    wave2_overlapped: bool = False
    # the per-row size prediction binning consumed (float64)
    pred_row_nnz: Optional[np.ndarray] = None
    decision: Optional[Dict] = None

    @property
    def pred_entries(self) -> float:
        """Sum of the predicted row sizes the bins were sized from."""
        return (0.0 if self.pred_row_nnz is None
                else float(self.pred_row_nnz.sum()))

    @property
    def alloc_entries(self) -> int:
        """Entries the plan's slabs reserve: rows x cap for a dense bin,
        rows x (table + spill) for a hash bin, and the ESC bin's
        products."""
        return (sum(len(d.rows) * d.cap for d in self.dense)
                + sum(len(h.rows) * (h.table + h.spill) for h in self.hash)
                + (self.esc.out_cap if self.esc is not None else 0))

    @property
    def exact_wide_rows(self) -> int:
        """Rows of long-row launches sized past ``CAP_LADDER[-1]`` from
        their exact sizes (:func:`exact_longrow_launches`)."""
        return sum(len(d.rows) for d in self.dense
                   if d.is_longrow and d.cap > CAP_LADDER[-1])

    @property
    def esc_routed_rows(self) -> int:
        """Rows of the ESC bin past the ``BinPlan``'s: rows no long-row
        launch holds, put there at plan time."""
        return (0 if self.esc is None
                else len(self.esc.rows) - self.bins_describe["esc"])


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

def exact_longrow_launches(bn: DenseBin, size: np.ndarray,
                           a_row_nnz: np.ndarray, max_cap: int
                           ) -> Tuple[List[DenseBin], np.ndarray]:
    """The launches of long-row bin ``bn`` when ``size`` holds each row's
    exact output nnz (the symbolic and known workflows): ``(launches,
    esc_rows)``.

    ``plan_bins`` clamps every cap at ``CAP_LADDER[-1]``, so a row past it
    would fill its slab, overflow and run again through the exact ESC
    fallback. Here such a row gets the power of two at or above its size,
    at most ``max_cap`` and the bin's width, one launch per cap, each with
    the ELL width of its own rows; a row past ``max_cap`` goes to the ESC
    bin (``esc_rows``) and is never launched in a slab. The other rows
    keep the bin's cap in a launch of their own, so a bin with no row past
    the ladder comes back as it is."""
    rows = bn.rows
    size = np.asarray(size, np.float64)[rows]
    wide = size > CAP_LADDER[-1]
    if not wide.any():
        return [bn], np.zeros(0, np.int64)
    exp2 = 2 ** np.ceil(np.log2(np.maximum(size, 1.0)))
    cap_of = np.minimum(np.minimum(exp2, max_cap),
                        bn.window * bn.col_tiles).astype(np.int64)
    to_esc = wide & (size > max_cap)
    groups = [(~wide, bn.cap)] + [
        (wide & ~to_esc & (cap_of == c), int(c))
        for c in np.unique(cap_of[wide & ~to_esc])]
    launches = []
    for sel, cap in groups:
        if sel.any():
            r = rows[sel]
            launches.append(DenseBin(
                window=bn.window, col_tiles=bn.col_tiles, cap=cap, rows=r,
                ell_width=pow2_at_least(int(a_row_nnz[r].max()), floor=8),
                cost=bn.cost[sel]))
    return launches, rows[to_esc]


def pattern_arrays(a: CSR, b: CSR) -> List[torch.Tensor]:
    """The arrays the plan key fingerprints: A's indptr and indices[:nnz],
    then B's."""
    return [a.indptr, a.indices[: a.nnz], b.indptr, b.indices[: b.nnz]]


def key_attrs(a: CSR, b: CSR) -> Dict[str, object]:
    """The ``plan.key`` span's attrs: the pattern bytes the key
    fingerprints and the fingerprint's path (``cuda`` or ``plain``)."""
    return {"bytes": sum(x.numel() * x.element_size()
                         for x in pattern_arrays(a, b)),
            "path": fingerprint_path(a.device)}


def structure_key(a: CSR, b: CSR, cfg: OceanConfig,
                  force_workflow: Optional[str], assisted: bool,
                  hybrid: bool,
                  known_sizes: Optional[np.ndarray] = None) -> str:
    """Cache key: the device fingerprint of both sparsity patterns (every
    index of A's and B's indptr and indices[:nnz], on their device; 16
    bytes come back), hashed on the host with both shapes and nnz, the
    index dtypes, every planning knob and the device. Values are excluded:
    plans are structure-only."""
    arrays = pattern_arrays(a, b)
    h = hashlib.blake2b(digest_size=16)
    for lane in pattern_fingerprint(arrays):
        h.update(lane.to_bytes(8, "little"))
    h.update(repr((a.shape, a.nnz, b.shape, b.nnz,
                   [str(x.dtype) for x in arrays], cfg, force_workflow,
                   assisted, hybrid, str(a.device))).encode())
    if known_sizes is not None:
        h.update(b"|known|")
        h.update(np.ascontiguousarray(
            np.asarray(known_sizes, np.int64)).tobytes())
    return h.hexdigest()


def build_plan(a: CSR, b: CSR, cfg: OceanConfig = OceanConfig(), *,
               force_workflow: Optional[str] = None, assisted: bool = True,
               hybrid: bool = True, analysis: Optional[AnalysisResult] = None,
               sketch_cache: Optional[Dict] = None,
               key: Optional[str] = None,
               analysis_devices=None,
               known_sizes: Optional[np.ndarray] = None) -> ExecutionPlan:
    """Run analysis -> size prediction -> binning and freeze the result.

    ``analysis_devices`` shards the analysis and, on the estimation
    workflow, the prediction's sketch merge across a device set; both are
    bit-identical to the single-device run, so the plan key leaves it out.
    The symbolic prediction stays on the inputs' device."""
    if a.device != b.device:
        raise ValueError(f"A on {a.device}, B on {b.device}")
    dev = a.device
    on_cpu = dev.type == "cpu"
    stage: Dict[str, float] = {}
    a_ptr_host = host(a.indptr).astype(np.int64)
    a_row_nnz = a_ptr_host[1:] - a_ptr_host[:-1]

    # Host prework run while the analysis launches are in flight: the ESC
    # bin's structure on the upper-bound path and, on the CPU, the whole
    # symbolic prediction when Table 1 cannot pick estimation.
    prework: Dict[str, object] = {}

    def _wave2_prework(prod_host: np.ndarray) -> None:
        if known_sizes is not None:
            return
        prods = np.asarray(prod_host, np.int64)
        total = int(prods.sum())
        avg = total / max(a.m, 1)
        if force_workflow in (None, "upper_bound") and hybrid and (
                force_workflow == "upper_bound"
                or avg < cfg.upper_bound_avg_products):
            from .binning import ESC_THRESHOLD
            esc_rows = np.nonzero((prods > 0) & (prods < ESC_THRESHOLD))[0]
            sub_ptr, src = flat_gather_index(a_ptr_host, esc_rows)
            prework.update(esc_rows=esc_rows, sub_ptr=sub_ptr, src=src,
                           p_cap=int(prods[esc_rows].sum()))
            return
        er = total / max(a.nnz, 1)
        certain_symbolic = (force_workflow == "symbolic"
                            or (force_workflow is None
                                and avg >= cfg.upper_bound_avg_products
                                and er < cfg.er_threshold))
        if certain_symbolic and on_cpu:
            prework["symbolic_pred"] = np.asarray(
                esc_mod.symbolic_exact_host(
                    a_ptr_host, host(a.indices), host(b.indptr),
                    host(b.indices), num_rows_a=a.m, n_cols_b=b.n),
                np.float64)

    # ---------------- analysis ----------------
    t0 = time.perf_counter()
    ov_s, ov_pending = 0.0, False
    if analysis is None:
        analysis = analyze(a, b, cfg, sketch_cache=sketch_cache,
                           devices=analysis_devices,
                           known_sizes=known_sizes,
                           overlap_work=_wave2_prework)
        ov_s = analysis.wave2_overlap_seconds
        ov_pending = analysis.wave2_overlapped
    if known_sizes is None and analysis.known_sizes is not None:
        known_sizes = analysis.known_sizes
    wf = ("known" if known_sizes is not None
          else (force_workflow or analysis.workflow))
    products = np.asarray(analysis.products_row, np.int64)
    total_products = analysis.total_products
    out_lo = np.asarray(analysis.out_lo)
    out_hi = np.asarray(analysis.out_hi)
    stage["analysis"] = time.perf_counter() - t0
    trace.add_span("plan.analysis", t0, stage["analysis"], workflow=wf)

    # ---------------- size prediction ----------------
    t0 = time.perf_counter()
    sketches = analysis.b_sketches
    if wf == "known":
        pred = np.asarray(known_sizes, np.float64)
        pred = np.where(products > 0, np.maximum(pred, 1.0), 0.0)
        pred = np.minimum(pred, products)
    elif wf == "estimation":
        if sketches is None:
            sketches = sketches_for(b, analysis.m_regs, cfg.seed,
                                    sketch_cache)
        # the sketches end in the all-zero sentinel row, the merge's pad
        est = sharded_merge_estimate(a, sketches, clip_max=b.n,
                                     devices=analysis_devices)
        pred = np.maximum(np.asarray(est, np.float64), 1.0)
        pred = np.where(products > 0, pred, 0.0)
        pred = np.minimum(pred, products)  # distinct count <= products
    elif wf == "symbolic":
        pred = prework.get("symbolic_pred")
        if pred is None and on_cpu:
            pred = np.asarray(esc_mod.symbolic_exact_host(
                a_ptr_host, host(a.indices), host(b.indptr), host(b.indices),
                num_rows_a=a.m, n_cols_b=b.n), np.float64)
        elif pred is None:
            pred = symbolic_row_nnz(a, b, out_lo, out_hi,
                                    products).astype(np.float64)
    else:  # upper_bound
        pred = products.astype(np.float64)
    stage["prediction"] = time.perf_counter() - t0
    trace.add_span("plan.prediction", t0, stage["prediction"])

    # ---------------- binning ----------------
    t0 = time.perf_counter()
    assisted_cr = analysis.conservative_cr if (assisted and wf == "upper_bound"
                                               and analysis.cr_mean) else None
    hash_enabled = hybrid and cfg.hash_rung
    hash_cfg = tuning_mod.DEFAULT_TUNING
    plan = plan_bins(pred, products, out_lo, out_hi, a_row_nnz, b.n,
                     expansion=cfg.expansion_for(analysis.m_regs),
                     workflow=wf, esc_enabled=hybrid,
                     assisted_cr=assisted_cr, hash_enabled=hash_enabled,
                     load_factor=hash_cfg.load_factor,
                     tile_rows=hash_cfg.tile_rows)
    if not hybrid:
        # V1/V2: long rows fall back to the global ESC pass instead of the
        # column-tiled kernel (the paper's 'nonadaptive global kernel')
        longrow_rows = np.concatenate(
            [bn.rows for bn in plan.dense_bins if bn.is_longrow]
            or [np.zeros(0, np.int64)])
        plan = BinPlan(
            dense_bins=[bn for bn in plan.dense_bins if not bn.is_longrow],
            esc_rows=np.concatenate([plan.esc_rows, longrow_rows]),
            esc_caps=np.concatenate(
                [plan.esc_caps, products[longrow_rows]]),
            empty_rows=plan.empty_rows, hash_bins=plan.hash_bins)

    # on an exact workflow a long-row bin launches at its rows' own sizes;
    # each launch keeps its bin's id
    dense_execs: List[DenseBinExec] = []
    routed = [np.zeros(0, np.int64)]
    for bin_id, bin_ in enumerate(plan.dense_bins):
        launches = [bin_]
        if wf in ("symbolic", "known") and bin_.is_longrow:
            launches, to_esc = exact_longrow_launches(
                bin_, pred, a_row_nnz, kdense.longrow_max_cap(
                    dev, bin_.window * bin_.col_tiles))
            routed.append(to_esc)
        for bn in launches:
            out_rows, pos, valid, a_rows, a_starts, a_lens = \
                kops.prep_bin_structure(a, b, bn.rows, bn.ell_width)
            lo_arr = (out_lo[bn.rows] if not bn.is_longrow
                      else np.zeros(len(bn.rows)))
            row_lo = torch.from_numpy(
                lo_arr.reshape(-1, 1).astype(np.int32)).to(dev)
            dense_execs.append(DenseBinExec(
                window=bn.window, col_tiles=bn.col_tiles, cap=bn.cap,
                rows=bn.rows, out_rows=out_rows, ell_width=bn.ell_width,
                is_longrow=bn.is_longrow, pos=pos, valid=valid,
                a_rows=a_rows, a_starts=a_starts, a_lens=a_lens,
                row_lo=row_lo, cost=np.asarray(bn.cost, np.int64),
                bin_id=bin_id, n_valid=len(bn.rows)))

    hash_execs: List[HashBinExec] = []
    for hash_id, hb in enumerate(plan.hash_bins):
        out_rows, pos, valid, a_rows, a_starts, a_lens = \
            kops.prep_bin_structure(a, b, hb.rows, hb.ell_width)
        hash_execs.append(HashBinExec(
            table=hb.table, spill=hb.spill, rows=hb.rows, out_rows=out_rows,
            ell_width=hb.ell_width, pos=pos, valid=valid, a_rows=a_rows,
            a_starts=a_starts, a_lens=a_lens,
            cost=np.asarray(hb.cost, np.int64),
            bin_id=len(plan.dense_bins) + hash_id, n_valid=len(hb.rows),
            f_chunk=hash_cfg.f_chunk, tile=hash_cfg.tile_rows))

    esc_exec = None
    routed = np.concatenate(routed)
    rows = np.concatenate([plan.esc_rows, routed])
    if len(rows):
        if (prework.get("esc_rows") is not None
                and np.array_equal(prework["esc_rows"], rows)):
            sub_ptr, src = prework["sub_ptr"], prework["src"]
            p_cap = prework["p_cap"]
        else:
            sub_ptr, src = flat_gather_index(a_ptr_host, rows)
            p_cap = int(products[rows].sum())
        src_t = torch.from_numpy(src).to(dev)
        esc_exec = EscExec(
            rows=rows,
            out_rows=torch.as_tensor(rows, dtype=torch.int64).to(dev),
            sub_indptr=torch.from_numpy(sub_ptr.astype(np.int32)).to(dev),
            sub_indices=a.indices[src_t], src=src_t, out_cap=p_cap,
            cost=np.concatenate([np.asarray(plan.esc_costs, np.int64),
                                 products[routed]]), n_valid=len(rows))
    stage["binning"] = time.perf_counter() - t0

    decision = obs_accuracy.record_decision(
        workflow=wf, forced=force_workflow, feed_forward=(wf == "known"),
        er=analysis.er, sampled_cr=analysis.sampled_cr,
        nproducts_avg=analysis.nproducts_avg, cfg=cfg)

    frozen = ExecutionPlan(
        key=key, shape_a=a.shape, shape_b=b.shape, workflow=wf,
        assisted=assisted, hybrid=hybrid, cfg=cfg, products=products,
        out_lo=out_lo, dense=dense_execs, esc=esc_exec, hash=hash_execs,
        empty_rows=plan.empty_rows, bins_describe=plan.describe(),
        er=analysis.er, sampled_cr=analysis.sampled_cr,
        nproducts_avg=analysis.nproducts_avg, total_products=total_products,
        m_regs=analysis.m_regs, b_sketches=sketches
        if wf == "estimation" else analysis.b_sketches,
        build_seconds=stage, analysis_shards=analysis.n_shards,
        analysis_shard_seconds=analysis.shard_seconds,
        feed_forward=(wf == "known"),
        wave2_overlap_seconds=ov_s, wave2_overlapped=ov_pending,
        pred_row_nnz=np.asarray(pred, np.float64), decision=decision)
    trace_binning(frozen, t0, stage["binning"])
    return frozen


def trace_binning(plan: ExecutionPlan, t0: float,
                  seconds: Optional[float] = None, **attrs) -> None:
    """Span ``plan.binning`` with the plan's sizing counters as attrs
    (nothing is summed while tracing is off). ``seconds`` None (a replay)
    spans the counters' reading from ``t0``, so the span is never empty."""
    if trace.enabled():
        pred, alloc = plan.pred_entries, plan.alloc_entries
        if seconds is None:
            seconds = time.perf_counter() - t0
        trace.add_span("plan.binning", t0, seconds, pred_entries=pred,
                       alloc_entries=alloc,
                       exact_wide_rows=plan.exact_wide_rows,
                       esc_routed_rows=plan.esc_routed_rows, **attrs)


def execute_plan(plan: ExecutionPlan, a: CSR, b: CSR, *,
                 stage: Optional[Dict[str, float]] = None,
                 cache_hit: bool = False,
                 post=None,
                 span_seconds: Optional[Dict[str, float]] = None,
                 ) -> Tuple[CSR, OceanReport]:
    """Run a frozen plan against (possibly new) values of A and B, with
    optional fused ``post`` (``executor.MergePostOps``)."""
    from .executor import execute_plan as _execute
    return _execute(plan, a, b, stage=stage, cache_hit=cache_hit, post=post,
                    span_seconds=span_seconds)


def execute_sharded_plan(splan, a: CSR, b: CSR, *,
                         stage: Optional[Dict[str, float]] = None,
                         cache_hit: bool = False,
                         post=None,
                         span_seconds: Optional[Dict[str, float]] = None,
                         ) -> Tuple[CSR, OceanReport]:
    """Run a :class:`~repro_torch.core.partition.ShardedPlan` across its
    devices through the same executor pipeline."""
    from .executor import execute_sharded_plan as _execute
    return _execute(splan, a, b, stage=stage, cache_hit=cache_hit,
                    post=post, span_seconds=span_seconds)


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------

class PlanCache:
    """Thread-safe LRU cache of plans keyed by structure hash.

    Multi-tenant serving (``repro_torch.serving``) shares one cache across
    tenants through :meth:`namespaced` views: each tenant's keys live under
    a private prefix, and its inserts are tagged with the tenant so that
    eviction can be fair. With ``tenant_quota`` set, a tenant over its
    quota evicts *its own* least-recently-used entry first; only then does
    the global ``maxsize`` LRU bound apply across all tenants."""

    def __init__(self, maxsize: int = 32,
                 tenant_quota: Optional[int] = None):
        self.maxsize = maxsize
        self.tenant_quota = tenant_quota
        self._plans: "OrderedDict[str, ExecutionPlan]" = OrderedDict()
        self._tenant_of: Dict[str, str] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def lookup(self, key: str):
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return plan

    def peek(self, key: str):
        """Non-counting lookup (still refreshes LRU recency)."""
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
            return plan

    def insert(self, key: str, plan, tenant: Optional[str] = None) -> None:
        with self._lock:
            self._plans[key] = plan
            self._plans.move_to_end(key)
            if tenant is not None:
                self._tenant_of[key] = tenant
            else:
                self._tenant_of.pop(key, None)
            if tenant is not None and self.tenant_quota:
                # fairness first: an over-quota tenant recycles its own
                # LRU slot instead of pushing another tenant's plan out
                mine = [k for k in self._plans
                        if self._tenant_of.get(k) == tenant]
                for k in mine[:max(0, len(mine) - self.tenant_quota)]:
                    del self._plans[k]
                    del self._tenant_of[k]
            while len(self._plans) > self.maxsize:
                k, _ = self._plans.popitem(last=False)
                self._tenant_of.pop(k, None)

    def namespaced(self, tenant: str) -> "TenantPlanCache":
        """A per-tenant view of this cache (see :class:`TenantPlanCache`)."""
        return TenantPlanCache(self, tenant)

    def tenant_sizes(self) -> Dict[str, int]:
        """Live entry count per tenant (untagged entries excluded)."""
        with self._lock:
            out: Dict[str, int] = {}
            for k in self._plans:
                t = self._tenant_of.get(k)
                if t is not None:
                    out[t] = out.get(t, 0) + 1
            return out

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self._tenant_of.clear()
            self.hits = 0
            self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "size": len(self._plans)}


class TenantPlanCache:
    """Per-tenant namespace view over a shared :class:`PlanCache`.

    Prefixes every key with the tenant id, so two tenants multiplying the
    same structures get separate entries, and tags inserts with the
    tenant so the base cache's quota applies. Offers the
    ``lookup``/``peek``/``insert`` surface ``ocean_spgemm`` consumes, so a
    view drops straight in as ``cache=``."""

    _SEP = "\x1f"  # never appears in hex structure keys

    def __init__(self, base: PlanCache, tenant: str):
        self.base = base
        self.tenant = tenant

    def _k(self, key: str) -> str:
        return f"{self.tenant}{self._SEP}{key}"

    def lookup(self, key: str):
        return self.base.lookup(self._k(key))

    def peek(self, key: str):
        return self.base.peek(self._k(key))

    def insert(self, key: str, plan) -> None:
        self.base.insert(self._k(key), plan, tenant=self.tenant)

    def stats(self) -> Dict[str, int]:
        return self.base.stats()

    def __len__(self) -> int:
        return self.base.tenant_sizes().get(self.tenant, 0)


DEFAULT_PLAN_CACHE = PlanCache()
