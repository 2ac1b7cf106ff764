"""Ocean's analysis step (paper §3.2, §4.3): cheap statistics + sampling that
select the workflow and configure the accumulators.

PyTorch port of the single-device path of ``repro.core.analysis``. The
three statistics stages (products per row, B column ranges, output column
ranges) run as integer segment reductions on the inputs' device in one
pass, their results copy back asynchronously, and the host tail (sampled
CR, Table-1 selection) is the reference's numpy, unchanged. The sharded
``AnalysisPipeline`` is not ported yet (ROADMAP queue 1, item 5).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels import hll as khll
from ..kernels import ops as kops
from ..obs import trace
from .dispatch import (Launch, host_arrays, mark_in_flight,
                       overlap_host_work, resolve_devices,
                       start_async_host_copies)
from .formats import CSR, flat_gather_index, host
from .hll import row_ids_from_indptr

_INT32_MAX = np.iinfo(np.int32).max
_INT32_MIN = np.iinfo(np.int32).min


@dataclasses.dataclass(frozen=True)
class OceanConfig:
    """Paper §4.3 constants (faithful defaults)."""
    # HLL register count: 32 when ER < er_register_switch else 64.
    m_regs_small: int = 32
    m_regs_large: int = 64
    er_register_switch: float = 48.0
    # Workflow selection thresholds (Table 1).
    upper_bound_avg_products: float = 64.0
    er_threshold: float = 8.0
    cr_threshold: float = 8.0
    # Sampling (paper: ratio 0.03, clamped to [600, 10000]).
    sample_ratio: float = 0.03
    sample_min: int = 600
    sample_max: int = 10_000
    # Hash-table/bin expansion: 1.5x (2.0x at m=32 per §5.3).
    expansion: float = 1.5
    expansion_small_regs: float = 2.0
    # Assisted sizing (§4.1): conservative CR = mean - cr_sigma * std, >= 1.
    cr_sigma: float = 1.0
    # Dense-accumulator bitmap-query threshold (§4.1), kept for the cost
    # model/ablation bookkeeping.
    bitmap_query_cr: float = 2.0
    # Hash-accumulator rung (§3.3/§4.1); rides the hybrid switch.
    hash_rung: bool = True
    seed: int = 0

    def m_regs(self, er: float) -> int:
        return self.m_regs_small if er < self.er_register_switch else self.m_regs_large

    def expansion_for(self, m_regs: int) -> float:
        return self.expansion_small_regs if m_regs <= 32 else self.expansion


# ---------------------------------------------------------------------------
# Device statistics. Empty segments keep the reference's identities
# (INT32_MAX for minima, INT32_MIN for maxima) so every array matches it.
# ---------------------------------------------------------------------------

def _products_impl(a_indptr, a_indices, b_indptr, num_rows_a: int):
    row = row_ids_from_indptr(a_indptr[: num_rows_a + 1])
    b_len = (b_indptr[1:] - b_indptr[:-1]).long()
    k = a_indices[: row.shape[0]].long().clamp(0, b_len.shape[0] - 1)
    prod = torch.zeros(num_rows_a, dtype=torch.int64,
                       device=a_indices.device)
    return prod.index_add_(0, row, b_len[k])


def _segment_min_max(row, lo_vals, hi_vals, num_rows: int, device):
    lo = torch.full((num_rows,), _INT32_MAX, dtype=torch.int64, device=device)
    hi = torch.full((num_rows,), _INT32_MIN, dtype=torch.int64, device=device)
    lo.scatter_reduce_(0, row, lo_vals, "amin", include_self=True)
    hi.scatter_reduce_(0, row, hi_vals, "amax", include_self=True)
    return lo.int(), hi.int()


def _ranges_impl(indptr, indices, num_rows: int):
    row = row_ids_from_indptr(indptr[: num_rows + 1])
    idx = indices[: row.shape[0]].long()
    return _segment_min_max(row, idx, idx, num_rows, indices.device)


def _out_ranges_impl(a_indptr, a_indices, b_min, b_max, num_rows_a: int):
    row = row_ids_from_indptr(a_indptr[: num_rows_a + 1])
    k = a_indices[: row.shape[0]].long().clamp(0, b_min.shape[0] - 1)
    return _segment_min_max(row, b_min[k].long(), b_max[k].long(),
                            num_rows_a, a_indices.device)


def products_per_row(a_indptr, a_indices, b_indptr, *, num_rows_a: int):
    """Number of intermediate products per output row — O(nnz_A)."""
    return _products_impl(a_indptr, a_indices, b_indptr, num_rows_a)


def _fused_stats(a: CSR, b: CSR):
    prod = _products_impl(a.indptr, a.indices, b.indptr, a.m)
    b_min, b_max = _ranges_impl(b.indptr, b.indices, b.m)
    lo, hi = _out_ranges_impl(a.indptr, a.indices, b_min, b_max, a.m)
    return prod, lo, hi


@dataclasses.dataclass
class AnalysisResult:
    """Everything the workflow selector and binning need."""
    nnz_a: int
    nnz_b: int
    total_products: int
    products_row: np.ndarray         # (m,) int64
    er: float                        # Input Expansion Ratio
    nproducts_avg: float
    m_regs: int
    # (nB + 1, m_regs) uint8, B's rows and the zero sentinel (None if skipped)
    b_sketches: Optional[torch.Tensor]
    sampled_cr: Optional[float]      # Sampled Output Compression Ratio
    cr_mean: Optional[float]
    cr_std: Optional[float]
    out_lo: np.ndarray               # (m,) per-row output col-range bounds
    out_hi: np.ndarray
    workflow: str                    # 'upper_bound'|'estimation'|'symbolic'|'known'
    sample_rows: Optional[np.ndarray] = None
    known_sizes: Optional[np.ndarray] = None
    cr_sigma: float = 1.0
    wave2_overlap_seconds: float = 0.0
    wave2_overlapped: bool = False

    @property
    def conservative_cr(self) -> float:
        """§4.1 assisted sizing: mean - cr_sigma * std, clipped to >= 1."""
        if self.cr_mean is None:
            return 1.0
        return max(1.0, self.cr_mean - self.cr_sigma * self.cr_std)


def _pick_sample_rows(num_rows: int, cfg: OceanConfig) -> np.ndarray:
    n = int(round(num_rows * cfg.sample_ratio))
    n = int(np.clip(n, min(cfg.sample_min, num_rows), cfg.sample_max))
    rng = np.random.default_rng(cfg.seed)
    return rng.choice(num_rows, size=n, replace=False).astype(np.int32)


def sketches_for(b: CSR, m_regs: int, seed: int,
                 sketch_cache: Optional[Dict] = None) -> torch.Tensor:
    """B-row sketches with the merge's zero sentinel row, (nB + 1, m_regs)
    uint8, built by ``kops.build_sketches_op`` (the ``hll_sketch`` kernel on
    a GPU) and reused from ``sketch_cache`` (keyed by ``(m_regs, seed)``)
    when present."""
    key = (m_regs, seed)
    if sketch_cache is not None and key in sketch_cache:
        return sketch_cache[key]
    sk = kops.build_sketches_op(b, m_regs, seed)
    if sketch_cache is not None:
        sketch_cache[key] = sk
    return sk


class AnalysisPipeline:
    """Ocean's analysis, single device: one fused statistics pass, an async
    copy of its results, and the host tail (workflow gate + sampled CR)."""

    def __init__(self, cfg: OceanConfig = OceanConfig()):
        self.cfg = cfg

    def _needs_sketches(self, er: float, nproducts_avg: float,
                        build_sketches: bool) -> bool:
        return (build_sketches
                and nproducts_avg >= self.cfg.upper_bound_avg_products
                and er >= self.cfg.er_threshold)

    def run(self, a: CSR, b: CSR, *, build_sketches: bool = True,
            sketch_cache: Optional[Dict] = None,
            known_sizes: Optional[np.ndarray] = None,
            overlap_work=None) -> AnalysisResult:
        """``overlap_work(prod_row_host)``, when given, runs on the host
        while the statistics launches are still in flight."""
        if known_sizes is not None:
            known_sizes = np.asarray(known_sizes, np.int64)
            if known_sizes.shape != (a.m,):
                raise ValueError(
                    f"known_sizes shape {known_sizes.shape} != ({a.m},)")
            build_sketches = False
        t0_w1 = time.perf_counter()
        wave1 = [Launch("stats", 0, _fused_stats(a, b))]
        start_async_host_copies(wave1)
        trace.add_span("analysis.wave1", t0_w1,
                       time.perf_counter() - t0_w1, fused=True)
        ov_s, ov_pending = 0.0, False
        if overlap_work is not None:
            _, ov_s, ov_pending = overlap_host_work(
                wave1, lambda: overlap_work(host_arrays(wave1[0])[0]))

        t0_w2 = time.perf_counter()
        prod_row, out_lo, out_hi = host_arrays(wave1[0])
        trace.add_span("analysis.wave2", t0_w2, time.perf_counter() - t0_w2)
        return self._finish(
            a, b, prod_row=prod_row, out_lo=out_lo, out_hi=out_hi,
            build_sketches=build_sketches, sketch_cache=sketch_cache,
            known_sizes=known_sizes, wave2_overlap_seconds=ov_s,
            wave2_overlapped=ov_pending)

    def _finish(self, a: CSR, b: CSR, *, prod_row, out_lo, out_hi,
                build_sketches: bool, sketch_cache: Optional[Dict],
                known_sizes: Optional[np.ndarray] = None,
                wave2_overlap_seconds: float = 0.0,
                wave2_overlapped: bool = False) -> AnalysisResult:
        cfg = self.cfg
        total_products = int(np.asarray(prod_row, np.int64).sum())
        nnz_a, nnz_b = a.nnz, b.nnz
        er = total_products / max(nnz_a, 1)
        nproducts_avg = total_products / max(a.m, 1)
        m_regs = cfg.m_regs(er)
        common = dict(nnz_a=nnz_a, nnz_b=nnz_b, total_products=total_products,
                      products_row=prod_row, er=er,
                      nproducts_avg=nproducts_avg, m_regs=m_regs,
                      out_lo=out_lo, out_hi=out_hi, cr_sigma=cfg.cr_sigma,
                      wave2_overlap_seconds=wave2_overlap_seconds,
                      wave2_overlapped=wave2_overlapped)

        if known_sizes is not None:
            # exact sizes fed forward by the caller trump Table-1 selection
            return AnalysisResult(b_sketches=None, sampled_cr=None,
                                  cr_mean=None, cr_std=None,
                                  workflow="known", known_sizes=known_sizes,
                                  **common)
        if nproducts_avg < cfg.upper_bound_avg_products:
            return AnalysisResult(b_sketches=None, sampled_cr=None,
                                  cr_mean=None, cr_std=None,
                                  workflow="upper_bound", **common)

        sketches = None
        sampled_cr = cr_mean = cr_std = None
        sample_rows = None
        if self._needs_sketches(er, nproducts_avg, build_sketches):
            sketches = sketches_for(b, m_regs, cfg.seed, sketch_cache)
            # the sampling prework is host work independent of the sketch
            # values, so it runs while the sketch launch is in flight
            in_flight = [mark_in_flight(Launch("sketches", 0, (sketches,)))]

            def _sample_prework():
                rows = _pick_sample_rows(a.m, cfg)
                new_ptr, src = flat_gather_index(host(a.indptr), rows)
                return rows, new_ptr, src

            (sample_rows, new_ptr, src), est_s, est_pend = \
                overlap_host_work(in_flight, _sample_prework)
            wave2_overlap_seconds += est_s
            wave2_overlapped = wave2_overlapped or est_pend
            # the sample rows' column ids alone: the merge reads no values
            sub_ptr = torch.from_numpy(new_ptr.astype(np.int32)).to(a.device)
            sub_ids = a.indices[torch.from_numpy(src).to(a.device)]
            _, est = khll.hll_merge(sub_ptr, sub_ids, sketches)
            est = np.maximum(host(torch.clamp(est, 0.0, float(b.n))), 1.0)
            prods = np.asarray(prod_row)[sample_rows].astype(np.float64)
            mask = prods > 0
            if mask.any():
                per_row_cr = prods[mask] / est[mask]
                sampled_cr = float(prods[mask].sum() / est[mask].sum())
                cr_mean = float(per_row_cr.mean())
                cr_std = float(per_row_cr.std())
            else:
                sampled_cr, cr_mean, cr_std = 1.0, 1.0, 0.0

        if (er >= cfg.er_threshold and sampled_cr is not None
                and sampled_cr >= cfg.cr_threshold):
            workflow = "estimation"
        else:
            workflow = "symbolic"
        common.update(wave2_overlap_seconds=wave2_overlap_seconds,
                      wave2_overlapped=wave2_overlapped)
        return AnalysisResult(b_sketches=sketches, sampled_cr=sampled_cr,
                              cr_mean=cr_mean, cr_std=cr_std,
                              workflow=workflow, sample_rows=sample_rows,
                              **common)


def analyze(a: CSR, b: CSR, cfg: OceanConfig = OceanConfig(),
            build_sketches: bool = True,
            sketch_cache: Optional[Dict] = None,
            devices=None,
            known_sizes: Optional[np.ndarray] = None,
            overlap_work=None) -> AnalysisResult:
    """The Ocean analysis step. Selects the workflow per Table 1:

        upper_bound  if nproducts_avg < 64
        estimation   if nproducts_avg >= 64 and ER >= 8 and sampled CR >= 8
        symbolic     otherwise
    """
    resolve_devices(devices)
    return AnalysisPipeline(cfg).run(a, b, build_sketches=build_sketches,
                                     sketch_cache=sketch_cache,
                                     known_sizes=known_sizes,
                                     overlap_work=overlap_work)


def sharded_merge_estimate(a: CSR, sketches_with_sentinel, *,
                           clip_max: Optional[int] = None,
                           devices=None) -> np.ndarray:
    """Per-row HLL output-size estimates for C = A @ B (prediction stage).
    Single device only: the merge kernel reads A's CSR directly."""
    resolve_devices(devices)
    _, est = kops.merge_estimate_op(a, sketches_with_sentinel,
                                    clip_max=clip_max)
    return host(est)[: a.m]
