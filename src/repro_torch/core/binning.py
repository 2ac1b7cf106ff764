"""Per-row accumulator binning (paper §2.3 / §3.3 / §4.3).

Rows are assigned to accumulator configurations by two attributes:

* predicted output nnz (expansion-factored, rounded up the capacity ladder —
  exactly the paper's binning-absorbs-estimation-error mechanism), and
* output column-range width (bounds the dense VMEM window).

TPU note: GPU Ocean bins hash kernels by nnz and dense kernels by range.
The ladder here mirrors the paper's hybrid accumulator: an ESC bin for
short rows (upper-bound workflow only, as in the paper), hash bins — the
atomics-free probe-insert kernel in ``kernels.spgemm_hash`` — for
mid-density rows whose output columns scatter far wider than their nnz,
dense windows by range for the rest, and the column-tiled long-row kernel
when a non-hash row's range exceeds the widest VMEM window.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from .formats import pow2_at_least

# Dense VMEM window ladder. The largest window (4096 f32 accum + 4096 f32
# counts = 32 KB) times 8 concurrently-resident rows stays well under the
# ~16 MB/core VMEM budget with room for the B-row stream.
WINDOW_LADDER = (256, 512, 1024, 2048, 4096)
# Capacity (slab) ladder — the accumulator sizes rows are rounded up to.
CAP_LADDER = (32, 64, 128, 256, 512, 1024, 2048, 4096)
# Column tile for the long-row kernel.
LONGROW_TILE = 2048
# Paper: smallest block size / ESC threshold.
ESC_THRESHOLD = 64
# Hash-accumulator rung (paper §3.3/§4.1): largest primary-table size the
# per-row VMEM budget admits, the smallest table the ladder allocates, and
# the window-to-table advantage ratio required before a row leaves the
# dense ladder — a hash table only wins when the dense window it replaces
# would be substantially wider than the table (scattered output columns).
HASH_MAX_TABLE = 2048
HASH_MIN_TABLE = 32
HASH_ADVANTAGE = 4
# Primary-table load factor of every hash rung (``core.tuning``'s fixed
# ``DEFAULT_TUNING``).
HASH_LOAD_FACTOR = 0.75


def round_up_ladder(x: int, ladder=CAP_LADDER) -> int:
    for v in ladder:
        if x <= v:
            return v
    return ladder[-1]


def round_up_ladder_vec(x: np.ndarray, ladder=CAP_LADDER) -> np.ndarray:
    """Vectorized ``round_up_ladder`` over an array (clamped to the top)."""
    lad = np.asarray(ladder, np.int64)
    pos = np.searchsorted(lad, np.asarray(x, np.int64), side="left")
    return lad[np.minimum(pos, len(lad) - 1)]


def _round_up(x: int, mult: int) -> int:
    return max(mult, ((x + mult - 1) // mult) * mult)


@dataclasses.dataclass
class DenseBin:
    window: int               # dense window width (or tile width for longrow)
    col_tiles: int            # 1 for windowed bins; >1 for the long-row kernel
    cap: int                  # output slab width per row
    rows: np.ndarray          # row ids (original matrix row indices)
    ell_width: int            # padded A-row nnz width for this bin
    cost: np.ndarray          # per-row estimated product counts (aligned
                              # with ``rows``) — the load-balancing weight
                              # device partitioning splits on

    @property
    def is_longrow(self) -> bool:
        return self.col_tiles > 1


@dataclasses.dataclass
class HashBin:
    """One hash-accumulator bin: rows sharing a primary-table size.

    ``spill`` is a pure function of ``table`` (never of the rows that
    happen to share a launch), and ``tile`` is a bin-level property too
    (the fixed row tile the kernel probes per grid step — shard
    slices inherit it, never re-derive it from their own row counts), so
    every shard slice of the bin replays the same kernel shapes — the
    invariant bit-identical sharding needs.
    """
    table: int                # pow2 primary-table slots per row
    spill: int                # pow2 spill-table slots per row
    rows: np.ndarray          # row ids (original matrix row indices)
    ell_width: int            # padded A-row nnz width for this bin
    cost: np.ndarray          # per-row estimated product counts
    tile: int = 8             # rows per kernel grid step (fixed)


def hash_spill_of(table: int) -> int:
    """Spill-table size for a primary table: half the primary, floor 16 —
    the shared/global split ratio (§4.1) scaled to per-row tables."""
    return max(table // 2, 16)


@dataclasses.dataclass
class BinPlan:
    dense_bins: List[DenseBin]
    esc_rows: np.ndarray      # rows handled by the ESC accumulator
    esc_caps: np.ndarray      # per-row capacity for ESC rows
    empty_rows: np.ndarray    # rows with zero products
    hash_bins: List[HashBin] = dataclasses.field(default_factory=list)

    @property
    def esc_costs(self) -> np.ndarray:
        """Per-row estimated product counts for the ESC bin. ESC capacity
        *is* the product-count upper bound, so the cost vector coincides
        with ``esc_caps``; exposed under its own name so partitioning code
        reads as cost-based, not capacity-based."""
        return self.esc_caps

    def describe(self) -> Dict[str, int]:
        d = {f"dense_w{b.window}x{b.col_tiles}": len(b.rows)
             for b in self.dense_bins}
        for b in self.hash_bins:
            d[f"hash_t{b.table}"] = len(b.rows)
        d["esc"] = len(self.esc_rows)
        d["empty"] = len(self.empty_rows)
        return d


def plan_bins(pred_nnz: np.ndarray, products: np.ndarray,
              range_lo: np.ndarray, range_hi: np.ndarray,
              a_row_nnz: np.ndarray, n_cols: int, *,
              expansion: float, workflow: str,
              esc_enabled: bool = True,
              assisted_cr: float | None = None,
              hash_enabled: bool = True,
              load_factor: float = HASH_LOAD_FACTOR,
              tile_rows: int = 8) -> BinPlan:
    """Assign every output row to an accumulator configuration.

    pred_nnz:   per-row predicted output nnz (estimate / exact / upper bound)
    products:   per-row intermediate-product counts (safe upper bound)
    range_*:    per-row output column-range bounds from the analysis step
    a_row_nnz:  nnz of each A row (sizes the ELL blocks)
    expansion:  hash-expansion analogue applied to estimates (1.5x / 2.0x)
    workflow:   'upper_bound' | 'estimation' | 'symbolic' | 'known'
                ('known' = exact sizes fed forward from a prior numeric
                pass — binned like symbolic: no expansion slack; a stale
                feed is absorbed by the overflow fallback like any other
                undersized bin)
    assisted_cr: §4.1 — divide upper-bound capacities by a conservative CR.
    hash_enabled: select the hash-accumulator rung for mid-density rows
                whose output columns are scattered across a window much
                wider than their predicted nnz (compression ratio between
                the ESC and dense thresholds). Disabled in the V1/V2
                ablations alongside ESC.
    load_factor: primary hash tables are sized ``pow2(alloc/load_factor)``
                (the planner passes ``core.tuning.DEFAULT_TUNING``'s).
    tile_rows:  rows the hash kernel probes vectorized per grid step
                (``core.tuning.DEFAULT_TUNING`` again); stamped onto every
                :class:`HashBin` so shard slices share the bin's tile.
    """
    m = len(pred_nnz)
    products = np.asarray(products)
    pred = np.asarray(pred_nnz, np.float64)

    if workflow == "estimation":
        alloc = np.ceil(pred * expansion)
    elif workflow == "upper_bound":
        alloc = pred.copy()
        if assisted_cr is not None and assisted_cr > 1.0:
            # assisted sizing, still clamped to a hard upper bound's safety
            alloc = np.maximum(np.ceil(pred / assisted_cr), 1.0)
    else:  # symbolic / known: exact sizes, no slack needed
        alloc = pred.copy()
    # capacity can never usefully exceed the range width or the product count
    width = np.maximum(range_hi - range_lo + 1, 0)
    alloc = np.minimum(alloc, np.maximum(width, 1))
    alloc = np.minimum(alloc, np.maximum(products, 1))

    empty = products == 0
    esc_mask = np.zeros(m, bool)
    if esc_enabled and workflow == "upper_bound":
        # Paper §3.3: ESC only in the upper-bound workflow, for short rows.
        esc_mask = (~empty) & (products < ESC_THRESHOLD)

    dense_mask = (~empty) & (~esc_mask)
    caps = round_up_ladder_vec(alloc)

    # Hash rung (paper §3.3): rows whose predicted nnz fits a VMEM-sized
    # table but whose output columns scatter across a window at least
    # HASH_ADVANTAGE times wider than that table. Dense accumulation would
    # pay for the whole window; the hash table pays only for the nnz.
    # Sufficiently sparse long rows (width > the widest dense window) are
    # absorbed here too instead of the column-tiled re-streaming kernel.
    hash_mask = np.zeros(m, bool)
    table_of = np.zeros(m, np.int64)
    if hash_enabled:
        want = np.ceil(np.maximum(alloc, 1.0) / max(load_factor, 1e-3))
        exp2 = 2 ** np.ceil(np.log2(np.maximum(want, 1.0)))
        table_of = np.maximum(exp2.astype(np.int64), HASH_MIN_TABLE)
        hash_mask = (dense_mask & (table_of <= HASH_MAX_TABLE)
                     & (np.asarray(width, np.int64)
                        >= HASH_ADVANTAGE * table_of))
        dense_mask &= ~hash_mask

    idx = np.nonzero(dense_mask)[0]
    max_w = WINDOW_LADDER[-1]
    # vectorized window assignment: every dense row gets a (window, tiles)
    # key; rows sharing a key share one kernel instantiation.
    w_idx = np.asarray(width, np.int64)[idx]
    cap_idx = np.minimum(caps[idx], max_w)
    window_of = round_up_ladder_vec(np.maximum(w_idx, cap_idx), WINDOW_LADDER)
    longrow = w_idx > max_w
    tiles_long = int(np.ceil(n_cols / LONGROW_TILE)) if longrow.any() else 1
    window_of = np.where(longrow, LONGROW_TILE, window_of)
    tiles_of = np.where(longrow, tiles_long, 1)

    dense_bins = []
    key = window_of * (2**20) + tiles_of  # lexicographic (window, tiles)
    uniq, inverse = np.unique(key, return_inverse=True)
    order = np.argsort(inverse, kind="stable")  # groups, rows ascending
    bounds = np.searchsorted(inverse[order], np.arange(len(uniq) + 1))
    for g in range(len(uniq)):
        rows_arr = idx[order[bounds[g] : bounds[g + 1]]]
        window = int(uniq[g] // 2**20)
        tiles = int(uniq[g] % 2**20)
        bin_cap = int(min(int(caps[rows_arr].max()), window * tiles))
        ell = pow2_at_least(int(a_row_nnz[rows_arr].max()), floor=8)
        dense_bins.append(DenseBin(window=window, col_tiles=tiles,
                                   cap=bin_cap, rows=rows_arr,
                                   ell_width=ell,
                                   cost=products[rows_arr].astype(np.int64)))

    hash_bins = []
    hidx = np.nonzero(hash_mask)[0]
    if len(hidx):
        tkeys = table_of[hidx]
        for t in np.unique(tkeys):
            rows_arr = hidx[tkeys == t]
            ell = pow2_at_least(int(a_row_nnz[rows_arr].max()), floor=8)
            hash_bins.append(HashBin(
                table=int(t), spill=hash_spill_of(int(t)), rows=rows_arr,
                ell_width=ell, cost=products[rows_arr].astype(np.int64),
                tile=int(tile_rows)))

    esc_rows = np.nonzero(esc_mask)[0]
    esc_caps = products[esc_rows].astype(np.int64)
    return BinPlan(dense_bins=dense_bins, esc_rows=esc_rows,
                   esc_caps=esc_caps, empty_rows=np.nonzero(empty)[0],
                   hash_bins=hash_bins)
