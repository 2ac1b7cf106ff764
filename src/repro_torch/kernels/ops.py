"""Bin-level ops around the kernels: input prep, launch, epilogue.

PyTorch port of ``repro.kernels.ops``. Which implementation runs is decided
by the tensors' device alone: CUDA tensors go through the hand-written
kernels, CPU tensors through their plain versions. The epilogues (window and
table compaction) were XLA in the reference and are plain torch here.
"""
from __future__ import annotations

import torch

from ..core.formats import CSR, PAD_COL, pad_axis
from .hll import hll_merge
from .spgemm_dense import spgemm_dense_bin
from .spgemm_hash import extract_hash_rows, spgemm_hash_bin

__all__ = ["prep_bin_structure", "gather_bin_values", "pad_b_flat",
           "extract_window_rows", "extract_hash_rows", "dense_bin_op",
           "hash_bin_op", "merge_estimate_op"]

# B arrays are padded by this many slots (the reference's DMA chunk), so
# the flat arrays the kernels read have the reference's shapes.
F_CHUNK = 128
# Upper bound on one dense launch's (acc, cnt) output; longer bins are
# launched in row chunks. A long row's window is the whole column range
# (8 bytes per column), so a 2**20-column bin stays at 256 rows a launch.
DENSE_OUT_BYTES = 2 << 30


def merge_estimate_op(a: CSR, sketches_with_sentinel: torch.Tensor,
                      clip_max: int | None = None):
    """Merged C-row sketches + estimates, clipped to ``clip_max``."""
    merged, est = hll_merge(a.indptr, a.indices[: a.nnz],
                            sketches_with_sentinel.contiguous())
    if clip_max is not None:
        est = torch.clamp(est, 0.0, float(clip_max))
    return merged, est


def extract_window_rows(acc, cnt, row_lo, *, cap: int):
    """Compact dense windows into per-row slabs of width ``cap``.

    Presence is ``cnt > 0`` (structural zeros kept). The window is already
    in column order, so a prefix sum over presence gives each entry's slot.
    Returns (cols (R, cap) int32 global indices padded with PAD_COL,
    vals (R, cap), nnz (R,) int32). Rows with nnz > cap overflowed."""
    r = acc.shape[0]
    pres = cnt > 0
    nnz = pres.sum(dim=1, dtype=torch.int32)
    rank = torch.cumsum(pres, dim=1, dtype=torch.int32) - 1
    ri, ci = (pres & (rank < cap)).nonzero(as_tuple=True)
    dest = rank[ri, ci].long()
    cols = torch.full((r, cap), PAD_COL, dtype=torch.int32, device=acc.device)
    vals = torch.zeros((r, cap), dtype=acc.dtype, device=acc.device)
    cols[ri, dest] = ci.int() + row_lo[ri, 0]
    vals[ri, dest] = acc[ri, ci]
    return cols, vals, nnz


def dense_bin_op(a_rows, a_vals, a_starts, a_lens, row_lo, b_cols_pad,
                 b_vals_pad, *, window: int, col_tiles: int = 1,
                 cap: int | None = None):
    """Run one bin through the dense accumulator and compact it.

    Returns (cols (R, cap), vals (R, cap), nnz (R,)). Rows are launched in
    chunks of at most ``DENSE_OUT_BYTES`` of window output; every row's
    result depends on that row alone, so chunking changes no value."""
    w = window * col_tiles
    cap = w if cap is None else cap
    r = a_rows.shape[0]
    step = max(1, DENSE_OUT_BYTES // (8 * w))
    parts = []
    for s in range(0, max(r, 1), step):
        e = min(r, s + step)
        acc, cnt = spgemm_dense_bin(
            a_rows[s:e], a_vals[s:e], a_starts[s:e], a_lens[s:e],
            row_lo[s:e], b_cols_pad, b_vals_pad, window=window,
            col_tiles=col_tiles)
        parts.append(extract_window_rows(acc, cnt, row_lo[s:e], cap=cap))
        del acc, cnt
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(xs) for xs in zip(*parts))


def hash_bin_op(a_rows, a_vals, a_starts, a_lens, b_cols_pad, b_vals_pad,
                *, table: int, spill: int, f_chunk: int = F_CHUNK,
                tile: int = 8):
    """Run one bin through the hash accumulator and compact it.

    Returns (cols (R, table+spill), vals (R, table+spill), nnz (R,))."""
    return spgemm_hash_bin(a_rows, a_vals, a_starts, a_lens, b_cols_pad,
                           b_vals_pad, table=table, spill=spill,
                           f_chunk=f_chunk, tile=tile)


def prep_bin_structure(a: CSR, b: CSR, rows, ell_width: int):
    """Structure-only half of bin preparation, on A's device.

    Returns ``(pos, valid, a_rows, a_starts, a_lens)``: ``pos``/``valid``
    are the (R, ell_width) flat gather positions into A's nnz arrays (the
    value gather each execution replays), ``a_rows``/``a_starts``/``a_lens``
    the value-independent int32 ELL blocks — B-row ids and the B rows'
    starts/lengths."""
    dev = a.device
    rows = torch.as_tensor(rows, dtype=torch.int64).to(dev)
    indptr = a.indptr.long()
    starts = indptr[rows][:, None]
    lens = (indptr[rows + 1] - indptr[rows])[:, None]
    e = torch.arange(ell_width, device=dev)[None, :]
    valid = e < lens
    pos = (starts + e).clamp(0, max(a.capacity - 1, 0))
    if a.capacity == 0:
        a_rows = torch.full(valid.shape, -1, dtype=torch.int32, device=dev)
    else:
        a_rows = torch.where(valid, a.indices[pos],
                             torch.tensor(-1, dtype=torch.int32, device=dev))
    k = a_rows.clamp(min=0).long()
    live = a_rows >= 0
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    a_starts = torch.where(live, b.indptr[k], zero)
    a_lens = torch.where(live, b.indptr[k + 1] - b.indptr[k], zero)
    return pos, valid, a_rows, a_starts.int(), a_lens.int()


def gather_bin_values(values: torch.Tensor, pos: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Value half of bin preparation: ELL-shaped A values for one bin."""
    if values.shape[0] == 0:
        return torch.zeros(pos.shape, dtype=values.dtype,
                           device=values.device)
    return torch.where(valid, values[pos],
                       torch.zeros((), dtype=values.dtype,
                                   device=values.device))


def pad_b_flat(b: CSR):
    """Flat B arrays padded by ``F_CHUNK`` slots (-1 columns, 0 values)."""
    return (pad_axis(b.indices, b.capacity + F_CHUNK, axis=0, value=-1),
            pad_axis(b.values, b.capacity + F_CHUNK, axis=0, value=0))
