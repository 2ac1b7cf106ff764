"""Bin-level ops around the kernels: input prep, launch, epilogue.

PyTorch port of ``repro.kernels.ops``. Which implementation runs is decided
by the tensors' device alone: CUDA tensors go through the hand-written
kernels, CPU tensors through their plain versions. The dense and hash
kernels write compacted slabs themselves; ``extract_window_rows``, the
reference's XLA window compaction, is the dense plain version's epilogue.
``slab_scatter`` copies the slabs, and the ESC results, into C.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.formats import CSR, pad_axis
from .hll import hll_merge, hll_sketch
from .slab_scatter import row_entries, row_spans, slab_scatter
from .spgemm_dense import (count_rows_launch_shape_on, count_rows_schedule,
                           extract_window_rows, spgemm_count_rows,
                           spgemm_dense_slab)
from .spgemm_hash import spgemm_hash_bin

__all__ = ["prep_bin_structure", "gather_bin_values", "pad_b_flat",
           "extract_window_rows", "dense_bin_op",
           "hash_bin_op", "count_rows_inputs", "count_rows_op",
           "build_sketches_op",
           "merge_estimate_op", "slab_scatter", "row_spans", "row_entries"]

# B arrays are padded by this many slots (the reference's DMA chunk), so
# the flat arrays the kernels read have the reference's shapes.
F_CHUNK = 128


def build_sketches_op(b: CSR, m_regs: int, seed: int = 0) -> torch.Tensor:
    """Per-row sketches of B: (b.m + 1, m_regs) uint8, the last row the
    all-zero sentinel that the merge treats as padding. The sketch writes
    B's rows straight into that buffer."""
    buf = torch.empty((b.m + 1, m_regs), dtype=torch.uint8, device=b.device)
    buf[b.m].zero_()
    hll_sketch(b.indptr, b.indices[: b.nnz], m_regs=m_regs, seed=seed,
               out=buf[: b.m])
    return buf


def merge_estimate_op(a: CSR, sketches_with_sentinel: torch.Tensor,
                      clip_max: int | None = None):
    """Merged C-row sketches + estimates, clipped to ``clip_max``."""
    merged, est = hll_merge(a.indptr, a.indices[: a.nnz],
                            sketches_with_sentinel)
    if clip_max is not None:
        est = torch.clamp(est, 0.0, float(clip_max))
    return merged, est


def dense_bin_op(a_rows, a_vals, a_starts, a_lens, row_lo, b_cols_pad,
                 b_vals_pad, *, window: int, col_tiles: int = 1,
                 cap: int | None = None):
    """Run one bin through the dense accumulator, compacted into slabs.

    Returns (cols (R, cap), vals (R, cap), nnz (R,)), as the reference's
    ``dense_bin_op``; ``cap`` defaults to the window's width. One launch
    per bin: the kernel keeps each row's window on chip."""
    cap = window * col_tiles if cap is None else cap
    return spgemm_dense_slab(a_rows, a_vals, a_starts, a_lens, row_lo,
                             b_cols_pad, b_vals_pad, window=window,
                             col_tiles=col_tiles, cap=cap)


def hash_bin_op(a_rows, a_vals, a_starts, a_lens, b_cols_pad, b_vals_pad,
                *, table: int, spill: int, f_chunk: int = F_CHUNK,
                tile: int = 8):
    """Run one bin through the hash accumulator, compacted into slabs.

    Returns (cols (R, table+spill), vals (R, table+spill), nnz (R,)), as
    the reference's ``hash_bin_op``. One launch per bin: the kernel keeps
    each row's primary table on chip and writes its sorted slab."""
    return spgemm_hash_bin(a_rows, a_vals, a_starts, a_lens, b_cols_pad,
                           b_vals_pad, table=table, spill=spill,
                           f_chunk=f_chunk, tile=tile)


def count_rows_inputs(rows, row_lo, products, device):
    """The row count kernel's inputs on ``device``: ``(rows, row_lo,
    heavy)``, the host arrays ``rows`` and ``row_lo`` as int32 tensors in
    one upload. On a CUDA device they are in the kernel's launch order,
    ``heavy`` rows a block each first, from each row's ``products``
    (``spgemm_dense.count_rows_schedule``); elsewhere in list order."""
    rows, row_lo = np.asarray(rows), np.asarray(row_lo)
    heavy = 0
    device = torch.device(device)
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        _, resident = count_rows_launch_shape_on(index)
        order, heavy = count_rows_schedule(products, resident)
        if heavy:
            rows, row_lo = rows[order], row_lo[order]
    both = np.empty((2, len(rows)), np.int32)
    both[0], both[1] = rows, row_lo
    both = torch.from_numpy(both).to(device)
    return both[0], both[1], heavy


def count_rows_op(a: CSR, b: CSR, rows, row_lo, products,
                  out: torch.Tensor) -> torch.Tensor:
    """Exact output nnz of the given rows of A @ B, each of whose output
    columns lies in ``[row_lo, row_lo + COUNT_ROW_COLUMNS)``, written into
    ``out`` (m,) int64 at the rows' own indices: one count launch over all of
    them, reading A's and B's CSR arrays directly. ``rows``, ``row_lo`` and
    ``products`` (each row's product count, which orders the launch) are
    host arrays. Returns ``out``."""
    t_rows, t_lo, heavy = count_rows_inputs(rows, row_lo, products,
                                            out.device)
    return spgemm_count_rows(a.indptr, a.indices, b.indptr, b.indices,
                             t_rows, t_lo, out, heavy=heavy)


def prep_bin_structure(a: CSR, b: CSR, rows, ell_width: int):
    """Structure-only half of bin preparation, on A's device.

    Returns ``(rows, pos, valid, a_rows, a_starts, a_lens)``: ``rows`` the
    bin's rows as an int64 tensor, ``pos``/``valid`` the (R, ell_width)
    flat gather positions into A's nnz arrays (the value gather each
    execution replays), ``a_rows``/``a_starts``/``a_lens`` the
    value-independent int32 ELL blocks — B-row ids and the B rows'
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
    return rows, pos, valid, a_rows, a_starts.int(), a_lens.int()


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
