"""Hash-table accumulator for one bin of output rows.

:func:`spgemm_hash_bin` is the port of the reference's ``hash_bin_op``
(``repro/kernels/ops.py:283``): the Pallas ``spgemm_hash_bin``
(``repro/kernels/spgemm_hash.py:170``) followed by its epilogue
``extract_hash_rows``. For CUDA tensors it launches the hand-written kernel
in ``csrc/spgemm_hash.cu`` (:func:`hash_slab`), which keeps each row's
primary table in shared memory, opens the row's spill only when the primary
refuses an insert, and writes the row's column-sorted slab itself; for CPU
tensors it runs :func:`hash_bin_plain`, a PyTorch port of the XLA twin
``_hash_bin_xla``. Both return slabs ``(cols, vals, nnz)`` of width
``table + spill``.

Per-row ``nnz`` is the exact distinct count for every row that fits its
tables. For a row that overflows (more distinct columns than
``table + spill``) the kernel reports occupied slots plus failed inserts,
the plain version the exact distinct count; both exceed the slab width,
which is all the executor's overflow scan reads.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.esc import segment_sum
from ..core.formats import PAD_COL
from ..obs.metrics import count_launch
from . import _build
from .spgemm_dense import _check_inputs, enumerate_products, row_chunks

# Threads a block at most: the kernel's ``__launch_bounds__``.
MAX_BLOCK_THREADS = 256
SLOT_BYTES = 8  # key int32 + value f32


def hash_bin_plain(a_rows, a_vals, a_starts, a_lens, b_cols, b_vals, *,
                   table: int, spill: int):
    """Plain PyTorch version: sort each row chunk's products by (row, col)
    with a stable sort, sum duplicates in enumeration order, and left-pack
    each row's first ``table + spill`` distinct columns. ``nnz`` is the
    exact distinct count."""
    r = a_rows.shape[0]
    dev = a_rows.device
    width = table + spill
    cols_out = torch.full((r, width), PAD_COL, dtype=torch.int32, device=dev)
    vals_out = torch.zeros((r, width), dtype=b_vals.dtype, device=dev)
    nnz = torch.zeros(r, dtype=torch.int32, device=dev)
    for s, e in row_chunks(a_rows, a_lens):
        row, col, val = enumerate_products(
            a_rows[s:e], a_vals[s:e], a_starts[s:e], a_lens[s:e], b_cols,
            b_vals)
        ok = col >= 0
        key_s, perm = torch.sort((row[ok] << 31) | col[ok], stable=True)
        val_s = val[ok][perm]
        uniq, per_key = torch.unique_consecutive(key_s, return_counts=True)
        n_u = int(uniq.shape[0])
        sums = segment_sum(val_s, per_key)
        row_d = uniq >> 31
        counts = torch.bincount(row_d, minlength=e - s)
        rank = torch.arange(n_u, device=dev) - (torch.cumsum(counts, 0)
                                                - counts)[row_d]
        emit = rank < width
        cols_out[s:e][row_d[emit], rank[emit]] = \
            (uniq[emit] & (2**31 - 1)).int()
        vals_out[s:e][row_d[emit], rank[emit]] = sums[emit]
        nnz[s:e] = counts.int()
    return cols_out, vals_out, nnz


def _check_tables(table: int, spill: int) -> None:
    for name, size in (("table", table), ("spill", spill)):
        if size < 16 or size > 4096 or size & (size - 1):
            raise ValueError(f"{name} {size} must be a power of two in "
                             "[16, 4096]")


def launch_shape(table: int, spill: int, blocks_per_sm):
    """``(lanes, rows, smem_bytes)`` of the kernel for a bin's tables: lanes
    a row (a group of 8 for t32, 16 for t64, a warp from t128 up), rows a
    block (whole warps, at most ``MAX_BLOCK_THREADS`` threads; the count
    that lets an SM hold the most rows at once, the smallest such), and the
    block's dynamic shared memory (the primary tables). ``blocks_per_sm(
    lanes, rows, smem)`` is how many such blocks one SM holds at once, 0
    when one cannot launch: on the card the CUDA occupancy API's answer for
    the kernel as built (:func:`launch_shape_on`)."""
    _check_tables(table, spill)
    lanes = min(32, max(8, table // 4))
    per_warp = 32 // lanes
    best = None
    for rows in range(per_warp, MAX_BLOCK_THREADS // lanes + 1, per_warp):
        smem = rows * table * SLOT_BYTES
        held = rows * blocks_per_sm(lanes, rows, smem)
        if held and (best is None or held > best[0]):
            best = (held, rows, smem)
    if best is None:
        raise ValueError(f"no block of {lanes}-lane rows with tables "
                         f"{table}+{spill} fits an SM")
    return lanes, best[1], best[2]


@functools.lru_cache(maxsize=None)
def launch_shape_on(device_index: int, table: int, spill: int):
    """:func:`launch_shape` on CUDA device ``device_index``, from the
    occupancy API (``ocean_hash_blocks_per_sm``)."""
    fn = _build.library().ocean_hash_blocks_per_sm

    def blocks_per_sm(lanes, rows, smem):
        out = ctypes.c_int(0)
        with torch.cuda.device(device_index):
            status = fn(lanes, rows, smem, ctypes.addressof(out))
        if status != 0:
            raise RuntimeError("CUDA occupancy query failed: cudaError "
                               f"{status}")
        return out.value

    return launch_shape(table, spill, blocks_per_sm)


def hash_slab(a_rows, a_vals, a_starts, a_lens, b_cols, b_vals, *,
              table: int, spill: int):
    """Launch the CUDA kernel: one bin into column-sorted slabs
    ``(cols, vals, nnz)``, as :func:`spgemm_hash_bin`. CUDA tensors only.
    The spill lives in global scratch allocated here, the paper's
    shared/global split (not initialised: a row initialises its own spill
    when it first needs it)."""
    if a_rows.device.type != "cuda":
        raise ValueError("hash_slab launches the CUDA kernel; tensors on "
                         f"{a_rows.device}")
    r, e = a_rows.shape
    _check_inputs(dict(a_rows=a_rows, a_vals=a_vals, a_starts=a_starts,
                       a_lens=a_lens, b_cols=b_cols, b_vals=b_vals), r, e)
    _check_tables(table, spill)
    if r >= 2**31:
        raise ValueError(f"{r} rows exceed the grid")
    dev = a_rows.device
    width = table + spill
    cols = torch.empty((r, width), dtype=torch.int32, device=dev)
    vals = torch.empty((r, width), dtype=torch.float32, device=dev)
    nnz = torch.empty(r, dtype=torch.int32, device=dev)
    if r == 0:
        return cols, vals, nnz
    lanes, rows, _ = launch_shape_on(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        table, spill)
    scratch = torch.empty((r, spill), dtype=torch.int64, device=dev)
    _build.launch(
        "ocean_hash_slab", dev, a_rows.data_ptr(), a_vals.data_ptr(),
        a_starts.data_ptr(), a_lens.data_ptr(), b_cols.data_ptr(),
        b_vals.data_ptr(), scratch.data_ptr(), cols.data_ptr(),
        vals.data_ptr(), nnz.data_ptr(), r, e, table, spill, lanes, rows)
    count_launch("hash")
    return cols, vals, nnz


def spgemm_hash_bin(a_rows, a_vals, a_starts, a_lens, b_cols, b_vals, *,
                    table: int, spill: int, f_chunk: int = 128,
                    tile: int = 8):
    """Hash accumulation of one bin, compacted: (cols, vals, nnz).

    a_rows/a_starts/a_lens: (R, E) int32 — B-row ids (pad -1), their starts
    and lengths in the flat B arrays (pad 0); a_vals (R, E) f32;
    b_cols/b_vals the flat B arrays. Returns (cols (R, table+spill) int32
    column-sorted, padded with PAD_COL, vals (R, table+spill) f32,
    nnz (R,) int32). ``f_chunk`` and ``tile`` are the reference kernel's
    DMA-chunk and row-tile knobs; this design loads B per lane and sizes
    its row groups from the table, so both are accepted, for the plan's
    tuned values, and ignored."""
    del f_chunk, tile
    if a_rows.device.type == "cpu":
        return hash_bin_plain(a_rows, a_vals, a_starts, a_lens, b_cols,
                              b_vals, table=table, spill=spill)
    return hash_slab(a_rows, a_vals, a_starts, a_lens, b_cols, b_vals,
                     table=table, spill=spill)
