"""Hash-table accumulator for one bin of output rows.

:func:`spgemm_hash_bin` is the port of the Pallas ``spgemm_hash_bin``
(``repro/kernels/spgemm_hash.py:170``) followed by the reference's
``ops.extract_hash_rows``. For CUDA tensors it launches the hand-written
kernel in ``csrc/spgemm_hash.cu`` (primary table in shared memory, spill
table in global memory) and compacts its tables; for CPU tensors it runs
:func:`hash_bin_plain`, a PyTorch port of the XLA twin ``_hash_bin_xla``.
Both return column-sorted slabs ``(cols, vals, nnz)`` of width
``table + spill``.

Per-row ``nnz`` is the exact distinct count for every row that fits its
tables. For a row that overflows (more distinct columns than
``table + spill``) the kernel reports occupied slots plus failed inserts,
the plain version the exact distinct count; both exceed the slab width,
which is all the executor's overflow scan reads.
"""
from __future__ import annotations

import torch

from ..core.esc import segment_sum
from ..core.formats import PAD_COL
from . import _build
from .spgemm_dense import _check_inputs, enumerate_products, row_chunks

_BIG = 2**30  # sorts empty table slots after every real column


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


def extract_hash_rows(keys, vals, skeys, svals, fail):
    """Compact per-row tables (primary + spill) into column-sorted slabs.

    Returns (cols (R, table+spill) int32 padded with PAD_COL, vals,
    nnz (R,) int32 = occupied slots + failed inserts)."""
    k = torch.cat([keys, skeys], dim=1)
    v = torch.cat([vals, svals], dim=1)
    key = torch.where(k >= 0, k, torch.full_like(k, _BIG))
    key_s, order = torch.sort(key, dim=1)
    val_s = torch.gather(v, 1, order)
    occ = (k >= 0).sum(dim=1, dtype=torch.int32)
    nnz = occ + fail.reshape(-1)
    slot = torch.arange(k.shape[1], device=k.device)[None, :]
    ok = (slot < occ[:, None]) & (key_s < _BIG)
    cols = torch.where(ok, key_s, torch.full_like(key_s, PAD_COL))
    out_vals = torch.where(ok, val_s, torch.zeros_like(val_s))
    return cols, out_vals, nnz


def hash_tables(a_rows, a_vals, a_starts, a_lens, b_cols, b_vals, *,
                table: int, spill: int):
    """Launch the CUDA kernel: per-row tables (keys (R, table) int32 with
    -1 empties, vals (R, table) f32, skeys/svals (R, spill), fail (R, 1)
    int32). CUDA tensors only."""
    if a_rows.device.type != "cuda":
        raise ValueError("hash_tables launches the CUDA kernel; tensors on "
                         f"{a_rows.device}")
    r, e = a_rows.shape
    _check_inputs(dict(a_rows=a_rows, a_vals=a_vals, a_starts=a_starts,
                       a_lens=a_lens, b_cols=b_cols, b_vals=b_vals), r, e)
    for name, size in (("table", table), ("spill", spill)):
        if size < 16 or size > 4096 or size & (size - 1):
            raise ValueError(f"{name} {size} must be a power of two in "
                             "[16, 4096]")
    dev = a_rows.device
    keys = torch.empty((r, table), dtype=torch.int32, device=dev)
    vals = torch.empty((r, table), dtype=torch.float32, device=dev)
    skeys = torch.empty((r, spill), dtype=torch.int32, device=dev)
    svals = torch.empty((r, spill), dtype=torch.float32, device=dev)
    fail = torch.empty((r, 1), dtype=torch.int32, device=dev)
    if r == 0:
        return keys, vals, skeys, svals, fail
    _build.launch(
        "ocean_hash_bin", dev, a_rows.data_ptr(), a_vals.data_ptr(),
        a_starts.data_ptr(), a_lens.data_ptr(), b_cols.data_ptr(),
        b_vals.data_ptr(), keys.data_ptr(), vals.data_ptr(),
        skeys.data_ptr(), svals.data_ptr(), fail.data_ptr(), r, e, table,
        spill)
    spgemm_hash_bin.launches += 1
    return keys, vals, skeys, svals, fail


def spgemm_hash_bin(a_rows, a_vals, a_starts, a_lens, b_cols, b_vals, *,
                    table: int, spill: int, f_chunk: int = 128,
                    tile: int = 8):
    """Hash accumulation of one bin, compacted: (cols, vals, nnz).

    ``f_chunk`` and ``tile`` are the reference kernel's DMA-chunk and
    row-tile knobs. This design streams B per thread and gives each row its
    own block, so both mean nothing here: they are accepted, for the
    plan's tuned values, and ignored."""
    del f_chunk, tile
    if a_rows.device.type == "cpu":
        return hash_bin_plain(a_rows, a_vals, a_starts, a_lens, b_cols,
                              b_vals, table=table, spill=spill)
    return extract_hash_rows(*hash_tables(a_rows, a_vals, a_starts, a_lens,
                                          b_cols, b_vals, table=table,
                                          spill=spill))


spgemm_hash_bin.launches = 0  # launch count of the CUDA kernel
