"""Dense-window accumulator, and its count-only pass, for one bin of rows.

:func:`spgemm_dense_bin` is the port of the Pallas ``spgemm_dense_bin``
(``repro/kernels/spgemm_dense.py:178``): for CUDA tensors it launches the
hand-written kernel in ``csrc/spgemm_dense.cu``, for CPU tensors it runs
:func:`dense_bin_plain`, a PyTorch port of the reference's XLA twin
``_dense_bin_xla``. Both return ``(acc, cnt)``, each (R, col_tiles*window)
f32; presence is ``cnt > 0``.

:func:`spgemm_count_bin` is the port of the Pallas ``spgemm_count_bin``
(``repro/kernels/spgemm_dense.py:148``), the same windows without values:
``csrc/spgemm_count.cu`` for CUDA tensors, :func:`count_bin_plain` for CPU
tensors. It returns each row's exact output nnz and, when asked, the
per-slot product counts.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

_INT_INPUTS = ("a_rows", "a_starts", "a_lens", "row_lo", "b_cols")


# The plain versions enumerate every product of a row chunk at once; rows
# are taken in chunks of about this many products to bound their memory.
PLAIN_CHUNK_PRODUCTS = 1 << 26


def enumerate_products(a_rows, a_vals, a_starts, a_lens, b_cols, b_vals):
    """Every product of an ELL bin in enumeration order (A slot major, B
    position minor): ``(row, col, val)``, int64/int64/float (``val`` is
    None when ``a_vals`` is)."""
    r, e = a_rows.shape
    dev = a_rows.device
    lens = torch.where(a_rows >= 0, a_lens, 0).reshape(-1).long()
    total = int(lens.sum()) if lens.numel() else 0
    j = torch.repeat_interleave(torch.arange(r * e, device=dev), lens,
                                output_size=total)
    t = torch.arange(total, device=dev) - (torch.cumsum(lens, 0) - lens)[j]
    bpos = a_starts.reshape(-1).long()[j] + t
    val = None if a_vals is None else a_vals.reshape(-1)[j] * b_vals[bpos]
    return j // e, b_cols[bpos].long(), val


def row_chunks(a_rows, a_lens):
    """Contiguous row ranges ``[s, e)`` of about ``PLAIN_CHUNK_PRODUCTS``
    products each (a row with more products is a range of its own)."""
    budget = PLAIN_CHUNK_PRODUCTS
    per_row = torch.where(a_rows >= 0, a_lens, 0).sum(1, dtype=torch.int64)
    cum = torch.cumsum(per_row, 0).cpu().numpy()
    s = 0
    while s < len(cum):
        base = int(cum[s - 1]) if s else 0
        e = int(np.searchsorted(cum, base + budget, side="right"))
        e = min(max(e, s + 1), len(cum))
        yield s, e
        s = e


def dense_bin_plain(a_rows, a_vals, a_starts, a_lens, row_lo, b_cols, b_vals,
                    *, window: int, col_tiles: int = 1):
    """Plain PyTorch version: scatter-add of every product into its row's
    window, in enumeration order."""
    r = a_rows.shape[0]
    w = window * col_tiles
    dev = b_vals.device
    acc = torch.zeros((r, w), dtype=b_vals.dtype, device=dev)
    cnt = torch.zeros((r, w), dtype=torch.float32, device=dev)
    for s, e in row_chunks(a_rows, a_lens):
        row, col, val = enumerate_products(
            a_rows[s:e], a_vals[s:e], a_starts[s:e], a_lens[s:e], b_cols,
            b_vals)
        local = col - row_lo[s:e][row, 0].long()
        ok = (local >= 0) & (local < w) & (col >= 0)
        flat = row[ok] * w + local[ok]
        acc[s:e].view(-1).index_add_(0, flat, val[ok])
        cnt[s:e].view(-1).index_add_(
            0, flat, torch.ones_like(flat, dtype=torch.float32))
    return acc, cnt


def count_bin_plain(a_rows, a_starts, a_lens, row_lo, b_cols, *,
                    window: int, col_tiles: int = 1,
                    want_counts: bool = False):
    """Plain PyTorch version: a count of every product into its row's
    window, then the number of slots above 0."""
    r = a_rows.shape[0]
    w = window * col_tiles
    cnt = torch.zeros((r, w), dtype=torch.int32, device=a_rows.device)
    for s, e in row_chunks(a_rows, a_lens):
        row, col, _ = enumerate_products(
            a_rows[s:e], None, a_starts[s:e], a_lens[s:e], b_cols, None)
        local = col - row_lo[s:e][row, 0].long()
        ok = (local >= 0) & (local < w) & (col >= 0)
        flat = row[ok] * w + local[ok]
        cnt[s:e].view(-1).index_add_(
            0, flat, torch.ones_like(flat, dtype=torch.int32))
    row_nnz = (cnt > 0).sum(1, dtype=torch.int32)
    return (cnt.float() if want_counts else None), row_nnz


def _check_inputs(tensors: dict, r: int, e: int) -> torch.device:
    dev = tensors["a_rows"].device
    for name, x in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, a_rows on {dev}")
        want = torch.int32 if name in _INT_INPUTS else torch.float32
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("a_vals", "a_starts", "a_lens"):
        if name in tensors and tuple(tensors[name].shape) != (r, e):
            raise ValueError(f"{name} shape {tuple(tensors[name].shape)} "
                             f"!= {(r, e)}")
    if "b_vals" in tensors and (tensors["b_cols"].shape
                                != tensors["b_vals"].shape):
        raise ValueError("b_cols and b_vals must have the same shape")
    if "row_lo" in tensors and tuple(tensors["row_lo"].shape) != (r, 1):
        raise ValueError(f"row_lo shape {tuple(tensors['row_lo'].shape)} "
                         f"!= {(r, 1)}")
    return dev


def _check_window(r: int, window: int, col_tiles: int) -> None:
    if not 0 < window <= 4096 or not 0 < col_tiles < 65536:
        raise ValueError(f"window {window} must be in (0, 4096], "
                         f"col_tiles {col_tiles} in [1, 65535]")
    if r >= 2**31:
        raise ValueError(f"{r} rows exceed the grid")


def spgemm_dense_bin(a_rows, a_vals, a_starts, a_lens, row_lo, b_cols, b_vals,
                     *, window: int, col_tiles: int = 1):
    """Dense-window accumulation of one bin.

    a_rows/a_starts/a_lens: (R, E) int32 — B-row ids (pad -1), their
    starts and lengths in the flat B arrays (pad 0); a_vals (R, E) f32;
    row_lo (R, 1) int32 window base per row; b_cols/b_vals flat B arrays.
    Returns (acc, cnt), each (R, col_tiles*window) f32.
    """
    if a_rows.device.type == "cpu":
        return dense_bin_plain(a_rows, a_vals, a_starts, a_lens, row_lo,
                               b_cols, b_vals, window=window,
                               col_tiles=col_tiles)
    r, e = a_rows.shape
    _check_inputs(dict(a_rows=a_rows, a_vals=a_vals, a_starts=a_starts,
                       a_lens=a_lens, row_lo=row_lo, b_cols=b_cols,
                       b_vals=b_vals), r, e)
    _check_window(r, window, col_tiles)
    if col_tiles > 1 and window % 4:
        raise ValueError(f"long-row window {window} must be a multiple of 4")
    w = window * col_tiles
    acc = torch.empty((r, w), dtype=torch.float32, device=a_rows.device)
    cnt = torch.empty((r, w), dtype=torch.float32, device=a_rows.device)
    if r == 0:
        return acc, cnt
    _build.launch(
        "ocean_dense_bin", a_rows.device, a_rows.data_ptr(),
        a_vals.data_ptr(), a_starts.data_ptr(), a_lens.data_ptr(),
        row_lo.data_ptr(), b_cols.data_ptr(), b_vals.data_ptr(),
        acc.data_ptr(), cnt.data_ptr(), r, e, window, col_tiles)
    if col_tiles > 1:
        spgemm_dense_bin.longrow_launches += 1
    else:
        spgemm_dense_bin.window_launches += 1
    return acc, cnt


# launch counts of the CUDA kernel, split by rung (windowed / long-row)
spgemm_dense_bin.window_launches = 0
spgemm_dense_bin.longrow_launches = 0


def spgemm_count_bin(a_rows, a_starts, a_lens, row_lo, b_cols, *,
                     window: int, col_tiles: int = 1,
                     want_counts: bool = False):
    """Count-only (symbolic) pass over one bin.

    Inputs as :func:`spgemm_dense_bin` without the values. Returns
    ``(counts, row_nnz)``: ``counts`` (R, col_tiles*window) f32 product
    counts per window slot when ``want_counts`` (else None), ``row_nnz``
    (R,) int32 the number of slots above 0 — the row's exact output nnz
    when its output columns lie in the window.
    """
    if a_rows.device.type == "cpu":
        return count_bin_plain(a_rows, a_starts, a_lens, row_lo, b_cols,
                               window=window, col_tiles=col_tiles,
                               want_counts=want_counts)
    r, e = a_rows.shape
    _check_inputs(dict(a_rows=a_rows, a_starts=a_starts, a_lens=a_lens,
                       row_lo=row_lo, b_cols=b_cols), r, e)
    _check_window(r, window, col_tiles)
    dev = a_rows.device
    counts = (torch.empty((r, window * col_tiles), dtype=torch.float32,
                          device=dev) if want_counts else None)
    row_nnz = torch.zeros(r, dtype=torch.int32, device=dev)
    if r == 0:
        return counts, row_nnz
    _build.launch(
        "ocean_count_bin", dev, a_rows.data_ptr(), a_starts.data_ptr(),
        a_lens.data_ptr(), row_lo.data_ptr(), b_cols.data_ptr(),
        None if counts is None else counts.data_ptr(), row_nnz.data_ptr(),
        r, e, window, col_tiles)
    spgemm_count_bin.launches += 1
    return counts, row_nnz


spgemm_count_bin.launches = 0  # launch count of the CUDA kernel
