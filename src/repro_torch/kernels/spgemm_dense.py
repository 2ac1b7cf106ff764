"""Dense-window accumulator, and its count-only pass, for one bin of rows.

:func:`spgemm_dense_slab` is the port of the reference's ``dense_bin_op``
(``repro/kernels/ops.py:162``): the Pallas ``spgemm_dense_bin``
(``repro/kernels/spgemm_dense.py:178``) followed by its epilogue
``extract_window_rows``. For CUDA tensors it launches the hand-written kernel
in ``csrc/spgemm_dense.cu``, which keeps each row's window in shared memory
and writes only the row's compacted slab; for CPU tensors it runs
:func:`dense_slab_plain`, :func:`dense_bin_plain` (a PyTorch port of the
reference's XLA twin ``_dense_bin_xla``, returning the (R, col_tiles*window)
``(acc, cnt)`` windows) followed by :func:`extract_window_rows`. Both return
``(cols (R, cap) int32, vals (R, cap) f32, nnz (R,) int32)``.

:func:`spgemm_count_bin` is the port of the Pallas ``spgemm_count_bin``
(``repro/kernels/spgemm_dense.py:148``), the same windows without values:
``csrc/spgemm_count.cu`` for CUDA tensors, :func:`count_bin_plain` for CPU
tensors. It returns each row's exact output nnz and, when asked, the
per-slot product counts. :func:`spgemm_count_rows` is the count the symbolic
prediction runs: the exact output nnz of a list of rows, read straight from
A's and B's CSR arrays, every listed row in one launch of the same source;
:func:`count_rows_plain` for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.esc import segment_sum
from ..core.formats import PAD_COL
from ..obs.metrics import count_launch
from . import _build

_INT_INPUTS = ("a_rows", "a_starts", "a_lens", "row_lo", "b_cols")


# The plain versions enumerate every product of a row chunk at once; rows
# are taken in chunks of about this many products to bound their memory.
PLAIN_CHUNK_PRODUCTS = 1 << 26
# :func:`dense_slab_plain` builds (acc, cnt) windows for at most this many
# bytes of rows at a time (a long row's window is 8 bytes a column).
PLAIN_WINDOW_BYTES = 2 << 30
# Largest slab width the CUDA kernel takes (its ranks are uint16).
MAX_CAP = 65535
# Columns of a row's presence bitmap in the row count kernel: a listed row's
# output column range is at most this wide.
COUNT_ROW_COLUMNS = 4096
# Threads a block of the row count kernel at most (its ``__launch_bounds__``).
COUNT_MAX_THREADS = 1024
# Products a warp of the row count kernel loads in one pass (32 lanes, 4
# loads in flight each): a row of at most this many gains nothing from more
# warps.
COUNT_WARP_STAGE = 128


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
    per_row = torch.where(a_rows >= 0, a_lens, 0).sum(1, dtype=torch.int64)
    return _chunks_of(per_row)


def _chunks_of(per_row):
    """:func:`row_chunks` given each row's product count."""
    budget = PLAIN_CHUNK_PRODUCTS
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
    """Plain PyTorch version: every product summed into its row's window
    slot. The products are stably sorted by slot and each slot summed by
    ``esc.segment_sum``: in enumeration order on the host, as the kernels
    sum, and as a fixed tree on a GPU, where an ``index_add_`` would add
    them with atomics in no fixed order."""
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
        flat, perm = torch.sort(row[ok] * w + local[ok], stable=True)
        slot, counts = torch.unique_consecutive(flat, return_counts=True)
        acc[s:e].view(-1)[slot] = segment_sum(val[ok][perm], counts)
        cnt[s:e].view(-1)[slot] = counts.to(torch.float32)
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


def _check_cap(cap: int) -> None:
    if not 0 < cap <= MAX_CAP:
        raise ValueError(f"cap {cap} must be in [1, {MAX_CAP}]")


@functools.lru_cache(maxsize=None)
def longrow_max_cap_on(device_index: int, width: int) -> int:
    """The largest cap at which one bitmap segment of the long-row kernel
    holds ``width`` columns on CUDA device ``device_index``, from the
    kernel's shared memory (0 when none). Up to 32,768 columns it is the
    largest cap the kernel launches at all; past it the launch is refused."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        status = _build.library().ocean_longrow_max_cap(
            width, ctypes.addressof(out))
    if status != 0:
        raise RuntimeError(f"long-row shared-memory query failed: cudaError "
                           f"{status}")
    return out.value


def longrow_max_cap(device, width: int) -> int:
    """The largest slab width the long-row rung takes over ``width``
    columns on ``device`` with the whole range in one bitmap segment (the
    products streamed once a step): ``MAX_CAP`` for the plain version
    (every device but CUDA), on the card also the kernel's shared memory
    (:func:`longrow_max_cap_on`)."""
    device = torch.device(device)
    if device.type != "cuda":
        return MAX_CAP
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return min(MAX_CAP, longrow_max_cap_on(index, int(width)))


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


def dense_slab_plain(a_rows, a_vals, a_starts, a_lens, row_lo, b_cols,
                     b_vals, *, window: int, col_tiles: int = 1, cap: int):
    """Plain PyTorch version of :func:`spgemm_dense_slab`: the windows of
    :func:`dense_bin_plain` compacted by :func:`extract_window_rows`, rows
    taken in chunks of at most ``PLAIN_WINDOW_BYTES`` of window (each row's
    result depends on that row alone)."""
    r = a_rows.shape[0]
    step = max(1, PLAIN_WINDOW_BYTES // (8 * window * col_tiles))
    parts = []
    for s in range(0, max(r, 1), step):
        e = min(r, s + step)
        acc, cnt = dense_bin_plain(
            a_rows[s:e], a_vals[s:e], a_starts[s:e], a_lens[s:e],
            row_lo[s:e], b_cols, b_vals, window=window, col_tiles=col_tiles)
        parts.append(extract_window_rows(acc, cnt, row_lo[s:e], cap=cap))
        del acc, cnt
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(xs) for xs in zip(*parts))


def spgemm_dense_slab(a_rows, a_vals, a_starts, a_lens, row_lo, b_cols,
                      b_vals, *, window: int, col_tiles: int = 1, cap: int):
    """Dense-window accumulation of one bin, compacted into slabs.

    a_rows/a_starts/a_lens: (R, E) int32 — B-row ids (pad -1), their
    starts and lengths in the flat B arrays (pad 0); a_vals (R, E) f32;
    row_lo (R, 1) int32 window base per row; b_cols/b_vals flat B arrays.
    Returns (cols (R, cap) int32 global column ids in column order padded
    with PAD_COL, vals (R, cap) f32, nnz (R,) int32 each row's number of
    present columns, which exceeds ``cap`` when the row overflowed; the slab
    then holds its first ``cap`` columns).
    """
    if a_rows.device.type == "cpu":
        return dense_slab_plain(a_rows, a_vals, a_starts, a_lens, row_lo,
                                b_cols, b_vals, window=window,
                                col_tiles=col_tiles, cap=cap)
    r, e = a_rows.shape
    _check_inputs(dict(a_rows=a_rows, a_vals=a_vals, a_starts=a_starts,
                       a_lens=a_lens, row_lo=row_lo, b_cols=b_cols,
                       b_vals=b_vals), r, e)
    _check_window(r, window, col_tiles)
    _check_cap(cap)
    dev = a_rows.device
    cols = torch.empty((r, cap), dtype=torch.int32, device=dev)
    vals = torch.empty((r, cap), dtype=torch.float32, device=dev)
    nnz = torch.empty(r, dtype=torch.int32, device=dev)
    if r == 0:
        return cols, vals, nnz
    _build.launch(
        "ocean_dense_slab", dev, a_rows.data_ptr(), a_vals.data_ptr(),
        a_starts.data_ptr(), a_lens.data_ptr(), row_lo.data_ptr(),
        b_cols.data_ptr(), b_vals.data_ptr(), cols.data_ptr(),
        vals.data_ptr(), nnz.data_ptr(), r, e, window, col_tiles, cap)
    count_launch("dense_longrow" if col_tiles > 1 else "dense_window")
    return cols, vals, nnz


def spgemm_count_bin(a_rows, a_starts, a_lens, row_lo, b_cols, *,
                     window: int, col_tiles: int = 1,
                     want_counts: bool = False):
    """Count-only (symbolic) pass over one bin.

    Inputs as :func:`spgemm_dense_slab` without the values. Returns
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
    count_launch("count_bin")
    return counts, row_nnz


def count_rows_plain(a_indptr, a_indices, b_indptr, b_indices, rows, row_lo,
                     out):
    """Plain PyTorch version of :func:`spgemm_count_rows`: each listed row's
    products enumerated from the two CSRs, the columns in the row's range
    made unique with a sort, and counted per row."""
    r = rows.shape[0]
    dev = out.device
    w = COUNT_ROW_COLUMNS
    rows64, lo = rows.long(), row_lo.long()
    a_ptr, b_ptr = a_indptr.long(), b_indptr.long()
    a_start = a_ptr[rows64]
    a_len = a_ptr[rows64 + 1] - a_start
    n_ent = int(a_len.sum()) if r else 0
    # the listed rows' A entries, row by row, as a one-slot ELL over B
    ent_row = torch.repeat_interleave(torch.arange(r, device=dev), a_len,
                                      output_size=n_ent)
    ent_end = torch.cumsum(a_len, 0)
    ent = a_start[ent_row] + torch.arange(n_ent, device=dev) - \
        (ent_end - a_len)[ent_row]
    k = a_indices[ent].long()
    live = (k >= 0) & (k < b_ptr.shape[0] - 1)
    k = torch.where(live, k, 0)
    b_start = b_ptr[k]
    b_len = torch.where(live, b_ptr[k + 1] - b_start, 0)
    per_row = torch.zeros(r, dtype=torch.int64, device=dev).index_add_(
        0, ent_row, b_len)
    nnz = torch.zeros(r, dtype=torch.int64, device=dev)
    for s, e in _chunks_of(per_row):
        sl = slice(int(ent_end[s] - a_len[s]), int(ent_end[e - 1]))
        j, col, _ = enumerate_products(
            k[sl, None], None, b_start[sl, None], b_len[sl, None], b_indices,
            None)
        pos = ent_row[sl][j]
        local = col - lo[pos]
        ok = (local >= 0) & (local < w)
        key = torch.unique((pos[ok] - s) * w + local[ok])
        nnz[s:e] = torch.bincount(key // w, minlength=e - s)
    out[rows64] = nnz
    return out


def count_rows_launch_shape(blocks_per_sm):
    """``(warps, held)`` of the row count kernel: warps a block, and the warps
    one SM holds at once. The block is the one that lets an SM hold the most
    warps, the largest such, since a heavy row takes a whole block.
    ``blocks_per_sm(warps)`` is how many such blocks one SM holds at once, 0
    when one cannot launch: on the card the CUDA occupancy API's answer for
    the kernel as built (:func:`count_rows_launch_shape_on`)."""
    best = None
    for warps in range(1, COUNT_MAX_THREADS // 32 + 1):
        held = warps * blocks_per_sm(warps)
        if held and (best is None or held >= best[1]):
            best = (warps, held)
    if best is None:
        raise ValueError("no block of the row count kernel fits an SM")
    return best


@functools.lru_cache(maxsize=None)
def count_rows_launch_shape_on(device_index: int):
    """``(warps, resident)`` on CUDA device ``device_index``: warps a block
    (:func:`count_rows_launch_shape`, from the occupancy API) and the warps
    the whole card holds at once."""
    fn = _build.library().ocean_count_rows_blocks_per_sm

    def blocks_per_sm(warps):
        out = ctypes.c_int(0)
        with torch.cuda.device(device_index):
            status = fn(warps, ctypes.addressof(out))
        if status != 0:
            raise RuntimeError("CUDA occupancy query failed: cudaError "
                               f"{status}")
        return out.value

    warps, held = count_rows_launch_shape(blocks_per_sm)
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return warps, held * sms


def count_rows_schedule(products, resident: int):
    """``(order, heavy)``: the launch order of a row list, given each listed
    row's product count, and how many rows, first in that order, the kernel
    takes a block each. Those are the rows with more products than a warp's
    share of the launch (all products over the ``resident`` warps the card
    holds at once), which a lone warp would still be counting after the rest
    of the launch is done, and than one pass of a warp
    (``COUNT_WARP_STAGE``); they go in descending order of products, the
    others follow in list order."""
    products = np.asarray(products, np.int64)
    big = ((products * resident > products.sum())
           & (products > COUNT_WARP_STAGE))
    heavy = np.nonzero(big)[0]
    if not len(heavy):
        return np.arange(len(products)), 0
    heavy = heavy[np.argsort(-products[heavy], kind="stable")]
    return np.concatenate([heavy, np.nonzero(~big)[0]]), len(heavy)


def _check_rows(tensors: dict, out, heavy: int) -> None:
    dev = out.device
    for name, x in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, out on {dev}")
        if x.dtype != torch.int32 or x.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out.dtype != torch.int64 or out.dim() != 1 or not out.is_contiguous():
        raise TypeError("out must be a contiguous 1-D int64 tensor")
    if tensors["a_indptr"].shape[0] != out.shape[0] + 1:
        raise ValueError(f"out has {out.shape[0]} rows, A "
                         f"{tensors['a_indptr'].shape[0] - 1}")
    r = tensors["rows"].shape[0]
    if tensors["row_lo"].shape[0] != r:
        raise ValueError("rows and row_lo must have the same length")
    if not 0 <= heavy <= r or r >= 2**31:
        raise ValueError(f"heavy {heavy} must be in [0, {r}] and rows "
                         "fewer than 2**31")


def spgemm_count_rows(a_indptr, a_indices, b_indptr, b_indices, rows, row_lo,
                      out, *, heavy: int = 0):
    """Exact output nnz of a list of rows of A @ B, from the CSR structures.

    a_indptr/a_indices and b_indptr/b_indices: A's and B's CSR arrays
    (int32); rows (R,) int32 rows of A; row_lo (R,) int32 the first column
    of each row's output range, which must be at most ``COUNT_ROW_COLUMNS``
    wide; out (m,) int64. Sets ``out[rows[i]]`` to the number of distinct
    columns in ``[row_lo[i], row_lo[i] + COUNT_ROW_COLUMNS)`` among the
    products of row ``rows[i]`` (its exact nnz) and leaves the other entries
    as they are. The kernel takes the first ``heavy`` rows a block each and
    the others a warp each (:func:`count_rows_schedule`); the result does not
    depend on it. Returns ``out``.
    """
    if out.device.type == "cpu":
        return count_rows_plain(a_indptr, a_indices, b_indptr, b_indices,
                                rows, row_lo, out)
    _check_rows(dict(a_indptr=a_indptr, a_indices=a_indices,
                     b_indptr=b_indptr, b_indices=b_indices, rows=rows,
                     row_lo=row_lo), out, heavy)
    r = rows.shape[0]
    if r == 0:
        return out
    dev = out.device
    warps, _ = count_rows_launch_shape_on(
        dev.index if dev.index is not None else torch.cuda.current_device())
    _build.launch(
        "ocean_count_rows", dev, a_indptr.data_ptr(), a_indices.data_ptr(),
        b_indptr.data_ptr(), b_indices.data_ptr(), rows.data_ptr(),
        row_lo.data_ptr(), out.data_ptr(), r, b_indptr.shape[0] - 1, heavy,
        warps)
    count_launch("count_rows")
    return out
