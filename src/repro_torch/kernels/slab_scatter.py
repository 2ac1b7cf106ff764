"""Row-disjoint sources of C's rows copied straight into C's CSR arrays.

The executor's merge writes every source of C's rows into C with
:func:`slab_scatter`, one call a source: a dense or hash bin's fixed-width
slab ``(cols, vals, nnz)``, or an ESC result's CSR ``(indptr, cols, vals)``.
For CUDA tensors it launches the hand-written kernel in
``csrc/slab_scatter.cu`` (:func:`slab_scatter_cuda`), a warp a row and no
temporaries; for CPU tensors it runs :func:`slab_scatter_plain`. It replaces
no TPU kernel: the reference scatters its slabs on the host, in numpy
(``repro/core/executor.py:287``). Both versions only copy, so C's entries
are the sources' bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..obs.metrics import count_launch
from . import _build


def row_spans(cols: torch.Tensor, nnz: Optional[torch.Tensor] = None,
              indptr: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(start, lens)``, int64 (R,): each source row's offset into the flat
    source arrays and how many entries it puts in C. A slab (``nnz``, cols
    (R, W)) row whose count passes W overflowed and puts none; a CSR's rows
    are ``indptr``'s."""
    if indptr is not None:
        start = indptr[:-1].long()
        return start, indptr[1:].long() - start
    r, width = cols.shape
    lens = nnz.long()
    lens = torch.where(lens > width, 0, lens)
    return torch.arange(r, device=cols.device) * width, lens


def row_entries(start: torch.Tensor, lens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(row, pos)``, int64: for every entry the rows put in C, in row
    order, its row and its position in the flat source arrays."""
    total = int(lens.sum())
    dev = lens.device
    row = torch.repeat_interleave(torch.arange(lens.shape[0], device=dev),
                                  lens, output_size=total)
    within = torch.arange(total, device=dev) - (torch.cumsum(lens, 0)
                                                - lens)[row]
    return row, start[row] + within


def _check(c_indptr, c_cols, c_vals, dest, cols, vals, nnz, indptr):
    if (nnz is None) == (indptr is None):
        raise ValueError("a source is a slab (nnz) or a CSR (indptr), "
                         "exactly one")
    tensors = dict(c_indptr=c_indptr, c_cols=c_cols, c_vals=c_vals,
                   dest=dest, cols=cols, vals=vals,
                   **({"nnz": nnz} if indptr is None else
                      {"indptr": indptr}))
    dev = c_cols.device
    for name, x in tensors.items():
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, c_cols on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    r = dest.shape[0]
    if indptr is None:
        if cols.dim() != 2 or cols.shape[0] != r or nnz.shape != (r,):
            raise ValueError(f"slab cols {tuple(cols.shape)} and nnz "
                             f"{tuple(nnz.shape)} for {r} rows")
    elif indptr.shape != (r + 1,):
        raise ValueError(f"indptr {tuple(indptr.shape)} for {r} rows")
    if cols.shape != vals.shape:
        raise ValueError(f"cols {tuple(cols.shape)} != vals "
                         f"{tuple(vals.shape)}")
    return tensors


def slab_scatter_plain(c_indptr, c_cols, c_vals, dest, cols, vals, *,
                       nnz=None, indptr=None) -> None:
    """Plain PyTorch version: each source row's entries gathered by flat
    position and written at C's positions of its row."""
    start, lens = row_spans(cols, nnz, indptr)
    row, pos = row_entries(start, lens)
    to = c_indptr.long()[dest][row] + (pos - start[row])
    c_cols[to] = cols.reshape(-1)[pos].to(c_cols.dtype)
    c_vals[to] = vals.reshape(-1)[pos].to(c_vals.dtype)


def slab_scatter_cuda(c_indptr, c_cols, c_vals, dest, cols, vals, *,
                      nnz=None, indptr=None) -> None:
    """Launch the CUDA kernel on one source: int32 columns, CSR offsets and
    counts, float32 values, int64 ``dest``. CUDA tensors only."""
    tensors = _check(c_indptr, c_cols, c_vals, dest, cols, vals, nnz, indptr)
    dev = c_cols.device
    if dev.type != "cuda":
        raise ValueError("slab_scatter_cuda launches the CUDA kernel; "
                         f"tensors on {dev}")
    for name, x in tensors.items():
        want = (torch.float32 if name in ("c_vals", "vals") else
                torch.int64 if name == "dest" else torch.int32)
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, got {x.dtype}")
    r = dest.shape[0]
    if r >= 2**31 - 8:
        raise ValueError(f"{r} rows exceed the grid")
    if r == 0:
        return
    _build.launch(
        "ocean_slab_scatter", dev, cols.data_ptr(), vals.data_ptr(),
        None if indptr is None else indptr.data_ptr(),
        None if nnz is None else nnz.data_ptr(),
        cols.shape[1] if indptr is None else 0, dest.data_ptr(),
        c_indptr.data_ptr(), c_cols.data_ptr(), c_vals.data_ptr(), r)
    count_launch("slab_scatter")


def slab_scatter(c_indptr, c_cols, c_vals, dest, cols, vals, *,
                 nnz=None, indptr=None) -> None:
    """Copy one source's rows into C, in place.

    ``dest`` (R,): the C row of each source row. A slab: ``cols``/``vals``
    (R, W) and ``nnz`` (R,), row r's first ``nnz[r]`` slots, unless
    ``nnz[r] > W`` (an overflowed row, skipped). A CSR: ``indptr`` (R+1,)
    and flat ``cols``/``vals``. Row r's entries land at
    ``C[c_indptr[dest[r]]:]``, in order; C's arrays must hold them."""
    if c_cols.device.type == "cpu":
        _check(c_indptr, c_cols, c_vals, dest, cols, vals, nnz, indptr)
        slab_scatter_plain(c_indptr, c_cols, c_vals, dest, cols, vals,
                           nnz=nnz, indptr=indptr)
        return
    slab_scatter_cuda(c_indptr, c_cols, c_vals, dest, cols, vals, nnz=nnz,
                      indptr=indptr)
