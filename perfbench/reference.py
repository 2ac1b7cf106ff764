"""Plain reference of C = A·B, and the comparison that decides ``correct``.

Plain PyTorch, independent of the program: it imports nothing of it and
takes nothing it made. It works C out again from the generator's A and B
by expand, sort and reduce (ESC) over blocks of rows, so it fits beside
the held outputs on the device. Products and sums are in float64; each
entry also carries the sum of |a_ik * b_kj| over its products, the scale
of the rounding a float32 sum can make.

``compare`` holds the program's C to the reference:

* ``pattern_mismatch``: rows whose length differs, plus entries whose
  column differs, plus the gap between the stated and the true nnz. The
  pattern of a product is exact, so its limit is 0.
* ``value_err``: the largest |c_ij - r_ij| / sum_k |a_ik * b_kj|, the
  error of an entry against the scale of its own products.

``control`` is the reference put in the program's place in the next lower
precision: operands rounded to bfloat16, products and sums in float32.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

Block = Tuple[int, int, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


def row_blocks(a_indptr: torch.Tensor, a_indices: torch.Tensor,
               b_indptr: torch.Tensor, max_products: int):
    """Row ranges [r0, r1) of A whose products stay near ``max_products``
    (a single row may exceed it)."""
    per_entry = (b_indptr[1:] - b_indptr[:-1])[a_indices]
    ends = torch.cat([per_entry.new_zeros(1), torch.cumsum(per_entry, 0)])
    row_end = ends[a_indptr].cpu()
    m = a_indptr.shape[0] - 1
    blocks, r0 = [], 0
    while r0 < m:
        limit = int(row_end[r0]) + max_products
        r1 = int(torch.searchsorted(row_end, limit, right=True)) - 1
        r1 = min(max(r1, r0 + 1), m)
        blocks.append((r0, r1))
        r0 = r1
    return blocks


def expand_block(a, b, r0: int, r1: int, n_cols: int,
                 dtype=torch.float64) -> Block:
    """ESC over A's rows [r0, r1). ``a`` and ``b`` are (indptr, indices,
    values) triples. Returns (r0, r1, counts, cols, vals, abs_sums): per-row
    lengths and the block's entries in (row, column) order."""
    a_ptr, a_idx, a_val = a
    b_ptr, b_idx, b_val = b
    dev = a_idx.device
    e0, e1 = int(a_ptr[r0]), int(a_ptr[r1])
    k = a_idx[e0:e1]
    lens = (b_ptr[1:] - b_ptr[:-1])[k]
    n_prod = int(lens.sum())
    a_row_len = a_ptr[r0 + 1:r1 + 1] - a_ptr[r0:r1]
    local_row = torch.repeat_interleave(
        torch.arange(r1 - r0, device=dev), a_row_len, output_size=e1 - e0)
    src = torch.repeat_interleave(torch.arange(e1 - e0, device=dev), lens,
                                  output_size=n_prod)
    first = torch.cumsum(lens, 0) - lens
    b_pos = b_ptr[k][src] + torch.arange(n_prod, device=dev) - first[src]
    col = b_idx[b_pos]
    prod = a_val[e0:e1][src].to(dtype) * b_val[b_pos].to(dtype)
    key = local_row[src] * n_cols + col
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    vals = torch.zeros(uniq.shape[0], dtype=dtype, device=dev)
    vals.index_add_(0, inv, prod)
    abs_sums = torch.zeros(uniq.shape[0], dtype=dtype, device=dev)
    abs_sums.index_add_(0, inv, prod.abs())
    counts = torch.bincount(uniq // n_cols, minlength=r1 - r0)
    return r0, r1, counts, uniq % n_cols, vals, abs_sums


def blocks(a, b, n_cols: int, max_products: int,
           dtype=torch.float64) -> Iterator[Block]:
    """The reference product block by block."""
    for r0, r1 in row_blocks(a[0], a[1], b[0], max_products):
        yield expand_block(a, b, r0, r1, n_cols, dtype)


def compare(c: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int],
            a, b, n_cols: int, max_products: int = 1 << 26
            ) -> Dict[str, float]:
    """Readings of the program's C = (indptr, indices, values, nnz) against
    the reference of A·B. Returns pattern_mismatch, value_err and the
    reference's nnz_c."""
    c_ptr, c_idx, c_val, c_nnz = c
    c_ptr = c_ptr.long()
    mismatch = 0
    worst = 0.0
    nnz = 0
    for r0, r1, counts, cols, vals, abs_sums in blocks(a, b, n_cols,
                                                       max_products):
        nnz += int(cols.shape[0])
        got = c_ptr[r0 + 1:r1 + 1] - c_ptr[r0:r1]
        bad_rows = int((got != counts).sum())
        if bad_rows:
            mismatch += bad_rows
            continue
        s0, s1 = int(c_ptr[r0]), int(c_ptr[r1])
        if s1 > min(c_idx.shape[0], c_val.shape[0]):
            mismatch += r1 - r0
            continue
        mismatch += int((c_idx[s0:s1].long() != cols).sum())
        diff = (c_val[s0:s1].to(vals.dtype) - vals).abs()
        err = torch.where(abs_sums > 0, diff / abs_sums.clamp_min(1e-300),
                          torch.where(diff == 0, 0.0, float("inf")))
        if err.numel():
            e = float(err.max())
            nan = math.isnan(e) or math.isnan(worst)
            worst = math.nan if nan else max(worst, e)
    mismatch += abs(int(c_nnz) - nnz) + abs(int(c_ptr[-1]) - nnz)
    if int(c_ptr[0]) != 0:
        mismatch += 1
    return {"pattern_mismatch": mismatch, "value_err": worst, "nnz_c": nnz}


def control(a, b, n_cols: int, max_products: int = 1 << 26):
    """The reference in the program's place, one precision lower: operands
    rounded to bfloat16, products and sums in float32. Returns C as
    (indptr, indices, values, nnz)."""
    def rounded(x):
        ptr, idx, val = x
        return ptr, idx, val.to(torch.bfloat16).to(torch.float32)
    ra, rb = rounded(a), rounded(b)
    m = a[0].shape[0] - 1
    counts, cols, vals = [], [], []
    for _, _, cnt, col, val, _ in blocks(ra, rb, n_cols, max_products,
                                         dtype=torch.float32):
        counts.append(cnt)
        cols.append(col.int())
        vals.append(val)
    indptr = torch.zeros(m + 1, dtype=torch.int64, device=a[0].device)
    indptr[1:] = torch.cumsum(torch.cat(counts), 0)
    return indptr, torch.cat(cols), torch.cat(vals), int(indptr[-1])
