"""ESC (Expand-Sort-Compact) accumulation and the exact symbolic pass.

PyTorch port of ``repro.core.esc``. Expansion is a ``repeat_interleave``
product enumeration at the exact product count (no pow2 ``p_cap``: there
is no jit specialization to share), keys are always int64
``row * n_cols + col`` (the reference's int32 packing overflows at
``(m + 1) * n >= 2**31``, e.g. 2**20 x 2**20), sorting is a stable
``torch.sort`` and compaction a segment sum. Plain torch on whatever device
the inputs live on: this rung was XLA, not Pallas, in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .formats import CSR
from .hll import row_ids_from_indptr


class EscOverflowError(ValueError):
    """ESC output exceeded its capacity bound (a sizing bug: capacities
    handed to ESC are per-row product upper bounds)."""


class Expanded(NamedTuple):
    rows: torch.Tensor   # (P,) int64 output row of each product
    cols: torch.Tensor   # (P,) int64 output column of each product
    vals: Optional[torch.Tensor]  # (P,) a_ik * b_kj (None without values)


def expand(a_indptr, a_indices, a_values, b_indptr, b_indices, b_values,
           *, num_rows_a: int, with_values: bool = True) -> Expanded:
    """Enumerate all intermediate products of C = A @ B, in A-slot-major,
    B-position-minor order (the reference's enumeration order)."""
    dev = a_indices.device
    a_row = row_ids_from_indptr(a_indptr[: num_rows_a + 1])
    nnz_a = a_row.shape[0]
    k = a_indices[:nnz_a].long()
    b_ptr = b_indptr.long()
    reps = (b_ptr[1:] - b_ptr[:-1])[k]
    total = int(reps.sum()) if nnz_a else 0
    j = torch.repeat_interleave(torch.arange(nnz_a, device=dev), reps,
                                output_size=total)
    first = torch.cumsum(reps, 0) - reps
    t = torch.arange(total, device=dev) - first[j]
    b_pos = b_ptr[k[j]] + t
    rows = a_row[j]
    cols = b_indices[b_pos].long()
    vals = a_values[j] * b_values[b_pos] if with_values else None
    return Expanded(rows, cols, vals)


def pack_keys(rows: torch.Tensor, cols: torch.Tensor,
              n_cols: int) -> torch.Tensor:
    """Paper §4.2 key packing, always int64 (``row * n_cols + col``)."""
    return rows.long() * int(n_cols) + cols.long()


def segment_sum(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sums of consecutive segments of ``values`` by
    ``torch.segment_reduce``: on the host each segment is summed in order,
    on the card as a tree (cub's segmented reduce); deterministic on both,
    unlike an atomic ``index_add_``."""
    if lengths.numel() == 0:
        return values.new_zeros(0)
    return torch.segment_reduce(values, "sum", lengths=lengths, unsafe=True)


class ESCResult(NamedTuple):
    indptr: torch.Tensor   # (m+1,) int32
    indices: torch.Tensor  # (nnz,) int32
    values: torch.Tensor   # (nnz,) float
    nnz: int               # true output nnz


def esc_spgemm(a_indptr, a_indices, a_values, b_indptr, b_indices,
               b_values, *, num_rows_a: int, n_cols_b: int) -> ESCResult:
    """Full ESC SpGEMM over exact sizes."""
    dev = a_indices.device
    ex = expand(a_indptr, a_indices, a_values, b_indptr, b_indices,
                b_values, num_rows_a=num_rows_a)
    key = pack_keys(ex.rows, ex.cols, n_cols_b)
    key_s, perm = torch.sort(key, stable=True)
    val_s = ex.vals[perm]
    uniq, counts = torch.unique_consecutive(key_s, return_counts=True)
    nnz = int(uniq.shape[0])
    out_vals = segment_sum(val_s, counts)
    row_of = uniq // n_cols_b
    col_of = (uniq % n_cols_b).int()
    row_counts = torch.bincount(row_of, minlength=num_rows_a)
    indptr = torch.zeros(num_rows_a + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(row_counts, 0).int()
    return ESCResult(indptr, col_of, out_vals, nnz)


def symbolic_exact(a_indptr, a_indices, b_indptr, b_indices, *,
                   num_rows_a: int, n_cols_b: int) -> torch.Tensor:
    """Exact per-row output nnz — the classical symbolic pass (indices
    only). Returns (num_rows_a,) int64 on the inputs' device."""
    ex = expand(a_indptr, a_indices, None, b_indptr, b_indices, None,
                num_rows_a=num_rows_a, with_values=False)
    key = pack_keys(ex.rows, ex.cols, n_cols_b)
    del ex
    uniq = torch.unique_consecutive(torch.sort(key).values)
    return torch.bincount(uniq // n_cols_b, minlength=num_rows_a)


def symbolic_exact_host(a_indptr, a_indices, b_indptr, b_indices,
                        *, num_rows_a: int, n_cols_b: int) -> np.ndarray:
    """Host (numpy) twin of :func:`symbolic_exact` — the reference's
    function as is; the planner takes it on the CPU."""
    a_ptr = np.asarray(a_indptr, np.int64)
    b_ptr = np.asarray(b_indptr, np.int64)
    m = int(num_rows_a)
    a_idx = np.asarray(a_indices, np.int64)[: int(a_ptr[-1])]
    b_idx = np.asarray(b_indices, np.int64)
    reps = (b_ptr[1:] - b_ptr[:-1])[a_idx]
    total = int(reps.sum())
    if total == 0:
        return np.zeros(m, np.int32)
    a_rows = np.repeat(np.arange(m, dtype=np.int64), a_ptr[1:] - a_ptr[:-1])
    rows = np.repeat(a_rows, reps)
    ends = np.cumsum(reps)
    offs = np.arange(total, dtype=np.int64) - np.repeat(ends - reps, reps)
    cols = b_idx[np.repeat(b_ptr[a_idx], reps) + offs]
    key = rows * int(n_cols_b) + cols
    key.sort()
    head = np.ones(total, bool)
    head[1:] = key[1:] != key[:-1]
    return np.bincount(key[head] // int(n_cols_b),
                       minlength=m).astype(np.int32)


def ensure_esc_capacity(nnz: int, out_cap: int, *, where: str = "ESC") -> int:
    """Single overflow gate for every ESC materialization point (strictly
    greater raises; capacity == nnz is fine)."""
    nnz = int(nnz)
    if nnz > out_cap:
        raise EscOverflowError(
            f"{where} overflow: nnz {nnz} > capacity {out_cap}")
    return nnz


def esc_to_csr(res: ESCResult, shape, out_cap: int) -> CSR:
    """Materialize an ESCResult as a CSR (nnz <= out_cap)."""
    nnz = ensure_esc_capacity(res.nnz, out_cap)
    return CSR(res.indptr, res.indices, res.values,
               tuple(int(s) for s in shape), nnz)
