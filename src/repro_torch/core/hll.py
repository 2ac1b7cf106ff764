"""HyperLogLog sketches for per-row SpGEMM output-size estimation (§3.1).

PyTorch port of ``repro.core.hll``. Torch has no unsigned 32-bit
arithmetic and no count-leading-zeros, so :func:`hash32` works in int64
with the product split into 16-bit halves (no step can overflow) and
:func:`_rho` takes an exact integer bit length. Registers are int32 and
equal to the reference's bit for bit.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

HASH_MULT = 0x9E3779B9
_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) without int64
    overflow: the high half of ``c`` contributes only its low 16 bits of
    product, shifted up by 16."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def hash32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Murmur3 fmix32 finalizer over uint32 lanes, returned as int64 in
    [0, 2**32)."""
    h = x.long() & _MASK32
    h = (_mul32(h, HASH_MULT) + (seed & _MASK32)) & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _bit_length(w: torch.Tensor) -> torch.Tensor:
    """Exact bit length of non-negative int64 values below 2**32."""
    n = torch.zeros_like(w)
    v = w
    for s in (16, 8, 4, 2, 1):
        big = v >= (1 << s)
        n = n + big.long() * s
        v = torch.where(big, v >> s, v)
    return n + (v > 0).long()


def _rho(h: torch.Tensor, p: int) -> torch.Tensor:
    """Leading-zero rank of the (32-p)-bit suffix, in [1, 32-p+1]:
    ``clz32(h >> p) - p + 1`` with ``clz32(w) = 32 - bit_length(w)``."""
    w = h >> p
    return (33 - p - _bit_length(w)).int()


def _alpha(m: int) -> float:
    return {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1 + 1.079 / m))


def row_ids_from_indptr(indptr: torch.Tensor) -> torch.Tensor:
    """Row id (int64) of each valid nnz slot ``[0, indptr[-1])``."""
    m = indptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(m, device=indptr.device),
        (indptr[1:] - indptr[:-1]).long())


def sketch_registers_impl(indptr, indices, m_regs: int, num_rows: int,
                          seed: int = 0) -> torch.Tensor:
    """Registers of every row: (num_rows, m_regs) int32, a scatter-max of
    ``rho`` into ``row * m + reg``."""
    p = m_regs.bit_length() - 1
    if 1 << p != m_regs:
        raise ValueError(f"m_regs must be a power of two, got {m_regs}")
    row = row_ids_from_indptr(indptr[: num_rows + 1])
    nnz = row.shape[0]
    h = hash32(indices[:nnz], seed=seed)
    reg = h & (m_regs - 1)
    rho = _rho(h, p)
    regs = torch.zeros(num_rows * m_regs, dtype=torch.int32,
                       device=indices.device)
    regs.scatter_reduce_(0, row * m_regs + reg, rho, "amax",
                         include_self=True)
    return regs.view(num_rows, m_regs)


def build_sketches(indptr, indices, *, m_regs: int, num_rows: int,
                   seed: int = 0) -> torch.Tensor:
    """Sketches for every row of a CSR matrix: (num_rows, m_regs) int32."""
    return sketch_registers_impl(indptr, indices, m_regs, num_rows, seed)


def merge_register_partials(partials, *, num_rows: int,
                            m_regs: int) -> np.ndarray:
    """Host merge of per-shard register arrays: register-wise max.

    ``partials`` is ``[(r0, r1, regs), ...]`` where ``regs`` covers rows
    ``[r0, r1)`` (extra shape-padding rows are dropped)."""
    full = np.zeros((num_rows, m_regs), np.int32)
    for r0, r1, regs in partials:
        regs = regs.cpu().numpy() if isinstance(regs, torch.Tensor) else \
            np.asarray(regs)
        np.maximum(full[r0:r1], regs[: r1 - r0], out=full[r0:r1])
    return full


def merge_sketches(a_indptr, a_indices, b_sketches, *,
                   num_rows_a: int) -> torch.Tensor:
    """Sketch of each C row = elementwise max of the B-row sketches its A
    row selects. Returns (num_rows_a, m_regs) int32."""
    row = row_ids_from_indptr(a_indptr[: num_rows_a + 1])
    k = a_indices[: row.shape[0]].long().clamp(0, b_sketches.shape[0] - 1)
    m_regs = b_sketches.shape[1]
    out = torch.zeros((num_rows_a, m_regs), dtype=torch.int32,
                      device=b_sketches.device)
    out.scatter_reduce_(0, row[:, None].expand(-1, m_regs), b_sketches[k],
                        "amax", include_self=True)
    return out


def estimate_cardinality(sketches: torch.Tensor,
                         clip_max: Optional[int] = None) -> torch.Tensor:
    """HLL estimate per sketch row with small-range correction (f32)."""
    m = sketches.shape[-1]
    regs = sketches.float()
    inv_sum = torch.exp2(-regs).sum(-1)
    e_raw = _alpha(m) * m * m / inv_sum
    v = (sketches == 0).sum(-1).float()
    ratio = torch.where(v > 0, m / torch.clamp(v, min=1e-9),
                        torch.ones_like(v))
    e_small = m * torch.log(ratio)
    # gate on the linear-counting estimate (continuous at the 2.5m cutoff)
    e = torch.where((e_small <= 2.5 * m) & (v > 0), e_small, e_raw)
    if clip_max is not None:
        e = torch.clamp(e, 0.0, float(clip_max))
    return e
