"""HyperLogLog sketch construction, and merge + estimate per A row.

:func:`hll_sketch` is the port of the Pallas ``hll_sketch``
(``repro/kernels/hll.py:64``): for CUDA tensors it launches the warp-per-row
kernel in ``csrc/hll_sketch.cu``, which reads B's CSR directly; for CPU
tensors it runs ``core.hll.sketch_registers_impl``. Both hash with the
seeded ``core.hll.hash32``, so at seed 0 they equal the Pallas kernel.

:func:`hll_merge` is the port of the Pallas ``hll_merge``
(``repro/kernels/hll.py:108``). For CUDA tensors it launches the warp-per-row
kernel in ``csrc/hll_merge.cu``, which reads A's CSR directly; for CPU
tensors it runs :func:`hll_merge_plain` (``core.hll.merge_sketches`` +
``estimate_cardinality``). Both return ``(merged (RA, m) int32, est (RA,)
f32)``; the caller clips ``est``.
"""
from __future__ import annotations

import torch

from ..core import hll as chll
from . import _build


def _check_int32(pairs, device) -> None:
    for name, x in pairs:
        if x.device != device:
            raise ValueError(f"{name} on {x.device}, expected {device}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def hll_sketch(indptr, indices, *, m_regs: int, seed: int = 0):
    """Registers of every row of a CSR pattern: (R, m_regs) int32, where
    R = len(indptr) - 1. ``m_regs`` is a power of two, at most 128."""
    if m_regs <= 0 or m_regs > 128 or m_regs & (m_regs - 1):
        raise ValueError(f"m_regs {m_regs} must be a power of two <= 128")
    r = indptr.shape[0] - 1
    if indptr.device.type == "cpu":
        return chll.sketch_registers_impl(indptr, indices, m_regs, r, seed)
    _check_int32((("indptr", indptr), ("indices", indices)), indptr.device)
    regs = torch.empty((r, m_regs), dtype=torch.int32, device=indptr.device)
    if r == 0:
        return regs
    _build.launch("ocean_hll_sketch", indptr.device, indptr.data_ptr(),
                  indices.data_ptr(), regs.data_ptr(), r, m_regs,
                  seed & 0xFFFFFFFF)
    hll_sketch.launches += 1
    return regs


hll_sketch.launches = 0  # launch count of the CUDA kernel


def hll_merge_plain(a_indptr, a_indices, sketches_with_sentinel):
    """Plain PyTorch version: segment max of the gathered sketch rows, then
    the estimate."""
    ra = a_indptr.shape[0] - 1
    merged = chll.merge_sketches(a_indptr, a_indices, sketches_with_sentinel,
                                 num_rows_a=ra)
    return merged, chll.estimate_cardinality(merged)


def hll_merge(a_indptr, a_indices, sketches_with_sentinel):
    """Merge the B-row sketches each A row selects and estimate the
    cardinality of the union.

    a_indptr (RA+1,) int32 and a_indices int32: A's CSR structure.
    sketches_with_sentinel: (NB+1, m) int32, the last row all zeros; ids
    outside [0, NB+1) act as that sentinel.
    """
    if a_indptr.device.type == "cpu":
        return hll_merge_plain(a_indptr, a_indices, sketches_with_sentinel)
    sk = sketches_with_sentinel
    _check_int32((("a_indptr", a_indptr), ("a_indices", a_indices),
                  ("sketches", sk)), a_indptr.device)
    nb1, m = sk.shape
    if m not in (32, 64, 128):
        raise ValueError(f"m_regs {m} not in (32, 64, 128)")
    ra = a_indptr.shape[0] - 1
    merged = torch.empty((ra, m), dtype=torch.int32, device=sk.device)
    est = torch.empty(ra, dtype=torch.float32, device=sk.device)
    if ra == 0:
        return merged, est
    _build.launch(
        "ocean_hll_merge", sk.device, a_indptr.data_ptr(),
        a_indices.data_ptr(), sk.data_ptr(), merged.data_ptr(),
        est.data_ptr(), ra, nb1, m, chll._alpha(m) * m * m)
    hll_merge.launches += 1
    return merged, est


hll_merge.launches = 0  # launch count of the CUDA kernel
