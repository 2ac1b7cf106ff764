"""HyperLogLog merge + estimate per A row.

:func:`hll_merge` is the port of the Pallas ``hll_merge``
(``repro/kernels/hll.py:108``). For CUDA tensors it launches the warp-per-row
kernel in ``csrc/hll_merge.cu``, which reads A's CSR directly; for CPU
tensors it runs :func:`hll_merge_plain` (``core.hll.merge_sketches`` +
``estimate_cardinality``). Both return ``(merged (RA, m) int32, est (RA,)
f32)``; the caller clips ``est``.

``hll_sketch`` (``repro/kernels/hll.py:64``) is off the main path and not
ported yet (ROADMAP queue 2, item 4).
"""
from __future__ import annotations

import torch

from ..core import hll as chll
from . import _build


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
    for name, x in (("a_indptr", a_indptr), ("a_indices", a_indices),
                    ("sketches", sk)):
        if x.device != a_indptr.device:
            raise ValueError(f"{name} on {x.device}, a_indptr on "
                             f"{a_indptr.device}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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
