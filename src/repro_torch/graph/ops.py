"""Graph-flavoured SpGEMM operations: masked multiply, prune, inflate.

PyTorch port of ``repro.graph.ops``. Masks, value transforms, pruning and
column normalization are fused into the executor's merge
(``core.executor.MergePostOps``, applied in torch to each result slab on
the multiply's device as it is collected) instead of running as separate
passes over an assembled CSR. This module builds those post-ops for the
graph algorithms and provides the standalone host equivalents (for
values-only steps between multiplies and as oracles); their results live
on the input's device.

Where the post-ops run: in the one merge there is, in torch on the
multiply's device. Mask membership is a ``torch.searchsorted`` against the
mask's keys, moved to the device once per ``MergePostOps``; a
``transform`` takes and returns tensors (so the ones built here are
``torch.pow(v.abs(), power)`` and ``(v != 0).to(v.dtype)``); the kept
entries become a CSR source that the ``slab_scatter`` kernel copies into
C; column-sum partials are float64, summed per column by a stable sort and
``esc.segment_sum`` (no atomics) and folded in dispatch order. Nothing of
a slab goes to the host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.analysis import OceanConfig
from ..core.executor import MergePostOps
from ..core.formats import CSR, csr_from_arrays, host
from ..core.planner import OceanReport
from ..core.workflow import ocean_spgemm

__all__ = ["bool_post", "inflate", "inflate_post", "mask_post",
           "masked_spgemm", "normalize_columns", "prune", "spgemm_mask"]


# ---------------------------------------------------------------------------
# MergePostOps constructors
# ---------------------------------------------------------------------------

def mask_post(mask: CSR, *, threshold: float = 0.0) -> MergePostOps:
    """Keep only entries of the product present in ``mask``'s pattern
    (``mask .* (A @ B)``), optionally dropping small values too."""
    return MergePostOps(n_cols=mask.n, mask_indptr=host(mask.indptr),
                        mask_indices=host(mask.indices[: mask.nnz]),
                        threshold=threshold)


def bool_post(n_cols: int) -> MergePostOps:
    """Boolean-semiring collapse: every accumulated value becomes 1.0."""
    return MergePostOps(n_cols=n_cols,
                        transform=lambda v: (v != 0).to(v.dtype))


def inflate_post(n_cols: int, power: float,
                 threshold: float = 0.0) -> MergePostOps:
    """MCL inflation fused into the expansion's merge: Hadamard power,
    column normalization and post-normalization pruning."""
    return MergePostOps(n_cols=n_cols,
                        transform=lambda v: torch.pow(v.abs(), power),
                        col_normalize=True, threshold=threshold)


# ---------------------------------------------------------------------------
# Masked multiply
# ---------------------------------------------------------------------------

def masked_spgemm(a: CSR, b: CSR, mask: CSR,
                  cfg: OceanConfig = OceanConfig(), *,
                  threshold: float = 0.0,
                  **kw) -> Tuple[CSR, OceanReport]:
    """``mask .* (A @ B)`` with the mask fused into the executor merge.
    The plan is post-independent, so it is shared with unmasked calls on
    the same pattern pair. ``kw`` forwards to ``ocean_spgemm``."""
    if mask.shape != (a.m, b.n):
        raise ValueError(f"mask shape {mask.shape} != product shape "
                         f"{(a.m, b.n)}")
    return ocean_spgemm(a, b, cfg, post=mask_post(mask,
                                                  threshold=threshold), **kw)


# the GraphBLAS spelling C<M> = A @ B
spgemm_mask = masked_spgemm


# ---------------------------------------------------------------------------
# Host-side standalone equivalents
# ---------------------------------------------------------------------------

def _rebuild(c: CSR, keep: np.ndarray,
             vals: Optional[np.ndarray] = None) -> CSR:
    """Rebuild of a CSR keeping a boolean subset of its nnz (host work,
    result on ``c``'s device)."""
    ptr = host(c.indptr).astype(np.int64)
    idx = host(c.indices[: c.nnz])
    v = host(c.values[: c.nnz]) if vals is None else vals
    rows = np.repeat(np.arange(c.m, dtype=np.int64), np.diff(ptr))
    new_ptr = np.zeros(c.m + 1, np.int64)
    np.add.at(new_ptr, rows[keep] + 1, 1)
    return csr_from_arrays(np.cumsum(new_ptr), idx[keep], v[keep], c.shape,
                           device=c.device)


def prune(c: CSR, threshold: float) -> CSR:
    """Drop entries with ``|value| < threshold``. The fused variant is
    ``MergePostOps(threshold=...)``."""
    vals = host(c.values[: c.nnz])
    return _rebuild(c, np.abs(vals) >= threshold)


def normalize_columns(c: CSR) -> CSR:
    """Make ``c`` column-stochastic (columns with zero sum stay zero)."""
    idx = host(c.indices[: c.nnz])
    raw = host(c.values[: c.nnz])
    vals = raw.astype(np.float64)
    colsum = np.zeros(c.n, np.float64)
    np.add.at(colsum, idx, vals)
    denom = np.where(colsum[idx] == 0.0, 1.0, colsum[idx])
    out = (vals / denom).astype(raw.dtype)
    return _rebuild(c, np.ones(len(idx), bool), vals=out)


def inflate(c: CSR, power: float, threshold: float = 0.0) -> CSR:
    """Standalone MCL inflation: Hadamard power + column normalization
    (+ optional prune). The fused variant is :func:`inflate_post`."""
    raw = host(c.values[: c.nnz])
    vals = np.power(np.abs(raw).astype(np.float64), power)
    powered = _rebuild(c, np.ones(c.nnz, bool), vals=vals.astype(raw.dtype))
    out = normalize_columns(powered)
    return prune(out, threshold) if threshold > 0.0 else out
