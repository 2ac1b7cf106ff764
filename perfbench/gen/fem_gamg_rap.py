"""Operands of the Galerkin coarse operator of smoothed-aggregation AMG on
PETSc's ex56 (``src/ksp/ksp/tutorials/ex56.c``) under GAMG: C = R·(A·P)
with R = Pᵀ explicit. The cell multiplies the second product, R times AP.

The brick has ``n = ne + 1`` nodes a side and 3 dofs a node; its stiffness
pattern is K ⊗ K ⊗ K ⊗ J(3×3), K the 1-D tridiagonal stencil (as
``fem_q1`` builds it). Aggregates are ``s`` nodes a side, ``n // s`` a
side, the last one taking the remainder: node i lies in aggregate
``min(i // s, n // s - 1)``. Each aggregate carries the six rigid-body
modes, orthonormalised over its dofs, so the tentative prolongator has a
dense 3 × 6 block at each node of an aggregate. One smoothing step,
P = (I - ω D⁻¹ A)·P_tent, gives P the pattern of A·P_tent.

Every factor is a Kronecker product of 1-D factors on a line of n nodes:
T (n × n // s) the aggregation, P1 = pattern(K·T), AP1 = pattern(K·P1),
R1 = P1ᵀ; then

    R  = R1 ⊗ R1 ⊗ R1 ⊗ J(6×3)     (coarse × fine)
    AP = AP1 ⊗ AP1 ⊗ AP1 ⊗ J(3×6)  (fine × coarse)

in ex56's one-process ordering (fine dof = 3·node + component, node =
x + n·(y + n·z)) and coarse dof = 6·agg + mode, agg = ax + na·(ay + na·az).
The patterns are the same for every seed; the values of R and of AP are
drawn from the seed, uniform in [-1, 1).
"""
from __future__ import annotations

import torch

from ..work import Matrix, Operands
from .fem_q1 import tridiagonal


def ones(rows: int, cols: int, device) -> tuple:
    """The all-ones rows x cols pattern as (indptr, indices, cols)."""
    indptr = torch.arange(rows + 1, device=device) * cols
    return indptr, torch.arange(cols, device=device).repeat(rows), cols


def kron(p: tuple, q: tuple) -> tuple:
    """Pattern of P ⊗ Q for rectangular factors, each (indptr, indices,
    n_cols): row (i1, i2) holds columns j1 * n_cols(Q) + j2 in increasing
    order. (``fem_q1.kron`` strides columns by Q's row count, which serves
    square factors only.)"""
    p_ptr, p_idx, p_cols = p
    q_ptr, q_idx, q_cols = q
    dev = p_ptr.device
    m2 = q_ptr.shape[0] - 1
    len_p = p_ptr[1:] - p_ptr[:-1]
    len_q = q_ptr[1:] - q_ptr[:-1]
    lens = (len_p[:, None] * len_q[None, :]).reshape(-1)
    indptr = torch.zeros(lens.shape[0] + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(lens, 0)
    total = int(indptr[-1])
    row = torch.repeat_interleave(torch.arange(lens.shape[0], device=dev),
                                  lens, output_size=total)
    t = torch.arange(total, device=dev) - indptr[row]
    i1, i2 = row // m2, row % m2
    del row
    lq = len_q[i2]
    cols = (p_idx[p_ptr[i1] + t // lq] * q_cols
            + q_idx[q_ptr[i2] + t % lq])
    return indptr, cols, p_cols * q_cols


def _dense(pattern, n_cols: int) -> torch.Tensor:
    indptr, indices = pattern
    rows = torch.repeat_interleave(torch.arange(indptr.shape[0] - 1),
                                   indptr[1:] - indptr[:-1])
    out = torch.zeros((indptr.shape[0] - 1, n_cols), dtype=torch.int64)
    out[rows, indices] = 1
    return out


def _pattern(dense: torch.Tensor, device) -> tuple:
    """(indptr, indices, n_cols) of a dense matrix's nonzeros, columns
    ascending."""
    nz = dense != 0
    indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int64)
    indptr[1:] = torch.cumsum(nz.sum(1), 0)
    return (indptr.to(device), nz.nonzero()[:, 1].to(device),
            dense.shape[1])


def line_factors(ne: int, agg: int) -> tuple:
    """The 1-D factors (R1, AP1) as dense 0/1 int64 matrices on the host:
    R1 is (n // agg) x n, AP1 is n x (n // agg), n = ne + 1."""
    n = ne + 1
    na = n // agg
    if na < 1:
        raise ValueError(f"{n} nodes a side hold no aggregate of {agg}")
    k = _dense(tridiagonal(n, "cpu"), n)
    t = torch.zeros((n, na), dtype=torch.int64)
    t[torch.arange(n), torch.clamp(torch.arange(n) // agg, max=na - 1)] = 1
    p1 = (k @ t > 0).long()
    ap1 = (k @ p1 > 0).long()
    return p1.T.contiguous(), ap1


def sizes(cfg: dict) -> dict:
    """The sizes of R·AP counted from the 1-D factors alone: the work of a
    Kronecker product is the product of its factors' work."""
    r1, ap1 = line_factors(cfg["ne"], cfg["aggregate_nodes"])
    modes, dofs = cfg["modes"], cfg["dofs_per_node"]
    products_1d = int((r1 @ ap1.sum(1)).sum())
    nnz_c_1d = int((r1 @ ap1 > 0).sum())
    return {"rows": r1.shape[0] ** 3 * modes,
            "inner": r1.shape[1] ** 3 * dofs,
            "nnz_r": int(r1.sum()) ** 3 * modes * dofs,
            "nnz_ap": int(ap1.sum()) ** 3 * dofs * modes,
            "products": products_1d ** 3 * modes * dofs * modes,
            "nnz_c": nnz_c_1d ** 3 * modes * modes}


def patterns(cfg: dict, device) -> tuple:
    """(R, AP) patterns, each (indptr, indices, n_cols), int64 on
    ``device``."""
    r1, ap1 = line_factors(cfg["ne"], cfg["aggregate_nodes"])
    modes, dofs = cfg["modes"], cfg["dofs_per_node"]
    r1, ap1 = _pattern(r1, device), _pattern(ap1, device)
    r = kron(kron(kron(r1, r1), r1), ones(modes, dofs, device))
    ap = kron(kron(kron(ap1, ap1), ap1), ones(dofs, modes, device))
    return r, ap


def make(cfg: dict, seed: int, value_sets: int, device) -> Operands:
    """A = R and B = AP, with ``value_sets`` seeded value sets each, R's
    drawn first, on ``device``."""
    s = sizes(cfg)
    (r_ptr, r_idx, _), (ap_ptr, ap_idx, _) = patterns(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    mats = []
    for ptr, idx, shape in ((r_ptr, r_idx, (s["rows"], s["inner"])),
                            (ap_ptr, ap_idx, (s["inner"], s["rows"]))):
        values = torch.rand((value_sets, idx.shape[0]), generator=gen,
                            device=device) * 2.0 - 1.0
        mats.append(Matrix(ptr, idx, values, shape))
    return Operands(*mats)
