"""Stiffness pattern of 3-D linear elasticity on trilinear (Q1) hexahedra,
as PETSc's ex56 (``src/ksp/ksp/tutorials/ex56.c``) assembles it on one
process: ``-ne n`` elements a side give ``(n + 1)**3`` nodes.

A brick of ``nx * ny * nz`` nodes, ``dofs_per_node`` unknowns a node. Two
nodes couple when they share an element, so a node's row holds the 27-node
stencil (|dx|, |dy|, |dz| <= 1, clipped at the faces), and each coupling
is a dense block of ``dofs_per_node`` x ``dofs_per_node``. In natural
ordering (node = x + nx * (y + ny * z), dof = dofs_per_node * node + c)
the pattern is the Kronecker product Kz ⊗ Ky ⊗ Kx ⊗ J, with K a 1-D
tridiagonal pattern and J all ones. The pattern is the same for every
seed; the values are drawn from the seed, uniform in [-1, 1).
"""
from __future__ import annotations

import torch

from ..work import Matrix, Operands


def tridiagonal(n: int, device) -> tuple:
    """The 1-D pattern |i - j| <= 1 as (indptr, indices), int64."""
    i = torch.arange(n, device=device)
    cols = torch.stack([i - 1, i, i + 1], 1)
    keep = (cols >= 0) & (cols < n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(keep.sum(1), 0)
    return indptr, cols[keep]


def dense_block(n: int, device) -> tuple:
    """The all-ones n x n pattern as (indptr, indices)."""
    indptr = torch.arange(n + 1, device=device) * n
    return indptr, torch.arange(n, device=device).repeat(n)


def kron(p: tuple, q: tuple) -> tuple:
    """Pattern of P ⊗ Q: row (i1, i2) holds columns j1 * n2 + j2 in
    increasing order, for j1 in P's row i1 and j2 in Q's row i2."""
    p_ptr, p_idx = p
    q_ptr, q_idx = q
    m2 = q_ptr.shape[0] - 1
    len_p = p_ptr[1:] - p_ptr[:-1]
    len_q = q_ptr[1:] - q_ptr[:-1]
    lens = (len_p[:, None] * len_q[None, :]).reshape(-1)
    indptr = torch.zeros(lens.shape[0] + 1, dtype=torch.int64,
                         device=p_ptr.device)
    indptr[1:] = torch.cumsum(lens, 0)
    total = int(indptr[-1])
    row = torch.repeat_interleave(
        torch.arange(lens.shape[0], device=p_ptr.device), lens,
        output_size=total)
    t = torch.arange(total, device=p_ptr.device) - indptr[row]
    i1, i2 = row // m2, row % m2
    lq = len_q[i2]
    cols = (p_idx[p_ptr[i1] + t // lq] * m2 + q_idx[q_ptr[i2] + t % lq])
    return indptr, cols


def pattern(nodes, dofs_per_node: int, device) -> tuple:
    """(indptr, indices) of the brick's stiffness pattern."""
    nx, ny, nz = nodes
    node = kron(kron(tridiagonal(nz, device), tridiagonal(ny, device)),
                tridiagonal(nx, device))
    return kron(node, dense_block(dofs_per_node, device))


def make(cfg: dict, seed: int, value_sets: int, device) -> Operands:
    """A = B = the stiffness pattern, with ``value_sets`` seeded value
    sets drawn on ``device`` in one call."""
    indptr, indices = pattern(cfg["nodes"], cfg["dofs_per_node"], device)
    rows = indptr.shape[0] - 1
    gen = torch.Generator(device=device).manual_seed(seed)
    values = torch.rand((value_sets, indices.shape[0]), generator=gen,
                        device=device) * 2.0 - 1.0
    return Operands(Matrix(indptr, indices, values, (rows, rows)))
