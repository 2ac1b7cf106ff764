"""Graph500 Kernel-1 graph: R-MAT edges, labels permuted, symmetrised.

``edge_factor * 2**scale`` edges, each drawing one quadrant a bit level
with probabilities (A, B, C, D). The edge list comes from the
configuration's fixed ``graph_seed``, so every run squares the same graph;
the run's seed permutes the vertex labels, as the specification does, and
draws a weight for each undirected edge uniform in [0, 1), as its SSSP
kernel does, so A is symmetric in values too. So
every seed gives the same sizes (rows, nnz, products, nnz of C) in another
order. Self-loops and duplicate edges are dropped after symmetrising.
"""
from __future__ import annotations

import torch

from ..work import Matrix, Operands


def edges(scale: int, edge_factor: int, probs, graph_seed: int, device):
    """(rows, cols) int64 of the R-MAT edge list, before any clean-up."""
    a, b, c, _ = probs
    n_edges = edge_factor << scale
    gen = torch.Generator(device=device).manual_seed(graph_seed)
    u = torch.rand((n_edges, scale), generator=gen, device=device,
                   dtype=torch.float64)
    row_bit = u >= a + b                     # quadrants C and D
    col_bit = ((u >= a) & (u < a + b)) | (u >= a + b + c)  # B and D
    weight = torch.pow(2, torch.arange(scale - 1, -1, -1, device=device))
    return ((row_bit.long() * weight).sum(1),
            (col_bit.long() * weight).sum(1))


def graph(cfg: dict, perm: torch.Tensor) -> tuple:
    """(indptr, indices) of the symmetrised, de-looped, de-duplicated
    graph with vertex v relabelled ``perm[v]``."""
    n = 1 << cfg["scale"]
    rows, cols = edges(cfg["scale"], cfg["edge_factor"], cfg["probs"],
                       cfg["graph_seed"], perm.device)
    rows, cols = perm[rows], perm[cols]
    rows, cols = torch.cat([rows, cols]), torch.cat([cols, rows])
    keep = rows != cols
    keys = torch.unique(rows[keep] * n + cols[keep])
    rows, cols = keys // n, keys % n
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=perm.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return indptr, cols


def make(cfg: dict, seed: int, value_sets: int, device) -> Operands:
    """A = B = the graph's weighted adjacency, ``value_sets`` weight sets."""
    n = 1 << cfg["scale"]
    gen = torch.Generator(device=device).manual_seed(seed)
    perm = torch.randperm(n, generator=gen, device=device)
    indptr, indices = graph(cfg, perm)
    rows = torch.repeat_interleave(torch.arange(n, device=device),
                                   indptr[1:] - indptr[:-1])
    edge = torch.minimum(rows, indices) * n + torch.maximum(rows, indices)
    undirected, slot = torch.unique(edge, return_inverse=True)
    weights = torch.rand((value_sets, undirected.shape[0]), generator=gen,
                         device=device)
    return Operands(Matrix(indptr, indices, weights[:, slot], (n, n)))
