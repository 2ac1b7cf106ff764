"""Seeded synthetic graph generators: R-MAT and Erdős–Rényi adjacency CSRs.

PyTorch port of ``repro.graph.generators``: the same numpy ``default_rng``
streams, so a key gives the reference's arrays exactly, placed on
``device`` (default ``"cuda"``). Both emit canonical CSR (rows sorted,
strictly increasing columns within a row, no duplicates) with unit weights
by default — the boolean-adjacency form triangle counting, k-hop and MCL
consume. R-MAT gives the skewed power-law degree regime, Erdős–Rényi the
uniform one. Generation is host numpy work, O(edges * scale) for R-MAT.
"""
from __future__ import annotations

import numpy as np

from ..core.formats import CSR, csr_from_arrays

__all__ = ["erdos_renyi_csr", "rmat_csr"]


def _edges_to_csr(rows: np.ndarray, cols: np.ndarray, n: int, *,
                  symmetric: bool, self_loops: bool, weights: str,
                  rng: np.random.Generator, dtype, device) -> CSR:
    """Canonicalize an edge list: dedupe, optional symmetrize/de-loop."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if symmetric:
        rows, cols = (np.concatenate([rows, cols]),
                      np.concatenate([cols, rows]))
    if not self_loops:
        keep = rows != cols
        rows, cols = rows[keep], cols[keep]
    keys = np.unique(rows * np.int64(n) + cols)
    rows, cols = keys // n, keys % n
    if weights == "unit":
        vals = np.ones(len(keys), dtype)
    elif weights == "random":
        # drawn after dedup so the value stream is canonical-order stable
        vals = rng.uniform(0.5, 1.5, len(keys)).astype(dtype)
    else:
        raise ValueError(f"unknown weights mode {weights!r}")
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return csr_from_arrays(np.cumsum(indptr), cols, vals, (n, n),
                           device=device)


def erdos_renyi_csr(key: int, n: int, avg_degree: float, *,
                    symmetric: bool = True, self_loops: bool = False,
                    weights: str = "unit", dtype=np.float32,
                    device="cuda") -> CSR:
    """G(n, m) Erdős–Rényi adjacency: ``n * avg_degree`` sampled edges
    (mirrored when ``symmetric``, so the degree is about twice that)."""
    rng = np.random.default_rng(key)
    m_edges = max(1, int(round(n * avg_degree)))
    rows = rng.integers(0, n, m_edges)
    cols = rng.integers(0, n, m_edges)
    return _edges_to_csr(rows, cols, n, symmetric=symmetric,
                         self_loops=self_loops, weights=weights, rng=rng,
                         dtype=dtype, device=device)


def rmat_csr(key: int, scale: int, edge_factor: int = 8, *,
             a: float = 0.57, b: float = 0.19, c: float = 0.19,
             symmetric: bool = True, self_loops: bool = False,
             weights: str = "unit", dtype=np.float32, device="cuda") -> CSR:
    """R-MAT graph (Graph500-style): ``n = 2**scale`` vertices,
    ``edge_factor * n`` sampled edges with recursive quadrant probabilities
    ``(a, b, c, d=1-a-b-c)``; each edge draws one quadrant per bit level."""
    d = 1.0 - a - b - c
    if d < 0:
        raise ValueError("rmat probabilities must sum to <= 1")
    n = 1 << scale
    rng = np.random.default_rng(key)
    m_edges = max(1, edge_factor * n)
    # quadrant per (edge, level): 0 -> (0,0), 1 -> (0,1), 2 -> (1,0), 3 -> (1,1)
    q = rng.choice(4, size=(m_edges, scale), p=[a, b, c, d])
    bits = (np.int64(1) << np.arange(scale - 1, -1, -1, dtype=np.int64))
    rows = ((q >> 1) & 1).astype(np.int64) @ bits
    cols = (q & 1).astype(np.int64) @ bits
    return _edges_to_csr(rows, cols, n, symmetric=symmetric,
                         self_loops=self_loops, weights=weights, rng=rng,
                         dtype=dtype, device=device)
