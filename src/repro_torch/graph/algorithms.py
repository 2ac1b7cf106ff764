"""Graph algorithms on chained/masked SpGEMM: triangles, k-hop, MCL.

PyTorch port of ``repro.graph.algorithms``. Each algorithm composes the
chain runner (``graph.chain``) with fused merge post-ops (``graph.ops``);
the multiplies run on the adjacency's device, the small host steps between
them (triangle split, frontier sets, labels) in numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.analysis import OceanConfig
from ..core.formats import CSR, csr_from_arrays, host
from ..core.planner import OceanReport

from . import ops
from .chain import ChainResult, ChainRunner, ChainStats

__all__ = ["k_hop_frontier", "lower_triangle", "markov_cluster",
           "MCLResult", "seeds_to_frontier", "triangle_count"]


def _np_dtype(c: CSR):
    """The numpy dtype of ``c``'s values."""
    return host(c.values[:0]).dtype


def _row_ids(c: CSR) -> Tuple[np.ndarray, np.ndarray]:
    """Host ``(rows, cols)`` int64 of ``c``'s stored entries."""
    ptr = host(c.indptr).astype(np.int64)
    idx = host(c.indices[: c.nnz]).astype(np.int64)
    return np.repeat(np.arange(c.m, dtype=np.int64), np.diff(ptr)), idx


def lower_triangle(adj: CSR) -> CSR:
    """Strictly-lower-triangular binary split of an adjacency matrix."""
    rows, idx = _row_ids(adj)
    keep = idx < rows
    new_ptr = np.zeros(adj.m + 1, np.int64)
    np.add.at(new_ptr, rows[keep] + 1, 1)
    vals = np.ones(int(keep.sum()), _np_dtype(adj))
    return csr_from_arrays(np.cumsum(new_ptr), idx[keep], vals, adj.shape,
                           device=adj.device)


def triangle_count(adj: CSR, cfg: OceanConfig = OceanConfig(), **kw
                   ) -> Tuple[int, OceanReport]:
    """Exact triangle count of an undirected graph: ``sum(L .* (L @ L))``
    with ``L`` the strictly-lower-triangular binary split, the mask fused
    into the executor merge. The entries are integer path counts; they are
    summed in float64, exact for any count below 2**53. ``kw`` forwards to
    the multiply (``cache=``, ``devices=``, ...)."""
    low = lower_triangle(adj)
    c, rep = ops.masked_spgemm(low, low, low, cfg, **kw)
    return int(round(float(c.values[: c.nnz].double().sum()))), rep


def seeds_to_frontier(seeds: Sequence[int], n: int, dtype=np.float32,
                      device="cuda") -> CSR:
    """A (1, n) frontier CSR with unit weight on each seed vertex."""
    cols = np.unique(np.asarray(list(seeds), np.int64))
    if len(cols) and (cols[0] < 0 or cols[-1] >= n):
        raise ValueError(f"seed out of range for n={n}")
    indptr = np.asarray([0, len(cols)], np.int64)
    return csr_from_arrays(indptr, cols, np.ones(len(cols), dtype), (1, n),
                           device=device)


def k_hop_frontier(adj: CSR, seeds: Sequence[int], hops: int,
                   cfg: OceanConfig = OceanConfig(), *,
                   runner: Optional[ChainRunner] = None,
                   stop_on_fixed_pattern: bool = False,
                   **runner_kw) -> Tuple[List[np.ndarray], ChainResult]:
    """Vertices reachable in exactly 1..``hops`` steps from ``seeds``.

    Boolean-semiring chain ``F_{k+1} = sign(F_k @ A)``, the collapse fused
    into each multiply's merge. Returns the per-hop vertex sets (host int
    arrays) and the chain result. ``runner=`` reuses a warm
    :class:`ChainRunner`; ``runner_kw`` constructs a fresh one otherwise.
    """
    if runner is None:
        runner = ChainRunner(adj, cfg, **runner_kw)
    post = ops.bool_post(adj.n)
    stats = ChainStats()
    reports = []
    frontiers: List[np.ndarray] = []
    f = seeds_to_frontier(seeds, adj.n, _np_dtype(adj), device=adj.device)
    prev: Optional[np.ndarray] = None
    for hop in range(hops):
        f, rep = runner.step(f, post=post, stats=stats)
        reports.append(rep)
        cur = host(f.indices[: f.nnz]).copy()
        frontiers.append(cur)
        if stop_on_fixed_pattern and prev is not None \
                and np.array_equal(cur, prev):
            stats.converged_at = hop + 1
            break
        prev = cur
    return frontiers, ChainResult(final=f, reports=reports, stats=stats)


@dataclasses.dataclass
class MCLResult:
    labels: np.ndarray            # (n,) cluster label per vertex
    matrix: CSR                   # converged (or last) MCL iterate
    result: ChainResult           # per-iteration reports + chain stats


def markov_cluster(adj: CSR, cfg: OceanConfig = OceanConfig(), *,
                   inflation: float = 2.0, iterations: int = 12,
                   prune_threshold: float = 1e-4,
                   runner: Optional[ChainRunner] = None,
                   **runner_kw) -> MCLResult:
    """Markov clustering (expand -> inflate -> prune loop).

    Each iteration is one fused multiply: expansion ``M @ M`` with the
    Hadamard power, column normalization and pruning folded into the merge
    (``ops.inflate_post``). Stops early once the iterate stops changing
    (pattern equal and values within 1e-7). Vertex ``j`` joins the cluster
    of the attractor row carrying its column's maximum.
    """
    m0 = ops.normalize_columns(_with_self_loops(adj))
    if runner is None:
        runner = ChainRunner(None, cfg, **runner_kw)
    post = ops.inflate_post(adj.n, inflation, prune_threshold)
    stats = ChainStats()
    reports = []
    m = m0
    for it in range(iterations):
        m_next, rep = runner.step(m, rhs=m, post=post, stats=stats)
        reports.append(rep)
        if _same_csr(m, m_next):
            stats.converged_at = it + 1
            m = m_next
            break
        m = m_next
    labels = _attractor_labels(m)
    return MCLResult(labels=labels, matrix=m,
                     result=ChainResult(final=m, reports=reports,
                                        stats=stats))


def _with_self_loops(adj: CSR) -> CSR:
    """adj + I (MCL's self-loop regularization), binarized."""
    rows, idx = _row_ids(adj)
    keys = np.unique(np.concatenate(
        [rows * adj.n + idx,
         np.arange(adj.m, dtype=np.int64) * adj.n + np.arange(adj.m)]))
    r, c = keys // adj.n, keys % adj.n
    new_ptr = np.zeros(adj.m + 1, np.int64)
    np.add.at(new_ptr, r + 1, 1)
    vals = np.ones(len(keys), _np_dtype(adj))
    return csr_from_arrays(np.cumsum(new_ptr), c, vals, adj.shape,
                           device=adj.device)


def _same_csr(x: CSR, y: CSR, tol: float = 1e-7) -> bool:
    if x.nnz != y.nnz:
        return False
    if not np.array_equal(host(x.indptr), host(y.indptr)):
        return False
    if not np.array_equal(host(x.indices[: x.nnz]),
                          host(y.indices[: y.nnz])):
        return False
    return bool(np.all(np.abs(host(x.values[: x.nnz])
                              - host(y.values[: y.nnz])) <= tol))


def _attractor_labels(m: CSR) -> np.ndarray:
    """Cluster labels from an MCL matrix: vertex j labels by the row
    holding its column's maximum (lowest row on ties); label chains then
    collapse to their attractor so one cluster shares one id."""
    rows, idx = _row_ids(m)
    vals = host(m.values[: m.nnz]).astype(np.float64)
    label = np.arange(m.n, dtype=np.int64)
    if len(idx):
        # sort by (col, val, -row) and take each column group's last
        order = np.lexsort((-rows, vals, idx))
        cols_sorted = idx[order]
        is_last = np.ones(len(order), bool)
        is_last[:-1] = cols_sorted[1:] != cols_sorted[:-1]
        label[cols_sorted[is_last]] = rows[order][is_last]
    # pointer jumping halves chain depth per pass, so ceil(log2 n) + 1
    # passes flatten any acyclic chain and bound the passes on the label
    # cycles a non-converged matrix can hold
    for _ in range(int(np.ceil(np.log2(max(m.n, 2)))) + 1):
        nxt = label[label]
        if np.array_equal(nxt, label):
            break
        label = nxt
    return label
