"""Device-partitioned ExecutionPlans: shard the bin ladder across devices.

PyTorch port of ``repro.core.partition``. Each bin's rows are divided into
per-device shards balanced by the plan's estimated per-row product counts,
greedy LPT with one load heap shared across the whole ladder, and each
shard takes row slices of the bin's ELL tensors (indexed on the bin's
device, then moved to the shard's), so partitioning never re-runs
analysis, prediction or binning. Every kernel's per-row output is
independent of the other rows of its launch, so executing the shards and
merging their slabs reproduces the single-device C bit for bit
(``planner.execute_sharded_plan``).

CUDA launches have no jit specializations to bound, so slices are not
padded to the reference's pow2 row ladder (``n_valid == len(rows)``); the
ladder functions are kept, equal to the reference's, for the plans and
tools that read them. A device set may repeat a device: shards are then
logical, as on a machine with one card.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .dispatch import resolve_devices, topology_key
from .formats import flat_gather_index, pow2_at_least
from .planner import DenseBinExec, EscExec, ExecutionPlan, HashBinExec

__all__ = [
    "PlanShard", "ShardedPlan", "balanced_split", "bucket_shard_rows",
    "contiguous_split", "partition_plan", "resolve_devices",
    "rung_capacity_cap", "topology_key",
]

# the reference's shard row ladder (pow2 from this floor, clamped to the
# bin) and the floor of its ESC shard nnz ladder
SHARD_ROW_FLOOR = 32
ESC_SHARD_NNZ_FLOOR = 64


def bucket_shard_rows(n_rows: int, bin_rows: int) -> int:
    """The reference's padded row count for a shard of ``n_rows`` sliced
    from a bin of ``bin_rows``: the next pow2 rung, clamped to the bin."""
    return min(pow2_at_least(n_rows, floor=SHARD_ROW_FLOOR), bin_rows)


def rung_capacity_cap(costs: np.ndarray, r_pad: int, bin_cap: int, *,
                      floor: int = 64) -> int:
    """Topology-independent capacity of a shard at rung ``r_pad``: the pow2
    cover of the sum of the bin's ``r_pad`` largest per-row costs (an
    exact power of two stays), clamped to the bin-level capacity."""
    costs = np.asarray(costs, np.int64)
    k = min(int(r_pad), len(costs))
    if k <= 0:
        return min(pow2_at_least(1, floor=floor), max(bin_cap, 1))
    top = np.partition(costs, len(costs) - k)[len(costs) - k:]
    return min(pow2_at_least(int(top.sum()), floor=floor),
               max(bin_cap, 1))


def contiguous_split(costs: np.ndarray,
                     n_shards: int) -> List[Tuple[int, int]]:
    """Split rows ``0..len(costs)`` into ``n_shards`` contiguous ``[start,
    end)`` blocks balancing the summed cost (prefix-sum targets). Blocks
    may be empty when rows run out; a zero-cost matrix splits rows
    equally. Contiguity keeps sharded-stage merges exact concatenations."""
    costs = np.asarray(costs, np.int64)
    m = len(costs)
    if n_shards <= 1 or m == 0:
        return [(0, m)] + [(m, m)] * (max(n_shards, 1) - 1)
    cum = np.cumsum(costs)
    total = int(cum[-1])
    if total <= 0:
        bounds = np.linspace(0, m, n_shards + 1).round().astype(np.int64)
    else:
        targets = total * np.arange(1, n_shards, dtype=np.float64) / n_shards
        inner = np.searchsorted(cum, targets, side="left") + 1
        bounds = np.concatenate([[0], inner, [m]])
    bounds = np.maximum.accumulate(np.clip(bounds, 0, m))
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n_shards)]


def balanced_split(costs: np.ndarray, n_shards: int,
                   heap: Optional[list] = None) -> List[np.ndarray]:
    """Split positions ``0..len(costs)-1`` into ``n_shards`` groups by
    greedy LPT (heaviest first onto the least-loaded shard). ``heap``
    (``[(load, shard), ...]``) carries the load across calls, so that
    consecutive bins balance against the global load. Each group's
    positions come back ascending."""
    costs = np.asarray(costs, np.int64)
    if heap is None:
        heap = [(0, i) for i in range(n_shards)]
        heapq.heapify(heap)
    sel: List[List[int]] = [[] for _ in range(n_shards)]
    for p in np.argsort(-costs, kind="stable"):
        load, i = heapq.heappop(heap)
        sel[i].append(int(p))
        heapq.heappush(heap, (load + int(costs[p]), i))
    return [np.sort(np.asarray(s, np.int64)) for s in sel]


def _take(x: torch.Tensor, idx: torch.Tensor, device) -> torch.Tensor:
    """Rows ``idx`` of ``x``, indexed where ``x`` lives, on ``device``
    (no copy beyond the gather when it is the same device)."""
    return x[idx].to(device)


def _slice_dense(be: DenseBinExec, sel: np.ndarray, device) -> DenseBinExec:
    """Row subset of a dense bin: the bin's window, tiles, cap and ELL
    width; the value gather map (``pos``/``valid``) stays on the plan's
    device, where A's values live, the kernel inputs go to ``device``."""
    idx = torch.from_numpy(sel).to(be.a_rows.device)
    return DenseBinExec(
        window=be.window, col_tiles=be.col_tiles, cap=be.cap,
        rows=be.rows[sel], out_rows=be.out_rows[idx],
        ell_width=be.ell_width, is_longrow=be.is_longrow, pos=be.pos[idx],
        valid=be.valid[idx],
        a_rows=_take(be.a_rows, idx, device),
        a_starts=_take(be.a_starts, idx, device),
        a_lens=_take(be.a_lens, idx, device),
        row_lo=_take(be.row_lo, idx, device), cost=be.cost[sel],
        bin_id=be.bin_id, n_valid=len(sel))


def _slice_hash(hb: HashBinExec, sel: np.ndarray, device) -> HashBinExec:
    """Row subset of a hash bin: table, spill and ELL width are the bin's
    (never the slice's), so each row's table is as in the whole bin."""
    idx = torch.from_numpy(sel).to(hb.a_rows.device)
    return HashBinExec(
        table=hb.table, spill=hb.spill, rows=hb.rows[sel],
        out_rows=hb.out_rows[idx], ell_width=hb.ell_width, pos=hb.pos[idx],
        valid=hb.valid[idx],
        a_rows=_take(hb.a_rows, idx, device),
        a_starts=_take(hb.a_starts, idx, device),
        a_lens=_take(hb.a_lens, idx, device), cost=hb.cost[sel],
        bin_id=hb.bin_id, n_valid=len(sel), f_chunk=hb.f_chunk,
        tile=hb.tile)


def _slice_esc(ex: EscExec, sel: np.ndarray, device) -> EscExec:
    """Row subset of the ESC bin through a flat segment gather of its
    sub-CSR; ``src`` (into A's values) stays on the plan's device. The
    capacity is the subset's exact product count."""
    new_ptr, seg = flat_gather_index(ex.sub_indptr, sel)
    seg_t = torch.from_numpy(seg).to(ex.sub_indices.device)
    cost = ex.cost[sel]
    return EscExec(
        rows=ex.rows[sel],
        out_rows=ex.out_rows[torch.from_numpy(sel).to(ex.out_rows.device)],
        sub_indptr=torch.from_numpy(new_ptr.astype(np.int32)).to(device),
        sub_indices=_take(ex.sub_indices, seg_t, device),
        src=ex.src[seg_t.to(ex.src.device)], out_cap=int(cost.sum()),
        cost=cost, n_valid=len(sel))


@dataclasses.dataclass
class PlanShard:
    """One device's slice of the bin ladder."""
    index: int
    device: torch.device
    dense: List[DenseBinExec]
    esc: Optional[EscExec]
    cost: int                       # summed estimated products assigned
    hash: List[HashBinExec] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ShardedPlan:
    """A device-partitioned :class:`ExecutionPlan`: wraps (never copies)
    the base plan; shards hold row slices of its bins. Cached by
    ``workflow.ocean_spgemm(..., devices=...)`` under the base key and the
    :func:`topology_key`."""
    plan: ExecutionPlan
    devices: Tuple
    shards: List[PlanShard]
    topology: str
    shard_costs: np.ndarray         # (n_shards,) int64

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def imbalance(self) -> float:
        """max/mean estimated cost across shards (1.0 = perfect)."""
        mean = float(self.shard_costs.mean()) if len(self.shard_costs) else 0.0
        if mean <= 0.0:
            return 1.0
        return float(self.shard_costs.max()) / mean

    def describe(self) -> Dict[str, object]:
        return {"topology": self.topology, "n_shards": self.n_shards,
                "shard_costs": self.shard_costs.tolist(),
                "imbalance": round(self.imbalance, 4)}


def partition_plan(plan: ExecutionPlan, devices=None) -> ShardedPlan:
    """Partition a plan's bin ladder across a device set (greedy LPT on the
    estimated per-row products, one load heap across bins). With one
    device the plan's own bins are wrapped and nothing is copied."""
    devs = resolve_devices(devices)
    topo = topology_key(devs)
    if len(devs) == 1:
        cost = int(sum(int(be.cost.sum()) for be in plan.dense)
                   + sum(int(hb.cost.sum()) for hb in plan.hash)
                   + (int(plan.esc.cost.sum()) if plan.esc is not None
                      else 0))
        shard = PlanShard(index=0, device=devs[0], dense=list(plan.dense),
                          esc=plan.esc, cost=cost, hash=list(plan.hash))
        return ShardedPlan(plan=plan, devices=devs, shards=[shard],
                           topology=topo,
                           shard_costs=np.asarray([cost], np.int64))

    d = len(devs)
    heap = [(0, i) for i in range(d)]
    heapq.heapify(heap)
    dense_by_shard: List[List[DenseBinExec]] = [[] for _ in range(d)]
    hash_by_shard: List[List[HashBinExec]] = [[] for _ in range(d)]
    esc_by_shard: List[Optional[EscExec]] = [None] * d
    for be in plan.dense:
        for i, sel in enumerate(balanced_split(be.cost, d, heap)):
            if len(sel):
                dense_by_shard[i].append(_slice_dense(be, sel, devs[i]))
    for hb in plan.hash:
        for i, sel in enumerate(balanced_split(hb.cost, d, heap)):
            if len(sel):
                hash_by_shard[i].append(_slice_hash(hb, sel, devs[i]))
    if plan.esc is not None:
        for i, sel in enumerate(balanced_split(plan.esc.cost, d, heap)):
            if len(sel):
                esc_by_shard[i] = _slice_esc(plan.esc, sel, devs[i])
    loads = np.zeros(d, np.int64)
    for load, i in heap:
        loads[i] = load
    shards = [PlanShard(index=i, device=devs[i], dense=dense_by_shard[i],
                        esc=esc_by_shard[i], cost=int(loads[i]),
                        hash=hash_by_shard[i])
              for i in range(d)]
    return ShardedPlan(plan=plan, devices=devs, shards=shards, topology=topo,
                       shard_costs=loads)
