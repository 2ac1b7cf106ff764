"""Chained SpGEMM with plan reuse and exact feed-forward sizing.

PyTorch port of ``repro.graph.chain``. Iterative graph
workloads multiply against a fixed right-hand side again and again
(``C_{k+1} = C_k @ A`` for k-hop frontiers) or square the iterate
(``C_{k+1} = C_k @ C_k`` for MCL expansion). Two facts make such chains
cheaper than independent multiplies:

* **plan reuse**: once the iterate's pattern repeats, its structure key
  hits the per-chain plan cache and planning is skipped;
* **exact feed-forward sizing**: every numeric pass measures the exact row
  nnz of its pattern pair; :class:`SizeFeed` keeps them, so a re-plan of the
  same pair bins with ``known_sizes=`` (workflow ``"known"``) and skips
  sketching, merging and the symbolic pass.

The output CSR feeds straight back in as the next left-hand side, B's
sketches are shared across the chain, and fused merge post-ops
(``repro_torch.graph.ops``) ride along each multiply. With ``devices=``
every iteration runs device-partitioned (``core.partition``), its sharded
plan cached under the structure key plus the topology.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.analysis import OceanConfig
from ..core.dispatch import resolve_devices, topology_key
from ..core.executor import MergePostOps
from ..core.formats import CSR, host, lru_bucket, structure_hash
from ..core.partition import partition_plan
from ..core.planner import (OceanReport, PlanCache, build_plan,
                            execute_plan, execute_sharded_plan,
                            structure_key)

__all__ = ["ChainResult", "ChainRunner", "ChainStats", "SizeFeed",
           "spgemm_chain", "structure_hash"]


class SizeFeed:
    """Exact output row nnz measured by past numeric passes, keyed by the
    product's structure key. An entry is a device- and value-independent
    fact of the pattern pair; LRU-bounded (an entry is O(m) int64)."""

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self._sizes: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[np.ndarray]:
        sizes = self._sizes.get(key)
        if sizes is None:
            self.misses += 1
            return None
        self._sizes.move_to_end(key)
        self.hits += 1
        return sizes

    def __contains__(self, key: str) -> bool:
        return key in self._sizes

    def record(self, key: str, sizes: np.ndarray) -> None:
        # a copy: the caller's array (often a live report's raw_row_nnz)
        # must not alias a trusted feed entry
        self._sizes[key] = np.array(sizes, np.int64, copy=True)
        self._sizes.move_to_end(key)
        while len(self._sizes) > self.maxsize:
            self._sizes.popitem(last=False)

    def __len__(self) -> int:
        return len(self._sizes)

    def clear(self) -> None:
        self._sizes.clear()
        self.hits = 0
        self.misses = 0


@dataclasses.dataclass
class ChainStats:
    """Chain-level counters (one per :meth:`ChainRunner.run`; the runner
    also accumulates a lifetime copy)."""
    iterations: int = 0
    plan_hits: int = 0                  # structure key repeated, plan reused
    feed_forward_skips: int = 0         # fresh builds sized from a SizeFeed
    estimated_builds: int = 0           # fresh builds that ran full planning
    converged_at: Optional[int] = None  # iteration the pattern fixed (if any)
    nnz_trajectory: List[int] = dataclasses.field(default_factory=list)
    workflows: List[str] = dataclasses.field(default_factory=list)
    total_seconds: float = 0.0
    setup_seconds: float = 0.0

    @property
    def plan_misses(self) -> int:
        return self.feed_forward_skips + self.estimated_builds


@dataclasses.dataclass
class ChainResult:
    final: CSR
    reports: List[OceanReport]
    stats: ChainStats


class ChainRunner:
    """Stateful runner for iterated multiplies against a (usually fixed)
    right-hand side. Holds the per-chain plan cache, the RHS sketch caches
    and the :class:`SizeFeed`; all three are injectable.
    ``devices``/``analysis_devices`` are ``ocean_spgemm``'s and apply to
    every iteration."""

    def __init__(self, rhs: Optional[CSR],
                 cfg: OceanConfig = OceanConfig(), *,
                 plan_cache: Optional[PlanCache] = None,
                 plan_cache_size: int = 32,
                 size_feed: Optional[SizeFeed] = None,
                 devices=None,
                 analysis_devices=None):
        self.rhs = rhs
        self.cfg = cfg
        self.plan_cache = (plan_cache if plan_cache is not None
                           else PlanCache(maxsize=plan_cache_size))
        self.size_feed = size_feed if size_feed is not None else SizeFeed()
        self.devices = (resolve_devices(devices) if devices is not None
                        else None)
        self.analysis_devices = (resolve_devices(analysis_devices)
                                 if analysis_devices is not None
                                 else self.devices)
        self.stats = ChainStats()           # lifetime accumulation
        self._sketch_caches: "OrderedDict[str, Dict]" = OrderedDict()

    def _sketch_cache_for(self, rhs: CSR) -> Dict:
        return lru_bucket(self._sketch_caches, structure_hash(rhs), dict)

    def step(self, c: CSR, *, rhs: Optional[CSR] = None,
             post: Optional[MergePostOps] = None,
             stats: Optional[ChainStats] = None
             ) -> Tuple[CSR, OceanReport]:
        """One iteration: ``c @ rhs`` (``rhs`` defaults to the chain's).

        Plan resolution: plan cache -> size feed (a ``known_sizes`` build)
        -> a full estimation-based build. The cache key is the clean
        structure key (plus the topology when sharded), so a feed-forward
        plan serves later lookups of the same pattern pair."""
        rhs = self.rhs if rhs is None else rhs
        if rhs is None:
            raise ValueError("no right-hand side: pass rhs= to step() or "
                             "construct the runner with one")
        t0 = time.perf_counter()
        key = structure_key(c, rhs, self.cfg, None, True, True)
        lkey = (key if self.devices is None
                else key + "|" + topology_key(self.devices))
        plan = self.plan_cache.lookup(lkey)
        lookup_s = time.perf_counter() - t0
        # "hit" (no planning; also a base plan that only needed
        # partitioning), "known" (built from a size feed) or "estimated"
        # (built with full prediction)
        resolved = "hit"
        if plan is None:
            base = (self.plan_cache.peek(key) if self.devices is not None
                    else None)
            if base is None:
                known = self.size_feed.get(key)
                base = build_plan(c, rhs, self.cfg, key=key,
                                  sketch_cache=self._sketch_cache_for(rhs),
                                  analysis_devices=self.analysis_devices,
                                  known_sizes=known)
                self.plan_cache.insert(key, base)
                stage = dict(base.build_seconds)
                resolved = "known" if known is not None else "estimated"
            else:
                stage = {"analysis": 0.0, "prediction": 0.0, "binning": 0.0}
            if self.devices is not None:
                t0 = time.perf_counter()
                plan = partition_plan(base, self.devices)
                stage["partition"] = time.perf_counter() - t0
                self.plan_cache.insert(lkey, plan)
            else:
                plan = base
        else:
            stage = {"analysis": 0.0, "prediction": 0.0, "binning": 0.0}
        stage["plan_lookup"] = lookup_s

        run = execute_plan if self.devices is None else execute_sharded_plan
        c_out, rep = run(plan, c, rhs, stage=stage,
                         cache_hit=resolved == "hit", post=post)

        # the measured raw product sizes of this pattern pair feed the next
        # plan of the pair; a plan hit with a resident entry skips the
        # O(m) re-record (an identical pair measures identical sizes)
        if resolved != "hit" or key not in self.size_feed:
            raw = (rep.raw_row_nnz if rep.raw_row_nnz is not None
                   else np.diff(host(c_out.indptr)).astype(np.int64))
            self.size_feed.record(key, raw)

        for st in (self.stats,) if stats is None else (self.stats, stats):
            st.iterations += 1
            st.plan_hits += int(resolved == "hit")
            st.feed_forward_skips += int(resolved == "known")
            st.estimated_builds += int(resolved == "estimated")
            st.nnz_trajectory.append(rep.nnz_out)
            st.workflows.append(rep.workflow)
            st.total_seconds += rep.total_seconds
            st.setup_seconds += rep.setup_seconds
        return c_out, rep

    def run(self, c0: CSR, iterations: int, *,
            rhs: Optional[CSR] = None,
            post: Optional[MergePostOps] = None,
            square: bool = False,
            stop_on_fixed_pattern: bool = False) -> ChainResult:
        """Run ``iterations`` chained multiplies from ``c0``.

        ``square=True`` multiplies the iterate by itself (MCL expansion).
        ``stop_on_fixed_pattern`` stops once an iteration leaves the
        sparsity pattern unchanged (values may still change)."""
        stats = ChainStats()
        reports: List[OceanReport] = []
        c = c0
        prev_hash = structure_hash(c0) if stop_on_fixed_pattern else None
        for it in range(iterations):
            c, rep = self.step(c, rhs=(c if square else rhs), post=post,
                               stats=stats)
            reports.append(rep)
            if stop_on_fixed_pattern:
                cur = structure_hash(c)
                if cur == prev_hash:
                    stats.converged_at = it + 1
                    break
                prev_hash = cur
        return ChainResult(final=c, reports=reports, stats=stats)


def spgemm_chain(c0: CSR, a: CSR, iterations: int,
                 cfg: OceanConfig = OceanConfig(), *,
                 post: Optional[MergePostOps] = None,
                 stop_on_fixed_pattern: bool = False,
                 **runner_kw) -> ChainResult:
    """One-shot chain ``C_{k+1} = C_k @ A`` for ``iterations`` steps with
    per-chain plan reuse and feed-forward sizing. ``runner_kw`` forwards
    to :class:`ChainRunner`."""
    runner = ChainRunner(a, cfg, **runner_kw)
    return runner.run(c0, iterations, post=post,
                      stop_on_fixed_pattern=stop_on_fixed_pattern)
