"""SpGEMM serving front-end: plan-cached, tenant-aware multiplies.

PyTorch port of ``repro.serving.spgemm_service``.
Production SpGEMM traffic (graph iterations, MoE dispatch, recurring
serving requests) multiplies the *same sparsity patterns* over and over
with fresh values. This module is the synchronous core of the serving
tier: every request is keyed by structure, plans are reused from a
per-service LRU cache, streams against a common right-hand side share
B sketches, and graph chains persist feed-forward :class:`SizeFeed`\\ s
per RHS.

Multi-tenancy lives here too: ``tenant=`` on :meth:`SpGEMMService.multiply`
/ :meth:`SpGEMMService.run_chain` routes a request through that tenant's
private plan-cache namespace (a
:class:`~repro_torch.core.planner.TenantPlanCache` view over the shared
LRU, with fairness-aware eviction: per-tenant quota before global LRU) and
per-tenant sketch/size-feed buckets. The queued, micro-batched front-end
that faces concurrent traffic is
:class:`repro_torch.serving.pool.SpGEMMPool`, which wraps one service
instance; :class:`ServiceStats` carries the shared SLO metrics (latency
percentiles, queue depth, batch occupancy, shed rate) for both.
``devices=`` shards every request across a device set.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.analysis import OceanConfig
from ..core.dispatch import resolve_devices
from ..core.formats import CSR, lru_bucket, structure_hash
from ..core.planner import OceanReport, PlanCache
from ..core.workflow import ocean_spgemm
from ..graph.chain import ChainResult, ChainRunner, SizeFeed
from ..obs.metrics import MetricsRegistry

# per-RHS buckets retained per tenant (sketch caches / size feeds); a
# tenant's stream usually reuses a handful of right-hand sides
RHS_BUCKETS_PER_TENANT = 8

# latency reservoir bound: percentiles are exact over the most recent
# LATENCY_SAMPLE_CAP requests (old entries age out, so p99 tracks current
# traffic instead of averaging over the service's whole lifetime)
LATENCY_SAMPLE_CAP = 4096


def _counter_property(name: str, doc: Optional[str] = None) -> property:
    """A ServiceStats field backed by the registry series ``name``: reads
    return the series value, ``stats.field += n`` writes through. The
    field and any exported snapshot can never disagree — they are one
    number."""
    def fget(self):
        return self.registry.counter(name).value

    def fset(self, v):
        self.registry.counter(name).value = v

    return property(fget, fset, doc=doc)


def _gauge_property(name: str, agg: str) -> property:
    def fget(self):
        return self.registry.gauge(name, agg=agg).value

    def fset(self, v):
        self.registry.gauge(name, agg=agg).value = v

    return property(fget, fset)


class ServiceStats:
    """Request counters + SLO metrics shared by :class:`SpGEMMService`
    and :class:`~repro_torch.serving.pool.SpGEMMPool`.

    Every public counter/gauge field is a *view* over this instance's
    :class:`~repro_torch.obs.metrics.MetricsRegistry` (``stats.registry``):
    ``stats.requests += 1`` writes the ``requests`` series, and
    ``stats.registry.snapshot()`` exports the same numbers — one set of
    values, not two that can drift. Latency percentiles are exact
    linear-interpolated quantiles (numpy's default convention) over a
    bounded histogram reservoir of the most recent request latencies;
    queue/batch/shed fields are maintained by the pool (they stay zero for
    direct synchronous service use). Per-worker aggregation is
    :meth:`merge` (fold another stats object in, race-free against
    concurrent recording on either side) and :meth:`reset` zeroes every
    series in place.
    """

    requests = _counter_property("requests")
    plan_hits = _counter_property("plan_hits")
    plan_misses = _counter_property("plan_misses")
    total_seconds = _counter_property("total_seconds")
    setup_seconds = _counter_property("setup_seconds")
    # pipelined-executor overlap: host-merge work moved off the
    # post-barrier critical path (OceanReport.overlap_seconds), and
    # the total merge work it is a fraction of
    overlap_seconds = _counter_property("overlap_seconds")
    merge_seconds = _counter_property("merge_seconds")
    # chain traffic (run_chain): iterations across all chains, how many
    # reused a cached plan outright, and how many fresh builds were sized
    # from a feed-forward SizeFeed (estimation skipped, workflow 'known')
    chains = _counter_property("chains")
    chain_iterations = _counter_property("chain_iterations")
    chain_plan_hits = _counter_property("chain_plan_hits")
    chain_feed_forward_skips = _counter_property("chain_feed_forward_skips")
    chain_estimated_builds = _counter_property("chain_estimated_builds")
    # pool traffic (serving.pool): admission control + micro-batching
    shed = _counter_property(
        "shed", "requests rejected by admission control")
    batches = _counter_property(
        "batches", "micro-batches dispatched to workers")
    batched_requests = _counter_property(
        "batched_requests", "requests served through those batches")
    queue_depth = _gauge_property("queue_depth", "sum")
    queue_depth_peak = _gauge_property("queue_depth_peak", "max")
    queue_wait_seconds = _counter_property(
        "queue_wait_seconds", "total submit -> dispatch wait")
    # plan warmer (serving.pool.SpGEMMPool): plans speculatively built
    # from queued requests, and worker-side plan-cache hits served by a
    # plan the warmer built (counted separately from organic plan_hits;
    # None tenant key = the default un-namespaced tenant)
    plans_warmed = _counter_property("plans_warmed")
    plan_warm_hits = _counter_property("plan_warm_hits")
    # sketch-cache accounting, separate from plan-cache hits: sketch
    # bucket lookups that hit, and the subset whose sketches the warmer
    # had inserted before a worker touched the request (warm-path hits)
    sketch_hits = _counter_property("sketch_hits")
    sketch_warm_hits = _counter_property("sketch_warm_hits")

    def __init__(self):
        self.registry = MetricsRegistry()
        self._lock = threading.Lock()
        # pre-create the latency reservoir so its cap is pinned
        self._latency_hist = self.registry.histogram(
            "latency_seconds", cap=LATENCY_SAMPLE_CAP)

    @property
    def plan_warm_hits_by_tenant(self) -> Dict[Optional[str], int]:
        """Warm plan-cache hits per tenant (plain dict view of the
        ``plan_warm_hits`` series that carry a ``tenant`` label)."""
        return self.registry.labeled_values("plan_warm_hits", "tenant")

    @property
    def sketch_warm_hits_by_tenant(self) -> Dict[Optional[str], int]:
        """Warm sketch-bucket hits per tenant."""
        return self.registry.labeled_values("sketch_warm_hits", "tenant")

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-ready export of every series (``registry.snapshot()``)."""
        return self.registry.snapshot()

    @property
    def hit_rate(self) -> float:
        return self.plan_hits / max(self.requests, 1)

    @property
    def merge_overlap_frac(self) -> float:
        return self.overlap_seconds / self.merge_seconds \
            if self.merge_seconds > 0.0 else 0.0

    @property
    def chain_reuse_rate(self) -> float:
        """Fraction of chain iterations that skipped estimation entirely
        (plan reuse or feed-forward sizing)."""
        done = self.chain_plan_hits + self.chain_feed_forward_skips
        return done / max(self.chain_iterations, 1)

    # -------------------- SLO metrics --------------------

    def record_latency(self, seconds: float) -> None:
        """Add one request latency to the bounded reservoir (oldest
        entries drop once ``LATENCY_SAMPLE_CAP`` is exceeded)."""
        with self._lock:
            self._latency_hist.record(seconds)

    def latency_sample(self) -> List[float]:
        """Snapshot of the retained latency sample (seconds, submit
        order)."""
        with self._lock:
            return self._latency_hist.sample()

    def latency_percentile(self, q: float) -> float:
        """Exact ``q``-th percentile (0..100) of the retained sample,
        linear interpolation between closest ranks (numpy's default
        method). 0.0 when no latency has been recorded."""
        with self._lock:
            return self._latency_hist.percentile(q)

    @property
    def p50_seconds(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p95_seconds(self) -> float:
        return self.latency_percentile(95.0)

    @property
    def p99_seconds(self) -> float:
        return self.latency_percentile(99.0)

    @property
    def shed_rate(self) -> float:
        """Fraction of submitted requests rejected by admission control
        (shed / (served + shed))."""
        return self.shed / max(self.requests + self.shed, 1)

    @property
    def batch_occupancy(self) -> float:
        """Mean requests per dispatched micro-batch (1.0 = no batching
        benefit; higher = compatible requests coalesced)."""
        return self.batched_requests / max(self.batches, 1)

    def note_queue_depth(self, depth: int) -> None:
        """Record the pool's current queue depth (tracks the peak)."""
        with self._lock:
            self.registry.gauge("queue_depth", agg="sum").set(depth)
            self.registry.gauge("queue_depth_peak", agg="max").set_max(depth)

    def note_plan_warm_hit(self, tenant: Optional[str]) -> None:
        """Count a plan-cache hit that was served by a warmed plan."""
        with self._lock:
            self.registry.counter("plan_warm_hits").inc()
            self.registry.counter("plan_warm_hits", tenant=tenant).inc()

    def note_sketch_hit(self, tenant: Optional[str], warm: bool) -> None:
        """Count a sketch-bucket hit (``warm`` = the warmer built it)."""
        with self._lock:
            self.registry.counter("sketch_hits").inc()
            if warm:
                self.registry.counter("sketch_warm_hits").inc()
                self.registry.counter("sketch_warm_hits",
                                      tenant=tenant).inc()

    # -------------------- aggregation --------------------

    def merge(self, other: "ServiceStats") -> None:
        """Fold ``other``'s series into this stats object (counters sum,
        queue_depth sums, queue_depth_peak takes the max, latency
        reservoirs concatenate under the cap). Safe against concurrent
        recording on either side; per-worker pools merge into a fleet
        aggregate this way."""
        with self._lock:
            self.registry.merge(other.registry)

    def reset(self) -> None:
        """Zero every series in place (identities survive, values
        restart) — e.g. between benchmark phases."""
        with self._lock:
            self.registry.reset()


class SketchCache(dict):
    """Per-(tenant, RHS) sketch bucket with warm-hit accounting.

    Behaves as the plain dict every consumer expects (``core.analysis``
    probes with ``in``/``[]``/``get`` and inserts with assignment), with
    two additions: the pool's plan warmer marks the keys it inserted via
    :meth:`mark_warm`, and every subsequent hit is counted on
    :class:`ServiceStats` — separately from plan-cache hits — so the
    warmer's effect on sketch reuse is observable per tenant."""

    def __init__(self, *, tenant: Optional[str] = None, stats=None):
        super().__init__()
        self.tenant = tenant
        self._stats = stats
        self._warm: set = set()

    def mark_warm(self, keys) -> None:
        """Tag ``keys`` as warmer-inserted (hits on them count warm)."""
        self._warm.update(keys)

    def __getitem__(self, key):
        val = super().__getitem__(key)
        if self._stats is not None:
            self._stats.note_sketch_hit(self.tenant, key in self._warm)
        return val

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default


class SpGEMMService:
    """Stateful SpGEMM endpoint with plan caching across requests.

    Requests run on their operands' device, or with ``devices`` (a device
    list or count, resolved once) device-partitioned, every request's
    sharded plan in the cache under the structure key plus the topology.
    ``analysis_devices`` shards each plan-building request's analysis
    (default: ``devices``); it changes no result and no cache key.

    ``tenant=`` on :meth:`multiply`/:meth:`run_chain` isolates a caller
    into its own plan-cache namespace and per-tenant sketch/size-feed
    buckets; ``tenant_plan_quota`` bounds any one tenant's share of the
    shared plan cache (fairness-aware eviction — the tenant's own LRU
    entry goes first). ``tenant=None`` (default) uses the shared
    un-namespaced cache.
    """

    def __init__(self, cfg: OceanConfig = OceanConfig(), *,
                 plan_cache_size: int = 64, devices=None,
                 analysis_devices=None,
                 executor: str = "pipelined",
                 tenant_plan_quota: Optional[int] = None):
        self.cfg = cfg
        self.plan_cache = PlanCache(maxsize=plan_cache_size,
                                    tenant_quota=tenant_plan_quota)
        self.stats = ServiceStats()
        # service-wide default; individual requests may override
        self.executor = executor
        # resolved once, so every request shards over one topology (and
        # hits the same cached sharded plan)
        self.devices = (resolve_devices(devices) if devices is not None
                        else None)
        self.analysis_devices = (resolve_devices(analysis_devices)
                                 if analysis_devices is not None
                                 else self.devices)
        # per-tenant namespaces of per-RHS buckets, keyed by B's structure
        # hash. Sketch caches hold HLL sketches (value-independent, so
        # isolation is a memory-fairness choice, not a correctness one);
        # size feeds hold O(m)-int exact sizings that outlive any plan's
        # LRU lifetime. None = the default (un-namespaced) tenant.
        self._tenant_sketch_caches: Dict[Optional[str], OrderedDict] = {}
        self._tenant_size_feeds: Dict[Optional[str], OrderedDict] = {}

    def plan_cache_for(self, tenant: Optional[str] = None):
        """The plan cache a request under ``tenant`` consults: the shared
        cache itself for ``None``, else that tenant's namespaced view."""
        if tenant is None:
            return self.plan_cache
        return self.plan_cache.namespaced(tenant)

    def sketch_cache_for(self, b: CSR, tenant: Optional[str] = None) -> Dict:
        """The per-(tenant, RHS-structure) sketch bucket for ``b``."""
        buckets = self._tenant_sketch_caches.setdefault(
            tenant, OrderedDict())
        return lru_bucket(
            buckets, structure_hash(b),
            lambda: SketchCache(tenant=tenant, stats=self.stats),
            maxsize=RHS_BUCKETS_PER_TENANT)

    def multiply(self, a: CSR, b: CSR, *,
                 tenant: Optional[str] = None,
                 force_workflow: Optional[str] = None,
                 assisted: bool = True,
                 hybrid: bool = True,
                 executor: Optional[str] = None) -> Tuple[CSR, OceanReport]:
        """Serve one C = A @ B request through the plan cache.

        ``tenant`` routes the request through that tenant's cache
        namespaces (plans, sketches); outputs are identical regardless.
        ``executor`` overrides the service default for this request
        (``"pipelined"`` merges each launch as it completes,
        ``"serial"`` keeps the global barrier; output is identical)."""
        t0 = time.perf_counter()
        c, report = ocean_spgemm(
            a, b, self.cfg, force_workflow=force_workflow,
            assisted=assisted, hybrid=hybrid,
            cache=self.plan_cache_for(tenant),
            sketch_cache=self.sketch_cache_for(b, tenant),
            devices=self.devices,
            analysis_devices=self.analysis_devices,
            executor=executor if executor is not None else self.executor)
        dt = time.perf_counter() - t0
        self.stats.requests += 1
        self.stats.plan_hits += int(report.plan_cache_hit)
        self.stats.plan_misses += int(not report.plan_cache_hit)
        self.stats.total_seconds += dt
        self.stats.setup_seconds += report.setup_seconds
        self.stats.overlap_seconds += report.overlap_seconds
        self.stats.merge_seconds += report.stage_seconds.get("merge", 0.0)
        self.stats.record_latency(dt)
        return c, report

    def multiply_many(self, a_list: Sequence[CSR], b: CSR, **kw
                      ) -> List[Tuple[CSR, OceanReport]]:
        """Serve a stream of left-hand sides against one B (shared
        sketches, shared plan cache)."""
        return [self.multiply(a, b, **kw) for a in a_list]

    def size_feed_for(self, b: CSR, tenant: Optional[str] = None
                      ) -> SizeFeed:
        """The per-(tenant, RHS-structure) feed-forward size feed."""
        buckets = self._tenant_size_feeds.setdefault(tenant, OrderedDict())
        return lru_bucket(buckets, structure_hash(b), SizeFeed,
                          maxsize=RHS_BUCKETS_PER_TENANT)

    def run_chain(self, c0: CSR, a: CSR, iterations: int, *,
                  tenant: Optional[str] = None,
                  post=None, square: bool = False,
                  stop_on_fixed_pattern: bool = False,
                  executor: Optional[str] = None) -> ChainResult:
        """Serve a chained multiply ``C_{k+1} = C_k @ A`` (the graph-
        iteration access pattern: k-hop, label propagation, MCL with
        ``square=True``).

        Plans live in a per-chain cache (heavyweight, device-resident —
        iteration-to-iteration reuse is where they pay off), while the
        feed-forward :class:`~repro_torch.graph.chain.SizeFeed` persists on the
        service per (tenant, right-hand side): a warm service re-plans
        previously seen pattern pairs with exact ``known_sizes`` and never
        re-estimates (``ServiceStats.chain_feed_forward_skips``).
        Returns the :class:`~repro_torch.graph.chain.ChainResult` (final
        CSR, per-iteration reports, chain stats).
        """
        t0 = time.perf_counter()
        runner = ChainRunner(
            a, self.cfg, size_feed=self.size_feed_for(a, tenant),
            devices=self.devices, analysis_devices=self.analysis_devices,
            executor=executor if executor is not None else self.executor)
        res = runner.run(c0, iterations, post=post, square=square,
                         stop_on_fixed_pattern=stop_on_fixed_pattern)
        st = res.stats
        self.stats.chains += 1
        self.stats.chain_iterations += st.iterations
        self.stats.chain_plan_hits += st.plan_hits
        self.stats.chain_feed_forward_skips += st.feed_forward_skips
        self.stats.chain_estimated_builds += st.estimated_builds
        self.stats.total_seconds += time.perf_counter() - t0
        self.stats.setup_seconds += st.setup_seconds
        for rep in res.reports:
            self.stats.overlap_seconds += rep.overlap_seconds
            self.stats.merge_seconds += rep.stage_seconds.get("merge", 0.0)
        return res
