"""Ocean's end-to-end SpGEMM workflow (paper Fig. 4), on PyTorch.

    analysis -> size prediction (HLL | symbolic | upper-bound)
             -> binning -> numeric accumulation -> overflow fallback
             -> post-processing (CSR compaction)

PyTorch port of ``repro.core.workflow``. The call runs on the device its
inputs live on (the hand-written CUDA kernels on a GPU, their plain
versions on the CPU), or with ``devices=`` across a device set
(``core.partition``). Ablation knobs mirror the paper's Table 3:

    V1 baseline:  force_workflow='symbolic', assisted=False, hybrid=False
    V2 (+E):      assisted=False, hybrid=False
    V3 (+AS):     assisted=True,  hybrid=False
    V4 (+HA):     assisted=True,  hybrid=True      (full Ocean)
"""
from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..obs import trace
from . import esc as esc_mod
from .analysis import AnalysisResult, OceanConfig, products_per_row
from .dispatch import resolve_devices, topology_key
from .formats import CSR
from .partition import ShardedPlan, partition_plan
from .planner import (DEFAULT_PLAN_CACHE, ExecutionPlan, OceanReport,
                      PlanCache, build_plan, execute_plan,
                      execute_sharded_plan, gather_rows, key_attrs,
                      structure_key, trace_binning)

__all__ = ["OceanReport", "ocean_spgemm", "ocean_spgemm_many",
           "spgemm_reference", "gather_rows", "warm_plan"]


def _resolve_cache(cache: Union[bool, PlanCache, None]):
    if cache is True:
        return DEFAULT_PLAN_CACHE
    if cache is False or cache is None:
        return None
    if hasattr(cache, "lookup") and hasattr(cache, "insert"):
        return cache
    raise TypeError(f"cache must be bool/None or expose lookup/insert, "
                    f"got {type(cache).__name__}")


def _check_same_device(a: CSR, b: CSR) -> None:
    if a.device != b.device:
        raise ValueError(f"A on {a.device} and B on {b.device}: both "
                         "operands must live on one device")


def _device_sets(devices, analysis_devices):
    """Resolved ``(devices, analysis_devices)``; the second defaults to
    the first."""
    devs = resolve_devices(devices) if devices is not None else None
    an_devs = (resolve_devices(analysis_devices)
               if analysis_devices is not None else devs)
    return devs, an_devs


def _partition(plan: ExecutionPlan, devs, stage: Dict[str, float]):
    """``partition_plan`` timed into ``stage["partition"]`` and its span."""
    t0 = time.perf_counter()
    splan = partition_plan(plan, devs)
    stage["partition"] = time.perf_counter() - t0
    trace.add_span("plan.partition", t0, stage["partition"])
    return splan


def _root_spanned(multiply):
    """``multiply`` as one root span, ``ocean.spgemm``, whose attrs take
    the report's cache hit and workflow."""
    @functools.wraps(multiply)
    def call(*args, **kwargs):
        with trace.root_span() as root:
            c, report = multiply(*args, **kwargs)
            root.set(cache_hit=report.plan_cache_hit,
                     workflow=report.workflow)
        return c, report
    return call


@_root_spanned
def ocean_spgemm(a: CSR, b: CSR, cfg: OceanConfig = OceanConfig(), *,
                 force_workflow: Optional[str] = None,
                 assisted: bool = True, hybrid: bool = True,
                 analysis: Optional[AnalysisResult] = None,
                 plan: Union[ExecutionPlan, ShardedPlan, None] = None,
                 cache: Union[bool, PlanCache, None] = True,
                 sketch_cache: Optional[Dict] = None,
                 devices=None,
                 analysis_devices=None,
                 known_sizes=None,
                 post=None,
                 ) -> Tuple[CSR, OceanReport]:
    """Estimation-based SpGEMM, C = A @ B, on the operands' device.
    Returns (C, report).

    ``plan``: execute a prebuilt :class:`ExecutionPlan` (or ``ShardedPlan``)
    directly.
    ``cache``: ``True`` (default) uses the process-wide LRU plan cache, a
    :class:`PlanCache` that cache, ``False``/``None`` always plans from
    scratch; a caller-supplied ``analysis`` bypasses the cache.
    ``sketch_cache``: dict shared across calls against one B to reuse HLL
    sketches. ``known_sizes``: exact per-row output nnz fed forward from a
    prior numeric pass (workflow ``"known"``).
    ``post``: fused merge post-ops (``executor.MergePostOps``: mask filter,
    value transform, prune, column-normalize) applied inside the merge;
    plans are post-independent, so a cached plan serves masked and
    unmasked calls alike (``repro_torch.graph.ops`` builds them).
    ``devices``: partition the plan's bins across a device set (a list of
    devices, repeats allowed, or a count of CUDA devices) and run the
    shards; C is the single-device C bit for bit. Sharded plans are cached
    under the structure key plus the topology, re-using a cached base
    plan. With ``plan=ExecutionPlan`` it partitions on every call; pass a
    ``ShardedPlan`` to reuse one. ``analysis_devices`` shards the analysis
    stage (default: ``devices``); it changes no result and no cache key.

    The call is one root span, ``ocean.spgemm``: while tracing, every span
    it records carries its multiply id (``trace.root_span``). The plan
    lookup's steps are timed into ``OceanReport.span_seconds``.
    """
    _check_same_device(a, b)
    if plan is not None:
        if isinstance(plan, ShardedPlan):
            if devices is not None:
                topo = topology_key(resolve_devices(devices))
                if topo != plan.topology:
                    raise ValueError(
                        f"plan was partitioned for [{plan.topology}], "
                        f"devices= requests [{topo}]; re-partition the "
                        "base plan with partition_plan(plan.plan, devices)")
            return execute_sharded_plan(plan, a, b, post=post)
        if devices is not None:
            stage = {"analysis": 0.0, "prediction": 0.0, "binning": 0.0}
            splan = _partition(plan, resolve_devices(devices), stage)
            return execute_sharded_plan(splan, a, b, stage=stage,
                                        post=post)
        return execute_plan(plan, a, b, post=post)

    devs, an_devs = _device_sets(devices, analysis_devices)
    cache_obj = _resolve_cache(cache) if analysis is None else None
    if cache_obj is not None:
        spans: Dict[str, float] = {}
        with trace.timed("plan.lookup", spans) as lookup:
            with trace.timed("plan.key", spans) as key_span:
                key = structure_key(a, b, cfg, force_workflow, assisted,
                                    hybrid, known_sizes=known_sizes)
                if trace.enabled():
                    key_span.set(**key_attrs(a, b))
            lkey = key if devs is None else key + "|" + topology_key(devs)
            with trace.timed("plan.probe", spans):
                cached = cache_obj.lookup(lkey)
            lookup.set(hit=cached is not None)
        lookup_s = lookup.seconds
        if cached is not None:
            stage = {"plan_lookup": lookup_s, "analysis": 0.0,
                     "prediction": 0.0, "binning": 0.0}
            trace_binning(cached.plan if isinstance(cached, ShardedPlan)
                          else cached, time.perf_counter(), replay=True)
            run = execute_plan if devs is None else execute_sharded_plan
            return run(cached, a, b, stage=stage, cache_hit=True, post=post,
                       span_seconds=spans)
        # a sharded miss re-uses a cached base plan of the structure (peek:
        # the lookup above already counted the miss)
        base = cache_obj.peek(key) if devs is not None else None
        if base is not None:
            stage = {"analysis": 0.0, "prediction": 0.0, "binning": 0.0}
        else:
            base = build_plan(a, b, cfg, force_workflow=force_workflow,
                              assisted=assisted, hybrid=hybrid,
                              sketch_cache=sketch_cache, key=key,
                              analysis_devices=an_devs,
                              known_sizes=known_sizes)
            cache_obj.insert(key, base)
            stage = dict(base.build_seconds)
        stage["plan_lookup"] = lookup_s
        if devs is None:
            return execute_plan(base, a, b, stage=stage, post=post,
                                span_seconds=spans)
        splan = _partition(base, devs, stage)
        cache_obj.insert(lkey, splan)
        return execute_sharded_plan(splan, a, b, stage=stage, post=post,
                                    span_seconds=spans)
    fresh = build_plan(a, b, cfg, force_workflow=force_workflow,
                       assisted=assisted, hybrid=hybrid, analysis=analysis,
                       sketch_cache=sketch_cache, analysis_devices=an_devs,
                       known_sizes=known_sizes)
    if devs is not None:
        stage = dict(fresh.build_seconds)
        splan = _partition(fresh, devs, stage)
        return execute_sharded_plan(splan, a, b, stage=stage, post=post)
    return execute_plan(fresh, a, b, stage=fresh.build_seconds, post=post)


def warm_plan(a: CSR, b: CSR, cfg: OceanConfig = OceanConfig(), *,
              force_workflow: Optional[str] = None,
              assisted: bool = True, hybrid: bool = True,
              cache: Union[bool, PlanCache, None] = True,
              sketch_cache: Optional[Dict] = None,
              devices=None, analysis_devices=None,
              known_sizes=None) -> Tuple[str, bool]:
    """Build (or verify) the cached plan for ``A @ B`` without executing
    it, keyed exactly as :func:`ocean_spgemm` keys it (with ``devices``,
    the base plan and its partition). Returns ``(cache_key, built)``;
    lookups ``peek``, so warming counts no hit or miss."""
    _check_same_device(a, b)
    cache_obj = _resolve_cache(cache)
    if cache_obj is None:
        raise ValueError("warm_plan needs a cache to warm (cache=False/None)")
    devs, an_devs = _device_sets(devices, analysis_devices)
    key = structure_key(a, b, cfg, force_workflow, assisted, hybrid,
                        known_sizes=known_sizes)
    lkey = key if devs is None else key + "|" + topology_key(devs)
    if cache_obj.peek(lkey) is not None:
        return lkey, False
    base = cache_obj.peek(key) if devs is not None else None
    if base is None:
        base = build_plan(a, b, cfg, force_workflow=force_workflow,
                          assisted=assisted, hybrid=hybrid,
                          sketch_cache=sketch_cache, key=key,
                          analysis_devices=an_devs, known_sizes=known_sizes)
        cache_obj.insert(key, base)
    if devs is not None:
        cache_obj.insert(lkey, partition_plan(base, devs))
    return lkey, True


def ocean_spgemm_many(a_list: Sequence[CSR], b: CSR,
                      cfg: OceanConfig = OceanConfig(), *,
                      force_workflow: Optional[str] = None,
                      assisted: bool = True, hybrid: bool = True,
                      cache: Union[bool, PlanCache, None, Sequence] = True,
                      sketch_cache: Union[Dict, Sequence, None] = None,
                      devices=None, analysis_devices=None,
                      post=None,
                      ) -> List[Tuple[CSR, OceanReport]]:
    """``[A_i @ B for A_i in a_list]`` against one B, sharing B's sketches
    across the stream. ``cache``/``sketch_cache`` also take one entry per
    left-hand side; ``post`` applies to every product; ``devices`` (resolved
    once) shards every multiply."""
    n = len(a_list)
    caches = (list(cache) if isinstance(cache, (list, tuple))
              else [cache] * n)
    if isinstance(sketch_cache, (list, tuple)):
        sketches = list(sketch_cache)
    else:
        shared: Dict = {} if sketch_cache is None else sketch_cache
        sketches = [shared] * n
    if len(caches) != n or len(sketches) != n:
        raise ValueError(
            f"per-item cache/sketch_cache sequences must match a_list: "
            f"{len(caches)}/{len(sketches)} entries for {n} items")
    devs, an_devs = _device_sets(devices, analysis_devices)
    return [ocean_spgemm(a, b, cfg, force_workflow=force_workflow,
                         assisted=assisted, hybrid=hybrid, cache=c,
                         sketch_cache=s, devices=devs,
                         analysis_devices=an_devs, post=post)
            for a, c, s in zip(a_list, caches, sketches)]


def spgemm_reference(a: CSR, b: CSR) -> CSR:
    """Exact reference product via the ESC machinery (the oracle)."""
    if a.device != b.device:
        raise ValueError(f"A on {a.device}, B on {b.device}")
    p = int(products_per_row(a.indptr, a.indices, b.indptr,
                             num_rows_a=a.m).sum())
    res = esc_mod.esc_spgemm(a.indptr, a.indices, a.values, b.indptr,
                             b.indices, b.values, num_rows_a=a.m,
                             n_cols_b=b.n)
    return esc_mod.esc_to_csr(res, (a.m, b.n), p)
