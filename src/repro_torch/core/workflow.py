"""Ocean's end-to-end SpGEMM workflow (paper Fig. 4), on PyTorch.

    analysis -> size prediction (HLL | symbolic | upper-bound)
             -> binning -> numeric accumulation -> overflow fallback
             -> post-processing (CSR compaction)

PyTorch port of ``repro.core.workflow`` for one device. The call runs on
the device its inputs live on (the hand-written CUDA kernels on a GPU, their
plain versions on the CPU). Ablation knobs mirror the paper's Table 3:

    V1 baseline:  force_workflow='symbolic', assisted=False, hybrid=False
    V2 (+E):      assisted=False, hybrid=False
    V3 (+AS):     assisted=True,  hybrid=False
    V4 (+HA):     assisted=True,  hybrid=True      (full Ocean)
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..obs import trace
from . import esc as esc_mod
from .analysis import AnalysisResult, OceanConfig, products_per_row
from .dispatch import resolve_devices
from .formats import CSR
from .planner import (DEFAULT_PLAN_CACHE, ExecutionPlan, OceanReport,
                      PlanCache, build_plan, execute_plan, gather_rows,
                      structure_key)

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


def _check_single_device(a: CSR, b: CSR, devices, analysis_devices,
                         post=None) -> None:
    resolve_devices(devices)
    resolve_devices(analysis_devices)
    if post is not None:
        raise NotImplementedError(
            "post= (fused MergePostOps) is ROADMAP queue 1, item 7; it is "
            "not ported yet")
    if a.device != b.device:
        raise ValueError(f"A on {a.device} and B on {b.device}: both "
                         "operands must live on one device")


def ocean_spgemm(a: CSR, b: CSR, cfg: OceanConfig = OceanConfig(), *,
                 force_workflow: Optional[str] = None,
                 assisted: bool = True, hybrid: bool = True,
                 analysis: Optional[AnalysisResult] = None,
                 plan: Optional[ExecutionPlan] = None,
                 cache: Union[bool, PlanCache, None] = True,
                 sketch_cache: Optional[Dict] = None,
                 devices=None,
                 analysis_devices=None,
                 executor: str = "pipelined",
                 known_sizes=None,
                 post=None,
                 ) -> Tuple[CSR, OceanReport]:
    """Estimation-based SpGEMM, C = A @ B, on the operands' device.
    Returns (C, report).

    ``plan``: execute a prebuilt :class:`ExecutionPlan` directly.
    ``cache``: ``True`` (default) uses the process-wide LRU plan cache, a
    :class:`PlanCache` that cache, ``False``/``None`` always plans from
    scratch; a caller-supplied ``analysis`` bypasses the cache.
    ``sketch_cache``: dict shared across calls against one B to reuse HLL
    sketches. ``executor``: ``"pipelined"`` (default), ``"threaded"`` or
    ``"serial"``, bit-identical. ``known_sizes``: exact per-row output nnz
    fed forward from a prior numeric pass (workflow ``"known"``).
    ``devices``/``analysis_devices``/``post`` are not ported yet and raise.
    """
    _check_single_device(a, b, devices, analysis_devices, post)
    if plan is not None:
        return execute_plan(plan, a, b, executor=executor)
    cache_obj = _resolve_cache(cache) if analysis is None else None
    if cache_obj is not None:
        t0 = time.perf_counter()
        key = structure_key(a, b, cfg, force_workflow, assisted, hybrid,
                            known_sizes=known_sizes)
        cached = cache_obj.lookup(key)
        lookup_s = time.perf_counter() - t0
        trace.add_span("plan.lookup", t0, lookup_s,
                       hit=bool(cached is not None))
        if cached is not None:
            stage = {"plan_lookup": lookup_s, "analysis": 0.0,
                     "prediction": 0.0, "binning": 0.0}
            return execute_plan(cached, a, b, stage=stage, cache_hit=True,
                                executor=executor)
        base = build_plan(a, b, cfg, force_workflow=force_workflow,
                          assisted=assisted, hybrid=hybrid,
                          sketch_cache=sketch_cache, key=key,
                          known_sizes=known_sizes)
        cache_obj.insert(key, base)
        stage = dict(base.build_seconds)
        stage["plan_lookup"] = lookup_s
        return execute_plan(base, a, b, stage=stage, executor=executor)
    fresh = build_plan(a, b, cfg, force_workflow=force_workflow,
                       assisted=assisted, hybrid=hybrid, analysis=analysis,
                       sketch_cache=sketch_cache, known_sizes=known_sizes)
    return execute_plan(fresh, a, b, stage=fresh.build_seconds,
                        executor=executor)


def warm_plan(a: CSR, b: CSR, cfg: OceanConfig = OceanConfig(), *,
              force_workflow: Optional[str] = None,
              assisted: bool = True, hybrid: bool = True,
              cache: Union[bool, PlanCache, None] = True,
              sketch_cache: Optional[Dict] = None,
              devices=None, analysis_devices=None,
              known_sizes=None) -> Tuple[str, bool]:
    """Build (or verify) the cached plan for ``A @ B`` without executing
    it, keyed exactly as :func:`ocean_spgemm` keys it. Returns
    ``(cache_key, built)``."""
    _check_single_device(a, b, devices, analysis_devices)
    cache_obj = _resolve_cache(cache)
    if cache_obj is None:
        raise ValueError("warm_plan needs a cache to warm (cache=False/None)")
    key = structure_key(a, b, cfg, force_workflow, assisted, hybrid,
                        known_sizes=known_sizes)
    if cache_obj.peek(key) is not None:
        return key, False
    cache_obj.insert(key, build_plan(
        a, b, cfg, force_workflow=force_workflow, assisted=assisted,
        hybrid=hybrid, sketch_cache=sketch_cache, key=key,
        known_sizes=known_sizes))
    return key, True


def ocean_spgemm_many(a_list: Sequence[CSR], b: CSR,
                      cfg: OceanConfig = OceanConfig(), *,
                      force_workflow: Optional[str] = None,
                      assisted: bool = True, hybrid: bool = True,
                      cache: Union[bool, PlanCache, None, Sequence] = True,
                      sketch_cache: Union[Dict, Sequence, None] = None,
                      devices=None, analysis_devices=None,
                      executor: str = "pipelined",
                      ) -> List[Tuple[CSR, OceanReport]]:
    """``[A_i @ B for A_i in a_list]`` against one B, sharing B's sketches
    across the stream. ``cache``/``sketch_cache`` also take one entry per
    left-hand side."""
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
    return [ocean_spgemm(a, b, cfg, force_workflow=force_workflow,
                         assisted=assisted, hybrid=hybrid, cache=c,
                         sketch_cache=s, devices=devices,
                         analysis_devices=analysis_devices,
                         executor=executor)
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
