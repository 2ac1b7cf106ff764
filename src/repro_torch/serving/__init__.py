"""SpGEMM serving tier: traffic-facing front-ends over the Ocean planner.

PyTorch port of the SpGEMM half of ``repro.serving``:
:class:`SpGEMMService` (synchronous, plan-cached, tenant-aware) and
:class:`SpGEMMPool` (bounded queue + admission control + worker threads +
micro-batching + plan warmer on top of a service). The reference's LM
text-generation engine (``ServingEngine``) waits for the LM substrate
(ROADMAP queue 1, item 8).
"""
from .pool import AdmissionError, PoolConfig, PoolFuture, SpGEMMPool
from .spgemm_service import ServiceStats, SketchCache, SpGEMMService

__all__ = ["AdmissionError", "PoolConfig", "PoolFuture", "ServiceStats",
           "SketchCache", "SpGEMMPool", "SpGEMMService"]
