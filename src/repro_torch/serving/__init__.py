"""Serving tier: traffic-facing front-ends.

PyTorch port of ``repro.serving``. Two independent surfaces live here.
The SpGEMM tier — :class:`SpGEMMService` (synchronous, plan-cached,
tenant-aware) and :class:`SpGEMMPool` (bounded queue + admission control +
worker threads + micro-batching + plan warmer on top of a service) —
serves repeated sparse-multiply traffic. :class:`ServingEngine` is the
separate LM text-generation engine (continuous batching over a KV cache)
used by ``launch.serve``.
"""
from .engine import Request, ServeConfig, ServingEngine
from .pool import AdmissionError, PoolConfig, PoolFuture, SpGEMMPool
from .spgemm_service import ServiceStats, SketchCache, SpGEMMService

__all__ = ["AdmissionError", "PoolConfig", "PoolFuture", "Request",
           "ServeConfig", "ServiceStats", "ServingEngine", "SketchCache",
           "SpGEMMPool", "SpGEMMService"]
