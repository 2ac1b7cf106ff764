"""Multi-tenant SpGEMM worker pool: bounded queue, admission control,
micro-batching, fairness-aware per-tenant caches, SLO metrics.

PyTorch port of ``repro.serving.pool``, with the same
semantics and span names. :class:`SpGEMMPool` is the traffic-facing
front-end over one
:class:`~repro_torch.serving.spgemm_service.SpGEMMService`. Requests
enter a bounded FIFO queue (``submit`` returns a :class:`PoolFuture`;
over-limit submissions are *shed* with a typed :class:`AdmissionError`),
worker threads pull the queue head plus every queued request with the same
*batch key* — identical right-hand side and planning knobs — and execute
the whole micro-batch through a single
:func:`~repro_torch.core.workflow.ocean_spgemm_many` call with per-item
tenant caches. Tenancy never changes results: plans and sketches are
deterministic functions of structure + config, so micro-batched
multi-tenant outputs are bit-identical to per-request serial execution.

Fairness lives in the caches: each tenant's plans sit in a private
:class:`~repro_torch.core.planner.TenantPlanCache` namespace whose
eviction is per-tenant quota first, global LRU second.

Threads and the device: every thread launches on the device's current
stream, which is the legacy default stream in each of them, so the
workers' and the warmer's device work is ordered, and a plan's device
tensors built by the warmer are safe for a worker to read. A worker's
failure (a kernel that does not build or launch included) fails the
futures of its batch; the warmer's failures only mark the request's
``warm_state`` as ``"error"``, and the worker's own call raises again.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

from ..core.analysis import OceanConfig
from ..core.formats import CSR
from ..core.planner import OceanReport
from ..core.workflow import ocean_spgemm_many, warm_plan
from ..obs import trace

from .spgemm_service import SpGEMMService


class AdmissionError(RuntimeError):
    """Request shed by admission control: the pool's bounded queue is at
    its configured limit. Carries ``tenant``/``depth``/``limit`` so
    callers can back off or retry against a different replica."""

    def __init__(self, tenant: str, depth: int, limit: int):
        super().__init__(
            f"request shed: queue depth {depth} >= limit {limit} "
            f"(tenant {tenant!r})")
        self.tenant = tenant
        self.depth = depth
        self.limit = limit


@dataclasses.dataclass
class PoolConfig:
    """Knobs for :class:`SpGEMMPool`.

    ``max_queue`` is the admission-control limit: a submit that would push
    the queue past it sheds with :class:`AdmissionError` instead of
    building unbounded backlog (bounded worst-case latency). ``max_batch``
    caps how many compatible requests one worker coalesces into a single
    ``ocean_spgemm_many`` call. ``tenant_plan_quota`` bounds any one
    tenant's share of the shared plan cache (``None`` = global LRU only).
    ``warm_plans`` runs the background plan warmer: a thread that
    speculatively builds plans (and sketches) for queued requests'
    structure keys before a worker picks them up, converting queue wait
    time into plan-setup time (results are unaffected — plans are
    deterministic, and a worker that races the warmer just builds the
    same plan itself).
    """
    workers: int = 2
    max_queue: int = 64
    max_batch: int = 8
    plan_cache_size: int = 64
    tenant_plan_quota: Optional[int] = None
    warm_plans: bool = True


class PoolFuture:
    """Completion handle for one submitted request.

    ``result()`` blocks until the worker finishes the request's
    micro-batch and returns ``(CSR, OceanReport)`` — or re-raises the
    worker-side exception."""

    def __init__(self):
        self._event = threading.Event()
        self._result: Optional[Tuple[CSR, OceanReport]] = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def set_result(self, value) -> None:
        self._result = value
        self._event.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request not completed within timeout")
        if self._exc is not None:
            raise self._exc
        return self._result


@dataclasses.dataclass
class _Pending:
    """One queued request. ``batch_key`` decides micro-batch
    compatibility: same B *object* (identical values, not just structure)
    and identical planning knobs — tenant deliberately excluded,
    cross-tenant coalescing is the point."""
    a: CSR
    b: CSR
    tenant: str
    force_workflow: Optional[str]
    assisted: bool
    hybrid: bool
    batch_key: tuple
    future: PoolFuture
    t_submit: float
    # plan-warmer progress for this request: "new" (untouched) ->
    # "warming" -> "warmed" (warmer built the plan) / "cached" (was
    # already in the cache) / "error" (warm attempt failed; the worker
    # will surface the real error, or succeed if it was transient)
    warm_state: str = "new"


class SpGEMMPool:
    """Worker-pool dispatcher serving multi-tenant SpGEMM traffic.

    Composition: the pool owns a :class:`SpGEMMService` (its plan cache,
    tenant namespaces, and :class:`ServiceStats` — exposed as
    ``pool.service`` / ``pool.stats``) and adds the concurrent front-end:
    bounded queueing, admission control, worker threads, micro-batching,
    and graceful drain/shutdown. Use it as a context manager::

        with SpGEMMPool(pool=PoolConfig(workers=4)) as pool:
            futs = [pool.submit(a, b, tenant="acme") for a in stream]
            outs = [f.result() for f in futs]

    ``autostart=False`` defers worker startup until :meth:`start` — queued
    submissions accumulate, which makes batching deterministic (tests and
    the load benchmark use this to pin batch occupancy).
    """

    def __init__(self, cfg: OceanConfig = OceanConfig(),
                 pool: PoolConfig = PoolConfig(), *,
                 devices=None,
                 analysis_devices=None,
                 autostart: bool = True):
        if isinstance(cfg, PoolConfig):   # SpGEMMPool(PoolConfig(...)) —
            cfg, pool = OceanConfig(), cfg  # knobs, not an OceanConfig
        self.pool_cfg = pool
        self.service = SpGEMMService(
            cfg, plan_cache_size=pool.plan_cache_size, devices=devices,
            analysis_devices=analysis_devices,
            tenant_plan_quota=pool.tenant_plan_quota)
        self.stats = self.service.stats
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)   # queue non-empty
        self._idle = threading.Condition(self._lock)   # queue drained
        self._queue: Deque[_Pending] = deque()
        self._inflight = 0
        self._closed = False      # no new submissions
        self._running = False     # workers alive
        self._threads: List[threading.Thread] = []
        # Plan warmer: starts with the pool object (not with start()) so
        # queued submissions warm even before workers run — that's the
        # deterministic-batching idiom (autostart=False, submit burst,
        # start) where warming has the most time to win.
        self._warm_cv = threading.Condition(self._lock)
        self._warm_stop = False
        self._warmer: Optional[threading.Thread] = None
        if pool.warm_plans:
            self._warmer = threading.Thread(
                target=self._warmer_loop, daemon=True,
                name="spgemm-pool-warmer")
            self._warmer.start()
        if autostart:
            self.start()

    # -------------------- lifecycle --------------------

    def start(self) -> None:
        """Spawn the worker threads (idempotent)."""
        with self._lock:
            if self._running:
                return
            if self._closed:
                raise RuntimeError("pool is shut down")
            self._running = True
            self._threads = [
                threading.Thread(target=self._worker_loop, daemon=True,
                                 name=f"spgemm-pool-{i}")
                for i in range(self.pool_cfg.workers)]
        for t in self._threads:
            t.start()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is empty and no batch is in flight.
        Returns False on timeout. Requires started workers to make
        progress."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._queue or self._inflight:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(remaining)
        return True

    def shutdown(self, *, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop accepting requests, optionally finish queued work, join
        workers. With ``drain=False`` queued (unstarted) requests fail
        with RuntimeError on their futures."""
        with self._lock:
            self._closed = True
        if drain and self._running:
            self.drain(timeout)
        with self._lock:
            self._running = False
            leftovers = list(self._queue)
            self._queue.clear()
            self.stats.note_queue_depth(0)
            self._work.notify_all()
            self._warm_stop = True
            self._warm_cv.notify_all()
        for r in leftovers:
            r.future.set_exception(RuntimeError("pool shut down"))
        for t in self._threads:
            t.join(timeout)
        if self._warmer is not None:
            self._warmer.join(timeout)

    def __enter__(self) -> "SpGEMMPool":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    # -------------------- request path --------------------

    def submit(self, a: CSR, b: CSR, *, tenant: str = "default",
               force_workflow: Optional[str] = None, assisted: bool = True,
               hybrid: bool = True) -> PoolFuture:
        """Enqueue one C = A @ B request; returns a :class:`PoolFuture`.

        Raises :class:`AdmissionError` (and counts a shed) when the queue
        is at ``PoolConfig.max_queue``, RuntimeError after shutdown."""
        fut = PoolFuture()
        key = (id(b), force_workflow, assisted, hybrid)
        with self._lock:
            if self._closed:
                raise RuntimeError("pool is shut down")
            depth = len(self._queue)
            if depth >= self.pool_cfg.max_queue:
                self.stats.shed += 1
                raise AdmissionError(tenant, depth, self.pool_cfg.max_queue)
            self._queue.append(_Pending(
                a=a, b=b, tenant=tenant, force_workflow=force_workflow,
                assisted=assisted, hybrid=hybrid, batch_key=key,
                future=fut, t_submit=time.perf_counter()))
            self.stats.note_queue_depth(len(self._queue))
            self._work.notify()
            self._warm_cv.notify()
        return fut

    def multiply(self, a: CSR, b: CSR, *, tenant: str = "default",
                 timeout: Optional[float] = None,
                 **kw) -> Tuple[CSR, OceanReport]:
        """Synchronous convenience: submit + wait."""
        return self.submit(a, b, tenant=tenant, **kw).result(timeout)

    # -------------------- plan warmer --------------------

    def warm_wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the warmer has visited every queued request (each
        ``warm_state`` has left "new"/"warming"). Returns False on
        timeout; returns True immediately when warming is disabled. Used
        by the deterministic-batching idiom (autostart=False burst) to
        measure warm-path hit rates without racing the warmer."""
        if self._warmer is None:
            return True
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while any(r.warm_state in ("new", "warming")
                      for r in self._queue):
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._warm_cv.wait(remaining)
        return True

    def _warm_one(self, r: _Pending) -> bool:
        """Build (or confirm) the plan for one queued request through the
        same caches a worker will use. Returns True only when the warmer
        actually built the plan (a later worker hit is then a *warm* hit,
        not an ordinary cache hit)."""
        svc = self.service
        with trace.span("pool.warm", tenant=str(r.tenant)):
            return self._warm_one_inner(r, svc)

    def _warm_one_inner(self, r: _Pending, svc) -> bool:
        bucket = svc.sketch_cache_for(r.b, r.tenant)
        before = set(bucket.keys())
        _, built = warm_plan(
            r.a, r.b, svc.cfg, force_workflow=r.force_workflow,
            assisted=r.assisted, hybrid=r.hybrid,
            cache=svc.plan_cache_for(r.tenant), sketch_cache=bucket,
            devices=svc.devices, analysis_devices=svc.analysis_devices)
        new_keys = set(bucket.keys()) - before
        if new_keys and hasattr(bucket, "mark_warm"):
            bucket.mark_warm(new_keys)
        return built

    def _warmer_loop(self) -> None:
        while True:
            with self._lock:
                target: Optional[_Pending] = None
                while not self._warm_stop:
                    target = next((r for r in self._queue
                                   if r.warm_state == "new"), None)
                    if target is not None:
                        break
                    self._warm_cv.wait()
                if self._warm_stop:
                    return
                target.warm_state = "warming"
            try:
                built = self._warm_one(target)
                state = "warmed" if built else "cached"
            except Exception:
                # Bad request (the worker will surface the real error) or
                # transient planner failure — either way warming is best
                # effort and must never take the pool down.
                state = "error"
            with self._lock:
                target.warm_state = state
                if state == "warmed":
                    self.stats.plans_warmed += 1
                self._warm_cv.notify_all()

    # -------------------- workers --------------------

    def _take_batch(self) -> Optional[List[_Pending]]:
        """Pop the queue head plus up to ``max_batch - 1`` later requests
        with the same batch key (compatible requests jump ahead of
        incompatible ones *only* into this batch; the skipped requests
        keep their FIFO order). None = shutdown."""
        with self._lock:
            while self._running and not self._queue:
                self._work.wait()
            if not self._queue:
                return None
            t0_take = time.perf_counter()
            head = self._queue.popleft()
            batch = [head]
            rest: List[_Pending] = []
            for r in self._queue:
                if (len(batch) < self.pool_cfg.max_batch
                        and r.batch_key == head.batch_key):
                    batch.append(r)
                else:
                    rest.append(r)
            self._queue = deque(rest)
            self._inflight += 1
            self.stats.note_queue_depth(len(self._queue))
            if trace.enabled():
                trace.add_span("pool.batch_assembly", t0_take,
                               time.perf_counter() - t0_take,
                               size=len(batch))
            return batch

    def _worker_loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                self._execute_batch(batch)
            finally:
                with self._lock:
                    self._inflight -= 1
                    self._idle.notify_all()

    def _execute_batch(self, batch: List[_Pending]) -> None:
        head = batch[0]
        svc = self.service
        t_dispatch = time.perf_counter()
        try:
            results = ocean_spgemm_many(
                [r.a for r in batch], head.b, svc.cfg,
                force_workflow=head.force_workflow, assisted=head.assisted,
                hybrid=head.hybrid,
                cache=[svc.plan_cache_for(r.tenant) for r in batch],
                sketch_cache=[svc.sketch_cache_for(r.b, r.tenant)
                              for r in batch],
                devices=svc.devices, analysis_devices=svc.analysis_devices)
        except Exception as exc:  # fail this batch's futures, keep pool alive
            for r in batch:
                r.future.set_exception(exc)
            return
        t_done = time.perf_counter()
        if trace.enabled():
            trace.add_span("pool.batch", t_dispatch, t_done - t_dispatch,
                           size=len(batch))
            for r in batch:
                # own synthetic lane per request: waits from different
                # batches partially overlap a worker's timeline, which
                # would break same-tid span nesting
                trace.add_span("pool.queue_wait", r.t_submit,
                               t_dispatch - r.t_submit,
                               tid=id(r), thread="pool-queue",
                               tenant=str(r.tenant))
        with self._lock:
            self.stats.batches += 1
            self.stats.batched_requests += len(batch)
            for r, (_, rep) in zip(batch, results):
                self.stats.requests += 1
                self.stats.plan_hits += int(rep.plan_cache_hit)
                self.stats.plan_misses += int(not rep.plan_cache_hit)
                if rep.plan_cache_hit and r.warm_state == "warmed":
                    self.stats.note_plan_warm_hit(r.tenant)
                self.stats.total_seconds += t_done - r.t_submit
                self.stats.setup_seconds += rep.setup_seconds
                self.stats.overlap_seconds += rep.overlap_seconds
                self.stats.merge_seconds += rep.stage_seconds.get(
                    "merge", 0.0)
                self.stats.queue_wait_seconds += t_dispatch - r.t_submit
                self.stats.record_latency(t_done - r.t_submit)
        for r, out in zip(batch, results):
            r.future.set_result(out)
