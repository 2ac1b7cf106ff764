"""The port's SpGEMM serving tier vs the JAX reference, on the CPU.

Service, worker pool and tenant plan caches of ``repro_torch`` are
compared with ``repro`` on the same requests: the
reference test's matrices (``tests/test_serving_pool.py``), built from the
same seeds in both packages. Integers are exact: output indptr/indices,
batch, warm, shed and plan-cache counts, chain counters. Values: rtol 1e-5
/ atol 1e-6 against the reference (both sides sum in product-enumeration
order); the port's pooled outputs are bit-identical to its own uncached
calls, one request at a time.

The reference sizes its hash tables from a timed load factor, so its
tuning cache is replaced by a pinned one while this module runs (the port
sizes them from a fixed one).
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.graph as rgraph  # noqa: E402
from repro import serving as rserving  # noqa: E402
from repro.core import formats as rformats  # noqa: E402
from repro.core import planner as rplanner  # noqa: E402
from repro.core import tuning as rtuning  # noqa: E402
from repro.serving import spgemm_service as rservice  # noqa: E402
import repro_torch.graph as graph  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.core import formats, planner, workflow  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.serving import pool as pool_mod  # noqa: E402
from repro_torch.serving import spgemm_service as service  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
RUNGS = (32, 64, 128, 256, 512, 1024, 2048, rtuning.REFERENCE_RUNG)
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
TENANTS = ("acme", "globex", "initech")
TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def pinned_tuning():
    with pytest.MonkeyPatch.context() as mp:
        rcache = rtuning.TuningCache()
        for r in RUNGS:
            rcache.insert(rtuning.tuning_key(r), rtuning.HashTuning())
        mp.setattr(rtuning, "DEFAULT_TUNING_CACHE", rcache)
        yield


def _mats(fmt, **dev):
    return (fmt.random_uniform_csr(11, 120, 120, 6.0, **dev),
            fmt.banded_csr(12, 120, 120, 24, **dev),
            fmt.powerlaw_csr(13, 120, 120, 6.0, **dev),
            fmt.random_uniform_csr(14, 120, 120, 5.0, **dev))


@pytest.fixture(scope="module")
def mats():
    """(reference, port) matrices: A1 uniform, A2 banded, A3 power-law, B."""
    return _mats(rformats), _mats(formats, device="cpu")


def requests(knobs=({},)):
    """3 tenants x 4 requests, interleaved as the serving benchmark's
    workload: (pattern index, tenant, knobs)."""
    return [((ti + i) % 3, t, knobs[(3 * i + ti) % len(knobs)])
            for i in range(4) for ti, t in enumerate(TENANTS)]


def port_serial(a, b, **kw):
    c, _ = workflow.ocean_spgemm(a, b, cache=False, **kw)
    return c


def assert_bit_identical(x, y):
    for u, v in zip(formats.to_numpy(x), formats.to_numpy(y)):
        np.testing.assert_array_equal(u, v)


def assert_same_csr(c_port, c_ref):
    got, want = formats.to_numpy(c_port), c_ref.to_scipy_like()
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[2], np.asarray(want[2]), **FLOAT_TOL)


def burst(pool_cls, cfg, mats, reqs, **pool_kw):
    """Deterministic burst: deferred start, every request queued (sheds
    counted), the warmer run over the queue, then the workers."""
    *pats, b = mats
    pool = pool_cls(pool=cfg, autostart=False, **pool_kw)
    futs = []
    for p, t, kw in reqs:
        try:
            futs.append(pool.submit(pats[p], b, tenant=t, **kw))
        except (rserving.AdmissionError, serving.AdmissionError):
            futs.append(None)
    assert pool.warm_wait(TIMEOUT)
    pool.start()
    assert pool.drain(TIMEOUT)
    outs = [None if f is None else f.result(0) for f in futs]
    pool.shutdown(timeout=TIMEOUT)
    return pool.stats, outs


# ---------------------------------------------------------------------------
# Pooled outputs: bit-identical to serial, equal to the reference pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knob", [
    {}, {"force_workflow": "symbolic"}, {"force_workflow": "estimation"},
    {"force_workflow": "upper_bound"}, {"hybrid": False}],
    ids=["default", "symbolic", "estimation", "upper_bound", "no_hybrid"])
def test_pooled_outputs_match_serial_and_reference(mats, knob):
    ref, port = mats
    reqs = requests((knob,))
    cfg = dict(workers=3, max_batch=4, max_queue=64)
    _, routs = burst(rserving.SpGEMMPool, rserving.PoolConfig(**cfg), ref,
                     reqs)
    st, pouts = burst(serving.SpGEMMPool, serving.PoolConfig(**cfg), port,
                      reqs)
    assert st.requests == st.batched_requests == len(reqs)
    for (p, _, _), (c, rep), (rc, _) in zip(reqs, pouts, routs):
        assert_bit_identical(c, port_serial(port[p], port[3], **knob))
        assert_same_csr(c, rc)
        if "force_workflow" in knob:
            assert rep.workflow == knob["force_workflow"]


# ---------------------------------------------------------------------------
# Deterministic batching: the same counts as the reference
# ---------------------------------------------------------------------------

INCOMPATIBLE = ({}, {"hybrid": False}, {"force_workflow": "estimation"})


@pytest.mark.parametrize("knobs", [({},), INCOMPATIBLE],
                         ids=["compatible", "incompatible"])
@pytest.mark.parametrize("max_batch", [1, 4, 8])
def test_deterministic_batching_counts_match_reference(mats, max_batch,
                                                       knobs):
    ref, port = mats
    reqs = requests(knobs)
    # 12 submissions against a queue of 10: the last two are shed
    cfg = dict(workers=2, max_batch=max_batch, max_queue=10)
    rst, routs = burst(rserving.SpGEMMPool, rserving.PoolConfig(**cfg),
                       ref, reqs)
    pst, pouts = burst(serving.SpGEMMPool, serving.PoolConfig(**cfg), port,
                       reqs)
    for field in ("requests", "batches", "batched_requests",
                  "batch_occupancy", "plans_warmed", "plan_warm_hits",
                  "plan_warm_hits_by_tenant", "sketch_hits",
                  "sketch_warm_hits", "sketch_warm_hits_by_tenant",
                  "plan_hits", "plan_misses", "shed", "shed_rate",
                  "queue_depth", "queue_depth_peak"):
        assert getattr(pst, field) == getattr(rst, field), field
    assert pst.shed == 2 and pst.plan_hits == 10
    if max_batch == 1:
        assert pst.batches == 10
    for po, ro in zip(pouts, routs):
        assert (po is None) == (ro is None)
        if po is not None:
            assert_same_csr(po[0], ro[0])
    if knobs is INCOMPATIBLE:   # estimation requests share warmed sketches
        assert pst.sketch_warm_hits > 0


# ---------------------------------------------------------------------------
# Plan cache: tenant namespaces and fairness-aware eviction
# ---------------------------------------------------------------------------

# (tenant or None for the un-namespaced cache, op, key)
CACHE_SCRIPT = [
    ("b", "insert", "k0"),     # oldest entry overall
    ("a", "insert", "k1"),
    ("a", "insert", "k2"),
    ("a", "insert", "k3"),     # a over quota 2: evicts its own k1
    ("b", "lookup", "k0"),     # b kept despite being the LRU entry
    ("a", "lookup", "k1"),     # miss
    ("a", "lookup", "k2"),
    (None, "insert", "k2"),    # default tenant: the shared namespace
    (None, "lookup", "k2"),
    ("b", "lookup", "k2"),     # isolation: b never sees a's or root's k2
    (None, "insert", "k5"),
    ("c", "insert", "k0"),     # past maxsize 6: the global LRU evicts
    ("c", "insert", "k1"),
    ("c", "peek", "k0"),       # peek counts neither hit nor miss
    ("b", "lookup", "k0"),
    (None, "lookup", "k9"),
    ("a", "insert", "k4"),
    ("a", "lookup", "k3"),
]


def _run_cache_script(mod):
    cache = mod.PlanCache(maxsize=6, tenant_quota=2)
    views = {}
    out = []
    for tenant, op, key in CACHE_SCRIPT:
        target = cache if tenant is None else views.setdefault(
            tenant, cache.namespaced(tenant))
        if op == "insert":
            target.insert(key, f"{tenant}:{key}")
        else:
            out.append(getattr(target, op)(key))
        out.append((list(cache._plans), cache.tenant_sizes(),
                    cache.stats(), len(target)))
    return cache, views, out


def test_plan_cache_tenancy_matches_reference():
    pcache, pviews, pout = _run_cache_script(planner)
    rcache, _, rout = _run_cache_script(rplanner)
    assert pout == rout
    # the global bound evicted a's k3 (LRU overall) and then its k2
    assert pcache.tenant_sizes() == {"a": 1, "b": 1, "c": 2}
    assert len(pviews["a"]) == 1 and len(pcache) == 6
    assert pcache.stats() == rcache.stats()
    assert pviews["a"].lookup("k1") is None          # self-evicted
    assert pcache.lookup("k2") == "None:k2"          # root namespace
    assert pviews["b"].lookup("k2") is None          # isolated
    assert pviews["b"].stats() == pcache.stats()
    pcache.clear()
    assert pcache.tenant_sizes() == {} and pcache._tenant_of == {}
    assert pcache.stats() == {"hits": 0, "misses": 0, "size": 0}


def test_plan_cache_without_tenants_is_plain_lru():
    cache = planner.PlanCache(maxsize=2)
    for k in ("x", "y", "z"):
        cache.insert(k, k)
    assert list(cache._plans) == ["y", "z"] and cache.tenant_sizes() == {}
    cache.namespaced("t").insert("y", "t")     # its own key, LRU evicts "y"
    assert list(cache._plans) == ["z", "t\x1fy"]
    assert cache.tenant_sizes() == {"t": 1} and cache.peek("y") is None


def test_service_tenants_and_default_share(mats):
    _, (a1, _, _, b) = mats
    svc = serving.SpGEMMService()
    c1, r1 = svc.multiply(a1, b, tenant="t1")
    c2, r2 = svc.multiply(a1, b, tenant="t2")
    assert not r1.plan_cache_hit and not r2.plan_cache_hit
    assert_bit_identical(c1, c2)
    assert svc.plan_cache.tenant_sizes() == {"t1": 1, "t2": 1}
    assert svc.multiply(a1, b, tenant="t1")[1].plan_cache_hit
    _, r3 = svc.multiply(a1, b)
    _, r4 = svc.multiply(a1, b)
    assert not r3.plan_cache_hit and r4.plan_cache_hit
    assert len(svc.plan_cache) == 3
    assert svc.sketch_cache_for(b, "t1") is not svc.sketch_cache_for(b)
    assert svc.stats.requests == 5 and svc.stats.plan_hits == 2


# ---------------------------------------------------------------------------
# ServiceStats: percentiles, reservoir, merge, reset
# ---------------------------------------------------------------------------

SAMPLE = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 10.0, 4.0, 8.0, 6.0]


def _stats_pair():
    return service.ServiceStats(), rservice.ServiceStats()


def test_service_stats_percentiles_match_reference():
    for st in _stats_pair():
        assert st.p50_seconds == 0.0 and st.p99_seconds == 0.0
    pst, rst = _stats_pair()
    for v in SAMPLE:
        pst.record_latency(v)
        rst.record_latency(v)
    for q in (0, 10, 25, 50, 75, 90, 95, 99, 100):
        assert pst.latency_percentile(q) == rst.latency_percentile(q)
        assert pst.latency_percentile(q) == pytest.approx(
            float(np.percentile(SAMPLE, q)))
    assert (pst.p50_seconds, pst.p95_seconds, pst.p99_seconds) == (
        rst.p50_seconds, rst.p95_seconds, rst.p99_seconds)


def test_service_stats_reservoir_keeps_newest():
    assert service.LATENCY_SAMPLE_CAP == rservice.LATENCY_SAMPLE_CAP
    assert service.RHS_BUCKETS_PER_TENANT == rservice.RHS_BUCKETS_PER_TENANT
    pst, rst = _stats_pair()
    for i in range(service.LATENCY_SAMPLE_CAP + 100):
        pst.record_latency(float(i))
        rst.record_latency(float(i))
    xs = pst.latency_sample()
    assert xs == rst.latency_sample()
    assert len(xs) == service.LATENCY_SAMPLE_CAP
    assert xs[0] == 100.0 and xs[-1] == float(service.LATENCY_SAMPLE_CAP
                                             + 99)


def _feed(st, k):
    st.requests += 3 + k
    st.plan_hits += 2
    st.shed += k
    st.batches += 1
    st.batched_requests += 3
    st.queue_wait_seconds += 0.25 * k
    st.note_queue_depth(4 + k)
    st.note_queue_depth(1)
    st.note_plan_warm_hit("acme")
    st.note_plan_warm_hit(None)
    st.note_sketch_hit("globex", warm=True)
    st.note_sketch_hit("globex", warm=False)
    for v in SAMPLE[k:]:
        st.record_latency(v)


def test_service_stats_fields_merge_reset_match_reference():
    pair = []
    for mod in (service, rservice):
        a, b = mod.ServiceStats(), mod.ServiceStats()
        _feed(a, 1)
        _feed(b, 3)
        # fields are views of the registry: one number, not two
        assert a.registry.counter("requests").value == a.requests == 4
        a.merge(b)
        pair.append(a)
    pst, rst = pair
    assert pst.snapshot() == rst.snapshot()
    assert pst.latency_sample() == rst.latency_sample()
    for f in ("requests", "plan_hits", "shed", "shed_rate",
              "batch_occupancy", "hit_rate", "queue_depth",
              "queue_depth_peak", "plan_warm_hits_by_tenant",
              "sketch_warm_hits_by_tenant", "sketch_hits", "p95_seconds"):
        assert getattr(pst, f) == getattr(rst, f), f
    assert pst.requests == 10 and pst.queue_depth_peak == 7
    assert pst.plan_warm_hits_by_tenant == {"acme": 2, None: 2}
    pst.reset()
    rst.reset()
    assert pst.snapshot() == rst.snapshot()
    assert pst.requests == 0 and pst.latency_sample() == []


# ---------------------------------------------------------------------------
# Lifecycle: admission, drain, shutdown, errors, warmer
# ---------------------------------------------------------------------------

def test_admission_control_sheds_over_limit(mats):
    _, (a1, _, _, b) = mats
    pool = serving.SpGEMMPool(pool=serving.PoolConfig(workers=1,
                                                      max_queue=3),
                              autostart=False)
    for _ in range(3):
        pool.submit(a1, b)
    with pytest.raises(serving.AdmissionError) as ei:
        pool.submit(a1, b, tenant="late")
    assert (ei.value.tenant, ei.value.depth, ei.value.limit) == ("late", 3,
                                                                 3)
    assert isinstance(ei.value, RuntimeError)
    assert pool.stats.shed == 1
    pool.start()
    assert pool.drain(TIMEOUT)
    assert pool.stats.requests == 3
    assert pool.stats.shed_rate == pytest.approx(1 / 4)
    assert pool.stats.queue_depth_peak == 3 and pool.stats.queue_depth == 0
    pool.shutdown(timeout=TIMEOUT)


def test_drain_then_shutdown_and_closed_pool(mats):
    _, (a1, a2, _, b) = mats
    pool = serving.SpGEMMPool(pool=serving.PoolConfig(workers=2,
                                                      max_batch=2))
    futs = [pool.submit(a, b) for a in (a1, a2, a1, a2, a1)]
    pool.shutdown(drain=True, timeout=TIMEOUT)
    for f, a in zip(futs, (a1, a2, a1, a2, a1)):
        assert f.done()
        assert_bit_identical(f.result(0)[0], port_serial(a, b))
    assert not any(t.is_alive() for t in pool._threads)
    assert not pool._warmer.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        pool.submit(a1, b)
    with pytest.raises(RuntimeError, match="shut down"):
        pool.start()


def test_shutdown_without_drain_fails_queued_futures(mats):
    _, (a1, _, _, b) = mats
    pool = serving.SpGEMMPool(pool=serving.PoolConfig(workers=1),
                              autostart=False)
    fut = pool.submit(a1, b)
    pool.shutdown(drain=False, timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="shut down"):
        fut.result(5)
    assert pool.stats.queue_depth == 0


def test_worker_exception_reaches_future_and_pool_survives(mats):
    _, (a1, _, _, b) = mats
    with serving.SpGEMMPool(pool=serving.PoolConfig(workers=1)) as pool:
        bad = pool.submit(None, b)            # not a CSR: worker-side error
        with pytest.raises(Exception):
            bad.result(TIMEOUT)
        c, _ = pool.submit(a1, b).result(TIMEOUT)
        assert_bit_identical(c, port_serial(a1, b))
    with pytest.raises(TimeoutError):
        serving.PoolFuture().result(0.01)


def test_warmer_survives_bad_request(mats):
    _, (a1, _, _, b) = mats
    pool = serving.SpGEMMPool(pool=serving.PoolConfig(workers=1),
                              autostart=False)
    bad = pool.submit(None, b)
    good = pool.submit(a1, b, hybrid=False)   # another batch key
    assert pool.warm_wait(TIMEOUT)
    with pool._lock:
        assert [r.warm_state for r in pool._queue] == ["error", "warmed"]
    pool.start()
    assert pool.drain(TIMEOUT)
    with pytest.raises(Exception):
        bad.result(0)
    c, _ = good.result(0)
    pool.shutdown(timeout=TIMEOUT)
    assert_bit_identical(c, port_serial(a1, b, hybrid=False))
    assert pool.stats.plans_warmed == 1 and pool.stats.plan_warm_hits == 1


def test_kernel_failure_fails_the_future_not_only_the_warm(mats,
                                                           monkeypatch):
    """A kernel that does not build marks the warm attempt "error" and the
    worker's own call raises the error again into the request's future:
    nothing carries on in a plain version."""
    _, (a1, _, _, b) = mats
    calls = []

    def broken(*args, **kw):
        calls.append(threading.current_thread().name)
        raise _build.KernelBuildError("nvcc failed")

    monkeypatch.setattr(pool_mod, "warm_plan", broken)
    monkeypatch.setattr(pool_mod, "ocean_spgemm_many", broken)
    pool = serving.SpGEMMPool(pool=serving.PoolConfig(workers=1),
                              autostart=False)
    fut = pool.submit(a1, b, tenant="acme")
    assert pool.warm_wait(TIMEOUT)
    with pool._lock:
        assert [r.warm_state for r in pool._queue] == ["error"]
    pool.start()
    assert pool.drain(TIMEOUT)
    with pytest.raises(_build.KernelBuildError, match="nvcc failed"):
        fut.result(0)
    pool.shutdown(timeout=TIMEOUT)
    assert calls == ["spgemm-pool-warmer", "spgemm-pool-0"]
    assert pool.stats.requests == 0 and pool.stats.plans_warmed == 0


def test_warm_plans_disabled(mats):
    _, (a1, _, _, b) = mats
    pool = serving.SpGEMMPool(pool=serving.PoolConfig(workers=1,
                                                      warm_plans=False),
                              autostart=False)
    assert pool._warmer is None
    fut = pool.submit(a1, b)
    assert pool.warm_wait(0.01) is True
    pool.start()
    assert pool.drain(TIMEOUT)
    c, _ = fut.result(0)
    pool.shutdown(timeout=TIMEOUT)
    assert_bit_identical(c, port_serial(a1, b))
    assert pool.stats.plans_warmed == 0 and pool.stats.plan_warm_hits == 0


def test_stats_accounting_under_threaded_burst(mats):
    """Concurrent submitters against a small queue, a short switch
    interval: every submission is accounted once as served or shed."""
    _, (a1, a2, _, b) = mats
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pool = serving.SpGEMMPool(pool=serving.PoolConfig(
            workers=3, max_batch=4, max_queue=6))
        futures, shed, lock = [], [0], threading.Lock()

        def submitter(tid):
            for i in range(8):
                try:
                    f = pool.submit(a1 if (tid + i) % 2 else a2, b,
                                    tenant=TENANTS[tid % 3])
                    with lock:
                        futures.append(f)
                except serving.AdmissionError:
                    with lock:
                        shed[0] += 1

        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
        assert pool.drain(TIMEOUT)
        for f in futures:
            f.result(0)
        st = pool.stats
        pool.shutdown(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(old)
    assert st.requests == len(futures) and st.shed == shed[0]
    assert st.requests + st.shed == 48
    assert st.batched_requests == st.requests
    assert st.queue_depth_peak <= 6 and st.queue_depth == 0
    assert len(st.latency_sample()) == st.requests
    assert st.p99_seconds >= st.p50_seconds >= 0.0


# ---------------------------------------------------------------------------
# run_chain: per-tenant size feeds, as the reference
# ---------------------------------------------------------------------------

def _chains(g, svc, adj, fmt_kw):
    f0 = g.seeds_to_frontier([0, 1, 2], adj.n, **fmt_kw)
    post = g.bool_post(adj.n)
    return [svc.run_chain(f0, adj, 3, tenant=t, post=post)
            for t in ("acme", "acme", "globex")]


def test_run_chain_per_tenant_feeds_match_reference():
    radj = rgraph.rmat_csr(1, 8, 16)
    padj = graph.rmat_csr(1, 8, 16, device="cpu")
    rsvc, psvc = rserving.SpGEMMService(), serving.SpGEMMService()
    rres = _chains(rgraph, rsvc, radj, {})
    pres = _chains(graph, psvc, padj, {"device": "cpu"})
    for p, r in zip(pres, rres):
        assert_same_csr(p.final, r.final)
        for f in ("iterations", "plan_hits", "feed_forward_skips",
                  "estimated_builds", "converged_at", "nnz_trajectory",
                  "workflows"):
            assert getattr(p.stats, f) == getattr(r.stats, f), f
    acme1, acme2, globex = pres
    assert acme1.stats.feed_forward_skips == 0
    assert acme2.stats.plan_hits + acme2.stats.feed_forward_skips > 0
    assert globex.stats.feed_forward_skips == 0     # its own, empty feed
    assert psvc.size_feed_for(padj, "acme") is not psvc.size_feed_for(
        padj, "globex")
    for f in ("chains", "chain_iterations", "chain_plan_hits",
              "chain_feed_forward_skips", "chain_estimated_builds",
              "chain_reuse_rate"):
        assert getattr(psvc.stats, f) == getattr(rsvc.stats, f), f
    # the final frontier: vertices reachable in exactly 3 hops
    a = padj.to_scipy_like()
    import scipy.sparse as sp
    m = sp.csr_matrix((a[2], a[1], a[0]), shape=padj.shape)
    cur = np.zeros(padj.n)
    cur[[0, 1, 2]] = 1.0
    for _ in range(3):
        cur = (m.T @ cur != 0).astype(np.float64)
    np.testing.assert_array_equal(
        formats.to_numpy(acme2.final)[1], np.nonzero(cur)[0])


# ---------------------------------------------------------------------------
# Unported options, import hygiene
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{"devices": 2}, {"analysis_devices": 2}])
def test_device_sets_raise(mats, kw):
    """A device list serves sharded, equal to the unsharded serial call; a
    count of CUDA devices the machine lacks raises."""
    a, b = mats[1][0], mats[1][3]
    cpus = {k: ["cpu"] * v for k, v in kw.items()}
    c, rep = serving.SpGEMMService(**cpus).multiply(a, b)
    assert rep.analysis_shards == 2
    assert rep.n_shards == (2 if "devices" in kw else 1)
    assert_bit_identical(c, port_serial(a, b))
    with serving.SpGEMMPool(serving.PoolConfig(workers=1), **cpus) as pool:
        assert_bit_identical(pool.multiply(a, b, timeout=TIMEOUT)[0],
                             port_serial(a, b))
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="CUDA devices"):
            serving.SpGEMMService(**kw)
        with pytest.raises(ValueError, match="CUDA devices"):
            serving.SpGEMMPool(serving.PoolConfig(), **kw)


def test_serving_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "from repro_torch.core import formats\n"
        "from repro_torch.serving import PoolConfig, SpGEMMPool\n"
        "from repro_torch.tools import trace_export\n"
        "a = formats.random_uniform_csr(1, 64, 64, 4.0, device='cpu')\n"
        "with SpGEMMPool(PoolConfig(workers=1)) as pool:\n"
        "    c, rep = pool.multiply(a, a, tenant='acme', timeout=120)\n"
        "assert c.nnz > 0 and pool.stats.requests == 1, rep\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')\n"
        "       or m == 'tools' or m.startswith('tools.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
