"""The port's sharded analysis, sharded merge estimate and the sharded path
through graph chains and serving, vs the JAX reference, on the CPU.

The port's shards are logical (``["cpu"] * n``); the reference's run on the
four host devices ``tests/conftest.py`` forces. The sharded
``AnalysisResult`` must equal the port's monolithic one field for field
(sketches byte for byte) and the reference's sharded one: integers
exactly, sampled-CR statistics to rtol 1e-6 (float64 over HLL estimates
that agree to rtol 1e-5). Sharded outputs are bit-identical to the port's
unsharded runs; against the reference, indices exact and values rtol 1e-5
/ atol 1e-6.

The reference sizes its hash tables from a timed load factor, so its
tuning cache is replaced by a pinned one while this module runs (the port
sizes them from a fixed one).
"""
import collections
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.graph as rgraph  # noqa: E402
from repro.core import analysis as ranalysis  # noqa: E402
from repro.core import formats as rformats  # noqa: E402
from repro.core import tuning as rtuning  # noqa: E402
from repro.core import workflow as rworkflow  # noqa: E402
from repro.obs import trace as rtrace  # noqa: E402
import repro_torch.graph as graph  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.core import analysis, formats, planner  # noqa: E402
from repro_torch.core import workflow  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.tools import trace_export  # noqa: E402
from tools import trace_export as rtrace_export  # noqa: E402

RUNGS = (32, 64, 128, 256, 512, 1024, 2048, rtuning.REFERENCE_RUNG)
SUITE_NAMES = [name for name, _ in rformats.make_suite(1)]
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
TIMEOUT = 120


def cpus(n):
    return ["cpu"] * n


@pytest.fixture(scope="module", autouse=True)
def pinned_tuning():
    with pytest.MonkeyPatch.context() as mp:
        rcache = rtuning.TuningCache()
        for r in RUNGS:
            rcache.insert(rtuning.tuning_key(r), rtuning.HashTuning())
        mp.setattr(rtuning, "DEFAULT_TUNING_CACHE", rcache)
        yield


@pytest.fixture(scope="module")
def suites():
    return (dict(rformats.make_suite(1)),
            dict(formats.make_suite(1, device="cpu")))


@pytest.fixture(scope="module")
def ref_sharded(suites):
    """The reference's analysis of each suite matrix on 4 host devices."""
    return {name: ranalysis.analyze(a, a, devices=4)
            for name, a in suites[0].items()}


def assert_bit_identical(x, y):
    for u, v in zip(formats.to_numpy(x), formats.to_numpy(y)):
        np.testing.assert_array_equal(u, v)


def assert_same_csr(c_port, c_ref, tol=FLOAT_TOL):
    got, want = formats.to_numpy(c_port), c_ref.to_scipy_like()
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[2], np.asarray(want[2]), **tol)


def assert_analysis_identical(r, r0):
    """Every field the selector and binning read (``benchmarks/sharding.py``'s
    parity list), exactly, dtypes included."""
    assert r.workflow == r0.workflow
    assert (r.total_products, r.er, r.nproducts_avg, r.m_regs) == \
        (r0.total_products, r0.er, r0.nproducts_avg, r0.m_regs)
    assert (r.sampled_cr, r.cr_mean, r.cr_std) == \
        (r0.sampled_cr, r0.cr_mean, r0.cr_std)
    assert r.conservative_cr == r0.conservative_cr
    for f in ("products_row", "out_lo", "out_hi"):
        x, y = getattr(r, f), getattr(r0, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)
    if r0.sample_rows is None:
        assert r.sample_rows is None
    else:
        np.testing.assert_array_equal(r.sample_rows, r0.sample_rows)
    if r0.b_sketches is None:
        assert r.b_sketches is None
    else:
        assert r.b_sketches.dtype == r0.b_sketches.dtype == torch.uint8
        assert torch.equal(r.b_sketches, r0.b_sketches)


def assert_matches_reference(r, rr, b_rows):
    assert (r.workflow, r.m_regs, r.total_products) == (
        rr.workflow, rr.m_regs, rr.total_products)
    for f in ("products_row", "out_lo", "out_hi"):
        np.testing.assert_array_equal(getattr(r, f),
                                      np.asarray(getattr(rr, f)))
    for f in ("sampled_cr", "cr_mean", "cr_std"):
        x, y = getattr(r, f), getattr(rr, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_allclose(x, y, rtol=1e-6)
    assert (r.b_sketches is None) == (rr.b_sketches is None)
    if rr.b_sketches is not None:
        np.testing.assert_array_equal(r.b_sketches[:b_rows].int().numpy(),
                                      np.asarray(rr.b_sketches))


# ---------------------------------------------------------------------------
# Sharded analysis == monolithic == the reference's sharded analysis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("name", SUITE_NAMES)
def test_sharded_analysis_equals_monolithic(suites, ref_sharded, name, n):
    a = suites[1][name]
    r0 = analysis.analyze(a, a)
    r = analysis.analyze(a, a, devices=cpus(n))
    assert_analysis_identical(r, r0)
    assert r.n_shards == n and len(r.shard_seconds) == n
    assert r0.n_shards == 1 and r0.shard_seconds is None
    assert_matches_reference(r, ref_sharded[name], a.m)
    if r0.b_sketches is not None:
        assert r.b_sketches.shape == (a.m + 1, r.m_regs)
        assert not r.b_sketches[-1].any()  # the merge's zero sentinel row


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_analysis_empty_and_rectangular(n):
    z = formats.csr_from_dense(np.zeros((5, 7), np.float32), device="cpu")
    b = formats.random_uniform_csr(3, 7, 30, 3.0, device="cpu")
    for x, y in ((z, b), (b, formats.csr_from_dense(
            np.zeros((30, 4), np.float32), device="cpu"))):
        r0 = analysis.analyze(x, y)
        r = analysis.analyze(x, y, devices=cpus(n))
        assert_analysis_identical(r, r0)
    # a matrix without rows takes the monolithic path
    e = formats.csr_from_dense(np.zeros((0, 7), np.float32), device="cpu")
    assert analysis.analyze(e, b, devices=cpus(n)).n_shards == 1
    # more shards than rows: the empty blocks are skipped
    t = formats.random_uniform_csr(4, 3, 3, 2.0, device="cpu")
    assert_analysis_identical(analysis.analyze(t, t, devices=cpus(n + 3)),
                              analysis.analyze(t, t))


def test_sharded_analysis_without_sketches_and_with_known_sizes(suites):
    a = suites[1]["banded_wide"]
    for kw in ({"build_sketches": False},
               {"known_sizes": np.arange(a.m, dtype=np.int64) % 7}):
        r0 = analysis.analyze(a, a, **kw)
        r = analysis.analyze(a, a, devices=cpus(4), **kw)
        assert_analysis_identical(r, r0)
        assert r.b_sketches is None
    assert r.workflow == "known"
    np.testing.assert_array_equal(r.known_sizes, r0.known_sizes)
    ra = suites[0]["banded_wide"]
    rr = ranalysis.analyze(ra, ra, devices=4, build_sketches=False)
    assert_matches_reference(
        analysis.analyze(a, a, devices=cpus(4), build_sketches=False), rr,
        a.m)


def test_sketch_cache_interchanges_between_sharded_and_monolithic(suites):
    a = suites[1]["banded_wide"]
    cache_s: dict = {}
    r_s = analysis.analyze(a, a, sketch_cache=cache_s, devices=cpus(4))
    assert r_s.workflow == "estimation" and len(cache_s) == 1
    (buf,) = cache_s.values()
    assert r_s.b_sketches is buf
    r_m = analysis.analyze(a, a, sketch_cache=cache_s)
    assert r_m.b_sketches is buf
    assert_analysis_identical(r_m, r_s)
    cache_m: dict = {}
    r0 = analysis.analyze(a, a, sketch_cache=cache_m)
    r1 = analysis.analyze(a, a, sketch_cache=cache_m, devices=cpus(4))
    assert r1.b_sketches is r0.b_sketches
    assert_analysis_identical(r1, r0)
    torch.testing.assert_close(buf, r0.b_sketches, rtol=0, atol=0)


def test_sharded_merge_estimate_parity(suites):
    rb, b = suites[0]["banded_wide"], suites[1]["banded_wide"]
    sk = analysis.sketches_for(b, 64, 0)
    mono = analysis.sharded_merge_estimate(b, sk, clip_max=b.n)
    for n in (1, 2, 3, 4, 7):
        got = analysis.sharded_merge_estimate(b, sk, clip_max=b.n,
                                              devices=cpus(n))
        assert got.dtype == mono.dtype
        np.testing.assert_array_equal(got, mono)
    import jax.numpy as jnp
    rsk = ranalysis.sketches_for(rb, 64, 0)
    rsk = jnp.concatenate([rsk, jnp.zeros((1, 64), jnp.int32)], axis=0)
    want = ranalysis.sharded_merge_estimate(rb, rsk, clip_max=rb.n,
                                            devices=4)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (analysis.contiguous_split_rows(np.asarray(b.indptr), 3)
            == ranalysis.contiguous_split_rows(np.asarray(rb.indptr), 3))


@pytest.mark.parametrize("name", ["banded_wide", "uniform_mid", "block"])
def test_build_plan_with_analysis_devices(suites, name):
    a = suites[1][name]
    p0 = planner.build_plan(a, a)
    p1 = planner.build_plan(a, a, analysis_devices=cpus(3))
    assert (p1.analysis_shards, p0.analysis_shards) == (3, 1)
    assert p1.workflow == p0.workflow
    assert p1.bins_describe == p0.bins_describe
    np.testing.assert_array_equal(p1.products, p0.products)
    np.testing.assert_array_equal(p1.pred_row_nnz, p0.pred_row_nnz)
    c0, _ = planner.execute_plan(p0, a, a)
    c1, rep = planner.execute_plan(p1, a, a)
    assert_bit_identical(c1, c0)
    assert rep.analysis_shards == 3 and len(rep.analysis_shard_seconds) == 3


def test_workflow_analysis_devices(suites):
    a = suites[1]["uniform_mid"]
    c0, rep0 = workflow.ocean_spgemm(a, a, cache=False)
    c1, rep1 = workflow.ocean_spgemm(a, a, cache=False, devices=cpus(2))
    assert (rep1.analysis_shards, rep1.n_shards) == (2, 2)
    c2, rep2 = workflow.ocean_spgemm(a, a, cache=False,
                                     analysis_devices=cpus(4))
    assert (rep2.analysis_shards, rep2.n_shards) == (4, 1)
    c3, rep3 = workflow.ocean_spgemm(a, a, cache=False, devices=cpus(2),
                                     analysis_devices=cpus(4))
    assert (rep3.analysis_shards, rep3.n_shards) == (4, 2)
    for c in (c1, c2, c3):
        assert_bit_identical(c, c0)
    # analysis_devices is not in the key: the plan serves a monolithic call
    cache = planner.PlanCache()
    workflow.ocean_spgemm(a, a, cache=cache, analysis_devices=cpus(4))
    c4, rep4 = workflow.ocean_spgemm(a, a, cache=cache)
    assert rep4.plan_cache_hit and rep4.analysis_shards == 4
    assert_bit_identical(c4, c0)


# ---------------------------------------------------------------------------
# Trace spans of a sharded call, as the reference's
# ---------------------------------------------------------------------------

# the port's spans that the reference does not record
PORT_SPANS = {trace.ROOT}.union(*trace.SUB_SPANS.values())


def lanes(tracer, exporter):
    """Per recording thread's name, the multiset of (span name, parent
    name), the port's own spans left out and a multiply root's children
    parentless, as the reference records them."""
    doc = exporter.to_chrome_trace(tracer)
    exporter.validate_chrome_trace(json.dumps(doc))
    thread_of = {e["tid"]: e["thread"] for e in tracer.events()}
    out = collections.defaultdict(collections.Counter)
    for e in doc["traceEvents"]:
        if e.get("pid") != 0 or e["name"] in PORT_SPANS:
            continue
        parent = e["args"].get("parent")
        out[thread_of[e["tid"]]][
            e["name"], None if parent == trace.ROOT else parent] += 1
    return dict(out)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("name", ["banded_wide", "uniform_small"])
def test_sharded_call_spans_match_reference(suites, name, n):
    ra, pa = suites[0][name], suites[1][name]
    rtr, ptr = rtrace.Tracer(), trace.Tracer()
    with rtrace.tracing(rtr):
        rworkflow.ocean_spgemm(ra, ra, cache=False, devices=n,
                               executor="pipelined")
    with trace.tracing(ptr):
        workflow.ocean_spgemm(pa, pa, cache=False, devices=cpus(n))
    assert lanes(ptr, trace_export) == lanes(rtr, rtrace_export)
    waves = {e["name"]: e["attrs"] for e in ptr.events()
             if e["name"].startswith("analysis.wave")}
    assert waves == {"analysis.wave1": {"shards": n},
                     "analysis.wave2": {"shards": n}}
    assert "plan.partition" in ptr.names()


# ---------------------------------------------------------------------------
# Graph chains and serving with device sets
# ---------------------------------------------------------------------------

def test_chain_k_hop_with_devices():
    radj = rgraph.rmat_csr(1, 7, 16)
    padj = graph.rmat_csr(1, 7, 16, device="cpu")
    seeds = [0, 1, 2]
    want, wres = graph.k_hop_frontier(padj, seeds, 3)
    got, res = graph.k_hop_frontier(padj, seeds, 3, devices=cpus(3))
    rgot, rres = rgraph.k_hop_frontier(radj, seeds, 3, devices=3)
    assert "estimation" in res.stats.workflows
    for x, y, z in zip(got, want, rgot):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    assert all(r.n_shards == 3 for r in res.reports)
    assert_bit_identical(res.final, wres.final)
    assert_same_csr(res.final, rres.final)
    assert res.stats.workflows == rres.stats.workflows


@pytest.mark.parametrize("n", [2, 4])
def test_chain_mcl_with_devices(n):
    """MCL's column sums fold in dispatch order, which sharding changes;
    the iterates must still equal the unsharded run's and the reference's
    sharded run's (values rtol 1e-5 / atol 1e-6)."""
    radj = rgraph.rmat_csr(77, 6, 4)
    padj = graph.rmat_csr(77, 6, 4, device="cpu")
    want = graph.markov_cluster(padj, iterations=6)
    got = graph.markov_cluster(padj, iterations=6, devices=cpus(n))
    ref = rgraph.markov_cluster(radj, iterations=6, devices=n)
    assert all(r.n_shards == n for r in got.result.reports)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.labels, ref.labels)
    got_np, want_np = formats.to_numpy(got.matrix), formats.to_numpy(
        want.matrix)
    np.testing.assert_array_equal(got_np[0], want_np[0])
    np.testing.assert_array_equal(got_np[1], want_np[1])
    np.testing.assert_allclose(got_np[2], want_np[2], **FLOAT_TOL)
    assert_same_csr(got.matrix, ref.matrix)


def _serve_mats(**dev):
    return (formats.random_uniform_csr(11, 120, 120, 6.0, **dev),
            formats.banded_csr(12, 120, 120, 24, **dev),
            formats.powerlaw_csr(13, 120, 120, 6.0, **dev),
            formats.random_uniform_csr(14, 120, 120, 5.0, **dev))


def test_service_with_devices():
    *pats, b = _serve_mats(device="cpu")
    svc = serving.SpGEMMService(devices=cpus(2), analysis_devices=cpus(4))
    for a in pats:
        want, _ = workflow.ocean_spgemm(a, b, cache=False)
        c1, rep1 = svc.multiply(a, b, tenant="acme")
        c2, rep2 = svc.multiply(a, b, tenant="acme")
        assert (rep1.n_shards, rep1.analysis_shards) == (2, 4)
        assert not rep1.plan_cache_hit and rep2.plan_cache_hit
        assert_bit_identical(c1, want)
        assert_bit_identical(c2, want)
    assert svc.stats.plan_hits == 3 and svc.stats.plan_misses == 3
    # the default analysis set is the service's execution set
    _, rep = serving.SpGEMMService(devices=cpus(3)).multiply(pats[0], b)
    assert (rep.n_shards, rep.analysis_shards) == (3, 3)


def test_pool_with_devices_and_chains():
    *pats, b = _serve_mats(device="cpu")
    wants = [workflow.ocean_spgemm(a, b, cache=False)[0] for a in pats]
    pool = serving.SpGEMMPool(serving.PoolConfig(workers=2, max_batch=4),
                              devices=cpus(3), autostart=False)
    futs = [(p, pool.submit(pats[p], b, tenant=t))
            for t in ("acme", "globex") for p in range(3)]
    assert pool.warm_wait(TIMEOUT)
    pool.start()
    for p, f in futs:
        c, rep = f.result(TIMEOUT)
        assert rep.n_shards == 3 and rep.plan_cache_hit
        assert_bit_identical(c, wants[p])
    assert pool.stats.plans_warmed == 6
    adj = graph.rmat_csr(1, 6, 8, device="cpu")
    res = pool.service.run_chain(graph.seeds_to_frontier(
        [0, 1], adj.n, device="cpu"), adj, 2, tenant="acme")
    pool.shutdown(timeout=TIMEOUT)
    want = graph.spgemm_chain(graph.seeds_to_frontier(
        [0, 1], adj.n, device="cpu"), adj, 2)
    assert all(r.n_shards == 3 for r in res.reports)
    assert_bit_identical(res.final, want.final)
