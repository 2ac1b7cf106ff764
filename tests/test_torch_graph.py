"""The port's fused merge post-ops and graph path vs the JAX reference, on
the CPU.

The same seeded graphs go through ``repro.graph`` and ``repro_torch.graph``.
Integers are exact: generator arrays, output indptr/indices, raw row nnz,
triangle counts, frontier vertex sets, MCL labels, workflows and chain
counters. Values: rtol 1e-5 / atol 1e-6 (both sides sum in
product-enumeration order); the MCL iterate within atol 1e-5, as the
reference's own test holds it to its oracle (inflation and normalization
over several iterations).

The reference sizes its hash tables from a timed load factor, so its
tuning cache is pinned to the default tuning while this module runs (the
port sizes them from that default without a cache).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.graph as rgraph  # noqa: E402
from repro.core import tuning as rtuning  # noqa: E402
from repro.core import executor as rexecutor  # noqa: E402
from repro.core import formats as rformats  # noqa: E402
from repro.core import workflow as rworkflow  # noqa: E402
import repro_torch.graph as graph  # noqa: E402
from repro_torch.core import executor, formats, workflow  # noqa: E402

RUNGS = (32, 64, 128, 256, 512, 1024, 2048, rtuning.REFERENCE_RUNG)
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def pinned_tuning():
    saved = dict(rtuning.DEFAULT_TUNING_CACHE._entries)
    for r in RUNGS:
        rtuning.DEFAULT_TUNING_CACHE.insert(rtuning.tuning_key(r),
                                            rtuning.HashTuning())
    yield
    rtuning.DEFAULT_TUNING_CACHE.clear()
    for k, v in saved.items():
        rtuning.DEFAULT_TUNING_CACHE.insert(k, v)


def both(gen_name, *args, **kw):
    """The reference's graph and the port's (CPU) from one generator call."""
    ref = getattr(rgraph, gen_name)(*args, **kw)
    return ref, getattr(graph, gen_name)(*args, device="cpu", **kw)


def uniform(seed, m, n, deg):
    return (rformats.random_uniform_csr(seed, m, n, deg),
            formats.random_uniform_csr(seed, m, n, deg, device="cpu"))


def assert_same_csr(c_port, c_ref, tol=FLOAT_TOL):
    got, want = formats.to_numpy(c_port), c_ref.to_scipy_like()
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[2], np.asarray(want[2]), **tol)


def assert_bit_identical(x, y):
    for u, v in zip(formats.to_numpy(x), formats.to_numpy(y)):
        np.testing.assert_array_equal(u, v)


def assert_same_stats(port, ref):
    for f in ("iterations", "plan_hits", "feed_forward_skips",
              "estimated_builds", "converged_at", "nnz_trajectory",
              "workflows"):
        assert getattr(port, f) == getattr(ref, f), f


@pytest.mark.parametrize("gen,args,kw", [
    ("rmat_csr", (5, 6, 6), {}),
    ("erdos_renyi_csr", (5, 80, 4.0), {}),
    ("rmat_csr", (9, 5, 4), dict(symmetric=False, self_loops=True,
                                 weights="random")),
    ("erdos_renyi_csr", (6, 50, 2.0), dict(symmetric=False,
                                           weights="random")),
])
def test_generators_give_the_reference_arrays(gen, args, kw):
    ref, port = both(gen, *args, **kw)
    assert port.shape == ref.shape and port.nnz == ref.nnz
    for x, y in zip(formats.to_numpy(port), ref.to_scipy_like()):
        np.testing.assert_array_equal(x, np.asarray(y))
    with pytest.raises(ValueError):
        graph.rmat_csr(0, 4, 2, a=0.9, b=0.2, c=0.2, device="cpu")
    with pytest.raises(ValueError):
        graph.erdos_renyi_csr(0, 10, 1.0, weights="bogus", device="cpu")


@pytest.mark.parametrize("known", [False, True])
def test_masked_spgemm_matches_reference(known):
    (ra, pa), (rm, pm) = uniform(44, 160, 160, 8.0), uniform(45, 160, 160,
                                                             4.0)
    kw = dict(known_sizes=np.ones(ra.m, np.int64)) if known else {}
    rc, rrep = rgraph.masked_spgemm(ra, ra, rm, cache=False, **kw)
    pc, prep = graph.masked_spgemm(pa, pa, pm, cache=False, **kw)
    assert_same_csr(pc, rc)
    np.testing.assert_array_equal(prep.raw_row_nnz, rrep.raw_row_nnz)
    assert (prep.workflow, prep.overflow_rows) == (rrep.workflow,
                                                   rrep.overflow_rows)
    if known:  # a stale feed overflows; the fallback slab is masked too
        assert prep.overflow_rows > 0
    with pytest.raises(ValueError):
        graph.masked_spgemm(pa, pa, uniform(52, 90, 90, 5.0)[1])


def test_fused_prune_and_bool_post_match_reference():
    ra, pa = uniform(53, 120, 120, 6.0)
    rc, _ = rworkflow.ocean_spgemm(
        ra, ra, cache=False, post=rexecutor.MergePostOps(n_cols=ra.n,
                                                         threshold=0.5))
    pc, _ = workflow.ocean_spgemm(
        pa, pa, cache=False, post=executor.MergePostOps(n_cols=pa.n,
                                                        threshold=0.5))
    assert_same_csr(pc, rc)
    plain, _ = workflow.ocean_spgemm(pa, pa, cache=False)
    assert_bit_identical(pc, graph.prune(plain, 0.5))
    f = graph.seeds_to_frontier([0, 1, 2], pa.n, device="cpu")
    rf = rgraph.seeds_to_frontier([0, 1, 2], ra.n)
    pb, _ = workflow.ocean_spgemm(f, pa, cache=False,
                                  post=graph.bool_post(pa.n))
    rb, _ = rworkflow.ocean_spgemm(rf, ra, cache=False,
                                   post=rgraph.bool_post(ra.n))
    assert_same_csr(pb, rb)
    assert (formats.to_numpy(pb)[2] == 1.0).all()
    with pytest.raises(ValueError, match="post-ops built for"):
        workflow.ocean_spgemm(pa, pa, cache=False,
                              post=graph.bool_post(pa.n + 1))


def test_host_ops_match_reference():
    ra, pa = uniform(54, 90, 90, 5.0)
    for name, args in (("prune", (0.7,)), ("normalize_columns", ()),
                       ("inflate", (2.0, 1e-2))):
        assert_same_csr(getattr(graph, name)(pa, *args),
                        getattr(rgraph, name)(ra, *args))
    radj, padj = both("rmat_csr", 73, 5, 4)
    assert_same_csr(graph.lower_triangle(padj), rgraph.lower_triangle(radj))


@pytest.mark.parametrize("post", ["mask", "inflate"])
def test_fused_mask_and_inflate_post_match_reference(post):
    (ra, pa), (rm, pm) = uniform(47, 200, 200, 10.0), uniform(48, 200, 200,
                                                              5.0)
    if post == "mask":
        ops, rops = (graph.mask_post(pm, threshold=0.1),
                     rgraph.mask_post(rm, threshold=0.1))
    else:
        ops, rops = (graph.inflate_post(pa.n, 2.0, 1e-3),
                     rgraph.inflate_post(ra.n, 2.0, 1e-3))
    c, rep = workflow.ocean_spgemm(pa, pa, cache=False, post=ops)
    rc, rrep = rworkflow.ocean_spgemm(ra, ra, cache=False, post=rops)
    assert_same_csr(c, rc)
    np.testing.assert_array_equal(rep.raw_row_nnz, rrep.raw_row_nnz)


@pytest.mark.parametrize("gen,args", [
    ("rmat_csr", (71, 6, 5)), ("erdos_renyi_csr", (72, 100, 4.0)),
    ("rmat_csr", (1, 8, 16))])
def test_triangle_count_matches_reference(gen, args):
    ref, port = both(gen, *args)
    rt, rrep = rgraph.triangle_count(ref, cache=False)
    pt, prep = graph.triangle_count(port, cache=False)
    assert pt == rt and prep.workflow == rrep.workflow
    assert prep.bins == rrep.bins
    np.testing.assert_array_equal(prep.raw_row_nnz, rrep.raw_row_nnz)


@pytest.mark.parametrize("gen,args,seeds,hops", [
    ("rmat_csr", (74, 6, 5), [0, 3], 4),
    ("erdos_renyi_csr", (75, 90, 3.0), [1], 3),
    ("rmat_csr", (1, 7, 16), [0, 1, 2], 3)])   # hops 2-3 take estimation
def test_k_hop_frontier_matches_reference(gen, args, seeds, hops):
    ref, port = both(gen, *args)
    rfr, rres = rgraph.k_hop_frontier(ref, seeds, hops)
    pfr, pres = graph.k_hop_frontier(port, seeds, hops)
    assert len(pfr) == len(rfr)
    for x, y in zip(pfr, rfr):
        np.testing.assert_array_equal(x, y)
    assert_same_stats(pres.stats, rres.stats)
    assert_same_csr(pres.final, rres.final)


def test_k_hop_empty_frontier_and_closure():
    ref, port = both("erdos_renyi_csr", 76, 40, 2.0)
    fronts, res = graph.k_hop_frontier(port, [], 2)
    assert all(len(f) == 0 for f in fronts) and res.final.nnz == 0
    from repro.graph.algorithms import _with_self_loops as rloops
    from repro_torch.graph.algorithms import _with_self_loops as ploops
    _, rstop = rgraph.k_hop_frontier(rloops(ref), [0], 30,
                                     stop_on_fixed_pattern=True)
    _, pstop = graph.k_hop_frontier(ploops(port), [0], 30,
                                    stop_on_fixed_pattern=True)
    assert_same_stats(pstop.stats, rstop.stats)
    assert pstop.stats.converged_at is not None


@pytest.mark.parametrize("gen,args", [
    ("rmat_csr", (77, 6, 4)), ("erdos_renyi_csr", (78, 64, 3.0))])
def test_markov_cluster_matches_reference(gen, args):
    ref, port = both(gen, *args)
    rm = rgraph.markov_cluster(ref, iterations=6)
    pm = graph.markov_cluster(port, iterations=6)
    np.testing.assert_array_equal(pm.labels, rm.labels)
    assert_same_csr(pm.matrix, rm.matrix, tol=dict(rtol=0, atol=1e-5))
    assert_same_stats(pm.result.stats, rm.result.stats)


def test_markov_cluster_converges_with_plan_hits():
    ref, port = both("erdos_renyi_csr", 79, 48, 2.5)
    rm = rgraph.markov_cluster(ref, iterations=25)
    pm = graph.markov_cluster(port, iterations=25)
    assert pm.result.stats.converged_at is not None
    assert pm.result.stats.plan_hits >= 1
    assert_same_stats(pm.result.stats, rm.result.stats)
    np.testing.assert_array_equal(pm.labels, rm.labels)


def test_chain_plan_hits_and_feed_forward_match_reference():
    eye = np.eye(64, dtype=np.float32)
    r_eye = rformats.csr_from_dense(eye)
    p_eye = formats.csr_from_dense(eye, device="cpu")
    rc0, pc0 = both("erdos_renyi_csr", 62, 64, 3.0)
    rres = rgraph.spgemm_chain(rc0, r_eye, 3)
    pres = graph.spgemm_chain(pc0, p_eye, 3)
    assert_same_stats(pres.stats, rres.stats)
    assert pres.stats.plan_hits == 2
    assert_bit_identical(pres.final, pc0)

    radj, padj = both("rmat_csr", 63, 6, 4)
    rc0, pc0 = both("erdos_renyi_csr", 64, radj.n, 2.0)
    rfeed, pfeed = rgraph.SizeFeed(), graph.SizeFeed()
    for runs in range(2):  # cold, then a fresh plan cache on a warm feed
        rres = rgraph.ChainRunner(radj, size_feed=rfeed).run(rc0, 3)
        pres = graph.ChainRunner(padj, size_feed=pfeed).run(pc0, 3)
        assert_same_stats(pres.stats, rres.stats)
        assert_same_csr(pres.final, rres.final)
    assert pres.stats.feed_forward_skips >= 1
    assert pres.stats.estimated_builds == 0
    assert all(rep.overflow_rows == 0 for rep in pres.reports)


def test_chain_refuses_device_sets_and_a_missing_rhs():
    """Device lists run every step sharded, equal to the unsharded chain;
    a count of CUDA devices the machine lacks, and a missing RHS, raise."""
    _, padj = both("erdos_renyi_csr", 66, 50, 2.0)
    _, pc0 = both("erdos_renyi_csr", 67, 50, 2.0)
    want = graph.ChainRunner(padj).run(pc0, 2)
    for kw in ({"devices": ["cpu"] * 2}, {"analysis_devices": ["cpu"] * 2}):
        got = graph.ChainRunner(padj, **kw).run(pc0, 2)
        assert [r.n_shards for r in got.reports] == (
            [2, 2] if "devices" in kw else [1, 1])
        for x, y in zip(formats.to_numpy(got.final),
                        formats.to_numpy(want.final)):
            np.testing.assert_array_equal(x, y)
    if torch.cuda.device_count() < 2:
        for kw in ({"devices": 2}, {"analysis_devices": 2}):
            with pytest.raises(ValueError, match="CUDA devices"):
                graph.ChainRunner(padj, **kw)
    with pytest.raises(ValueError):
        graph.ChainRunner(None).step(padj)
    assert graph.structure_hash(padj) == rgraph.structure_hash(
        rgraph.erdos_renyi_csr(66, 50, 2.0))
