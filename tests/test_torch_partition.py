"""The port's device-partitioned plans and sharded executor vs the JAX
reference, on the CPU.

The port's shards are logical: a device set that repeats ``"cpu"``. The
reference partitions across the four host devices ``tests/conftest.py``
forces. Integers are exact: split and ladder functions, shard row sets,
shard costs and imbalance, output indptr/indices, overflow counts. The
port's sharded C is bit-identical to its single-device C; against the
reference's sharded C the values are held to rtol 1e-5 / atol 1e-6 (both
sides sum in product-enumeration order).

The reference sizes its hash tables from a timed load factor, so its
tuning cache is replaced by a pinned one while this module runs (the port
sizes them from a fixed one).
"""

import numpy as np
import pytest

try:  # hypothesis is optional: the suite must collect and pass without it
    from hypothesis import given, settings, strategies as st
except ImportError:  # deterministic fixed-seed fallback, same properties
    from _hypothesis_fallback import given, settings, st

torch = pytest.importorskip("torch")

from repro.core import formats as rformats  # noqa: E402
from repro.core import partition as rpartition  # noqa: E402
from repro.core import planner as rplanner  # noqa: E402
from repro.core import tuning as rtuning  # noqa: E402
from repro.core.analysis import OceanConfig as ROceanConfig  # noqa: E402
from repro_torch.core import (dispatch, formats, partition, planner,  # noqa: E402,E501
                              workflow)
from repro_torch.core.analysis import OceanConfig  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_shard_mesh)

RUNGS = (32, 64, 128, 256, 512, 1024, 2048, rtuning.REFERENCE_RUNG)
SUITE_NAMES = [name for name, _ in rformats.make_suite(1)]
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)


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
def plans(pinned_tuning):
    """Per suite matrix: (reference matrix, reference plan, port matrix,
    port plan, port single-device C)."""
    out = {}
    for (name, ra), (_, pa) in zip(rformats.make_suite(1),
                                   formats.make_suite(1, device="cpu")):
        pplan = planner.build_plan(pa, pa)
        c, _ = planner.execute_plan(pplan, pa, pa)
        out[name] = (ra, rplanner.build_plan(ra, ra), pa, pplan, c)
    return out


def assert_bit_identical(x, y):
    for u, v in zip(formats.to_numpy(x), formats.to_numpy(y)):
        np.testing.assert_array_equal(u, v)


def assert_same_csr(c_port, c_ref):
    got, want = formats.to_numpy(c_port), c_ref.to_scipy_like()
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[2], np.asarray(want[2]), **FLOAT_TOL)


def both_dense(dense):
    dense = np.asarray(dense, np.float32)
    return (rformats.csr_from_dense(dense),
            formats.csr_from_dense(dense, device="cpu"))


# ---------------------------------------------------------------------------
# The split and ladder functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_splits_and_ladders_match_reference(seed):
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 1000, int(rng.integers(1, 400))).astype(np.int64)
    costs[rng.random(len(costs)) < 0.2] = 0
    for n in (1, 2, 3, 4, 5):
        for got, want in zip(partition.balanced_split(costs, n),
                             rpartition.balanced_split(costs, n)):
            np.testing.assert_array_equal(got, want)
        assert (partition.contiguous_split(costs, n)
                == rpartition.contiguous_split(costs, n))
    # one heap carried across consecutive bins, as partition_plan does
    heaps = [[(0, i) for i in range(3)] for _ in range(2)]
    for part in np.array_split(costs, 3):
        for got, want in zip(partition.balanced_split(part, 3, heaps[0]),
                             rpartition.balanced_split(part, 3, heaps[1])):
            np.testing.assert_array_equal(got, want)
    assert sorted(heaps[0]) == sorted(heaps[1])
    for rows in (0, 1, 31, 32, 33, 100, 1000):
        for bin_rows in (1, 40, 64, 5000):
            assert (partition.bucket_shard_rows(rows, bin_rows)
                    == rpartition.bucket_shard_rows(rows, bin_rows))
    for r_pad in (0, 1, 2, 7, 64, 10_000):
        for bin_cap in (1, 100, 1 << 20):
            for floor in (64, partition.ESC_SHARD_NNZ_FLOOR, 8):
                assert (partition.rung_capacity_cap(costs, r_pad, bin_cap,
                                                    floor=floor)
                        == rpartition.rung_capacity_cap(
                            costs, r_pad, bin_cap, floor=floor))


def test_ladder_edges_match_reference():
    """The exact-pow2 boundary, degenerate rungs and contiguous splits of
    zero-cost rows and of more shards than rows."""
    costs = np.array([64, 64], np.int64)
    cases = [(costs, 2, 1 << 20), (costs, 1, 1 << 20), (costs, 2, 100),
             (np.zeros(0, np.int64), 4, 256),
             (np.array([1], np.int64), 1, 1), (costs, 8, 1 << 20)]
    for args in cases:
        assert (partition.rung_capacity_cap(*args)
                == rpartition.rung_capacity_cap(*args))
    assert partition.rung_capacity_cap(costs, 2, 1 << 20) == 128
    for costs, n in ((np.zeros(10, np.int64), 3), (np.ones(2, np.int64), 4),
                     (np.zeros(0, np.int64), 3), (np.ones(7, np.int64), 1)):
        assert (partition.contiguous_split(costs, n)
                == rpartition.contiguous_split(costs, n))
    assert (partition.SHARD_ROW_FLOOR, partition.ESC_SHARD_NNZ_FLOOR) == (
        rpartition.SHARD_ROW_FLOOR, rpartition.ESC_SHARD_NNZ_FLOOR)


# ---------------------------------------------------------------------------
# partition_plan against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("name", SUITE_NAMES)
def test_partition_matches_reference(plans, name, n):
    _, rplan, _, pplan, _ = plans[name]
    rs = rpartition.partition_plan(rplan, n)
    ps = partition.partition_plan(pplan, cpus(n))
    assert ps.n_shards == rs.n_shards == n
    np.testing.assert_array_equal(ps.shard_costs, rs.shard_costs)
    assert ps.imbalance == rs.imbalance
    assert ps.topology == ",".join(["cpu"] * n)
    for psh, rsh in zip(ps.shards, rs.shards):
        assert psh.cost == rsh.cost
        for kind in ("dense", "hash"):
            got, want = getattr(psh, kind), getattr(rsh, kind)
            assert [s.bin_id for s in got] == [s.bin_id for s in want]
            for gs, ws in zip(got, want):
                np.testing.assert_array_equal(gs.rows, ws.rows)
                np.testing.assert_array_equal(gs.cost, ws.cost)
                assert gs.n_valid == ws.n_valid == len(gs.rows)
                # unpadded slices: the kernel inputs hold the real rows
                assert gs.a_rows.shape[0] == gs.n_valid
        assert (psh.esc is None) == (rsh.esc is None)
        if psh.esc is not None:
            np.testing.assert_array_equal(psh.esc.rows, rsh.esc.rows)
            np.testing.assert_array_equal(psh.esc.cost, rsh.esc.cost)
    # every bin's slices are a disjoint cover of its rows
    for be in pplan.dense + pplan.hash:
        got = np.concatenate([s.rows for sh in ps.shards
                              for s in sh.dense + sh.hash
                              if s.bin_id == be.bin_id])
        np.testing.assert_array_equal(np.sort(got), np.sort(be.rows))


@pytest.mark.parametrize("name", SUITE_NAMES)
def test_bin_containers_carry_reference_costs(plans, name):
    _, rplan, _, pplan, _ = plans[name]
    for got, want in zip(pplan.dense + pplan.hash, rplan.dense + rplan.hash):
        assert (got.bin_id, got.n_valid) == (want.bin_id, want.n_valid)
        np.testing.assert_array_equal(got.cost, want.cost)
    if rplan.esc is not None:
        np.testing.assert_array_equal(pplan.esc.cost, rplan.esc.cost)
        assert pplan.esc.n_valid == rplan.esc.n_valid


# ---------------------------------------------------------------------------
# Sharded execution: bit-identical to single-device, as the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", (2, 3, 4))
@pytest.mark.parametrize("name", SUITE_NAMES)
def test_sharded_equals_single_device(plans, name, n):
    _, _, pa, pplan, c1 = plans[name]
    c2, rep = planner.execute_sharded_plan(
        partition.partition_plan(pplan, cpus(n)), pa, pa)
    assert_bit_identical(c2, c1)
    assert (rep.n_shards, rep.nnz_out) == (n, c1.nnz)


@pytest.mark.parametrize("name", SUITE_NAMES)
def test_sharded_matches_reference_sharded(plans, name):
    ra, rplan, pa, pplan, _ = plans[name]
    rc, rrep = rplanner.execute_sharded_plan(
        rpartition.partition_plan(rplan, 4), ra, ra)
    pc, prep = planner.execute_sharded_plan(
        partition.partition_plan(pplan, cpus(4)), pa, pa)
    assert_same_csr(pc, rc)
    assert (prep.n_shards, prep.overflow_rows) == (rrep.n_shards,
                                                   rrep.overflow_rows)
    assert prep.shard_imbalance == rrep.shard_imbalance


def test_sharded_exact_rectangular():
    rng = np.random.default_rng(7)
    d = (rng.random((128, 512)) < 12 / 512) * rng.random((128, 512))
    ra, pa = both_dense(d)
    rb, pb = both_dense(d.T)
    pplan = planner.build_plan(pa, pb)
    c1, _ = planner.execute_plan(pplan, pa, pb)
    c2, _ = planner.execute_sharded_plan(
        partition.partition_plan(pplan, cpus(4)), pa, pb)
    assert_bit_identical(c2, c1)
    rplan = rplanner.build_plan(ra, rb)
    rc, _ = rplanner.execute_sharded_plan(
        rpartition.partition_plan(rplan, 4), ra, rb)
    assert_same_csr(c2, rc)


def test_sharded_exact_under_overflow():
    """Undersized capacities: the overflow rows and their count are the
    unsharded run's and the reference's, and C is bit-identical."""
    kw = dict(expansion=0.05, expansion_small_regs=0.05, cr_threshold=0.0,
              er_threshold=0.0, upper_bound_avg_products=0.0)
    ra = rformats.random_uniform_csr(10, 200, 200, 16.0)
    pa = formats.random_uniform_csr(10, 200, 200, 16.0, device="cpu")
    pplan = planner.build_plan(pa, pa, OceanConfig(**kw),
                               force_workflow="estimation")
    c1, rep1 = planner.execute_plan(pplan, pa, pa)
    assert rep1.overflow_rows > 0
    rplan = rplanner.build_plan(ra, ra, ROceanConfig(**kw),
                                force_workflow="estimation")
    rc, rrep = rplanner.execute_sharded_plan(
        rpartition.partition_plan(rplan, 4), ra, ra)
    c2, rep2 = planner.execute_sharded_plan(
        partition.partition_plan(pplan, cpus(4)), pa, pa)
    assert rep2.overflow_rows == rep1.overflow_rows == rrep.overflow_rows
    assert_bit_identical(c2, c1)
    assert_same_csr(c2, rc)


def test_more_devices_than_rows():
    dense = np.array([[1.0, 0, 2.0, 0], [0, 3.0, 0, 0], [4.0, 0, 0, 5.0]],
                     np.float32)
    _, pa = both_dense(dense)
    _, pb = both_dense(dense.T.copy())
    plan = planner.build_plan(pa, pb)
    splan = partition.partition_plan(plan, cpus(5))
    assert sum(not sh.dense and not sh.hash and sh.esc is None
               for sh in splan.shards) >= 2
    c1, _ = planner.execute_plan(plan, pa, pb)
    c2, _ = planner.execute_sharded_plan(splan, pa, pb)
    assert_bit_identical(c2, c1)
    np.testing.assert_allclose(c2.to_dense().numpy(), dense @ dense.T,
                               atol=1e-5)


def test_single_device_passes_the_plan_through(plans):
    _, _, pa, plan, c1 = plans["banded_wide"]
    splan = partition.partition_plan(plan, ["cpu"])
    assert splan.n_shards == 1 and splan.topology == "cpu"
    sh = splan.shards[0]
    assert all(s is p for s, p in zip(sh.dense, plan.dense))
    assert all(s is p for s, p in zip(sh.hash, plan.hash))
    assert sh.esc is plan.esc
    c2, rep = planner.execute_sharded_plan(splan, pa, pa)
    assert_bit_identical(c2, c1)
    assert rep.n_shards == 1 and rep.shard_imbalance == 1.0


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 4))
def test_property_sharded_exact_on_random_pairs(seed, n):
    rng = np.random.default_rng(seed)
    m, k, n_cols = (int(rng.integers(2, 60)) for _ in range(3))
    am = ((rng.random((m, k)) < 0.15)
          * rng.integers(-3, 4, (m, k))).astype(np.float32)
    bm = ((rng.random((k, n_cols)) < 0.15)
          * rng.integers(-3, 4, (k, n_cols))).astype(np.float32)
    a = formats.csr_from_dense(am, device="cpu")
    b = formats.csr_from_dense(bm, device="cpu")
    if a.nnz == 0 or b.nnz == 0:
        return
    plan = planner.build_plan(a, b)
    c1, _ = planner.execute_plan(plan, a, b)
    c2, _ = planner.execute_sharded_plan(
        partition.partition_plan(plan, cpus(n)), a, b)
    assert_bit_identical(c2, c1)
    np.testing.assert_allclose(c2.to_dense().numpy(), am @ bm, atol=1e-5)


# ---------------------------------------------------------------------------
# Workflow: topology keying, prebuilt sharded plans, batches, warming
# ---------------------------------------------------------------------------

def test_workflow_devices_and_topology_cache_keying():
    a = formats.random_uniform_csr(99, 300, 300, 9.0, device="cpu")
    cache = planner.PlanCache()
    c1, rep1 = workflow.ocean_spgemm(a, a, cache=cache, devices=cpus(2))
    assert not rep1.plan_cache_hit and rep1.n_shards == 2
    assert rep1.stage_seconds["partition"] >= 0.0
    assert rep1.analysis_shards == 2 and len(rep1.analysis_shard_seconds) == 2
    c2, rep2 = workflow.ocean_spgemm(a, a, cache=cache, devices=cpus(2))
    assert rep2.plan_cache_hit and rep2.n_shards == 2
    assert_bit_identical(c1, c2)
    # another topology: a miss that re-uses the base plan
    _, rep3 = workflow.ocean_spgemm(a, a, cache=cache, devices=cpus(4))
    assert not rep3.plan_cache_hit and rep3.n_shards == 4
    for k in ("analysis", "prediction", "binning"):
        assert rep3.stage_seconds[k] == 0.0
    # the unsharded call hits the base plan the sharded miss inserted
    c4, rep4 = workflow.ocean_spgemm(a, a, cache=cache)
    assert rep4.plan_cache_hit and rep4.n_shards == 1
    assert_bit_identical(c1, c4)
    key = planner.structure_key(a, a, OceanConfig(), None, True, True)
    assert isinstance(cache.peek(key + "|cpu,cpu"), partition.ShardedPlan)
    assert isinstance(cache.peek(key + "|cpu,cpu,cpu,cpu"),
                      partition.ShardedPlan)
    assert len(cache) == 3


def test_prebuilt_sharded_plan_via_workflow():
    a = formats.banded_csr(61, 140, 140, 20, device="cpu")
    plan = planner.build_plan(a, a)
    splan = partition.partition_plan(plan, cpus(2))
    c1, rep1 = workflow.ocean_spgemm(a, a, plan=splan)
    assert rep1.n_shards == 2
    c2, _ = workflow.ocean_spgemm(a, a, plan=plan)
    assert_bit_identical(c1, c2)
    c3, _ = workflow.ocean_spgemm(a, a, plan=splan, devices=cpus(2))
    assert_bit_identical(c1, c3)
    with pytest.raises(ValueError, match="partitioned for"):
        workflow.ocean_spgemm(a, a, plan=splan, devices=cpus(4))
    # an ExecutionPlan with devices= partitions on the call
    c4, rep4 = workflow.ocean_spgemm(a, a, plan=plan, devices=cpus(3))
    assert rep4.n_shards == 3 and "partition" in rep4.stage_seconds
    assert_bit_identical(c1, c4)


def test_workflow_many_and_warm_plan_with_devices():
    b = formats.random_uniform_csr(52, 180, 180, 12.0, device="cpu")
    a_list = [formats.random_uniform_csr(53 + i, 140, 180, 8.0,
                                         device="cpu") for i in range(3)]
    cache = planner.PlanCache()
    many = workflow.ocean_spgemm_many(a_list, b, cache=cache,
                                      devices=cpus(3))
    loop = [workflow.ocean_spgemm(a, b, cache=False) for a in a_list]
    for (cm, rm), (cl, _) in zip(many, loop):
        assert rm.n_shards == 3 and rm.analysis_shards == 3
        assert_bit_identical(cm, cl)
    warm = planner.PlanCache()
    key, built = workflow.warm_plan(a_list[0], b, cache=warm,
                                    devices=cpus(2))
    assert built and key.endswith("|cpu,cpu") and len(warm) == 2
    assert workflow.warm_plan(a_list[0], b, cache=warm,
                              devices=cpus(2)) == (key, False)
    assert warm.stats()["hits"] == warm.stats()["misses"] == 0
    c, rep = workflow.ocean_spgemm(a_list[0], b, cache=warm,
                                   devices=cpus(2))
    assert rep.plan_cache_hit and rep.n_shards == 2
    assert_bit_identical(c, loop[0][0])


def test_resolve_devices_and_topology_key():
    assert dispatch.resolve_devices(["cpu", torch.device("cpu")]) == (
        torch.device("cpu"),) * 2
    assert partition.topology_key(cpus(3)) == "cpu,cpu,cpu"
    assert dispatch.topology_key([torch.device("cuda", 0)] * 2) == \
        "cuda:0,cuda:0"
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for bad in (0, have + 1, []):
        with pytest.raises(ValueError):
            dispatch.resolve_devices(bad)
    if have == 0:
        for bad in (None, ["cuda:0"], ["cpu", "cuda"]):
            with pytest.raises(ValueError, match="CUDA devices"):
                dispatch.resolve_devices(bad)
    with pytest.raises(ValueError, match="CUDA devices"):
        dispatch.resolve_devices([torch.device("cuda", have)])
    # the mesh form (launch/mesh.py): a shard mesh is its devices, keyed
    # as the same device list; a production mesh is a shape and raises
    shard = make_shard_mesh(2, device_type="cpu")
    assert dispatch.resolve_devices(shard) == (torch.device("cpu"),) * 2
    assert dispatch.topology_key(dispatch.resolve_devices(shard)) == \
        partition.topology_key(cpus(2))
    with pytest.raises(ValueError, match="holds no devices"):
        dispatch.resolve_devices(make_production_mesh())
    with pytest.raises(TypeError, match="sequence"):
        dispatch.resolve_devices("cpu")
