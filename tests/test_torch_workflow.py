"""The PyTorch port's main path vs the JAX reference, on the CPU.

Analysis statistics, ESC, the symbolic pass, plans and whole
``ocean_spgemm`` calls of ``repro_torch`` are compared with ``repro`` on the
same matrices (the suite's numpy generators, the same seeds). Integers are
exact: products, ranges, symbolic counts, workflow choice, ``bins_describe``,
and the output's indptr/indices. Output values: rtol 1e-5 / atol 1e-6 (both
sides sum in product-enumeration order; only last-ulp f32 differences are
allowed). Sampled CR statistics: rtol 1e-6 (float64 arithmetic over HLL
estimates that agree to rtol 1e-5).

The reference sizes its hash tables from a *timed* load factor, so its
tuning cache is pinned to the default tuning for the duration of this
module; the port sizes them from that default without a cache.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import analysis as ranalysis  # noqa: E402
from repro.core import esc as resc  # noqa: E402
from repro.core import formats as rformats  # noqa: E402
from repro.core import planner as rplanner  # noqa: E402
from repro.core import tuning as rtuning  # noqa: E402
from repro.core import workflow as rworkflow  # noqa: E402
from repro_torch.core import analysis, esc, formats, planner, tuning  # noqa: E402,E501
from repro_torch.core import partition, workflow  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import spgemm_dense as kdense  # noqa: E402
from _torch_launches import launches  # noqa: E402,F401 (the fixture)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
SUITE_NAMES = [name for name, _ in rformats.make_suite(1)]
RUNGS = (32, 64, 128, 256, 512, 1024, 2048, rtuning.REFERENCE_RUNG)


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


@pytest.fixture(scope="module")
def suites():
    return (dict(rformats.make_suite(1)),
            dict(formats.make_suite(1, device="cpu")))


def assert_same_csr(c_port, c_ref):
    got, want = formats.to_numpy(c_port), c_ref.to_scipy_like()
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[2], np.asarray(want[2]), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", SUITE_NAMES)
def test_analysis_statistics_and_selection_match(suites, name):
    ref, port = suites[0][name], suites[1][name]
    prod_r, lo_r, hi_r = (np.asarray(x) for x in ranalysis._fused_stats(
        ref.indptr, ref.indices, ref.indptr, ref.indices,
        num_rows_a=ref.m, num_rows_b=ref.m))
    prod_p, lo_p, hi_p = (x.numpy() for x in analysis._fused_stats(port,
                                                                    port))
    np.testing.assert_array_equal(prod_p, prod_r)
    np.testing.assert_array_equal(lo_p, lo_r)   # incl. empty-row identities
    np.testing.assert_array_equal(hi_p, hi_r)
    ra = ranalysis.analyze(ref, ref)
    pa = analysis.analyze(port, port)
    assert pa.workflow == ra.workflow
    assert (pa.total_products, pa.m_regs) == (ra.total_products, ra.m_regs)
    assert pa.er == ra.er and pa.nproducts_avg == ra.nproducts_avg
    for f in ("sampled_cr", "cr_mean", "cr_std"):
        x, y = getattr(pa, f), getattr(ra, f)
        assert (x is None) == (y is None)
        if x is not None:
            assert x == pytest.approx(y, rel=1e-6)
    if ra.sample_rows is not None:
        np.testing.assert_array_equal(pa.sample_rows, ra.sample_rows)


@pytest.mark.parametrize("name", ["uniform_small", "powerlaw", "skewed"])
def test_esc_and_symbolic_match(suites, name):
    ref, port = suites[0][name], suites[1][name]
    p = int(np.asarray(ranalysis.products_per_row(
        ref.indptr, ref.indices, ref.indptr, num_rows_a=ref.m)).sum())
    p_cap = rformats.pow2_at_least(p + 1, floor=64)
    rres = resc.esc_spgemm(ref.indptr, ref.indices, ref.values, ref.indptr,
                           ref.indices, ref.values, p_cap=p_cap,
                           out_cap=p_cap, num_rows_a=ref.m, n_cols_b=ref.n)
    assert_same_csr(workflow.spgemm_reference(port, port),
                    resc.esc_to_csr(rres, ref.shape, p_cap))
    want = np.asarray(resc.symbolic_exact(
        ref.indptr, ref.indices, ref.indptr, ref.indices, p_cap=p_cap,
        num_rows_a=ref.m, n_cols_b=ref.n))
    got = esc.symbolic_exact(port.indptr, port.indices, port.indptr,
                             port.indices, num_rows_a=port.m, n_cols_b=port.n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        esc.symbolic_exact_host(*formats.to_numpy(port)[:2],
                                *formats.to_numpy(port)[:2],
                                num_rows_a=port.m, n_cols_b=port.n), want)


def test_int64_keys_past_the_int32_packing_limit():
    """(m + 1) * n >= 2**31, where the reference's int32 key packing
    overflows: the port's int64 keys stay exact (checked against the numpy
    symbolic pass and a dense product)."""
    m = n = 1 << 16
    ref = rformats.hypersparse_csr(11, m, n)
    assert (m + 1) * n >= 2**31
    a = formats.from_numpy_csr(*ref.to_scipy_like(), ref.shape, device="cpu")
    got = esc.symbolic_exact(a.indptr, a.indices, a.indptr, a.indices,
                             num_rows_a=m, n_cols_b=n).numpy()
    want = resc.symbolic_exact_host(*formats.to_numpy(a)[:2],
                                    *formats.to_numpy(a)[:2],
                                    num_rows_a=m, n_cols_b=n)
    np.testing.assert_array_equal(got, want)
    c = workflow.spgemm_reference(a, a)
    np.testing.assert_array_equal(np.diff(c.indptr.numpy()), want)


@pytest.mark.parametrize("name", SUITE_NAMES)
def test_ocean_spgemm_matches_reference(suites, name):
    ref, port = suites[0][name], suites[1][name]
    c_ref, r_ref = rworkflow.ocean_spgemm(ref, ref, cache=False)
    c, rep = workflow.ocean_spgemm(port, port, cache=False)
    assert rep.workflow == r_ref.workflow
    assert rep.bins == r_ref.bins
    assert rep.overflow_rows == r_ref.overflow_rows
    assert rep.nnz_out == r_ref.nnz_out
    assert_same_csr(c, c_ref)
    assert rep.audit() == []
    assert set(rep.estimation_accuracy.summary()) == set(
        r_ref.estimation_accuracy.summary())


@pytest.mark.parametrize("name,kw", [
    (name, kw) for name in ("uniform_small", "powerlaw", "banded_wide")
    for kw in ({"force_workflow": "symbolic"},
               {"force_workflow": "upper_bound"},
               {"force_workflow": "estimation"},
               {"force_workflow": "symbolic", "assisted": False,
                "hybrid": False})])
def test_forced_workflows_and_v1_ablation_match(suites, name, kw):
    ref, port = suites[0][name], suites[1][name]
    c_ref, r_ref = rworkflow.ocean_spgemm(ref, ref, cache=False, **kw)
    c, rep = workflow.ocean_spgemm(port, port, cache=False, **kw)
    assert rep.workflow == r_ref.workflow == kw["force_workflow"]
    assert rep.bins == r_ref.bins
    assert_same_csr(c, c_ref)


@pytest.mark.parametrize("name", ["uniform_small", "powerlaw", "skewed"])
def test_cache_replays_bit_identical(suites, name):
    a = suites[1][name]
    cache = planner.PlanCache()
    outs = [workflow.ocean_spgemm(a, a, cache=cache) for _ in range(3)]
    assert [r.plan_cache_hit for _, r in outs] == [False, True, True]
    assert cache.stats() == {"hits": 2, "misses": 1, "size": 1}
    base = formats.to_numpy(outs[0][0])
    for c, _ in outs[1:]:
        for x, y in zip(formats.to_numpy(c), base):
            np.testing.assert_array_equal(x, y)


def test_overflow_fallback_matches_reference(suites):
    """Undersized feed-forward sizes force dense/hash overflow into the
    exact ESC fallback on both sides."""
    ref, port = suites[0]["powerlaw"], suites[1]["powerlaw"]
    known = np.ones(ref.m, np.int64)
    c_ref, r_ref = rworkflow.ocean_spgemm(ref, ref, cache=False,
                                          known_sizes=known)
    c, rep = workflow.ocean_spgemm(port, port, cache=False,
                                   known_sizes=known)
    assert rep.workflow == r_ref.workflow == "known"
    assert rep.overflow_rows == r_ref.overflow_rows > 0
    assert rep.estimation_accuracy.overflow_causes == \
        r_ref.estimation_accuracy.overflow_causes
    assert_same_csr(c, c_ref)


def test_warm_plan_and_many(suites):
    a = suites[1]["uniform_mid"]
    cache = planner.PlanCache()
    key, built = workflow.warm_plan(a, a, cache=cache)
    assert built and workflow.warm_plan(a, a, cache=cache) == (key, False)
    outs = workflow.ocean_spgemm_many([a, a], a, cache=cache)
    assert all(r.plan_cache_hit for _, r in outs)
    with pytest.raises(ValueError):
        workflow.warm_plan(a, a, cache=False)


def test_unported_options_raise(suites):
    """Device sets run sharded and give the unsharded C; a count of CUDA
    devices raises on a machine that has fewer."""
    a = suites[1]["uniform_small"]
    c0, _ = workflow.ocean_spgemm(a, a, cache=False)
    for kw in ({"devices": ["cpu"] * 2}, {"analysis_devices": ["cpu"] * 2}):
        c, rep = workflow.ocean_spgemm(a, a, cache=False, **kw)
        assert (rep.n_shards, rep.analysis_shards) == (
            (2, 2) if "devices" in kw else (1, 2))
        for x, y in zip(formats.to_numpy(c), formats.to_numpy(c0)):
            np.testing.assert_array_equal(x, y)
    if torch.cuda.device_count() < 2:
        for kw in ({"devices": 2}, {"analysis_devices": 2}):
            with pytest.raises(ValueError, match="CUDA devices"):
                workflow.ocean_spgemm(a, a, **kw)


def test_default_device_refuses_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        a = formats.random_uniform_csr(1, 16, 16, 2.0)
        workflow.ocean_spgemm(a, a)


@pytest.mark.parametrize("name", SUITE_NAMES)
def test_default_plan_needs_no_pin(suites, name, monkeypatch, launches):
    """With an empty tuning cache the port plans what the reference plans
    with every rung pinned, bin for bin, and never runs the hash bin op
    to choose a load factor: the cache is neither read nor filled."""
    ref, port = suites[0][name], suites[1][name]
    cache = tuning.TuningCache()
    monkeypatch.setattr(tuning, "DEFAULT_TUNING_CACHE", cache)
    hash_ops = []
    real_hash_op = kops.hash_bin_op

    def counted_hash_op(*args, **kw):
        hash_ops.append(kw.get("table"))
        return real_hash_op(*args, **kw)

    monkeypatch.setattr(kops, "hash_bin_op", counted_hash_op)
    pplan = planner.build_plan(port, port)
    rplan = rplanner.build_plan(ref, ref)
    assert pplan.workflow == rplan.workflow
    assert dict(pplan.bins_describe) == dict(rplan.bins_describe)
    assert len(pplan.dense) == len(rplan.dense)
    assert len(pplan.hash) == len(rplan.hash)
    for got, want in zip(pplan.dense, rplan.dense):
        assert (got.window, got.col_tiles, got.cap, got.bin_id) == (
            want.window, want.col_tiles, want.cap, want.bin_id)
        np.testing.assert_array_equal(got.rows, want.rows)
    for got, want in zip(pplan.hash, rplan.hash):
        assert (got.table, got.spill, got.f_chunk, got.tile, got.bin_id) == (
            want.table, want.spill, want.f_chunk, want.tile, want.bin_id)
        np.testing.assert_array_equal(got.rows, want.rows)
    assert (pplan.esc is None) == (rplan.esc is None)
    if rplan.esc is not None:
        np.testing.assert_array_equal(pplan.esc.rows, rplan.esc.rows)
    assert cache.stats() == {"hits": 0, "misses": 0, "size": 0}
    assert hash_ops == [] and launches().get("hash", 0) == 0


# ---------------------------------------------------------------------------
# Long rows past the cap ladder, sized from exact row sizes
# ---------------------------------------------------------------------------

WIDE_COLS = 12288  # six 2048-column tiles: the long-row rung


def _wide_rows_pair(seed, m=48, k=600, b_row=250, a_lens=(40, 80, 25, 12)):
    """A (m x k) and B (k x WIDE_COLS) as numpy CSR ``(indptr, indices,
    values, shape)``: every B row has ``b_row`` random columns, so A's rows
    of ``a_lens`` entries have about 6,900, 9,900, 5,000 and 2,700 output
    columns spread over all of B's (the long-row rung; the first three past
    ``CAP_LADDER[-1]``) and the other rows 1-3 entries (hash rungs)."""
    rng = np.random.default_rng(seed)
    b_ind = np.concatenate([np.sort(rng.choice(WIDE_COLS, b_row,
                                               replace=False))
                            for _ in range(k)])
    b_ptr = np.arange(k + 1) * b_row
    lens = list(a_lens) + list(rng.integers(1, 4, m - len(a_lens)))
    a_ind = np.concatenate([np.sort(rng.choice(k, n, replace=False))
                            for n in lens])
    a_ptr = np.concatenate([[0], np.cumsum(lens)])
    vals = [rng.uniform(-1.0, 1.0, len(x)).astype(np.float32)
            for x in (a_ind, b_ind)]
    return ((a_ptr, a_ind, vals[0], (m, k)),
            (b_ptr, b_ind, vals[1], (k, WIDE_COLS)))


@pytest.fixture(scope="module")
def wide():
    """The pair on both sides, and C's exact row sizes (scipy)."""
    np_a, np_b = _wide_rows_pair(0)
    port = [formats.from_numpy_csr(*x, device="cpu") for x in (np_a, np_b)]
    ref = [rformats.csr_from_arrays(*x) for x in (np_a, np_b)]
    sp = pytest.importorskip("scipy.sparse")
    want = (sp.csr_matrix(np_a[2:0:-1] + (np_a[0],), shape=np_a[3])
            @ sp.csr_matrix(np_b[2:0:-1] + (np_b[0],), shape=np_b[3]))
    want.sort_indices()
    return port, ref, want


def assert_exact_product(c, a, b, want):
    """C against the port's plain ESC and scipy: the pattern exactly, the
    values to rtol 1e-5 / atol 1e-6."""
    for other in (formats.to_numpy(workflow.spgemm_reference(a, b)),
                  (want.indptr, want.indices, want.data)):
        got = formats.to_numpy(c)
        np.testing.assert_array_equal(got[0], other[0])
        np.testing.assert_array_equal(got[1], other[1])
        np.testing.assert_allclose(got[2], other[2], rtol=1e-5, atol=1e-6)


def longrow_execs(plan):
    return [be for be in plan.dense if be.is_longrow]


@pytest.mark.parametrize("wf", ["symbolic", "known"])
def test_exact_sizes_give_long_rows_their_own_caps(wide, wf):
    """On an exact workflow the long-row bin launches once per cap rung,
    each cap at least its rows' exact sizes, so no row overflows; the
    ``BinPlan`` stays the reference's and C is exact."""
    (a, b), (ra, rb), want = wide
    exact = np.diff(want.indptr)
    kw = ({"force_workflow": "symbolic"} if wf == "symbolic"
          else {"known_sizes": exact})
    plan = planner.build_plan(a, b, **kw)
    rplan = rplanner.build_plan(ra, rb, **kw)
    assert plan.workflow == rplan.workflow == wf
    assert dict(plan.bins_describe) == dict(rplan.bins_describe)
    execs = longrow_execs(plan)
    (rbin,) = [be for be in rplan.dense if be.col_tiles > 1]
    assert rbin.cap == 4096
    np.testing.assert_array_equal(
        np.sort(np.concatenate([be.rows for be in execs])), rbin.rows)
    caps = [be.cap for be in execs]
    assert caps == sorted(set(caps)) == [4096, 8192, WIDE_COLS]
    for be in execs:
        assert (be.bin_id, be.window, be.col_tiles) == (
            rbin.bin_id, rbin.window, rbin.col_tiles)
        assert (exact[be.rows] <= be.cap).all()
        assert be.ell_width == formats.pow2_at_least(
            int(np.diff(formats.to_numpy(a)[0])[be.rows].max()), floor=8)
    assert [hb.bin_id for hb in plan.hash] == [hb.bin_id for hb in rplan.hash]
    n_wide = int((exact[rbin.rows] > 4096).sum())
    assert (plan.exact_wide_rows, plan.esc_routed_rows) == (n_wide, 0) == (
        3, 0)
    assert plan.esc is None
    c, rep = planner.execute_plan(plan, a, b)
    assert rep.overflow_rows == 0
    assert (rep.exact_wide_rows, rep.esc_routed_rows) == (3, 0)
    assert rep.estimation_accuracy.overflow_causes == {}
    assert_exact_product(c, a, b, want)
    # the sharded path slices each launch and keeps its bin id
    c2, _ = planner.execute_sharded_plan(
        partition.partition_plan(plan, ["cpu"] * 3), a, b)
    for x, y in zip(formats.to_numpy(c2), formats.to_numpy(c)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["estimation", "stale_known"])
def test_inexact_sizes_keep_the_ladder_and_the_fallback(wide, case):
    """Estimated sizes keep the reference's clamped long-row bin, and its
    rows past 4,096 run again through the exact fallback; fed-forward
    sizes that undershoot overflow into the same fallback."""
    (a, b), (ra, rb), want = wide
    exact = np.diff(want.indptr)
    if case == "estimation":
        kw = {"force_workflow": "estimation"}
        plan = planner.build_plan(a, b, **kw)
        rplan = rplanner.build_plan(ra, rb, **kw)
        assert len(plan.dense) == len(rplan.dense)
        for got, ref in zip(plan.dense, rplan.dense):
            assert (got.window, got.col_tiles, got.cap, got.bin_id) == (
                ref.window, ref.col_tiles, ref.cap, ref.bin_id)
            np.testing.assert_array_equal(got.rows, ref.rows)
        (rows,) = [be.rows for be in longrow_execs(plan)]
        over = rows[exact[rows] > 4096]
    else:
        stale = exact.copy()
        (rows,) = [be.rows for be in longrow_execs(
            planner.build_plan(a, b, force_workflow="estimation"))]
        over = rows[exact[rows] > 4096]
        stale[over] //= 2
        plan = planner.build_plan(a, b, known_sizes=stale)
        # each row's launch is sized from its stale size, short of its own
        cap_of = {int(r): be.cap for be in longrow_execs(plan)
                  for r in be.rows}
        assert all(stale[r] <= cap_of[r] < exact[r] for r in over)
    assert len(over) == 3
    c, rep = planner.execute_plan(plan, a, b)
    assert rep.overflow_rows == len(over)
    assert plan.esc_routed_rows == 0
    cause = "longrow_slab" + ("+stale_feed" if case == "stale_known" else "")
    assert rep.estimation_accuracy.overflow_causes == {cause: len(over)}
    assert_exact_product(c, a, b, want)


def test_rows_past_the_largest_cap_go_to_the_esc_bin(wide, monkeypatch):
    """With the long-row rung's largest cap lowered, a row whose exact size
    passes it is put in the plan's ESC bin, launched once there and in no
    slab, and C stays exact."""
    (a, b), _, want = wide
    exact = np.diff(want.indptr)
    monkeypatch.setattr(kdense, "MAX_CAP", 8192)
    plan = planner.build_plan(a, b, force_workflow="symbolic")
    routed = np.nonzero(exact > 8192)[0]
    assert len(routed) == 1
    np.testing.assert_array_equal(plan.esc.rows, routed)
    np.testing.assert_array_equal(plan.esc.cost,
                                  np.asarray(plan.products)[routed])
    slabbed = np.concatenate([be.rows for be in plan.dense + plan.hash])
    assert not np.isin(routed, slabbed).any()
    assert [be.cap for be in longrow_execs(plan)] == [4096, 8192]
    assert (plan.exact_wide_rows, plan.esc_routed_rows) == (2, 1)
    assert plan.bins_describe["esc"] == 0  # the BinPlan's, unchanged
    c, rep = planner.execute_plan(plan, a, b)
    assert rep.overflow_rows == 0
    assert (rep.exact_wide_rows, rep.esc_routed_rows) == (2, 1)
    assert_exact_product(c, a, b, want)


def test_exact_sizing_counters_cold_and_replayed(wide, monkeypatch):
    """``plan.exact_wide_rows`` and ``plan.esc_routed_rows`` read what the
    plan did, on the report, in the registry and as attrs of
    ``plan.binning``, cold and on a replay."""
    from repro_torch.obs import metrics, trace
    (a, b), _, _ = wide
    monkeypatch.setattr(kdense, "MAX_CAP", 8192)
    cache = planner.PlanCache()
    reg = metrics.MetricsRegistry()
    prev = metrics.install_registry(reg)
    tr = trace.Tracer()
    try:
        with trace.tracing(tr):
            reps = [workflow.ocean_spgemm(a, b, cache=cache)[1]
                    for _ in range(2)]
    finally:
        metrics.install_registry(prev)
    assert [r.plan_cache_hit for r in reps] == [False, True]
    assert [(r.workflow, r.exact_wide_rows, r.esc_routed_rows)
            for r in reps] == [("symbolic", 2, 1)] * 2
    assert reg.series("plan.exact_wide_rows") == {(): 4}
    assert reg.series("plan.esc_routed_rows") == {(): 2}
    spans = [e["attrs"] for e in tr.events() if e["name"] == "plan.binning"]
    assert [(s["exact_wide_rows"], s["esc_routed_rows"], s.get("replay"))
            for s in spans] == [(2, 1, None), (2, 1, True)]


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "from repro_torch.core import formats, workflow\n"
        "a = formats.random_uniform_csr(1, 64, 64, 4.0, device='cpu')\n"
        "c, rep = workflow.ocean_spgemm(a, a)\n"
        "assert c.nnz > 0, rep\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
