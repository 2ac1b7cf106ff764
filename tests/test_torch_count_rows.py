"""The count kernel's row-list entry point vs the JAX reference on the CPU.

``repro_torch.kernels.spgemm_dense.spgemm_count_rows`` is the symbolic
prediction's count: for a list of rows of A, each with an output column
range at most ``COUNT_ROW_COLUMNS`` wide, the exact output nnz read straight
from A's and B's CSR arrays. On the card it launches ``csrc/spgemm_count.cu``
(held to its plain version by ``chip_smoke.py``); for CPU tensors it runs
``count_rows_plain``. Here the plain version, and ``planner.symbolic_row_nnz``
through it, are held to the reference's ``repro.core.esc.symbolic_exact_host``
on seeded inputs: ``make_suite(1)``, the R-MAT lower triangle of the triangle
path, and edge rows (an output range of exactly 4096 columns and one of 4097,
a range ending at the last column, B rows with repeated columns, empty A rows,
rows with zero products, an empty row list). Everything compared is an
integer, so every comparison is exact. The launch order, the launch shape
(given an SM's occupancy, which the card's occupancy API answers) and the
input checks are plain Python and are tested here too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import esc as resc  # noqa: E402
from repro.core import formats as rformats  # noqa: E402
from repro.graph import lower_triangle as rlower_triangle  # noqa: E402
from repro.graph import rmat_csr as rrmat_csr  # noqa: E402
from repro_torch.core import analysis, formats, planner  # noqa: E402
from repro_torch.core.binning import WINDOW_LADDER  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import spgemm_dense as kdense  # noqa: E402
from _torch_launches import launches  # noqa: E402,F401 (the fixture)


def _stats(a, b):
    return (x.numpy() for x in analysis._fused_stats(a, b))


def _exact(a, b):
    return resc.symbolic_exact_host(
        a.indptr.numpy(), a.indices.numpy(), b.indptr.numpy(),
        b.indices.numpy(), num_rows_a=a.m, n_cols_b=b.n)


def _count(a, b, rows, lo, out=None):
    """``count_rows_plain`` through the wrapper on CPU tensors."""
    out = torch.full((a.m,), -7, dtype=torch.int64) if out is None else out
    t_rows, t_lo, heavy = ops.count_rows_inputs(rows, lo[rows],
                                                np.ones(len(rows)), "cpu")
    assert heavy == 0
    return kdense.spgemm_count_rows(a.indptr, a.indices, b.indptr,
                                    b.indices, t_rows, t_lo, out).numpy()


def _check_rows_against_reference(a, b):
    prod, lo, hi = _stats(a, b)
    rows = planner.counted_rows(lo, hi, prod)
    want = _exact(a, b)
    got = _count(a, b, rows, lo)
    np.testing.assert_array_equal(got[rows], want[rows])
    untouched = np.ones(a.m, bool)
    untouched[rows] = False
    assert (got[untouched] == -7).all()
    np.testing.assert_array_equal(
        planner.symbolic_row_nnz(a, b, lo, hi, prod), want)
    return rows


@pytest.mark.parametrize("name", [n for n, _ in rformats.make_suite(1)])
def test_count_rows_plain_matches_reference_on_suite(name):
    a = dict(formats.make_suite(1, device="cpu"))[name]
    _check_rows_against_reference(a, a)


@pytest.mark.parametrize("scale", [8, 10])
def test_count_rows_plain_on_rmat_lower_triangle(scale):
    ref = rlower_triangle(rrmat_csr(1, scale, 16))
    low = formats.from_numpy_csr(*ref.to_scipy_like(), ref.shape,
                                 device="cpu")
    rows = _check_rows_against_reference(low, low)
    assert len(rows) > 100


N_COLS = 10000


def _edge_matrices():
    """A (9 rows) and B (7 rows, ``N_COLS`` columns) whose rows are the edge
    cases: B0 spans 4096 columns, B1 4097, B2 ends at the last column, B3
    repeats its columns, B4 is empty, B5 and B6 are seeded random rows."""
    rng = np.random.default_rng(16)
    b_rows = [np.array([0, 17, 4095]), np.array([1, 4097]),
              np.array([N_COLS - 3, N_COLS - 1]),
              np.array([5, 5, 9, 9, 5]), np.array([], np.int64),
              np.sort(rng.choice(np.arange(1000, 3000), 40, replace=False)),
              np.sort(rng.choice(np.arange(2000, 5000), 60, replace=False))]
    a_rows = {"width_4096": [0], "width_4097": [1], "last_column": [2],
              "repeated_columns": [3, 3], "empty_a_row": [],
              "zero_products": [4, 4], "width_4096_with_repeats": [0, 3, 5],
              "random": [5, 6], "past_4096_by_rows": [6, 0]}

    def csr(rows, n):
        ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
        idx = np.concatenate([np.asarray(r, np.int64) for r in rows])
        vals = np.ones(len(idx), np.float32)
        return formats.from_numpy_csr(ptr, idx, vals, (len(rows), n),
                                      device="cpu")

    return (csr(list(a_rows.values()), len(b_rows)), csr(b_rows, N_COLS),
            list(a_rows))


@pytest.mark.parametrize("case", ["width_4096", "width_4097", "last_column",
                                  "repeated_columns", "empty_a_row",
                                  "zero_products", "empty_row_list"])
def test_count_rows_edge_cases(case):
    assert kdense.COUNT_ROW_COLUMNS == WINDOW_LADDER[-1]
    a, b, names = _edge_matrices()
    prod, lo, hi = _stats(a, b)
    want = _exact(a, b)
    rows = planner.counted_rows(lo, hi, prod)
    by_name = dict(zip(names, range(a.m)))
    if case == "empty_row_list":
        out = torch.arange(a.m, dtype=torch.int64)
        got = _count(a, b, np.zeros(0, np.int64), lo, out)
        np.testing.assert_array_equal(got, np.arange(a.m))
        # no row fits the bitmap: everything goes through ESC
        none = np.full(a.m, N_COLS, np.int64)
        assert len(planner.counted_rows(lo, lo + none, prod)) == 0
        np.testing.assert_array_equal(
            planner.symbolic_row_nnz(a, b, lo, lo + none, prod), want)
    else:
        i = by_name[case]
        counted = i in rows
        expect = {"width_4096": (True, 3, 4096),
                  "width_4097": (False, 2, 4097),
                  "last_column": (True, 2, 3),
                  "repeated_columns": (True, 2, 5),
                  "empty_a_row": (False, 0, None),
                  "zero_products": (False, 0, None)}[case]
        assert counted == expect[0] and want[i] == expect[1]
        if expect[2] is not None:  # empty rows have no range
            assert int(hi[i]) - int(lo[i]) + 1 == expect[2]
        if case == "last_column":
            assert hi[i] == N_COLS - 1
        if case in ("empty_a_row", "zero_products"):
            assert prod[i] == 0
        got = _count(a, b, rows, lo)
        np.testing.assert_array_equal(got[rows], want[rows])
        # the same row alone, in a list of one
        if counted:
            one = _count(a, b, np.array([i]), lo)
            assert one[i] == want[i]
    assert {names[r] for r in rows} == {
        "width_4096", "last_column", "repeated_columns",
        "width_4096_with_repeats", "random"}
    np.testing.assert_array_equal(
        planner.symbolic_row_nnz(a, b, lo, hi, prod), want)


def test_count_rows_plain_keeps_only_the_rows_range():
    """Columns outside ``[row_lo, row_lo + COUNT_ROW_COLUMNS)`` are not
    counted (the kernel's bitmap holds only that range)."""
    a, b, names = _edge_matrices()
    i = names.index("random")
    cols = np.unique(np.concatenate(
        [b.indices[b.indptr[k]:b.indptr[k + 1]].numpy() for k in (5, 6)]))
    lo = np.zeros(a.m, np.int64)
    for base in (0, 1000, 2000):
        lo[i] = base
        got = _count(a, b, np.array([i]), lo)
        inside = (cols >= base) & (cols < base + kdense.COUNT_ROW_COLUMNS)
        assert got[i] == inside.sum()
    assert got[i] == len(cols) - (cols < 2000).sum() > 0


def test_count_rows_schedule():
    products = np.array([5, 900, 0, 40, 900, 3000, 7], np.int64)
    order, heavy = kdense.count_rows_schedule(products, resident=4)
    # share: 4852 / 4 = 1213 products a warp; only row 5 is above it
    assert heavy == 1 and list(order) == [5, 0, 1, 2, 3, 4, 6]
    order, heavy = kdense.count_rows_schedule(products, resident=16)
    # share 303.25: rows 5, 1, 4 (ties in list order), descending
    assert heavy == 3 and list(order) == [5, 1, 4, 0, 2, 3, 6]
    order, heavy = kdense.count_rows_schedule(products, resident=1)
    assert heavy == 0 and list(order) == list(range(7))
    # share 4.852, but rows of at most one warp pass stay a warp each
    order, heavy = kdense.count_rows_schedule(products, resident=1000)
    assert kdense.COUNT_WARP_STAGE == 128
    assert heavy == 3 and list(order) == [5, 1, 4, 0, 2, 3, 6]
    order, heavy = kdense.count_rows_schedule(np.zeros(0, np.int64), 8)
    assert heavy == 0 and len(order) == 0


def _sm_model(regs):
    """Blocks one H100 SM holds at once, by the occupancy API's rules, for
    the row count kernel at ``regs`` registers a thread: 512 B of bitmap a
    warp, 228 KB of shared memory an SM (1 KB more a block than it asks),
    64K registers in units of 256 a warp, 64 warps and 32 blocks."""
    def blocks_per_sm(warps):
        if warps * 32 > kdense.COUNT_MAX_THREADS:
            return 0
        warp_regs = -(-regs * 32 // 256) * 256
        by_regs = 65536 // warp_regs // warps
        return min(32, 233472 // (warps * 512 + 1024), 64 // warps,
                   by_regs)
    return blocks_per_sm


@pytest.mark.parametrize("regs,want", [(32, (32, 64)), (40, (17, 51)),
                                       (64, (32, 32))])
def test_count_rows_launch_shape(regs, want):
    """The block that lets an SM hold the most warps, the largest such."""
    assert kdense.count_rows_launch_shape(_sm_model(regs)) == want


def test_count_rows_launch_shape_refuses_when_no_block_fits():
    with pytest.raises(ValueError, match="fits an SM"):
        kdense.count_rows_launch_shape(lambda warps: 0)


def test_count_rows_cpu_launches_nothing_and_checks_inputs(launches):
    a, b, _ = _edge_matrices()
    rows = torch.tensor([0, 2], dtype=torch.int32)
    lo = torch.tensor([0, N_COLS - 3], dtype=torch.int32)
    out = torch.zeros(a.m, dtype=torch.int64)
    kdense.spgemm_count_rows(a.indptr, a.indices, b.indptr, b.indices, rows,
                             lo, out, heavy=2)
    assert launches() == {}
    assert out.tolist()[:3] == [3, 0, 2]
    good = dict(a_indptr=a.indptr, a_indices=a.indices, b_indptr=b.indptr,
                b_indices=b.indices, rows=rows, row_lo=lo)
    kdense._check_rows(good, out, 2)
    with pytest.raises(TypeError, match="rows must be"):
        kdense._check_rows(dict(good, rows=rows.long()), out, 0)
    with pytest.raises(TypeError, match="out must be"):
        kdense._check_rows(good, out.int(), 0)
    with pytest.raises(ValueError, match="out has"):
        kdense._check_rows(good, out[1:], 0)
    with pytest.raises(ValueError, match="same length"):
        kdense._check_rows(dict(good, row_lo=lo[:1]), out, 0)
    with pytest.raises(ValueError, match="heavy"):
        kdense._check_rows(good, out, 3)
