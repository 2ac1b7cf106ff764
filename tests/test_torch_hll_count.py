"""The port's ``hll_sketch`` and count-only kernels, and the symbolic
prediction that uses the count kernel, vs the JAX reference on the CPU.

On CPU tensors each wrapper runs its plain PyTorch version; here those are
held to the reference's Pallas kernels run with ``interpret=True``, to its
jnp oracles and to ``core.hll``, on the same numpy inputs. Everything
compared is an integer (registers, counts, row nnz), so every comparison
is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import esc as resc  # noqa: E402
from repro.core import formats as rformats  # noqa: E402
from repro.core import hll as rhll  # noqa: E402
from repro.graph import lower_triangle as rlower_triangle  # noqa: E402
from repro.graph import rmat_csr as rrmat_csr  # noqa: E402
from repro.kernels import hll as rkhll  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels import spgemm_dense as rkdense  # noqa: E402
from repro_torch.core import analysis, formats, planner  # noqa: E402
from repro_torch.kernels import hll as khll  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import spgemm_dense as kdense  # noqa: E402
from _torch_launches import launches  # noqa: E402,F401 (the fixture)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _ell_to_csr(ell):
    lens = (ell >= 0).sum(1)
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    idx = np.concatenate([row[row >= 0] for row in ell]).astype(np.int32)
    return ptr, idx


def _sketch_ell(seed):
    """16 rows of up to 256 ids, padded with -1: empty rows, short rows and
    rows longer than one 128-wide ELL block."""
    rng = np.random.default_rng(seed)
    ell = np.full((16, 256), -1, np.int32)
    for i in range(16):
        n = (0, 3, 40, 129, 200, 256)[i % 6]
        ell[i, :n] = rng.choice(1 << 20, n, replace=False)
    return ell


@pytest.mark.parametrize("m_regs", [32, 64])
def test_hll_sketch_plain_matches_pallas_and_oracles(m_regs):
    ell = _sketch_ell(m_regs)
    ptr, idx = _ell_to_csr(ell)
    got = khll.hll_sketch(*_t(ptr, idx), m_regs=m_regs).numpy()
    pallas = rkhll.hll_sketch(jnp.asarray(ell), m_regs=m_regs,
                              interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    np.testing.assert_array_equal(
        got, np.asarray(rref.hll_sketch_ref(jnp.asarray(ell),
                                            m_regs=m_regs)))
    assert (got[0] == 0).all() and (got[1] > 0).any()
    for seed in (0, 7):
        want = rhll.build_sketches(jnp.asarray(ptr), jnp.asarray(idx),
                                   m_regs=m_regs, num_rows=len(ptr) - 1,
                                   seed=seed)
        np.testing.assert_array_equal(
            khll.hll_sketch(*_t(ptr, idx), m_regs=m_regs, seed=seed).numpy(),
            np.asarray(want))


def test_hll_sketch_cpu_launches_nothing_and_checks_m(launches):
    ptr, idx = _ell_to_csr(_sketch_ell(1))
    khll.hll_sketch(*_t(ptr, idx), m_regs=32)
    assert launches() == {}
    for bad in (0, 48, 256):
        with pytest.raises(ValueError, match="power of two"):
            khll.hll_sketch(*_t(ptr, idx), m_regs=bad)


@pytest.mark.parametrize("name", ["powerlaw", "banded_wide"])
def test_build_sketches_op_matches_reference(name):
    ref = dict(rformats.make_suite(1))[name]
    port = dict(formats.make_suite(1, device="cpu"))[name]
    want = rops.build_sketches_op(ref, 32)
    got = ops.build_sketches_op(port, 32)
    assert got.shape == (port.m + 1, 32) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[-1] == 0).all()
    sk = analysis.sketches_for(port, 32, 0)  # the sentinel row included
    assert torch.equal(sk, got)


def _count_bin(seed, r, e, n_b, n_cols):
    rng = np.random.default_rng(seed)
    b = rformats.random_uniform_csr(seed, n_b, n_cols, 10.0)
    b_ptr = np.asarray(b.indptr)
    a_rows = rng.integers(0, n_b, (r, e)).astype(np.int32)
    for i in range(r):
        a_rows[i, rng.integers(0, e + 1):] = -1
    a_rows[0, 1:3] = -1  # padding between live slots
    k = np.maximum(a_rows, 0)
    a_starts = np.where(a_rows >= 0, b_ptr[k], 0).astype(np.int32)
    a_lens = np.where(a_rows >= 0, b_ptr[k + 1] - b_ptr[k], 0).astype(
        np.int32)
    b_cols = np.asarray(rops.pad_b_flat(b)[0])
    return a_rows, a_starts, a_lens, b_cols


@pytest.mark.parametrize("window,tiles,offset", [
    (256, 1, True), (128, 1, False), (128, 3, False), (64, 4, True)])
def test_count_plain_matches_pallas(window, tiles, offset, launches):
    n_cols = window * tiles + 100
    a_rows, a_starts, a_lens, b_cols = _count_bin(window + tiles, 6, 8, 40,
                                                  n_cols)
    rng = np.random.default_rng(tiles)
    row_lo = (rng.integers(0, 100, (6, 1)) if offset
              else np.zeros((6, 1))).astype(np.int32)
    args = (a_rows, a_starts, a_lens, row_lo, b_cols)
    want = np.asarray(rkdense.spgemm_count_bin(
        *[jnp.asarray(x) for x in args], window=window, col_tiles=tiles,
        interpret=True))
    counts, row_nnz = kdense.spgemm_count_bin(
        *_t(*args), window=window, col_tiles=tiles, want_counts=True)
    assert launches() == {}
    np.testing.assert_array_equal(counts.numpy(), want)
    np.testing.assert_array_equal(row_nnz.numpy(), (want > 0).sum(1))
    assert row_nnz.dtype == torch.int32
    none, nnz2 = kdense.spgemm_count_bin(*_t(*args), window=window,
                                         col_tiles=tiles)
    assert none is None and torch.equal(nnz2, row_nnz)


def _stats(a, b):
    return (x.numpy() for x in analysis._fused_stats(a, b))


def _exact(a, b):
    return resc.symbolic_exact_host(
        a.indptr.numpy(), a.indices.numpy(), b.indptr.numpy(),
        b.indices.numpy(), num_rows_a=a.m, n_cols_b=b.n)


@pytest.mark.parametrize("name", [n for n, _ in rformats.make_suite(1)])
def test_symbolic_row_nnz_matches_reference_on_suite(name):
    a = dict(formats.make_suite(1, device="cpu"))[name]
    prod, lo, hi = _stats(a, a)
    got = planner.symbolic_row_nnz(a, a, lo, hi, prod)
    np.testing.assert_array_equal(got, _exact(a, a))


def test_symbolic_row_nnz_on_rmat_lower_triangle(monkeypatch):
    ref = rlower_triangle(rrmat_csr(1, 8, 16))
    low = formats.from_numpy_csr(*ref.to_scipy_like(), ref.shape,
                                 device="cpu")
    prod, lo, hi = _stats(low, low)
    want = _exact(low, low)
    np.testing.assert_array_equal(
        planner.symbolic_row_nnz(low, low, lo, hi, prod), want)
    # the counted rows' products taken in many small chunks change nothing
    rows = planner.counted_rows(lo, hi, prod)
    assert len(rows) > 8 and prod[rows].max() > 64
    monkeypatch.setattr(kdense, "PLAIN_CHUNK_PRODUCTS", 64)
    np.testing.assert_array_equal(
        planner.symbolic_row_nnz(low, low, lo, hi, prod), want)


@pytest.mark.parametrize("case", ["all_windowed", "none_windowed", "mixed"])
def test_symbolic_row_nnz_split(case):
    """Every live row counted by the kernel, none (all through
    ``esc.symbolic_exact``), and both at once."""
    n = {"all_windowed": 512, "none_windowed": 16384, "mixed": 8192}[case]
    if case == "all_windowed":
        a = formats.banded_csr(3, 256, n, 40, device="cpu")
    elif case == "none_windowed":
        a = formats.random_uniform_csr(3, 128, n, 12.0, device="cpu")
    else:
        a = formats.skewed_rows_csr(3, 256, n, 6.0, device="cpu")
    b = formats.banded_csr(4, n, n, 24, device="cpu") \
        if case != "none_windowed" else \
        formats.random_uniform_csr(4, n, n, 4.0, device="cpu")
    prod, lo, hi = _stats(a, b)
    live = prod > 0
    rows = planner.counted_rows(lo, hi, prod)
    assert (np.diff(rows) > 0).all() and live[rows].all()
    assert (hi[rows] - lo[rows] + 1 <= kdense.COUNT_ROW_COLUMNS).all()
    counted = np.zeros(a.m, bool)
    counted[rows] = True
    assert (hi - lo + 1 > kdense.COUNT_ROW_COLUMNS)[live & ~counted].all()
    n_counted = int(counted.sum())
    assert {"all_windowed": n_counted == live.sum(),
            "none_windowed": n_counted == 0,
            "mixed": 0 < n_counted < live.sum()}[case]
    np.testing.assert_array_equal(
        planner.symbolic_row_nnz(a, b, lo, hi, prod), _exact(a, b))


def test_kernel_input_checks():
    """The checks every CUDA wrapper runs before a launch, on the input
    sets of the count, dense and hash kernels."""
    a_rows, a_starts, a_lens, b_cols = _t(*_count_bin(5, 4, 8, 20, 300))
    row_lo = torch.zeros((4, 1), dtype=torch.int32)
    vals = torch.zeros((4, 8), dtype=torch.float32)
    b_vals = torch.zeros(b_cols.shape, dtype=torch.float32)
    count = dict(a_rows=a_rows, a_starts=a_starts, a_lens=a_lens,
                 row_lo=row_lo, b_cols=b_cols)
    hash_ = dict(a_rows=a_rows, a_vals=vals, a_starts=a_starts,
                 a_lens=a_lens, b_cols=b_cols, b_vals=b_vals)
    for inputs in (count, dict(hash_, row_lo=row_lo), hash_):
        assert kdense._check_inputs(inputs, 4, 8) == a_rows.device
    with pytest.raises(ValueError, match="row_lo shape"):
        kdense._check_inputs(dict(count, row_lo=row_lo[:3]), 4, 8)
    with pytest.raises(TypeError, match="a_lens must be"):
        kdense._check_inputs(dict(count, a_lens=a_lens.long()), 4, 8)
    with pytest.raises(ValueError, match="window"):
        kdense._check_window(4, 8192, 1)
