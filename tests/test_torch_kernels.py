"""Plain versions of the port's CUDA kernels vs the JAX reference.

Each kernel module of ``repro_torch.kernels`` holds a plain PyTorch version
that its wrapper runs for CPU tensors (the CUDA kernel itself runs only on a
GPU, where ``chip_smoke.py`` holds it to this plain version). Here the plain
versions are held both to the reference's XLA twins and to its Pallas kernels
run with ``interpret=True``, on the same numpy inputs. Integer outputs
(counts, columns, registers, nnz, overflow flags) must match exactly. Float
values: rtol 1e-5 / atol 1e-6 — both sides sum each output entry in
product-enumeration order, so only the last ulp of f32 products may differ.
HLL estimates: rtol 1e-5 (f32 log/exp2 differ in the last ulp).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import binning  # noqa: E402
from repro.core import formats as rformats  # noqa: E402
from repro.core import hll as rhll  # noqa: E402
from repro.kernels import hll as rkhll  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels import spgemm_dense as rkdense  # noqa: E402
from repro.kernels import spgemm_hash as rkhash  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import hll as khll  # noqa: E402
from repro_torch.kernels import spgemm_dense as kdense  # noqa: E402
from repro_torch.kernels import spgemm_hash as khash  # noqa: E402

FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _random_bin(seed, nb, n, r, e):
    """An ELL bin over a random B (the reference tests' workload)."""
    rng = np.random.default_rng(seed)
    b = rformats.random_uniform_csr(seed, nb, n, 10.0)
    b_indptr = np.asarray(b.indptr)
    a_rows = rng.integers(0, nb, (r, e)).astype(np.int32)
    a_vals = rng.standard_normal((r, e)).astype(np.float32)
    for i in range(r):
        ln = rng.integers(1, e + 1)
        a_rows[i, ln:] = -1
        a_vals[i, ln:] = 0
    k = np.maximum(a_rows, 0)
    a_starts = np.where(a_rows >= 0, b_indptr[k], 0).astype(np.int32)
    a_lens = np.where(a_rows >= 0, b_indptr[k + 1] - b_indptr[k],
                      0).astype(np.int32)
    b_cols, b_vals = (np.asarray(x) for x in rops.pad_b_flat(b))
    return a_rows, a_vals, a_starts, a_lens, b_cols, b_vals


@pytest.mark.parametrize("r,e,w,tiles,offset", [
    (4, 8, 256, 1, False), (8, 16, 512, 1, True), (16, 4, 1024, 1, False),
    (4, 8, 128, 2, False), (4, 8, 128, 3, False)])
def test_dense_plain_matches_xla_twin_and_pallas(r, e, w, tiles, offset):
    n = w * tiles - 16
    a_rows, a_vals, a_starts, a_lens, b_cols, b_vals = _random_bin(
        r * e + w + tiles, 48, n, r, e)
    rng = np.random.default_rng(1)
    row_lo = (rng.integers(0, max(n - w, 1), (r, 1)) if offset
              else np.zeros((r, 1))).astype(np.int32)
    args = (a_rows, a_vals, a_starts, a_lens, row_lo, b_cols, b_vals)
    p_cap = rformats.pow2_at_least(int(a_lens.sum()), floor=64)
    x_acc, x_cnt = rops._dense_bin_xla(*args, window=w, col_tiles=tiles,
                                       p_cap=p_cap)
    k_acc, k_cnt = rkdense.spgemm_dense_bin(
        *[jnp.asarray(x) for x in args], window=w, col_tiles=tiles,
        interpret=True)
    acc, cnt = kdense.dense_bin_plain(*_t(*args), window=w, col_tiles=tiles)
    for ref_acc, ref_cnt in ((x_acc, x_cnt), (k_acc, k_cnt)):
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))
        np.testing.assert_allclose(acc.numpy(), np.asarray(ref_acc),
                                   **FLOAT_TOL)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = (kdense.spgemm_dense_bin.window_launches,
              kdense.spgemm_dense_bin.longrow_launches)
    acc2, cnt2 = kdense.spgemm_dense_bin(*_t(*args), window=w,
                                         col_tiles=tiles)
    assert torch.equal(acc2, acc) and torch.equal(cnt2, cnt)
    assert before == (kdense.spgemm_dense_bin.window_launches,
                      kdense.spgemm_dense_bin.longrow_launches)


def test_dense_plain_row_chunks_change_nothing(monkeypatch):
    args = _t(*_random_bin(3, 40, 500, 12, 8))
    row_lo = torch.zeros((12, 1), dtype=torch.int32)
    whole = kdense.dense_bin_plain(*args[:4], row_lo, *args[4:], window=512)
    monkeypatch.setattr(kdense, "PLAIN_CHUNK_PRODUCTS", 7)
    assert len(list(kdense.row_chunks(args[0], args[3]))) > 1
    chunked = kdense.dense_bin_plain(*args[:4], row_lo, *args[4:],
                                     window=512)
    for x, y in zip(whole, chunked):
        assert torch.equal(x, y)


def test_extract_window_rows_matches():
    rng = np.random.default_rng(4)
    cnt = rng.integers(0, 3, (6, 64)).astype(np.float32)
    acc = (rng.standard_normal((6, 64)) * (cnt > 0)).astype(np.float32)
    acc[0, 3] = 0.0  # a structural zero with count > 0 must be kept
    cnt[0, 3] = 1.0
    row_lo = rng.integers(0, 100, (6, 1)).astype(np.int32)
    for cap in (8, 64, 80):
        want = rops.extract_window_rows(jnp.asarray(acc), jnp.asarray(cnt),
                                        jnp.asarray(row_lo), cap=cap)
        got = ops.extract_window_rows(*_t(acc, cnt, row_lo), cap=cap)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def _hash_workload(seed, r, nb, blen, n_distinct):
    rng = np.random.default_rng(seed)
    b_cols = rng.integers(0, n_distinct, nb * blen).astype(np.int32)
    # B rows have distinct columns, as the generators make them
    for k in range(nb):
        b_cols[k * blen:(k + 1) * blen] = rng.choice(n_distinct, blen,
                                                     replace=False)
    b_vals = rng.standard_normal(nb * blen).astype(np.float32)
    b_cols = np.concatenate([b_cols, np.full(128, -1, np.int32)])
    b_vals = np.concatenate([b_vals, np.zeros(128, np.float32)])
    a_rows = np.stack([rng.permutation(nb) for _ in range(r)]).astype(
        np.int32)
    a_vals = rng.standard_normal((r, nb)).astype(np.float32)
    a_rows[0, nb // 2:] = -1
    a_vals[0, nb // 2:] = 0
    a_starts = np.where(a_rows >= 0, a_rows * blen, 0).astype(np.int32)
    a_lens = np.where(a_rows >= 0, blen, 0).astype(np.int32)
    return a_rows, a_vals, a_starts, a_lens, b_cols, b_vals


@pytest.mark.parametrize("table,n_distinct", [(32, 40), (64, 90),
                                               (32, 200)])
def test_hash_plain_matches_xla_twin_and_pallas(table, n_distinct):
    """Slabs after extraction agree; rows that overflow table + spill agree
    on the flag (the kernel's count there is occupied + failed inserts)."""
    spill = binning.hash_spill_of(table)
    width = table + spill
    args = _hash_workload(table + n_distinct, 6, 6, 24, n_distinct)
    p_cap = rformats.pow2_at_least(int(args[3].sum()), floor=64)
    xla = [np.asarray(x) for x in rops._hash_bin_xla(
        *args, table=table, spill=spill, n_cols=n_distinct, p_cap=p_cap)]
    pallas = [np.asarray(x) for x in rops.extract_hash_rows(
        *rkhash.spgemm_hash_bin(*args, table=table, spill=spill,
                                interpret=True))]
    got = [x.numpy() for x in khash.hash_bin_plain(*_t(*args), table=table,
                                                   spill=spill)]
    np.testing.assert_array_equal(got[2], xla[2])  # exact distinct counts
    fits = got[2] <= width
    for ref in (xla, pallas):
        np.testing.assert_array_equal(got[2] > width, ref[2] > width)
        np.testing.assert_array_equal(got[2][fits], ref[2][fits])
        np.testing.assert_array_equal(got[0][fits], ref[0][fits])
        np.testing.assert_allclose(got[1][fits], ref[1][fits], **FLOAT_TOL)
    if n_distinct > width:
        assert not fits.all()
    wrapped = khash.spgemm_hash_bin(*_t(*args), table=table, spill=spill,
                                    f_chunk=64, tile=2)
    for x, y in zip(wrapped, got):
        np.testing.assert_array_equal(x.numpy(), y)


def test_extract_hash_rows_matches():
    rng = np.random.default_rng(8)
    keys = np.full((4, 32), -1, np.int32)
    skeys = np.full((4, 16), -1, np.int32)
    for i in range(4):
        cols = rng.choice(500, 20 + i, replace=False)
        slots = rng.choice(48, len(cols), replace=False)
        for c, s in zip(cols, slots):
            (keys[i] if s < 32 else skeys[i])[s % 32 if s < 32 else s - 32] \
                = c
    vals = rng.standard_normal((4, 32)).astype(np.float32)
    svals = rng.standard_normal((4, 16)).astype(np.float32)
    fail = np.array([[0], [0], [2], [0]], np.int32)
    want = rops.extract_hash_rows(*[jnp.asarray(x) for x in
                                    (keys, vals, skeys, svals, fail)])
    got = khash.extract_hash_rows(*_t(keys, vals, skeys, svals, fail))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_hash_tables_refuses_cpu_tensors():
    args = _t(*_hash_workload(1, 2, 4, 8, 20))
    with pytest.raises(ValueError, match="CUDA kernel"):
        khash.hash_tables(*args, table=32, spill=16)


@pytest.mark.parametrize("m_regs", [32, 64])
@pytest.mark.parametrize("ra,k,nb", [(4, 8, 16), (8, 5, 100)])
def test_hll_merge_plain_matches_reference_and_pallas(m_regs, ra, k, nb):
    rng = np.random.default_rng(ra * k + nb)
    bcols = rng.integers(0, 5000, (nb, 128)).astype(np.int32)
    sk = np.asarray(rref.hll_sketch_ref(jnp.asarray(bcols), m_regs=m_regs))
    sk = np.vstack([sk, np.zeros((1, m_regs), np.int32)])
    lens = rng.integers(0, k + 1, ra)
    lens[0] = k
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    indices = rng.integers(0, nb, int(indptr[-1])).astype(np.int32)
    ell = np.full((ra, k), nb, np.int32)  # pad -> sentinel row
    for i in range(ra):
        ell[i, :lens[i]] = indices[indptr[i]:indptr[i + 1]]
    p_merged, p_est = rkhll.hll_merge(jnp.asarray(ell), jnp.asarray(sk),
                                      interpret=True)
    c_merged = rhll.merge_sketches(jnp.asarray(indptr), jnp.asarray(indices),
                                   jnp.asarray(sk[:-1]), num_rows_a=ra)
    c_est = rhll.estimate_cardinality(c_merged)
    merged, est = khll.hll_merge(*_t(indptr, indices, sk))
    for ref_m, ref_e in ((p_merged, p_est), (c_merged, c_est)):
        np.testing.assert_array_equal(merged.numpy(), np.asarray(ref_m))
        np.testing.assert_allclose(est.numpy(), np.asarray(ref_e),
                                   rtol=1e-5)


def test_merge_estimate_op_clips_like_reference():
    a = rformats.random_uniform_csr(5, 40, 40, 6.0)
    sk = np.asarray(rhll.sketch_rows(a, 32))
    sk = np.vstack([sk, np.zeros((1, 32), np.int32)])
    want_m, want_e = rops.merge_estimate_op(a, jnp.asarray(sk), clip_max=9)
    from repro_torch.core import formats
    pa = formats.from_numpy_csr(*a.to_scipy_like(), a.shape, device="cpu")
    got_m, got_e = ops.merge_estimate_op(pa, torch.from_numpy(sk),
                                         clip_max=9)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), rtol=1e-5)
    assert float(got_e.max()) <= 9.0


def test_kernel_build_reports_missing_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build._nvcc()


def test_kernel_sources_declare_every_entry_point():
    text = "".join(p.read_text() for p in _build.SRC_DIR.glob("*.cu"))
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in text
