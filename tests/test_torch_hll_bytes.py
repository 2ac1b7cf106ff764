"""The port's one-byte HLL sketches vs the JAX reference's int32 registers.

On CPU tensors ``kernels.hll.hll_sketch`` and ``hll_merge`` run their plain
versions and return bytes; here they are held to the reference's Pallas
kernels (``interpret=True``) and to ``core.hll`` at seeds 0 and 7: registers
exactly, estimates to rtol 1e-5 (f32 log/exp2 may differ in the last ulp).
Also: the sketch buffer carries the merge's zero sentinel row without a
copy, the planner hands that buffer to the merge as it is, the analysis's
sampled CR goes through the ``hll_merge`` wrapper and matches the reference,
and the sketch kernel's launch shape, in plain Python given an occupancy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import analysis as ranalysis  # noqa: E402
from repro.core import formats as rformats  # noqa: E402
from repro.core import hll as rhll  # noqa: E402
from repro.kernels import hll as rkhll  # noqa: E402
from repro_torch.core import analysis, formats, planner  # noqa: E402
from repro_torch.kernels import hll as khll  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SUITE_NAMES = [name for name, _ in rformats.make_suite(1)]


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _rows(seed, n_rows, lens, n_cols=1 << 20):
    """A CSR pattern (indptr, indices) with rows of the given lengths, and
    its ELL (-1 padded to a multiple of 128) for the Pallas sketch."""
    rng = np.random.default_rng(seed)
    lens = np.resize(np.asarray(lens), n_rows)
    rows = [rng.choice(n_cols, k, replace=False) for k in lens]
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    idx = np.concatenate(rows).astype(np.int32)
    width = max(128, -(-int(lens.max()) // 128) * 128)
    ell = np.full((-(-n_rows // 8) * 8, width), -1, np.int32)
    for i, r in enumerate(rows):
        ell[i, :len(r)] = r
    return ptr, idx, ell


@pytest.mark.parametrize("m_regs", [32, 64, 128])
def test_sketch_bytes_equal_reference_registers(m_regs):
    ptr, idx, ell = _rows(m_regs, 21, [0, 1, 5, 34, 130, 300, 2])
    r = len(ptr) - 1
    got = khll.hll_sketch(*_t(ptr, idx), m_regs=m_regs)
    assert got.dtype == torch.uint8 and got.shape == (r, m_regs)
    pallas = np.asarray(rkhll.hll_sketch(jnp.asarray(ell), m_regs=m_regs,
                                         interpret=True))[:r]
    np.testing.assert_array_equal(got.numpy().astype(np.int32), pallas)
    assert 0 < int(got.max()) <= 32 - (m_regs.bit_length() - 1) + 1
    for seed in (0, 7):
        want = np.asarray(rhll.build_sketches(
            jnp.asarray(ptr), jnp.asarray(idx), m_regs=m_regs, num_rows=r,
            seed=seed))
        out = torch.full((r, m_regs), 255, dtype=torch.uint8)
        same = khll.hll_sketch(*_t(ptr, idx), m_regs=m_regs, seed=seed,
                               out=out)
        assert same is out
        np.testing.assert_array_equal(out.numpy().astype(np.int32), want)


def test_sketch_checks_m_and_out():
    ptr, idx, _ = _rows(1, 4, [3])
    for bad in (0, 48, 256):
        with pytest.raises(ValueError, match="power of two"):
            khll.hll_sketch(*_t(ptr, idx), m_regs=bad)
    for out in (torch.zeros((4, 32), dtype=torch.int32),
                torch.zeros((5, 32), dtype=torch.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            khll.hll_sketch(*_t(ptr, idx), m_regs=32, out=out)


@pytest.mark.parametrize("m_regs", [32, 64, 128])
@pytest.mark.parametrize("ra,k,nb", [(5, 9, 16), (12, 300, 40)])
def test_merge_bytes_equal_reference(m_regs, ra, k, nb):
    rng = np.random.default_rng(ra + k + m_regs)
    b_ptr, b_idx, _ = _rows(nb, nb, [0, 3, 40, 200])
    sk = np.asarray(rhll.build_sketches(jnp.asarray(b_ptr),
                                        jnp.asarray(b_idx), m_regs=m_regs,
                                        num_rows=nb))
    sk = np.vstack([sk, np.zeros((1, m_regs), np.int32)])
    lens = rng.integers(0, k + 1, ra)
    lens[0], lens[-1] = k, 0
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    indices = rng.integers(0, nb + 3, int(indptr[-1])).astype(np.int32)
    ell = np.full((ra, k), nb, np.int32)  # ids past nb: the sentinel row
    for i in range(ra):
        row = indices[indptr[i]:indptr[i + 1]]
        ell[i, :lens[i]] = np.where(row < nb, row, nb)
    p_merged, p_est = rkhll.hll_merge(jnp.asarray(ell), jnp.asarray(sk),
                                      interpret=True)
    c_merged = rhll.merge_sketches(jnp.asarray(indptr), jnp.asarray(indices),
                                   jnp.asarray(sk), num_rows_a=ra)
    c_est = rhll.estimate_cardinality(c_merged)
    merged, est = khll.hll_merge(*_t(indptr, indices, sk.astype(np.uint8)))
    assert merged.dtype == torch.uint8 and merged.shape == (ra, m_regs)
    assert est.dtype == torch.float32
    for ref_m, ref_e in ((p_merged, p_est), (c_merged, c_est)):
        np.testing.assert_array_equal(merged.numpy().astype(np.int32),
                                      np.asarray(ref_m))
        np.testing.assert_allclose(est.numpy(), np.asarray(ref_e),
                                   rtol=1e-5)
    assert float(est[-1]) == 0.0  # an empty row


def test_estimate_takes_bytes_as_int32():
    rng = np.random.default_rng(3)
    regs = rng.integers(0, 29, (64, 32)).astype(np.int32)
    regs[:8, :20] = 0  # rows in the small-range branch
    from repro_torch.core import hll as chll
    np.testing.assert_array_equal(
        chll.estimate_cardinality(torch.from_numpy(regs.astype(np.uint8))),
        chll.estimate_cardinality(torch.from_numpy(regs)))


def test_merge_refuses_int32_sketches():
    indptr, indices = _t(np.array([0, 1], np.int32), np.array([0], np.int32))
    with pytest.raises(TypeError, match="uint8"):
        khll.hll_merge(indptr, indices, torch.zeros((2, 32),
                                                    dtype=torch.int32))
    # the checks the CUDA path runs before a launch
    with pytest.raises(TypeError, match="uint8"):
        khll._check((("sketches", torch.zeros((2, 32), dtype=torch.int32)),),
                    torch.device("cpu"), torch.uint8)
    with pytest.raises(ValueError, match="contiguous"):
        khll._check((("sketches", torch.zeros((32, 2),
                                              dtype=torch.uint8).t()),),
                    torch.device("cpu"), torch.uint8)
    with pytest.raises(ValueError, match="CUDA kernels take m_regs"):
        khll._check_m(16, True)
    khll._check_m(16, False)


def test_plain_versions_take_m16_as_the_reference():
    # the CPU path keeps every power of two the reference takes; only the
    # CUDA kernels start at 32 registers
    ptr, idx, _ = _rows(16, 12, [0, 2, 9, 70])
    sk = khll.hll_sketch(*_t(ptr, idx), m_regs=16, seed=7)
    want = np.asarray(rhll.build_sketches(jnp.asarray(ptr), jnp.asarray(idx),
                                          m_regs=16, num_rows=12, seed=7))
    np.testing.assert_array_equal(sk.numpy().astype(np.int32), want)
    sk = torch.cat([sk, torch.zeros((1, 16), dtype=torch.uint8)])
    a_ptr = np.array([0, 3, 3, 8], np.int32)
    a_idx = np.array([0, 5, 11, 1, 2, 3, 12, 40], np.int32)
    merged, est = khll.hll_merge(*_t(a_ptr, a_idx), sk)
    c_merged = rhll.merge_sketches(jnp.asarray(a_ptr), jnp.asarray(a_idx),
                                   jnp.asarray(sk.numpy().astype(np.int32)),
                                   num_rows_a=3)
    np.testing.assert_array_equal(merged.numpy().astype(np.int32),
                                  np.asarray(c_merged))
    np.testing.assert_allclose(
        est.numpy(), np.asarray(rhll.estimate_cardinality(c_merged)),
        rtol=1e-5)


def test_unaligned_inputs_are_copied_not_refused():
    # the kernels load 16 bytes at a time: a view at an odd offset (a CSR
    # built from a slice) is copied to an aligned buffer, not refused
    base = torch.arange(40, dtype=torch.int32)
    assert khll._aligned(base) is base
    view = base[1:]
    got = khll._aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)


def test_build_sketches_op_writes_in_place(monkeypatch):
    port = dict(formats.make_suite(1, device="cpu"))["banded_wide"]
    seen = []
    real = ops.hll_sketch

    def recording(*args, out=None, **kw):
        seen.append(out.data_ptr())
        return real(*args, out=out, **kw)

    monkeypatch.setattr(ops, "hll_sketch", recording)
    got = ops.build_sketches_op(port, 32, seed=7)
    assert seen == [got.data_ptr()]
    assert got.untyped_storage().nbytes() == (port.m + 1) * 32
    assert (got[-1] == 0).all() and got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got[:-1].numpy().astype(np.int32),
        np.asarray(rhll.build_sketches(jnp.asarray(np.asarray(port.indptr)),
                                       jnp.asarray(np.asarray(
                                           port.indices[: port.nnz])),
                                       m_regs=32, num_rows=port.m, seed=7)))


def test_planner_merges_the_cached_buffer(monkeypatch):
    port = dict(formats.make_suite(1, device="cpu"))["banded_wide"]
    passed = []
    real = planner.sharded_merge_estimate

    def recording(a, sk, **kw):
        passed.append(sk)
        return real(a, sk, **kw)

    monkeypatch.setattr(planner, "sharded_merge_estimate", recording)
    cache = {}
    plan = planner.build_plan(port, port, sketch_cache=cache)
    assert plan.workflow == "estimation"
    (key, buf), = cache.items()
    assert len(passed) == 1 and passed[0] is buf
    assert plan.b_sketches is buf and buf.shape == (port.m + 1, key[0])
    assert (buf[-1] == 0).all()


@pytest.mark.parametrize("name", SUITE_NAMES)
def test_sampled_cr_goes_through_merge_op(monkeypatch, name):
    ref = dict(rformats.make_suite(1))[name]
    port = dict(formats.make_suite(1, device="cpu"))[name]
    calls = []
    real = khll.hll_merge

    def counting(a_indptr, a_indices, sk):
        calls.append((a_indptr.shape[0] - 1, sk.dtype))
        return real(a_indptr, a_indices, sk)

    # the sampled CR merges the sample rows' ids alone, with the kernel's
    # wrapper (the plain version on the CPU)
    monkeypatch.setattr(khll, "hll_merge", counting)
    ra = ranalysis.analyze(ref, ref)
    pa = analysis.analyze(port, port)
    assert pa.workflow == ra.workflow
    if ra.sampled_cr is None:
        assert pa.sampled_cr is None and calls == []
        return
    assert calls == [(len(ra.sample_rows), torch.uint8)]
    for f in ("sampled_cr", "cr_mean", "cr_std"):
        assert getattr(pa, f) == pytest.approx(getattr(ra, f), rel=1e-6)


def test_sketch_chunks():
    # a chunk weighs 8 keys a thread; a row its ids plus m/4 keys
    assert khll.sketch_chunks(35966862, 1 << 20, 256, 32) == \
        -(-(35966862 + 8 * (1 << 20)) // 2048)
    assert khll.sketch_chunks(0, 1, 128, 32) == 1
    assert khll.sketch_chunks(1024 - 8, 1, 128, 32) == 1
    assert khll.sketch_chunks(1024 - 7, 1, 128, 32) == 2
    assert khll.sketch_chunks(1024 - 32, 1, 128, 128) == 1
    assert khll.sketch_chunks(1024 - 31, 1, 128, 128) == 2


def _sm_model(threads_per_sm=2048, smem_per_sm=228 * 1024, max_blocks=32,
              smem_a_thread=130):
    """Blocks an SM holds, given a block's threads, for a kernel whose
    shared memory grows with its block."""
    def blocks_per_sm(threads):
        return min(threads_per_sm // threads,
                   smem_per_sm // (threads * smem_a_thread), max_blocks)
    return blocks_per_sm


def test_sketch_launch_shape_given_an_occupancy():
    # both block sizes fill the SM's threads: the smaller block
    assert khll.sketch_launch_shape(32, _sm_model()) == 128
    # shared memory holds more threads in the smaller block
    model = _sm_model(smem_per_sm=100 * 1024, smem_a_thread=280)
    held = {t: t * model(t) for t in khll.SKETCH_BLOCK_THREADS}
    got = khll.sketch_launch_shape(128, model)
    assert held[got] == max(held.values())
    assert got == min(t for t, h in held.items() if h == held[got])
    # only blocks of 256 threads launch
    assert khll.sketch_launch_shape(64, lambda t: int(t == 256)) == 256
    with pytest.raises(ValueError, match="fits an SM"):
        khll.sketch_launch_shape(32, lambda t: 0)
