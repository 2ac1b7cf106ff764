"""PyTorch port vs the JAX reference: CSR formats, generators and HLL.

Every comparison feeds the same numpy arrays (made from a seed) to the
reference function and to its port on the CPU. Integers (arrays, registers,
digests) must match exactly; HLL estimates to rtol 1e-5, since the two
frameworks' f32 ``log``/``exp2``/sum implementations may differ in the last
ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import formats as rformats  # noqa: E402
from repro.core import hll as rhll  # noqa: E402
from repro_torch.core import formats, hll  # noqa: E402

SUITE_NAMES = [name for name, _ in rformats.make_suite(1)]


@pytest.fixture(scope="module")
def suites():
    return (dict(rformats.make_suite(1)),
            dict(formats.make_suite(1, device="cpu")))


@pytest.mark.parametrize("name", SUITE_NAMES)
def test_generators_and_structure_hash_match(suites, name):
    ref, port = suites[0][name], suites[1][name]
    assert port.shape == ref.shape and port.nnz == ref.nnz
    assert port.indptr.dtype == torch.int32
    assert port.indices.dtype == torch.int32
    for x, y in zip(ref.to_scipy_like(), formats.to_numpy(port)):
        np.testing.assert_array_equal(np.asarray(x), y)
    assert formats.structure_hash(port) == rformats.structure_hash(ref)


def test_from_numpy_roundtrip_and_capacity():
    ref = rformats.random_uniform_csr(3, 40, 50, 4.0)
    c = formats.from_numpy_csr(*ref.to_scipy_like(), ref.shape, device="cpu")
    for x, y in zip(ref.to_scipy_like(), formats.to_numpy(c)):
        np.testing.assert_array_equal(np.asarray(x), y)
    padded = formats.csr_from_arrays(*formats.to_numpy(c), c.shape,
                                     capacity=c.nnz + 5, device="cpu")
    rpad = rformats.csr_from_arrays(*ref.to_scipy_like(), ref.shape,
                                    capacity=ref.nnz + 5)
    np.testing.assert_array_equal(padded.indices.numpy(),
                                  np.asarray(rpad.indices))
    np.testing.assert_allclose(padded.to_dense().numpy(),
                               np.asarray(ref.to_dense()))
    with pytest.raises(ValueError):
        formats.csr_from_arrays(*formats.to_numpy(c), c.shape,
                                capacity=c.nnz - 1, device="cpu")


def test_csr_helpers_match():
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((12, 9)).astype(np.float32)
    dense[rng.random((12, 9)) < 0.6] = 0
    ref = rformats.csr_from_dense(dense)
    c = formats.csr_from_dense(dense, device="cpu")
    for x, y in zip(ref.to_scipy_like(), formats.to_numpy(c)):
        np.testing.assert_array_equal(np.asarray(x), y)
    ri, rv = rformats.csr_rows_to_ell(ref.indptr, ref.indices, ref.values,
                                      num_rows=12, ell_width=4, pad_index=-7)
    pi, pv = formats.csr_rows_to_ell(c.indptr, c.indices, c.values,
                                     num_rows=12, ell_width=4, pad_index=-7)
    np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
    np.testing.assert_array_equal(np.asarray(rv), pv.numpy())
    rows = np.array([5, 0, 11, 5])
    for x, y in zip(rformats.flat_gather_index(np.asarray(ref.indptr), rows),
                    formats.flat_gather_index(c.indptr, rows)):
        np.testing.assert_array_equal(x, y)
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    np.testing.assert_array_equal(
        formats.pad_axis(x, 5, axis=1, value=-1).numpy(),
        np.asarray(rformats.pad_axis(jnp.asarray(x.numpy()), 5, axis=1,
                                     value=-1)))
    assert formats.pow2_at_least(65, floor=8) == 128
    with pytest.raises(ValueError):
        formats.pow2_at_least(3, floor=0)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**32 - 1])
def test_hash32_and_rho_bit_identical(seed):
    rng = np.random.default_rng(seed % 1000)
    x = np.concatenate([rng.integers(-2**31, 2**31, 4000),
                        [0, 1, -1, 2**31 - 1, -2**31]]).astype(np.int32)
    ref = np.asarray(rhll.hash32(jnp.asarray(x), seed=seed))
    got = hll.hash32(torch.from_numpy(x), seed=seed).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    for p in (4, 5, 6, 7):
        ref_rho = np.asarray(rhll._rho(jnp.asarray(ref), p))
        got_rho = hll._rho(torch.from_numpy(got), p).numpy()
        np.testing.assert_array_equal(got_rho, ref_rho)


@pytest.mark.parametrize("m_regs,seed", [(32, 0), (64, 3)])
@pytest.mark.parametrize("name", ["uniform_mid", "powerlaw", "hypersparse"])
def test_sketches_merge_and_estimate_match(suites, name, m_regs, seed):
    ref, port = suites[0][name], suites[1][name]
    rsk = np.asarray(rhll.sketch_rows(ref, m_regs, seed=seed))
    psk = hll.build_sketches(port.indptr, port.indices, m_regs=m_regs,
                             num_rows=port.m, seed=seed)
    np.testing.assert_array_equal(psk.numpy(), rsk)
    rmerged = np.asarray(rhll.merge_sketches(ref.indptr, ref.indices,
                                             jnp.asarray(rsk),
                                             num_rows_a=ref.m))
    pmerged = hll.merge_sketches(port.indptr, port.indices, psk,
                                 num_rows_a=port.m)
    np.testing.assert_array_equal(pmerged.numpy(), rmerged)
    for clip in (None, 40):
        # f32 log/exp2/sum differ in the last ulp between the frameworks
        np.testing.assert_allclose(
            hll.estimate_cardinality(pmerged, clip_max=clip).numpy(),
            np.asarray(rhll.estimate_cardinality(jnp.asarray(rmerged),
                                                 clip_max=clip)),
            rtol=1e-5)


@pytest.mark.parametrize("v", [1, 5, 6, 20, 63])
def test_estimate_small_range_gate_matches(v):
    """Both sides of the linear-counting gate (v zero registers of 64)."""
    rng = np.random.default_rng(v)
    regs = rng.integers(1, 9, (3, 64)).astype(np.int32)
    regs[:, :v] = 0
    np.testing.assert_allclose(
        hll.estimate_cardinality(torch.from_numpy(regs)).numpy(),
        np.asarray(rhll.estimate_cardinality(jnp.asarray(regs))),
        rtol=1e-5)


def test_merge_register_partials_match():
    rng = np.random.default_rng(2)
    parts = [(0, 3, rng.integers(0, 9, (4, 32)).astype(np.int32)),
             (3, 7, rng.integers(0, 9, (4, 32)).astype(np.int32))]
    want = rhll.merge_register_partials(parts, num_rows=7, m_regs=32)
    got = hll.merge_register_partials(
        [(r0, r1, torch.from_numpy(x)) for r0, r1, x in parts],
        num_rows=7, m_regs=32)
    np.testing.assert_array_equal(got, want)
