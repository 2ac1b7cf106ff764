"""The dense accumulator's slab wrapper vs the JAX reference's ``dense_bin_op``.

``repro_torch.kernels.spgemm_dense.spgemm_dense_slab`` computes one dense
bin straight into compacted slabs ``(cols, vals, nnz)``: on the card a
hand-written kernel (``csrc/spgemm_dense.cu``, held to its plain version by
``chip_smoke.py``), for CPU tensors its plain version ``dense_slab_plain``.
Here the plain version is held to the reference's ``dense_bin_op``, which is
the reference's dense kernel followed by ``extract_window_rows``, run both
through its XLA twin and through the Pallas kernel in interpret mode
(``REPRO_CPU_NUMERIC=pallas``, the reference's own switch), on the same
seeded numpy bins. ``cols``/``nnz`` must match exactly; ``vals`` to rtol
1e-5 / atol 1e-6 (both sum each column in product-enumeration order, so only
the last ulp of f32 products may differ).

The card's tests at the end hold the long-row kernel to the plain version
bit for bit at the caps an exact plan gives R-MAT's wide rows. They need no
reference: the JAX package is imported only by the tests that compare with
it, so this file runs on a machine without JAX. On the chip:
``PYTHONPATH=src python -m pytest -q tests/test_torch_dense_slab.py -k card``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import spgemm_dense as kdense  # noqa: E402
from _torch_launches import launches  # noqa: E402,F401 (the fixture)

FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)


def _reference():
    """``jax.numpy`` and the reference's formats and kernel ops, imported
    by the tests that compare with them."""
    import jax.numpy as jnp
    from repro.core import formats as rformats
    from repro.kernels import ops as rops
    return jnp, rformats, rops


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _slab_bin(seed, r, e, n, *, window, offset):
    """An ELL bin over a random B with rows that exercise the slab's edges:
    row 0 is padding only, row 1 has padding between live slots, and the
    rest have a random number of live slots (padding at the end)."""
    _, rformats, rops = _reference()
    rng = np.random.default_rng(seed)
    nb = 40
    b = rformats.random_uniform_csr(seed, nb, n, 12.0)
    b_indptr = np.asarray(b.indptr)
    a_rows = rng.integers(0, nb, (r, e)).astype(np.int32)
    a_vals = rng.standard_normal((r, e)).astype(np.float32)
    a_rows[0] = -1
    a_rows[1, 1::3] = -1
    for i in range(2, r):
        a_rows[i, rng.integers(1, e + 1):] = -1
    a_vals[a_rows < 0] = 0
    k = np.maximum(a_rows, 0)
    a_starts = np.where(a_rows >= 0, b_indptr[k], 0).astype(np.int32)
    a_lens = np.where(a_rows >= 0, b_indptr[k + 1] - b_indptr[k],
                      0).astype(np.int32)
    row_lo = (rng.integers(0, max(n - window, 1), (r, 1)) if offset
              else np.zeros((r, 1))).astype(np.int32)
    b_cols, b_vals = (np.asarray(x) for x in rops.pad_b_flat(b))
    return a_rows, a_vals, a_starts, a_lens, row_lo, b_cols, b_vals


# (window, col_tiles, cap, offset): windowed and long-row bins; caps below
# the rows' nnz (overflowing rows keep their first cap columns), at the
# window's width, and above it (the slab padded past the window)
CASES = [(256, 1, 256, False), (512, 1, 32, True), (128, 1, 8, False),
         (64, 1, 128, True), (128, 2, 64, False), (128, 3, 16, False)]


@pytest.mark.parametrize("numeric", ["xla", "pallas"])
@pytest.mark.parametrize("window,tiles,cap,offset", CASES)
def test_slab_plain_matches_reference_dense_bin_op(monkeypatch, numeric,
                                                   window, tiles, cap,
                                                   offset):
    if numeric == "pallas":
        monkeypatch.setenv("REPRO_CPU_NUMERIC", "pallas")
    else:
        monkeypatch.delenv("REPRO_CPU_NUMERIC", raising=False)
    r, e = 8, 12
    n = window * tiles - 8 if tiles > 1 else 2 * window
    args = _slab_bin(window + cap + tiles, r, e, n, window=window,
                     offset=offset)
    jnp, _, rops = _reference()
    want = [np.asarray(x) for x in rops.dense_bin_op(
        *[jnp.asarray(x) for x in args], window=window, col_tiles=tiles,
        cap=cap)]
    got = [x.numpy() for x in kdense.dense_slab_plain(
        *_t(*args), window=window, col_tiles=tiles, cap=cap)]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **FLOAT_TOL)
    assert got[0].shape == (r, cap) and got[0].dtype == np.int32
    assert got[2][0] == 0 and (got[0][0] == kdense.PAD_COL).all()
    assert got[2][1] > 0  # live slots past the padding are summed
    if cap < window * tiles // 4:
        assert (got[2] > cap).any()  # an overflowing row is covered


@pytest.mark.parametrize("window,tiles,cap", [(256, 1, 64), (128, 3, 32)])
def test_slab_wrapper_on_cpu_runs_plain_and_launches_nothing(window, tiles,
                                                             cap, launches):
    args = _t(*_slab_bin(3, 6, 8, window * tiles - 8, window=window,
                         offset=False))
    got = kdense.spgemm_dense_slab(*args, window=window, col_tiles=tiles,
                                   cap=cap)
    want = ops.extract_window_rows(
        *kdense.dense_bin_plain(*args, window=window, col_tiles=tiles),
        args[4], cap=cap)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert launches() == {}


@pytest.mark.parametrize("window,tiles,cap", [(256, 1, 32), (128, 2, 128)])
def test_dense_bin_op_without_row_chunks_equals_chunked(window, tiles, cap):
    """One call per bin gives what launching the bin in row chunks and
    compacting each chunk's windows gave."""
    args = _t(*_slab_bin(5, 10, 8, window * tiles - 8, window=window,
                         offset=tiles == 1))
    got = ops.dense_bin_op(*args, window=window, col_tiles=tiles, cap=cap)
    parts = []
    for s in range(0, 10, 3):
        chunk = [x[s:s + 3] for x in args[:5]] + args[5:]
        parts.append(ops.extract_window_rows(
            *kdense.dense_bin_plain(*chunk, window=window, col_tiles=tiles),
            chunk[4], cap=cap))
    for x, y in zip(got, (torch.cat(xs) for xs in zip(*parts))):
        assert torch.equal(x, y)
    # cap defaults to the window's width, as in the reference
    whole = ops.dense_bin_op(*args, window=window, col_tiles=tiles)
    assert whole[0].shape == (10, window * tiles)


def test_slab_plain_window_chunks_change_nothing(monkeypatch):
    args = _t(*_slab_bin(7, 12, 8, 500, window=512, offset=False))
    whole = kdense.dense_slab_plain(*args, window=512, cap=64)
    monkeypatch.setattr(kdense, "PLAIN_WINDOW_BYTES", 3 * 8 * 512)
    chunked = kdense.dense_slab_plain(*args, window=512, cap=64)
    for x, y in zip(whole, chunked):
        assert torch.equal(x, y)


def test_slab_checks_cap():
    kdense._check_cap(1)
    kdense._check_cap(4096)
    for bad in (0, kdense.MAX_CAP + 1):
        with pytest.raises(ValueError, match="cap"):
            kdense._check_cap(bad)


def test_longrow_largest_cap_off_the_card():
    """The plain version has no shared memory to fill: every device but
    CUDA takes caps up to ``MAX_CAP``, at any width."""
    for width in (4096, 32768, 1 << 21):
        assert kdense.longrow_max_cap("cpu", width) == kdense.MAX_CAP


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _wide_longrow_bin(seed, slots, n, b_row, device):
    """A long-row ELL bin over a B of ``b_row`` random columns a row out of
    ``n``: row i has ``slots[i]`` live slots (0: padding only; a padding
    slot sits between the live ones of row 1). In torch, no reference."""
    gen = torch.Generator().manual_seed(seed)
    nb, r, e = 96, len(slots), max(slots)
    b_cols = torch.stack([torch.randperm(n, generator=gen)[:b_row].sort()[0]
                          for _ in range(nb)]).reshape(-1).int()
    b_vals = torch.rand(nb * b_row, generator=gen) * 2 - 1
    a_rows = torch.randint(0, nb, (r, e), generator=gen, dtype=torch.int32)
    live = torch.arange(e)[None, :] < torch.tensor(slots)[:, None]
    if r > 1 and slots[1] > 2:
        live[1, 1] = False
    a_rows[~live] = -1
    a_vals = torch.where(live, torch.rand((r, e), generator=gen) * 2 - 1, 0.)
    a_starts = torch.where(live, a_rows.clamp(min=0) * b_row, 0).int()
    a_lens = torch.where(live, b_row, 0).int()
    row_lo = torch.zeros((r, 1), dtype=torch.int32)
    return [x.contiguous().to(device) for x in (
        a_rows, a_vals, a_starts, a_lens, row_lo, b_cols, b_vals)]


# (cap, live slots a row): rows sized about the cap, one of padding only,
# and past caps below the width a row that passes it (the slab keeps its
# first cap columns)
LONGROW_CAPS = [(8192, [6, 0, 9, 4, 8, 30, 7, 3, 9, 5, 8, 6]),
                (16384, [20, 14, 0, 17, 22, 60, 12, 19, 21, 9]),
                (32768, [60, 40, 52, 0, 70, 64, 33, 58])]


@pytest.mark.parametrize("cap,slots", LONGROW_CAPS)
def test_card_longrow_kernel_at_exact_caps_equals_plain(card, cap, slots,
                                                        launches):
    """The long-row kernel at the caps an exact plan gives R-MAT scale 15's
    wide rows (2048 x 16 = 32,768 columns) equals the plain version bit
    for bit: every product added in enumeration order, none dropped."""
    window, tiles = 2048, 16
    assert kdense.longrow_max_cap(card, window * tiles) >= cap
    args = _wide_longrow_bin(cap, slots, window * tiles, 1000, card)
    got = kdense.spgemm_dense_slab(*args, window=window, col_tiles=tiles,
                                   cap=cap)
    # the plain version on the host, where ``torch.segment_reduce`` sums a
    # segment in its order, as the kernel sums each column (on the card it
    # reduces a segment as a tree)
    want = kdense.dense_slab_plain(*[x.cpu() for x in args], window=window,
                                   col_tiles=tiles, cap=cap)
    torch.cuda.synchronize(card)
    assert launches() == {"dense_longrow": 1}
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)
    nnz = got[2].cpu()
    assert nnz[slots.index(0)] == 0
    assert (nnz > cap // 2).sum() >= len(slots) // 2  # rows sized about cap
    if cap < window * tiles:
        assert (nnz > cap).any()  # and a row past it


def test_card_longrow_cap_past_shared_memory_is_refused(card, launches):
    """A cap whose slots the kernel's shared memory cannot hold beside its
    smallest segment is refused before any launch; the largest cap one
    segment of R-MAT scale 15's 32,768 columns holds launches, and fewer
    fit beside the segment of a wider range."""
    most = kdense.longrow_max_cap(card, 32768)
    assert 32768 <= most < kdense.MAX_CAP
    assert kdense.longrow_max_cap(card, 1 << 20) < most
    args = _wide_longrow_bin(1, [4, 2], 32768, 200, card)
    for cap in (most + 1, kdense.MAX_CAP):
        with pytest.raises(RuntimeError, match="failed to launch"):
            kdense.spgemm_dense_slab(*args, window=2048, col_tiles=16,
                                     cap=cap)
    assert launches() == {}
    kdense.spgemm_dense_slab(*args, window=2048, col_tiles=16, cap=most)
    torch.cuda.synchronize(card)
    assert launches() == {"dense_longrow": 1}
