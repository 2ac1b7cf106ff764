"""The hash accumulator's slab wrapper vs the JAX reference's ``hash_bin_op``.

``repro_torch.kernels.spgemm_hash.spgemm_hash_bin`` computes one hash bin
straight into column-sorted slabs ``(cols, vals, nnz)``: on the card a
hand-written kernel (``csrc/spgemm_hash.cu``, launched by ``hash_slab`` and
held to its plain version by ``chip_smoke.py``), for CPU tensors its plain
version ``hash_bin_plain``. Here the plain version is held to the
reference's ``hash_bin_op``, run both through its XLA twin and through the
Pallas kernel in interpret mode followed by ``extract_hash_rows``
(``REPRO_CPU_NUMERIC=pallas``, the reference's own switch), on the same
seeded numpy bins: rows that spill, rows that overflow both tables, empty
rows, padding between live slots, a B row holding a column twice, and a
2048-slot table. Integers (overflow flags; nnz, cols on rows that fit)
must match exactly; values to rtol 1e-5 / atol 1e-6 (both sides sum each
column in product-enumeration order, so only the last ulp of f32 products
may differ). The kernel's launch shape (given an SM's occupancy, which the
card's occupancy API answers) and input checks are plain Python and are
tested here too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import binning  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import spgemm_hash as khash  # noqa: E402
from _torch_launches import launches  # noqa: E402,F401 (the fixture)

FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _bin(seed, b_rows, ell):
    """An ELL bin over flat B rows ``b_rows`` (lists of columns; -1 in
    ``ell`` is padding, with length 0 as the executor's bin prep gives
    it), B padded by 128 slots as the executor pads it."""
    rng = np.random.default_rng(seed)
    starts = np.cumsum([0] + [len(x) for x in b_rows])
    b_cols = np.concatenate([np.asarray(x) for x in b_rows]
                            + [np.full(128, -1)]).astype(np.int32)
    b_vals = rng.standard_normal(len(b_cols)).astype(np.float32)
    b_vals[len(b_cols) - 128:] = 0
    ell = np.asarray(ell, np.int32)
    live = ell >= 0
    k = np.maximum(ell, 0)
    a_starts = np.where(live, starts[k], 0).astype(np.int32)
    a_lens = np.where(live, np.diff(starts)[k], 0).astype(np.int32)
    a_vals = np.where(live, rng.standard_normal(ell.shape), 0).astype(
        np.float32)
    return ell, a_vals, a_starts, a_lens, b_cols, b_vals


def _distinct(args):
    ell, _, _, _, b_cols, _ = args
    rows = []
    for slots in ell:
        cols = set()
        for k in slots[slots >= 0]:
            cols |= set(_b_row(args, k))
        rows.append(len(cols))
    return np.asarray(rows)


def _b_row(args, k):
    ell, _, a_starts, a_lens, b_cols, _ = args
    i, j = np.argwhere(ell == k)[0]
    return b_cols[a_starts[i, j]:a_starts[i, j] + a_lens[i, j]].tolist()


def _case(name):
    """(table, args) of one named bin; its rows' distinct counts are
    checked against the case's purpose in the test."""
    rng = np.random.default_rng(sum(map(ord, name)))
    pad = -1
    if name == "t2048":
        # rows: four B rows (spills past 2048, fits 3072), two with padding
        # between (primary only), all five (overflows 3072), padding only
        b = [rng.choice(1 << 20, 720, replace=False) for _ in range(5)]
        ell = [[0, 1, 2, 3, pad], [0, pad, 1, pad, pad], [0, 1, 2, 3, 4],
               [pad] * 5]
        return 2048, _bin(1, b, ell)
    if name == "spill":
        b = [rng.choice(400, 10, replace=False) for _ in range(6)]
        ell = [[0, 1, 2, 3], [4, 5, 0, pad], [1, pad, pad, pad],
               [2, 3, 4, 5]]
        return 32, _bin(2, b, ell)
    if name == "overflow":
        b = [rng.choice(5000, 14, replace=False) for _ in range(6)]
        ell = [[0, 1, 2, 3, 4, 5], [0, 1, 2, pad, pad, pad],
               [5, pad, 4, 3, 2, 1]]
        return 32, _bin(3, b, ell)
    if name == "padding":
        b = [rng.choice(300, 9, replace=False) for _ in range(4)]
        ell = [[pad] * 6, [0, pad, 1, pad, pad, 2], [pad, pad, pad, 3, pad,
                                                     pad], [pad] * 6,
               [3, 2, 1, 0, pad, pad]]
        return 64, _bin(4, b, ell)
    if name == "repeat":
        # B row 0 holds column 5 three times and column 9 twice
        b = [np.array([5, 9, 5, 12, 9, 5]),
             rng.choice(200, 12, replace=False), np.array([9, 40, 41])]
        ell = [[0, 1, 2], [1, 0, pad], [2, 2, 0], [0, pad, pad]]
        return 32, _bin(5, b, ell)
    raise KeyError(name)


CASES = ["t2048", "spill", "overflow", "padding", "repeat"]


def _check_purpose(name, table, counts):
    spill = binning.hash_spill_of(table)
    width = table + spill
    if name == "t2048":
        assert spill == 1024
        assert ((counts > table) & (counts <= width)).any()
        assert (counts > width).any()
        assert ((counts > 0) & (counts <= table)).any()
    if name == "spill":
        assert ((counts > table) & (counts <= width)).any()
    if name == "overflow":
        assert (counts > width).any() and (counts <= width).any()
    if name == "padding":
        assert (counts == 0).sum() == 2 and (counts > 0).sum() == 3


@pytest.mark.parametrize("numeric", ["xla", "pallas"])
@pytest.mark.parametrize("name", CASES)
def test_hash_plain_matches_reference_hash_bin_op(monkeypatch, numeric,
                                                  name):
    if numeric == "pallas":
        monkeypatch.setenv("REPRO_CPU_NUMERIC", "pallas")
    else:
        monkeypatch.delenv("REPRO_CPU_NUMERIC", raising=False)
    table, args = _case(name)
    spill = binning.hash_spill_of(table)
    width = table + spill
    counts = _distinct(args)
    _check_purpose(name, table, counts)
    want = [np.asarray(x) for x in rops.hash_bin_op(
        *[jnp.asarray(x) for x in args], table=table, spill=spill,
        n_cols=int(args[4].max()) + 1)]
    got = [x.numpy() for x in khash.hash_bin_plain(*_t(*args), table=table,
                                                   spill=spill)]
    assert got[0].shape == (len(counts), width) and got[0].dtype == np.int32
    np.testing.assert_array_equal(got[2], counts)  # exact distinct counts
    fits = counts <= width
    np.testing.assert_array_equal(want[2] > width, ~fits)
    np.testing.assert_array_equal(got[2][fits], want[2][fits])
    np.testing.assert_array_equal(got[0][fits], want[0][fits])
    np.testing.assert_allclose(got[1][fits], want[1][fits], **FLOAT_TOL)
    # the slab: columns ascending, then padding
    for row, n in zip(got[0][fits], counts[fits]):
        assert (np.diff(row[:n]) > 0).all()
        assert (row[n:] == khash.PAD_COL).all()


def test_repeated_column_sums_in_enumeration_order():
    """A B row holding a column twice adds both products, in the order the
    products are enumerated, as one sequential insert per product would."""
    table, args = _case("repeat")
    spill = binning.hash_spill_of(table)
    ell, a_vals, a_starts, a_lens, b_cols, b_vals = args
    cols, vals, nnz = (x.numpy() for x in khash.hash_bin_plain(
        *_t(*args), table=table, spill=spill))
    for i in range(ell.shape[0]):
        want = {}
        for j in range(ell.shape[1]):
            if ell[i, j] < 0:
                continue
            for p in range(a_starts[i, j], a_starts[i, j] + a_lens[i, j]):
                c = int(b_cols[p])
                want[c] = np.float32(want.get(c, np.float32(0))
                                     + a_vals[i, j] * b_vals[p])
        assert nnz[i] == len(want)
        assert cols[i, :nnz[i]].tolist() == sorted(want)
        assert vals[i, :nnz[i]].tolist() == [want[c] for c in sorted(want)]


def _sm_model(regs):
    """Blocks one H100 SM holds at once, by the occupancy API's rules, for
    a kernel of ``regs`` registers a thread: 227 KB of shared memory a block
    at most; 228 KB an SM, of which each block takes 1 KB more than it
    asks; 64K registers, given to warps in units of 256; 2048 threads and
    32 blocks."""
    def blocks_per_sm(lanes, rows, smem):
        threads = rows * lanes
        if smem > 232448 or threads > khash.MAX_BLOCK_THREADS:
            return 0
        warp_regs = -(-regs * 32 // 256) * 256
        by_regs = 65536 // warp_regs // (threads // 32)
        return min(32, 233472 // (smem + 1024), 2048 // threads, by_regs)
    return blocks_per_sm


@pytest.mark.parametrize("regs", [32, 80])
@pytest.mark.parametrize("table", [2 ** k for k in range(4, 13)])
def test_launch_shape_fits_each_table(table, regs):
    spill = binning.hash_spill_of(table)
    blocks = _sm_model(regs)
    lanes, rows, smem = khash.launch_shape(table, spill, blocks)
    assert lanes == {16: 8, 32: 8, 64: 16}.get(table, 32)
    assert table % lanes == 0 and spill % lanes == 0
    threads = rows * lanes
    assert threads % 32 == 0 and 32 <= threads <= khash.MAX_BLOCK_THREADS
    assert smem == rows * table * khash.SLOT_BYTES  # the primary tables
    assert smem <= 232448  # 227 KB a block on the H100
    # the SM holds the most rows any block of whole warps gives, and the
    # smallest block that does
    held = rows * blocks(lanes, rows, smem)
    per_warp = 32 // lanes
    candidates = range(per_warp, khash.MAX_BLOCK_THREADS // lanes + 1,
                       per_warp)
    most = max(n * blocks(lanes, n, n * table * khash.SLOT_BYTES)
               for n in candidates)
    assert held == most > 0
    assert all(n * blocks(lanes, n, n * table * khash.SLOT_BYTES) < most
               for n in candidates if n < rows)
    # one shape per table, the same on every call
    assert khash.launch_shape(table, spill, blocks) == (lanes, rows, smem)


def test_launch_shape_covers_the_plan_ladder():
    """Every table a plan or the load-factor tuner can ask for has a shape
    (the tuner's largest rung sizes a table of 4096 at load factor 0.5)."""
    shapes = {}
    for table in [binning.HASH_MIN_TABLE * 2 ** k for k in range(8)]:
        shapes[table] = khash.launch_shape(
            table, binning.hash_spill_of(table), _sm_model(80))
    assert max(shapes) == 2 * binning.HASH_MAX_TABLE
    for lanes, rows, smem in shapes.values():
        assert rows * lanes % 32 == 0 and smem <= 232448


@pytest.mark.parametrize("table,spill", [(8, 16), (32, 8), (48, 16),
                                         (8192, 4096), (32, 24)])
def test_launch_shape_refuses_bad_tables(table, spill):
    with pytest.raises(ValueError, match="power of two"):
        khash.launch_shape(table, spill, _sm_model(32))


def test_launch_shape_refuses_when_no_block_fits():
    with pytest.raises(ValueError, match="fits an SM"):
        khash.launch_shape(4096, 2048, lambda lanes, rows, smem: 0)


def test_hash_slab_refuses_cpu_tensors(monkeypatch, launches):
    """The launcher raises on CPU tensors before it builds or launches
    anything."""
    def no_launch(*a, **kw):
        raise AssertionError("launched")

    monkeypatch.setattr(_build, "launch", no_launch)
    monkeypatch.setattr(_build, "library", no_launch)
    _, args = _case("spill")
    with pytest.raises(ValueError, match="CUDA kernel"):
        khash.hash_slab(*_t(*args), table=32, spill=16)
    assert launches() == {}


def test_wrapper_on_cpu_runs_plain_and_launches_nothing(launches):
    _, args = _case("overflow")
    got = khash.spgemm_hash_bin(*_t(*args), table=32, spill=16, f_chunk=64,
                                tile=2)
    want = khash.hash_bin_plain(*_t(*args), table=32, spill=16)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert launches() == {}
