"""The merge on the multiply's device: ``kernels.slab_scatter`` against a
numpy oracle (slabs with empty, full and overflowed rows, ESC CSRs, views
at odd offsets), and ``ocean_spgemm`` with and without fused post-ops and
overflowed rows against the exact ESC product with the post-ops applied in
numpy. On a card: the CUDA
kernel against the plain version bit for bit on FEM- and R-MAT-shaped
sources, the compaction's memory, no pinned host buffer, and one launch a
non-empty source.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import executor, formats, workflow  # noqa: E402
from repro_torch.core.formats import PAD_COL  # noqa: E402
from repro_torch.graph import ops as graph_ops  # noqa: E402
from repro_torch.kernels import slab_scatter as ss  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from _torch_launches import launches  # noqa: E402,F401 (the fixture)


# ---------------------------------------------------------------------------
# The scatter against a numpy oracle
# ---------------------------------------------------------------------------

def _slab(rng, rows, width, nnz):
    """A slab source of the given counts: each row's first min(nnz, W)
    slots sorted distinct columns, the rest padding."""
    r = len(rows)
    cols = np.full((r, width), PAD_COL, np.int32)
    vals = np.zeros((r, width), np.float32)
    for i, k in enumerate(nnz):
        k = min(int(k), width)
        cols[i, :k] = np.sort(rng.choice(1000, k, replace=False))
        vals[i, :k] = rng.standard_normal(k)
    return dict(rows=np.asarray(rows, np.int64), cols=cols, vals=vals,
                nnz=np.asarray(nnz, np.int32))


def _csr(rng, rows, lens):
    ptr = np.zeros(len(rows) + 1, np.int32)
    ptr[1:] = np.cumsum(lens)
    cols = np.concatenate([np.sort(rng.choice(1000, int(k), replace=False))
                           for k in lens] or [np.zeros(0)]).astype(np.int32)
    vals = rng.standard_normal(len(cols)).astype(np.float32)
    return dict(rows=np.asarray(rows, np.int64), cols=cols, vals=vals,
                indptr=ptr)


def _case(name, rng):
    """``(m, sources)`` of one case; the sources are row-disjoint, and a
    slab's overflowed rows are a later CSR source's."""
    if name == "empty":
        return 6, [_slab(rng, [], 8, []), _csr(rng, np.arange(6),
                                                [3, 0, 1, 2, 0, 5])]
    if name == "zero_rows":
        return 5, [_slab(rng, [4, 0, 2], 8, [0, 0, 3]),
                   _slab(rng, [1, 3], 4, [0, 0])]
    if name == "full":
        return 4, [_slab(rng, [3, 1, 0, 2], 16, [16, 16, 1, 16])]
    if name == "overflow":
        return 7, [_slab(rng, [0, 5, 2, 6], 8, [8, 9, 40, 2]),
                   _slab(rng, [1, 3], 4, [5, 4]),
                   _slab(rng, [4], 4, [1]),
                   _csr(rng, [5, 2, 1], [12, 40, 5])]
    if name == "csr":
        return 9, [_csr(rng, [8, 0, 4, 2], [0, 7, 1, 33]),
                   _csr(rng, [1, 3, 5, 6, 7], [2, 0, 0, 9, 4])]
    raise KeyError(name)


def _oracle(m, sources):
    """C's arrays, row by row from whichever source writes each row."""
    rows = {}
    for s in sources:
        for i, r in enumerate(s["rows"]):
            if "nnz" in s:
                k = int(s["nnz"][i])
                if k > s["cols"].shape[1]:
                    continue
                rows[int(r)] = (s["cols"][i, :k], s["vals"][i, :k])
            else:
                a, b = s["indptr"][i], s["indptr"][i + 1]
                rows[int(r)] = (s["cols"][a:b], s["vals"][a:b])
    empty = (np.zeros(0, np.int32), np.zeros(0, np.float32))
    parts = [rows.get(r, empty) for r in range(m)]
    ptr = np.zeros(m + 1, np.int32)
    ptr[1:] = np.cumsum([len(c) for c, _ in parts])
    return (ptr, np.concatenate([c for c, _ in parts]).astype(np.int32),
            np.concatenate([v for _, v in parts]).astype(np.float32))


def _scatter_all(m, sources, device, offset=0):
    """Every source scattered into C's arrays, allocated at ``offset``
    words into larger buffers (C's rows then start at other alignments),
    filled with sentinels first."""
    ptr, want_c, _ = _oracle(m, sources)
    total = len(want_c)
    c_ptr = torch.from_numpy(ptr).to(device)
    c_cols = torch.full((total + offset,), -7, dtype=torch.int32,
                        device=device)[offset:]
    c_vals = torch.full((total + offset,), float("nan"), device=device
                        )[offset:]
    for s in sources:
        t = {k: torch.from_numpy(v).to(device) for k, v in s.items()}
        ss.slab_scatter(c_ptr, c_cols, c_vals, t["rows"], t["cols"],
                        t["vals"], nnz=t.get("nnz"), indptr=t.get("indptr"))
    return c_cols, c_vals


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("name", ["empty", "zero_rows", "full", "overflow",
                                  "csr"])
def test_plain_scatter_matches_the_oracle(name, offset):
    rng = np.random.default_rng(len(name) + offset)
    m, sources = _case(name, rng)
    _, want_c, want_v = _oracle(m, sources)
    c_cols, c_vals = _scatter_all(m, sources, "cpu", offset)
    np.testing.assert_array_equal(c_cols.numpy(), want_c)
    np.testing.assert_array_equal(c_vals.numpy().view(np.int32),
                                  want_v.view(np.int32))


def test_row_spans_and_entries():
    cols = torch.zeros((3, 4), dtype=torch.int32)
    start, lens = ss.row_spans(cols, nnz=torch.tensor([2, 5, 4]))
    assert start.tolist() == [0, 4, 8] and lens.tolist() == [2, 0, 4]
    row, pos = ss.row_entries(start, lens)
    assert row.tolist() == [0, 0, 2, 2, 2, 2]
    assert pos.tolist() == [0, 1, 8, 9, 10, 11]
    start, lens = ss.row_spans(cols.reshape(-1),
                               indptr=torch.tensor([0, 3, 3, 5]))
    assert start.tolist() == [0, 3, 3] and lens.tolist() == [3, 0, 2]


def test_scatter_refuses_bad_sources():
    c_ptr = torch.zeros(3, dtype=torch.int32)
    c = (c_ptr, torch.zeros(4, dtype=torch.int32), torch.zeros(4))
    rows = torch.tensor([0, 1])
    cols = torch.zeros((2, 2), dtype=torch.int32)
    vals = torch.zeros((2, 2))
    nnz = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="exactly one"):
        ss.slab_scatter(*c, rows, cols, vals)
    with pytest.raises(ValueError, match="exactly one"):
        ss.slab_scatter(*c, rows, cols, vals, nnz=nnz,
                        indptr=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="for 2 rows"):
        ss.slab_scatter(*c, rows, cols, vals, nnz=nnz[:1])
    with pytest.raises(ValueError, match="!= vals"):
        ss.slab_scatter(*c, rows, cols, vals[:, :1].contiguous(), nnz=nnz)
    with pytest.raises(ValueError, match="contiguous"):
        ss.slab_scatter(*c, rows, cols.t(), vals, nnz=nnz)
    with pytest.raises(ValueError, match="launches the CUDA kernel"):
        ss.slab_scatter_cuda(*c, rows, cols, vals, nnz=nnz)


# ---------------------------------------------------------------------------
# The device merge: collect policies, post-ops, overflow
# ---------------------------------------------------------------------------

def _post(name, n, mask):
    if name == "none":
        return None
    if name == "mask":
        return graph_ops.mask_post(mask, threshold=0.05)
    if name == "bool":
        return graph_ops.bool_post(n)
    if name == "prune":
        return executor.MergePostOps(n_cols=n, threshold=0.5)
    if name == "inflate":
        return graph_ops.inflate_post(n, 2.0, 1e-3)
    raise KeyError(name)


def _post_oracle(ref, name, mask):
    """The exact product ``ref`` with the post-ops applied in numpy:
    ``{(row, col): value}``."""
    ptr, idx, v = formats.to_numpy(ref)
    rows = np.repeat(np.arange(ref.m), np.diff(ptr))
    keep = np.ones(len(idx), bool)
    if name == "mask":
        mp, mi, _ = formats.to_numpy(mask)
        mrows = np.repeat(np.arange(mask.m), np.diff(mp))
        keep &= np.isin(rows * ref.n + idx, mrows * ref.n + mi)
        keep &= np.abs(v) >= 0.05
    elif name == "bool":
        v = (v != 0).astype(v.dtype)
    elif name == "prune":
        keep &= np.abs(v) >= 0.5
    elif name == "inflate":
        v = np.abs(v).astype(np.float64) ** 2.0
        colsum = np.zeros(ref.n)
        np.add.at(colsum, idx, v)
        v = v / np.where(colsum[idx] == 0.0, 1.0, colsum[idx])
        keep &= np.abs(v) >= 1e-3
    return {(int(r), int(c)): float(x)
            for r, c, x in zip(rows[keep], idx[keep], v[keep])}


@pytest.mark.parametrize("overflow", [False, True], ids=["fit", "overflow"])
@pytest.mark.parametrize("post", ["none", "mask", "bool", "prune",
                                  "inflate"])
def test_device_merge_is_the_exact_product(post, overflow):
    a = formats.powerlaw_csr(5, 160, 160, 6.0, device="cpu")
    mask = formats.random_uniform_csr(48, 160, 160, 30.0, device="cpu")
    kw = dict(known_sizes=np.ones(a.m, np.int64)) if overflow else {}
    c0, rep0 = workflow.ocean_spgemm(a, a, cache=False,
                                     post=_post(post, a.n, mask), **kw)
    assert (rep0.overflow_rows > 0) == overflow
    assert c0.nnz == rep0.nnz_out
    assert (rep0.raw_row_nnz is None) == (post == "none")
    ref = workflow.spgemm_reference(a, a)
    assert c0.indptr.dtype == torch.int32 and c0.capacity == c0.nnz
    if post == "none":
        for x, y in zip(formats.to_numpy(c0), formats.to_numpy(ref)):
            np.testing.assert_array_equal(x, y)
    else:
        np.testing.assert_array_equal(
            rep0.raw_row_nnz, np.diff(formats.to_numpy(ref)[0]))
    want = _post_oracle(ref, post, mask)
    ptr, idx, v = formats.to_numpy(c0)
    rows = np.repeat(np.arange(c0.m), np.diff(ptr))
    assert [(int(r), int(c)) for r, c in zip(rows, idx)] == sorted(want)
    np.testing.assert_allclose(v, [want[r, c] for r, c in sorted(want)],
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _shaped_sources(kind, rng):
    """Sources shaped like a cell's: FEM's hash slabs (t256 + 128 spill,
    rows of about 340 entries), R-MAT's long-row slabs (width 4096, some
    rows overflowed) and its fallback's ESC rows of 10^4 entries."""
    if kind == "fem":
        m, r, width = 60_000, 50_000, 384
        nnz = rng.integers(200, 385, r)
    else:
        m, r, width = 6_000, 4_000, 4096
        nnz = rng.integers(0, 4097, r)
        nnz[rng.choice(r, 300, replace=False)] = 5000
    dest = rng.permutation(m)
    cols = np.sort(rng.integers(0, 2**31 - 1, (r, width), dtype=np.int32),
                   axis=1)
    vals = rng.standard_normal((r, width)).astype(np.float32)
    slab = dict(rows=dest[:r], cols=cols, vals=vals,
                nnz=nnz.astype(np.int32))
    over = dest[:r][nnz > width]
    rest = np.concatenate([over, dest[r:]])
    lens = rng.integers(0, 12_000 if kind == "rmat" else 600, len(rest))
    ptr = np.zeros(len(rest) + 1, np.int32)
    ptr[1:] = np.cumsum(lens)
    esc = dict(rows=rest, indptr=ptr,
               cols=rng.integers(0, 2**31 - 1, int(ptr[-1]), dtype=np.int32),
               vals=rng.standard_normal(int(ptr[-1])).astype(np.float32))
    counts = np.zeros(m, np.int64)
    counts[slab["rows"]] = np.where(nnz > width, 0, nnz)
    counts[rest] = lens
    return m, counts, [slab, esc]


@pytest.mark.parametrize("kind", ["fem", "rmat"])
def test_cuda_scatter_equals_the_plain_version(card, kind, launches):
    rng = np.random.default_rng(11)
    m, counts, sources = _shaped_sources(kind, rng)
    ptr = np.zeros(m + 1, np.int32)
    ptr[1:] = np.cumsum(counts)
    c_ptr = torch.from_numpy(ptr).to(card)
    total = int(ptr[-1])
    got = {}
    for offset in (0, 1, 2, 3):
        for name, fn in (("cuda", ss.slab_scatter_cuda),
                         ("plain", ss.slab_scatter_plain)):
            c_cols = torch.full((total + offset,), -7, dtype=torch.int32,
                                device=card)[offset:]
            c_vals = torch.full((total + offset,), float("nan"),
                                device=card)[offset:]
            for s in sources:
                t = {k: torch.from_numpy(v).to(card) for k, v in s.items()}
                if "indptr" in t:  # a source at another alignment too
                    t["cols"] = torch.cat([t["cols"][:offset], t["cols"]]
                                          )[offset:]
                fn(c_ptr, c_cols, c_vals, t["rows"], t["cols"], t["vals"],
                   nnz=t.get("nnz"), indptr=t.get("indptr"))
            torch.cuda.synchronize(card)
            got[name] = (c_cols.cpu(), c_vals.view(torch.int32).cpu())
        assert torch.equal(got["cuda"][0], got["plain"][0]), offset
        assert torch.equal(got["cuda"][1], got["plain"][1]), offset
        assert not (got["cuda"][0] == -7).any()
    assert launches() == {"slab_scatter": 4 * len(sources)}


def test_device_merge_on_the_card(card, launches, monkeypatch):
    """A warm multiply with overflowed rows: C as the exact product,
    compaction's peak at most C's arrays plus O(m) over what it found,
    no pinned host buffer, a ``slab_scatter`` launch a non-empty source."""
    from repro_torch.core import planner
    from repro_torch.kernels import _build
    _build.library()
    a = formats.powerlaw_csr(3, 1 << 14, 1 << 14, 12.0, device=card)
    known = np.full(a.m, 8, np.int64)
    cache = planner.PlanCache()
    c0, _ = workflow.ocean_spgemm(a, a, cache=cache, known_sizes=known)
    ref = workflow.spgemm_reference(a, a)
    for x, y in zip(formats.to_numpy(c0)[:2], formats.to_numpy(ref)[:2]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(formats.to_numpy(c0)[2],
                               formats.to_numpy(ref)[2], rtol=1e-5,
                               atol=1e-5)

    rises, pinned = [], []
    compact = executor._compact_slabs

    def measured(state, shape, dtype, device):
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        c = compact(state, shape, dtype, device)
        torch.cuda.synchronize(device)
        rises.append((torch.cuda.max_memory_allocated(device) - before,
                      c.nnz * 8, shape[0]))
        return c

    empty, pin = torch.empty, torch.Tensor.pin_memory

    def empty_counted(*args, **kw):
        if kw.get("pin_memory"):
            pinned.append(args)
        return empty(*args, **kw)

    def pin_counted(self, *args, **kw):
        pinned.append(self.shape)
        return pin(self, *args, **kw)

    monkeypatch.setattr(executor, "_compact_slabs", measured)
    monkeypatch.setattr(torch, "empty", empty_counted)
    monkeypatch.setattr(torch.Tensor, "pin_memory", pin_counted)
    before = launches().get("slab_scatter", 0)
    tr = trace.Tracer()
    with trace.tracing(tr):
        c, rep = workflow.ocean_spgemm(a, a, cache=cache, known_sizes=known)
    monkeypatch.undo()
    assert not pinned
    assert rep.plan_cache_hit and rep.overflow_rows > 0
    for x, y in zip((c.indptr, c.indices, c.values),
                    (c0.indptr, c0.indices, c0.values)):
        assert torch.equal(x, y)
    for rise, c_bytes, m in rises:
        assert rise <= c_bytes + 64 * (m + 1) + (2 << 20), (rise, c_bytes)
    # every dispatched launch has rows, and the fallback is one more source
    dispatched = sum(e["attrs"]["launches"] for e in tr.events()
                     if e["name"] == "exec.dispatch")
    assert launches()["slab_scatter"] - before == dispatched + 1
