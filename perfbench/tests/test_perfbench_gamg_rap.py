"""The GAMG coarse-operator generator (``gen/fem_gamg_rap.py``) against
the Galerkin factors built explicitly in plain torch, its size formula
against the configuration, the reference and its control on R·AP, and a
traced run of the cell at a small size on the CPU."""
import sys

import pytest
import torch

from perfbench import manifest, reference, work
from perfbench import run as bench_run
from perfbench.gen import fem_gamg_rap
from perfbench.program import Port

BENCH = manifest.load()
CFG = manifest.config(BENCH, "fem-q1-gamg-rap")
SIZE_KEYS = ("rows", "inner", "nnz_r", "nnz_ap", "products", "nnz_c")


def small(ne):
    return dict(CFG, ne=ne)


def explicit_factors(ne, agg=3, dofs=3, modes=6):
    """Dense 0/1 (R, AP) from the mesh itself: the stiffness pattern of
    nodes that share an element, the aggregation map, P_tent with a dense
    dofs x modes block at each node of its aggregate, P =
    pattern((I + A)·P_tent), AP = pattern(A·P) and R = Pᵀ."""
    n = ne + 1
    na = n // agg
    z, y, x = torch.meshgrid(torch.arange(n), torch.arange(n),
                             torch.arange(n), indexing="ij")
    xyz = torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], 1)
    assert torch.equal(xyz[:, 0] + n * (xyz[:, 1] + n * xyz[:, 2]),
                       torch.arange(n ** 3))
    near = ((xyz[:, None, :] - xyz[None, :, :]).abs() <= 1).all(2)
    a = torch.kron(near.double(), torch.ones(dofs, dofs))
    ag = torch.clamp(xyz // agg, max=na - 1)
    agg_of = ag[:, 0] + na * (ag[:, 1] + na * ag[:, 2])
    p_tent = torch.zeros(n ** 3 * dofs, na ** 3 * modes, dtype=torch.float64)
    for node in range(n ** 3):
        c0 = modes * int(agg_of[node])
        p_tent[dofs * node:dofs * node + dofs, c0:c0 + modes] = 1.0
    eye = torch.eye(a.shape[0], dtype=torch.float64)
    p = ((eye + a) @ p_tent > 0).double()
    ap = (a @ p > 0).double()
    return p.T.contiguous(), ap


def triple(m, v=0):
    return m.indptr, m.indices, m.values[v]


def dense(m, v=None):
    out = torch.zeros(m.shape, dtype=torch.float64)
    rows = torch.repeat_interleave(torch.arange(m.shape[0]), m.row_lengths())
    out[rows, m.indices] = 1.0 if v is None else m.values[v].double()
    return out


@pytest.mark.parametrize("ne", [5, 6, 8])
def test_patterns_are_the_explicit_galerkin_factors(ne):
    ops = fem_gamg_rap.make(small(ne), 2 ** 31 + 9, 1, "cpu")
    r, ap = explicit_factors(ne)
    assert ops.a.shape == tuple(r.shape) and ops.b.shape == tuple(ap.shape)
    assert torch.equal(dense(ops.a), r) and torch.equal(dense(ops.b), ap)
    for m in (ops.a, ops.b):   # each row's columns strictly increasing
        row = torch.repeat_interleave(torch.arange(m.shape[0]),
                                      m.row_lengths())
        step = m.indices[1:] - m.indices[:-1]
        assert bool((step[row[1:] == row[:-1]] > 0).all())


@pytest.mark.parametrize("ne", [5, 6, 8])
def test_size_formula_counts_what_is_built(ne):
    cfg = small(ne)
    ops = fem_gamg_rap.make(cfg, 7, 1, "cpu")
    got = {"rows": ops.a.shape[0], "inner": ops.a.shape[1],
           "nnz_r": ops.a.nnz, "nnz_ap": ops.b.nnz,
           "products": work.products(ops)}
    got["nnz_c"] = sum(int(blk[3].shape[0]) for blk in reference.blocks(
        triple(ops.a), triple(ops.b), ops.b.shape[1], 5000))
    assert got == {k: v for k, v in fem_gamg_rap.sizes(cfg).items()
                   if k in SIZE_KEYS}


@pytest.mark.parametrize("ne,row", [
    (39, (13182, 192000, 4718592, 12266496, 271669248, 1823508)),
    (79, (105456, 1536000, 39546000, 104976000, 2370816000, 15803136)),
    (119, (384000, 5184000, 139723056, 378442368, 8707129344, 59149152))])
def test_size_formula_at_full_size(ne, row):
    got = fem_gamg_rap.sizes(small(ne))
    assert tuple(got[k] for k in SIZE_KEYS) == row
    if ne == CFG["ne"]:
        assert {k: CFG["sizes"][k] for k in SIZE_KEYS} == dict(
            zip(SIZE_KEYS, row))
        assert CFG["sizes"]["cols"] == row[0]
        assert row[4] > 2 ** 32     # the multiply's products pass 32 bits


def test_seed_changes_values_only():
    one = fem_gamg_rap.make(small(5), 11, 2, "cpu")
    two = fem_gamg_rap.make(small(5), 12, 2, "cpu")
    for m1, m2 in ((one.a, two.a), (one.b, two.b)):
        assert torch.equal(m1.indptr, m2.indptr)
        assert torch.equal(m1.indices, m2.indices)
        assert not torch.equal(m1.values, m2.values)
        assert not torch.equal(m1.values[0], m1.values[1])
        assert float(m1.values.min()) >= -1.0 and float(m1.values.max()) < 1
    assert one.b is not None and one.rhs is one.b


def as_c(pattern, values):
    """A dense product as the program's C, its pattern the structural
    one."""
    rows, cols = pattern.nonzero(as_tuple=True)
    indptr = torch.zeros(pattern.shape[0] + 1, dtype=torch.int64)
    indptr[1:] = torch.cumsum(pattern.sum(1), 0)
    return (indptr.int(), cols.int(), values[rows, cols].float(),
            int(cols.shape[0]))


@pytest.mark.parametrize("ne", [5, 8])
def test_reference_equals_the_dense_product(ne):
    ops = fem_gamg_rap.make(small(ne), 2 ** 32 + 1, 1, "cpu")
    pattern = dense(ops.a) @ dense(ops.b) > 0
    c = as_c(pattern, dense(ops.a, 0) @ dense(ops.b, 0))
    got = reference.compare(c, triple(ops.a), triple(ops.b), ops.b.shape[1],
                            max_products=5000)
    assert got["pattern_mismatch"] == 0
    assert got["nnz_c"] == int(pattern.sum())
    assert got["value_err"] <= 1e-7     # a float32 rounding of each entry
    assert got["value_err"] <= CFG["limits"]["value_err"]


def test_control_fails_the_limit_by_value():
    ops = fem_gamg_rap.make(small(8), 3, 1, "cpu")
    args = (triple(ops.a), triple(ops.b), ops.b.shape[1])
    got = reference.compare(reference.control(*args, max_products=5000),
                            *args)
    assert got["pattern_mismatch"] == 0
    assert got["value_err"] > 10 * CFG["limits"]["value_err"]


def test_traced_run_reads_the_planner_counters(monkeypatch):
    Port()  # puts the checkout's src on the path
    from repro_torch.core import tuning
    monkeypatch.setattr(tuning, "DEFAULT_TUNING_CACHE", tuning.TuningCache())
    before = set(sys.modules)
    monkeypatch.setattr(bench_run, "forbidden_modules", lambda: sorted(
        {n.split(".")[0] for n in set(sys.modules) - before}
        & set(bench_run.FORBIDDEN)))
    cell = manifest.cell(BENCH, "fem-rap-cold")
    res = bench_run.run(BENCH, cell, 2 ** 31 + 17, 0.2, True,
                        torch.device("cpu"), config_override={"ne": 5})
    assert res["correct"] and res["failed"] == 0
    want = {m["name"] for m in manifest.reported(BENCH["per_layer"],
                                                 "fem-rap-cold")}
    assert want == {"est_ratio", "alloc_ratio"} == set(res["metrics"])
    est = res["metrics"]["est_ratio"]["value"]
    alloc = res["metrics"]["alloc_ratio"]["value"]
    assert 0.5 < est < 2.0 and alloc >= 1.0
