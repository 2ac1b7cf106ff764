"""The plain reference against scipy, the product count against a brute
count, and the comparison against planted faults and the control."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from perfbench import reference, work
from perfbench.gen import fem_q1, rmat_graph500

RMAT = {"scale": 8, "edge_factor": 16, "probs": [0.57, 0.19, 0.19, 0.05],
        "graph_seed": 2}


def operands(kind):
    if kind == "fem":
        return fem_q1.make({"nodes": [4, 3, 3], "dofs_per_node": 3}, 5, 2,
                           "cpu")
    return rmat_graph500.make(RMAT, 5, 2, "cpu")


def triple(m, v=0):
    return m.indptr, m.indices, m.values[v]


def scipy_product(ops, v=0):
    a = sp.csr_matrix((ops.a.values[v].double().numpy(),
                       ops.a.indices.numpy(), ops.a.indptr.numpy()),
                      shape=ops.a.shape)
    c = (a @ a).tocsr()
    c.sort_indices()
    return c


def as_c(c, dtype=torch.float32):
    """A scipy CSR in the program's form (indptr, indices, values, nnz)."""
    return (torch.from_numpy(c.indptr.astype(np.int32)),
            torch.from_numpy(c.indices.astype(np.int32)),
            torch.from_numpy(c.data).to(dtype), int(c.nnz))


@pytest.mark.parametrize("kind", ["fem", "rmat"])
def test_product_count_against_brute_count(kind):
    ops = operands(kind)
    ptr, idx = ops.a.indptr.tolist(), ops.a.indices.tolist()
    brute = [sum(ptr[k + 1] - ptr[k] for k in idx[ptr[i]:ptr[i + 1]])
             for i in range(ops.a.shape[0])]
    assert work.products(ops) == sum(brute)
    assert work.flops(ops) == 2 * sum(brute)


@pytest.mark.parametrize("kind", ["fem", "rmat"])
@pytest.mark.parametrize("max_products", [1 << 30, 700])
def test_reference_equals_scipy(kind, max_products):
    ops = operands(kind)
    want = scipy_product(ops, 1)
    counts, cols, vals = [], [], []
    for _, _, cnt, col, val, abs_sums in reference.blocks(
            triple(ops.a, 1), triple(ops.a, 1), ops.a.shape[1],
            max_products):
        counts.append(cnt)
        cols.append(col)
        vals.append(val)
        assert bool((abs_sums >= val.abs()).all())
    np.testing.assert_array_equal(np.diff(want.indptr),
                                  torch.cat(counts).numpy())
    np.testing.assert_array_equal(want.indices, torch.cat(cols).numpy())
    np.testing.assert_allclose(torch.cat(vals).numpy(), want.data,
                               rtol=1e-12, atol=1e-12)


def test_row_blocks_cover_every_row_once():
    ops = operands("rmat")
    blocks = reference.row_blocks(ops.a.indptr, ops.a.indices,
                                  ops.a.indptr, 500)
    assert blocks[0][0] == 0 and blocks[-1][1] == ops.a.shape[0]
    assert all(r1 > r0 for r0, r1 in blocks)
    assert all(x[1] == y[0] for x, y in zip(blocks, blocks[1:]))


@pytest.mark.parametrize("kind", ["fem", "rmat"])
def test_compare_passes_float32_and_fails_faults(kind):
    ops = operands(kind)
    c = scipy_product(ops)
    args = (triple(ops.a), triple(ops.a), ops.a.shape[1], 1 << 16)
    good = reference.compare(as_c(c), *args)
    assert good["pattern_mismatch"] == 0 and good["nnz_c"] == c.nnz
    assert good["value_err"] < 1e-6

    bad = c.copy()
    bad.data[c.nnz // 2] += 0.01                   # one answer altered
    assert reference.compare(as_c(bad), *args)["value_err"] > 1e-4

    bad = c.copy()
    row = int(np.argmax(np.diff(c.indptr)))
    bad.indices[c.indptr[row]] = c.indices[c.indptr[row] + 1]
    assert reference.compare(as_c(bad), *args)["pattern_mismatch"] >= 1

    half = c.copy()                                 # second half of rows empty
    m = c.shape[0]
    half.indptr[m // 2 + 1:] = half.indptr[m // 2]
    half = sp.csr_matrix((half.data[:half.indptr[-1]],
                          half.indices[:half.indptr[-1]], half.indptr),
                         shape=c.shape)
    assert reference.compare(as_c(half), *args)["pattern_mismatch"] > 0

    nan = c.copy()
    nan.data[0] = np.nan
    assert np.isnan(reference.compare(as_c(nan), *args)["value_err"])


@pytest.mark.parametrize("kind", ["fem", "rmat"])
def test_control_fails_by_far(kind):
    """The reference one precision lower (bfloat16 operands) is read far
    above float32's rounding."""
    ops = operands(kind)
    args = (triple(ops.a), triple(ops.a), ops.a.shape[1])
    ctl = reference.control(*args, max_products=900)
    got = reference.compare(ctl, *args)
    assert got["pattern_mismatch"] == 0
    assert got["value_err"] > 1e-4
