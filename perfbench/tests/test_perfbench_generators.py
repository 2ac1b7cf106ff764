"""The generators against closed forms, scipy and the Graph500 spec."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from perfbench import work
from perfbench.gen import fem_q1, rmat_graph500

RMAT = {"scale": 9, "edge_factor": 16, "probs": [0.57, 0.19, 0.19, 0.05],
        "graph_seed": 1}


def scipy_of(m, v=0):
    return sp.csr_matrix((m.values[v].double().numpy(), m.indices.numpy(),
                          m.indptr.numpy()), shape=m.shape)


def stencil_sum(n, power):
    """sum over a 1-D line of n nodes of (neighbours incl. itself)**power."""
    c = np.full(n, 3)
    c[[0, -1]] = 2
    return int((c ** power).sum())


@pytest.mark.parametrize("nodes,dofs", [((5, 4, 3), 3), ((6, 6, 6), 3),
                                        ((4, 3, 5), 2)])
def test_fem_pattern_closed_form(nodes, dofs):
    ops = fem_q1.make({"nodes": list(nodes), "dofs_per_node": dofs}, 11, 2,
                      "cpu")
    a = scipy_of(ops.a)
    rows = dofs * int(np.prod(nodes))
    assert a.shape == (rows, rows)
    assert a.has_sorted_indices
    # 27-node stencil, clipped at the faces, times a dense dofs x dofs block
    assert a.nnz == dofs * dofs * int(np.prod([3 * n - 2 for n in nodes]))
    pattern = sp.csr_matrix((np.ones(a.nnz), a.indices, a.indptr),
                            shape=a.shape)
    assert (pattern != pattern.T).nnz == 0
    # A*A couples nodes up to two apart in each dimension
    assert (a @ a).nnz == dofs * dofs * int(
        np.prod([5 * n - 6 for n in nodes]))
    assert work.products(ops) == dofs ** 3 * int(
        np.prod([stencil_sum(n, 2) for n in nodes]))
    vals = ops.a.values
    assert vals.dtype == torch.float32 and vals.shape == (2, a.nnz)
    assert float(vals.min()) >= -1.0 and float(vals.max()) < 1.0


def test_fem_full_size_matches_config():
    """The stated sizes of the configuration are the generated ones."""
    import json
    from perfbench.manifest import HERE
    cfg = json.load(open(HERE / "configs" / "fem-q1-elasticity.json"))
    nodes, d = cfg["nodes"], cfg["dofs_per_node"]
    s = cfg["sizes"]
    assert s["rows"] == d * int(np.prod(nodes))
    assert s["nnz"] == d * d * int(np.prod([3 * n - 2 for n in nodes]))
    assert s["products"] == d ** 3 * int(
        np.prod([stencil_sum(n, 2) for n in nodes]))
    assert s["nnz_c"] == d * d * int(np.prod([5 * n - 6 for n in nodes]))


def test_fem_seed_changes_values_only():
    x = fem_q1.make({"nodes": [4, 4, 4], "dofs_per_node": 3}, 1, 1, "cpu")
    y = fem_q1.make({"nodes": [4, 4, 4], "dofs_per_node": 3}, 2**31 + 9, 1,
                    "cpu")
    z = fem_q1.make({"nodes": [4, 4, 4], "dofs_per_node": 3}, 1, 1, "cpu")
    assert torch.equal(x.a.indptr, y.a.indptr)
    assert torch.equal(x.a.indices, y.a.indices)
    assert not torch.equal(x.a.values, y.a.values)
    assert torch.equal(x.a.values, z.a.values)


def test_rmat_quadrants_follow_the_spec():
    rows, cols = rmat_graph500.edges(12, 16, [0.57, 0.19, 0.19, 0.05], 3,
                                     "cpu")
    assert rows.shape[0] == 16 << 12
    # the top bit level alone draws the quadrant of the whole matrix
    top_r, top_c = rows >> 11, cols >> 11
    share = [float(((top_r == r) & (top_c == c)).double().mean())
             for r, c in ((0, 0), (0, 1), (1, 0), (1, 1))]
    np.testing.assert_allclose(share, [0.57, 0.19, 0.19, 0.05], atol=0.01)


def test_rmat_graph_is_clean_and_permuted():
    n = 1 << RMAT["scale"]
    ident = rmat_graph500.graph(RMAT, torch.arange(n))
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(5))
    moved = rmat_graph500.graph(RMAT, perm)
    g = sp.csr_matrix((np.ones(ident[1].shape[0]), ident[1].numpy(),
                       ident[0].numpy()), shape=(n, n))
    h = sp.csr_matrix((np.ones(moved[1].shape[0]), moved[1].numpy(),
                       moved[0].numpy()), shape=(n, n))
    assert g.has_sorted_indices and h.has_sorted_indices
    assert g.diagonal().sum() == 0 and (g != g.T).nnz == 0
    assert g.max() == 1                               # no duplicate edges
    p = sp.csr_matrix((np.ones(n), (perm.numpy(), np.arange(n))),
                      shape=(n, n))
    # vertex v of the unpermuted graph is vertex perm[v] of the permuted one
    assert (p @ g @ p.T != h).nnz == 0


def test_rmat_every_seed_gives_the_same_sizes():
    a = rmat_graph500.make(RMAT, 3, 2, "cpu")
    b = rmat_graph500.make(RMAT, 2**31 + 17, 2, "cpu")
    assert a.a.nnz == b.a.nnz
    assert work.products(a) == work.products(b)
    assert (scipy_of(a.a) @ scipy_of(a.a)).nnz == (
        scipy_of(b.a) @ scipy_of(b.a)).nnz
    assert not torch.equal(a.a.indices, b.a.indices)
    w = scipy_of(a.a, 1)
    assert (w != w.T).nnz == 0                        # one weight an edge
    assert float(a.a.values.min()) >= 0.0 and float(a.a.values.max()) < 1.0
