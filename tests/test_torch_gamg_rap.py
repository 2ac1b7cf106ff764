"""The port on GAMG's coarse-operator product R·AP (R = Pᵀ, B not A, both
rectangular; ``perfbench/gen/fem_gamg_rap.py``) against the dense float64
product, and the plan's sizing counters (``pred_entries``,
``alloc_entries``) on the report, the ``plan.binning`` span and the
installed registry, cold and replayed."""
import numpy as np
import pytest
import torch

from perfbench import manifest
from perfbench.gen import fem_gamg_rap
from repro_torch.core import formats, planner, workflow
from repro_torch.obs import metrics, trace

CFG = manifest.config(manifest.load(), "fem-q1-gamg-rap")


def operands(ne, seed):
    ops = fem_gamg_rap.make(dict(CFG, ne=ne), seed, 2, "cpu")
    return [[formats.CSR(m.indptr.int(), m.indices.int(), m.values[v],
                         m.shape, m.nnz) for v in range(2)]
            for m in (ops.a, ops.b)]


def dense(c):
    c = c if isinstance(c, tuple) else (c.indptr, c.indices, c.values,
                                        c.shape, c.nnz)
    ptr, idx, val, shape, nnz = c
    rows = torch.repeat_interleave(torch.arange(shape[0]),
                                   (ptr[1:] - ptr[:-1]).long())
    out = torch.zeros(shape, dtype=torch.float64)
    out[rows, idx[:nnz].long()] = val[:nnz].double()
    return out


def sums_of(plan):
    """The counters taken from the plan's own arrays."""
    alloc = sum(len(d.rows) * d.cap for d in plan.dense)
    alloc += sum(len(h.rows) * (h.table + h.spill) for h in plan.hash)
    if plan.esc is not None:
        alloc += int(plan.products[plan.esc.rows].sum())
    return float(np.sum(plan.pred_row_nnz)), alloc


@pytest.mark.parametrize("ne", [5, 8])
def test_port_equals_the_dense_product(ne):
    (r, _), (ap, _) = operands(ne, 2 ** 31 + 21)
    c, rep = workflow.ocean_spgemm(r, ap, cache=False)
    assert rep.workflow == "estimation" and rep.overflow_rows == 0
    assert c.shape == (r.m, ap.n)
    want = dense(r) @ dense(ap)
    scale = dense(r).abs() @ dense(ap).abs()
    pattern = (dense(r) != 0).double() @ (dense(ap) != 0).double() > 0
    got = dense(c)
    ptr = c.indptr.long()
    got_pattern = torch.zeros_like(pattern)
    rows = torch.repeat_interleave(torch.arange(c.m), ptr[1:] - ptr[:-1])
    got_pattern[rows, c.indices[:c.nnz].long()] = True
    assert torch.equal(got_pattern, pattern) and c.nnz == int(pattern.sum())
    # rtol 1e-5 / atol 1e-6 against the scale of each entry's own products,
    # sum |r_ik * ap_kj|: the float64 product sums in another order, and an
    # entry of ~150 float32 products that cancels cannot match its own
    # value to 1e-5 (the port reads about 2e-7 of the scale)
    err = (got - want).abs()
    assert bool((err <= 1e-6 + 1e-5 * scale).all())


@pytest.mark.parametrize("ne", [5, 8])
def test_sizing_counters_cold_and_replayed(ne):
    (r0, r1), (ap0, ap1) = operands(ne, 5)
    cache = planner.PlanCache()
    key, built = workflow.warm_plan(r0, ap0, cache=cache)
    plan = cache.peek(key)
    assert built and plan.workflow == "estimation"
    pred, alloc = sums_of(plan)
    assert (plan.pred_entries, plan.alloc_entries) == (pred, alloc)
    assert alloc >= pred > 0
    reg = metrics.MetricsRegistry()
    prev = metrics.install_registry(reg)
    tr = trace.Tracer()
    try:
        with trace.tracing(tr):
            _, cold = workflow.ocean_spgemm(r0, ap0, cache=False)
            _, warm = workflow.ocean_spgemm(r1, ap1, cache=cache)
    finally:
        metrics.install_registry(prev)
    assert not cold.plan_cache_hit and warm.plan_cache_hit
    for rep in (cold, warm):
        assert (rep.pred_entries, rep.alloc_entries) == (pred, alloc)
    assert reg.series("plan.pred_entries") == {(): 2 * pred}
    assert reg.series("plan.alloc_entries") == {(): 2 * alloc}
    spans = [e for e in tr.events() if e["name"] == "plan.binning"]
    assert [e["attrs"] for e in spans] == [
        {"pred_entries": pred, "alloc_entries": alloc},
        {"pred_entries": pred, "alloc_entries": alloc, "replay": True}]
    # the replay's span covers the counters' reading: never empty, so an
    # interval sweep over the spans opens and closes it
    lookup = next(e for e in tr.events() if e["name"] == "plan.lookup")
    assert spans[1]["t0"] >= lookup["t0"] + lookup["dur"]
    assert 0.0 < spans[1]["dur"] < 0.1


def test_report_carries_the_counters_without_a_registry_or_tracer():
    (r, _), (ap, _) = operands(5, 1)
    prev_reg, prev_tracer = metrics.install_registry(None), trace.install(None)
    try:
        _, rep = workflow.ocean_spgemm(r, ap, cache=False)
    finally:
        metrics.install_registry(prev_reg)
        trace.install(prev_tracer)
    assert rep.pred_entries > 0 and rep.alloc_entries >= rep.pred_entries
