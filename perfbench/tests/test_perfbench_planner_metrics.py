"""The planner's sizing readers (``est_ratio``, ``alloc_ratio``) on
hand-made reports; a report of a port without the counters reads
nothing, not 0."""
import types

import pytest

from perfbench.context import TraceContext
from perfbench.metrics import alloc_ratio, est_ratio

READERS = {"est_ratio": (est_ratio, "pred_entries"),
           "alloc_ratio": (alloc_ratio, "alloc_entries")}


def report(nnz_out, **counters):
    return types.SimpleNamespace(stage_seconds={}, plan_cache_hit=False,
                                 overflow_rows=0, nnz_out=nnz_out,
                                 **counters)


def ctx(reports):
    return TraceContext(reports=reports, device_events=[],
                        window=(0.0, 10.0), work={}, widths={}, peaks=None)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_mean_ratio_over_the_window(metric):
    mod, field = READERS[metric]
    reps = [report(100, **{field: 150.0}), report(200, **{field: 250})]
    assert mod.read(ctx(reps)) == pytest.approx((1.5 + 1.25) / 2)
    # an empty product has no ratio and is left out
    assert mod.read(ctx(reps + [report(0, **{field: 0})])) == \
        pytest.approx(1.375)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_port_without_the_counters_reads_nothing(metric):
    mod, field = READERS[metric]
    assert mod.read(ctx([report(100), report(200)])) is None
    assert mod.read(ctx([report(100, **{field: 90.0}), report(5)])) is None
    assert mod.read(ctx([])) is None


def test_readers_of_one_report_differ_by_field():
    rep = report(50, pred_entries=40.0, alloc_entries=300)
    assert est_ratio.read(ctx([rep])) == pytest.approx(0.8)
    assert alloc_ratio.read(ctx([rep])) == pytest.approx(6.0)
