"""The readers of the port's timed steps and bin device time, on synthetic
reports against hand counts; a report of a port without these fields
reads nothing."""
import types

import pytest

from perfbench.context import TraceContext
from perfbench.metrics import (bin_device_ms, compact_scatter_ms,
                               compact_upload_ms, fallback_ms, plan_key_ms)

READERS = {"plan_key_ms": (plan_key_ms, "plan.key"),
           "compact_scatter_ms": (compact_scatter_ms,
                                  "exec.compact.scatter"),
           "compact_upload_ms": (compact_upload_ms, "exec.compact.upload"),
           "fallback_ms": (fallback_ms, "exec.overflow_fallback")}


def report(span_seconds=None, device_seconds=None, **stages):
    """A report; without ``span_seconds`` one of a port that lacks both
    new fields."""
    r = types.SimpleNamespace(stage_seconds=stages, plan_cache_hit=False,
                              overflow_rows=0)
    if span_seconds is not None:
        r.span_seconds = span_seconds
        r.device_seconds = device_seconds
    return r


def ctx(reports):
    return TraceContext(reports=reports, device_events=[],
                        window=(0.0, 10.0), work={}, widths={}, peaks=None)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_step_readers_average_over_the_window(metric):
    mod, name = READERS[metric]
    two = [report({name: 0.25, "other": 9.0}), report({name: 0.75})]
    assert mod.read(ctx(two)) == pytest.approx(500.0)
    # a multiply that did not run the step counts 0
    assert mod.read(ctx(two + [report({"other": 1.0})])) == \
        pytest.approx(1000.0 / 3)
    assert mod.read(ctx([report({})])) == 0.0


@pytest.mark.parametrize("metric", sorted(READERS) + ["bin_device_ms"])
def test_readers_of_a_port_without_the_fields_read_nothing(metric):
    mod = bin_device_ms if metric == "bin_device_ms" else READERS[metric][0]
    assert mod.read(ctx([report(), report()])) is None
    assert mod.read(ctx([])) is None


def test_bin_device_ms_sums_the_kinds():
    reps = [report({}, {"dense": 0.002, "hash": 0.010}),
            report({}, {"hash": 0.004, "esc": 0.002}),
            report({}, None)]          # a multiply the tracer did not see
    assert bin_device_ms.read(ctx(reps)) == pytest.approx(9.0)
    # bins that ran on the host time no device
    assert bin_device_ms.read(ctx([report({}, {})])) == 0.0
