"""Each per-layer reader and the device-trace arithmetic on synthetic
reports, spans and profiler events, against hand counts."""
import json
import types

import pytest

from perfbench import devtrace, manifest
from perfbench.context import TraceContext
from perfbench.metrics import (idle_pct, kernel_roofline_pct, merge_ms,
                               overflow_rows, plan_lookup_ms, plan_ms)

WIDTHS = {"offset_bytes": 8, "index_bytes": 4, "value_bytes": 4}
PEAKS = {"memory_bytes_per_s": 1e9, "f32_flops_per_s": 1e10}


def report(stages, hit=False, overflow=0):
    return types.SimpleNamespace(stage_seconds=stages, plan_cache_hit=hit,
                                 overflow_rows=overflow)


COLD = [report({"analysis": 0.1, "prediction": 0.2, "binning": 0.3,
                "merge": 1.0}, overflow=4),
        report({"analysis": 0.2, "prediction": 0.2, "binning": 0.2,
                "merge": 2.0}, overflow=0)]
WARM = [report({"plan_lookup": 0.05, "analysis": 0.0, "prediction": 0.0,
                "binning": 0.0, "merge": 3.0}, hit=True)] * 3

# a 10 s window: two kernels that overlap, a copy, a memset, one kernel
# outside the window and one cut by its end
EVENTS = [(1.0, 2.0, "window_slab_kernel"), (1.5, 2.5, "hash_slab_kernel"),
          (4.0, 5.0, "Memcpy DtoH (Device -> Pinned)"),
          (6.0, 6.5, "Memset (Device)"), (-3.0, -2.0, "early_kernel"),
          (9.5, 12.0, "window_slab_kernel")]
WORK = {"rows": 100, "inner": 100, "cols": 100, "nnz_a": 1000,
        "nnz_b": 1000, "nnz_c": 5000, "products": 20000,
        "same_operand": True}


def ctx(reports, events=EVENTS, peaks=PEAKS, work=WORK):
    return TraceContext(reports=reports, device_events=events,
                        window=(0.0, 10.0), work=work, widths=WIDTHS,
                        peaks=peaks)


def test_stage_readers():
    assert plan_ms.read(ctx(COLD)) == pytest.approx(600.0)
    assert plan_ms.read(ctx(WARM)) is None
    assert plan_lookup_ms.read(ctx(WARM)) == pytest.approx(50.0)
    assert plan_lookup_ms.read(ctx(COLD)) is None
    assert merge_ms.read(ctx(COLD)) == pytest.approx(1500.0)
    assert overflow_rows.read(ctx(COLD)) == pytest.approx(2.0)
    assert overflow_rows.read(ctx(WARM)) == 0.0


def test_interval_arithmetic():
    inside = devtrace.clip(EVENTS, 0.0, 10.0)
    assert len(inside) == 5 and inside[-1][:2] == (9.5, 10.0)
    assert devtrace.union(inside) == [(1.0, 2.5), (4.0, 5.0), (6.0, 6.5),
                                      (9.5, 10.0)]
    assert devtrace.covered(inside) == pytest.approx(3.5)
    assert devtrace.gaps(inside, 0.0, 10.0) == [
        (0.0, 1.0), (2.5, 4.0), (5.0, 6.0), (6.5, 9.5)]
    assert devtrace.kind_of("Memcpy HtoD (Pageable -> Device)") == "copy"
    assert devtrace.kind_of("Memset (Device)") == "memset"
    assert devtrace.kind_of("window_slab_kernel") == "kernel"


def test_idle_pct_is_the_uncovered_share():
    assert idle_pct.read(ctx(COLD)) == pytest.approx(65.0)
    assert idle_pct.read(ctx(COLD, events=[])) is None


def test_kernel_roofline_against_a_hand_count():
    # bytes: A once (8*101 + 1000*8) and C (8*101 + 5000*8) = 49,616 B at
    # 1e9 B/s = 49.616 us; operations 40,000 at 1e10/s = 4 us. Bound
    # 49.616 us a multiply, 2 multiplies; kernels cover [1, 2.5] and
    # [9.5, 10]: 2 s.
    assert kernel_roofline_pct.bytes_moved(WORK, WIDTHS) == 49616
    assert kernel_roofline_pct.operations(WORK) == 40000
    got = kernel_roofline_pct.read(ctx(COLD))
    assert got == pytest.approx(100.0 * 2 * 49.616e-6 / 2.0)
    # B counted apart when it is not A
    other = dict(WORK, same_operand=False, inner=50, nnz_b=300)
    assert kernel_roofline_pct.bytes_moved(other, WIDTHS) == (
        49616 + 8 * 51 + 300 * 8)
    # compute-bound when the operations dominate
    heavy = dict(WORK, products=10**9)
    assert kernel_roofline_pct.bound_seconds(heavy, WIDTHS, PEAKS) == (
        pytest.approx(0.2))
    assert kernel_roofline_pct.read(ctx(COLD, peaks=None)) is None
    copies_only = [e for e in EVENTS if "Mem" in e[2]]
    assert kernel_roofline_pct.read(ctx(COLD, events=copies_only)) is None


def test_h100_peaks_are_the_data_sheet_s():
    peaks = json.load(open(manifest.HERE / "peaks.json"))
    h100 = peaks["NVIDIA H100 80GB HBM3"]
    assert h100["memory_bytes_per_s"] == 3.35e12
    assert h100["f32_flops_per_s"] == 67e12


def test_idle_time_by_open_span():
    spans = [(0.0, 3.0, "plan.analysis"), (0.5, 0.8, "analysis.wave1"),
             (3.0, 9.0, "exec.merge"), (5.2, 5.6, "exec.compact")]
    idle = devtrace.gaps(devtrace.clip(EVENTS, 0.0, 10.0), 0.0, 10.0)
    got = devtrace.idle_by_span(idle, spans)
    assert got["analysis.wave1"] == pytest.approx(0.3)
    assert got["plan.analysis"] == pytest.approx(0.7 + 0.5)
    assert got["exec.compact"] == pytest.approx(0.4)
    assert got["exec.merge"] == pytest.approx(1.0 + 0.6 + 2.5)
    assert got[devtrace.OUTSIDE] == pytest.approx(0.5)
    assert sum(got.values()) == pytest.approx(10.0 - 3.5)


def test_breakdown_shape():
    bd = devtrace.breakdown(EVENTS, [(0.0, 10.0, "exec.merge")], 0.0, 10.0)
    assert bd["device_ops"][0] == ["window_slab_kernel", pytest.approx(1.5)]
    assert len(bd["device_ops"]) == 4
    assert bd["idle_gaps"] == [["exec.merge", pytest.approx(6.5)]]
    many = [(float(i), i + 0.5, f"k{i}") for i in range(20)]
    assert len(devtrace.breakdown(many, [], 0.0, 30.0)["device_ops"]) == 10
    assert devtrace.breakdown([], [], 0.0, 1.0) is None
