"""The port's spans inside a multiply: one multiply id on every span under
the root ``ocean.spgemm``, the timed steps of the merge and the plan
lookup nested in their parents and equal to ``OceanReport.span_seconds``,
the same stage keys under every executor, nothing built while tracing is
off, and (on a card) each bin launch's device span around its kernel in
the profiler's trace.
"""
import collections
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import formats, planner, workflow
from repro_torch.obs import metrics, trace
from _torch_launches import launches  # noqa: F401 (the fixture)

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_OF = {c: p for p, cs in trace.SUB_SPANS.items() for c in cs}


def _matrix(device="cpu"):
    return formats.powerlaw_csr(5, 160, 160, 6.0, device=device)


def _traced_calls(executor, warm, n=2):
    """``n`` traced multiplies of one powerlaw matrix whose undersized
    fed-forward sizes send rows to the overflow fallback; ``warm``: each
    replays a plan cached by an untraced call first."""
    a = _matrix()
    known = np.ones(a.m, np.int64)
    cache = planner.PlanCache() if warm else False
    if warm:
        workflow.ocean_spgemm(a, a, cache=cache, known_sizes=known,
                              executor=executor)
    tr = trace.Tracer()
    with trace.tracing(tr):
        reps = [workflow.ocean_spgemm(a, a, cache=cache, known_sizes=known,
                                      executor=executor)[1]
                for _ in range(n)]
    return tr, reps


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("executor", ["serial", "pipelined", "threaded"])
def test_spans_of_a_multiply(executor, warm):
    tr, reps = _traced_calls(executor, warm)
    events = tr.events()
    roots = [e for e in events if e["name"] == trace.ROOT]
    assert len(roots) == 2 and roots[0]["mid"] != roots[1]["mid"]
    by_mid = collections.defaultdict(list)
    for e in events:
        by_mid[e["mid"]].append(e)
    # every span of the window belongs to one of the two multiplies
    assert set(by_mid) == {r["mid"] for r in roots}
    for root, rep in zip(roots, reps):
        mine = by_mid[root["mid"]]
        assert root["attrs"] == {"mid": root["mid"],
                                 "cache_hit": warm, "workflow": "known"}
        assert rep.plan_cache_hit == warm and rep.overflow_rows > 0
        for e in mine:
            assert root["t0"] <= e["t0"] and (
                e["t0"] + e["dur"] <= root["t0"] + root["dur"])
        # each step nests in its parent, and in its interval
        secs = collections.Counter()
        parents = {e["name"]: e for e in mine if e["name"] in trace.SUB_SPANS}
        for e in mine:
            if e["name"] in CHILD_OF or e["name"] in trace.SUB_SPANS:
                secs[e["name"]] += e["dur"]
            if e["name"] in CHILD_OF:
                p = parents[CHILD_OF[e["name"]]]
                assert e["parent"] == p["name"]
                assert p["t0"] <= e["t0"]
                assert e["t0"] + e["dur"] <= p["t0"] + p["dur"]
        want = {"exec.compact", "exec.compact.scatter",
                "exec.overflow_fallback", "exec.fallback.gather",
                "exec.fallback.esc"}
        if warm:
            want |= {"plan.lookup", "plan.key", "plan.probe"}
        assert set(secs) == want
        # the report's seconds are the spans' durations, measured once
        assert rep.span_seconds == dict(secs)
        for p, cs in trace.SUB_SPANS.items():
            assert sum(rep.span_seconds.get(c, 0.0) for c in cs) <= \
                rep.span_seconds.get(p, 0.0)
        if warm:
            assert rep.stage_seconds["plan_lookup"] == \
                rep.span_seconds["plan.lookup"]
        assert {"dispatch", "collect", "merge"} <= set(rep.stage_seconds)
        assert not {"numeric", "overflow", "postprocess"} & set(
            rep.stage_seconds)
        assert rep.audit() == []
        dispatched = [e["attrs"]["launches"] for e in mine
                      if e["name"] == "exec.dispatch"]
        assert len(dispatched) == 1 and dispatched[0] > 0
        # the bins ran on the host: no device span, no device time
        assert rep.device_seconds == {}
    assert tr.device_events() == []


def test_merge_stage_equals_its_parts_under_every_executor():
    """``merge`` is the per-slab merge, the fallback and the compaction,
    under each executor; without tracing the steps are timed all the
    same, and no device time is measured."""
    a = _matrix()
    known = np.ones(a.m, np.int64)
    for ex in ("serial", "pipelined", "threaded"):
        _, rep = workflow.ocean_spgemm(a, a, cache=False, known_sizes=known,
                                       executor=ex)
        parts = (rep.span_seconds["exec.overflow_fallback"]
                 + rep.span_seconds["exec.compact"])
        assert 0.0 < parts <= rep.stage_seconds["merge"]
        assert rep.device_seconds is None
        assert rep.audit() == []


def test_nothing_built_while_tracing_is_off(monkeypatch):
    built = collections.Counter()
    span_init, event_init = trace.Span.__init__, torch.cuda.Event.__init__

    def counting_span(self, tracer, *a, **kw):
        # a timed step is a stopwatch Span with no tracer while off
        built["Span" if tracer is not None else "stopwatch"] += 1
        span_init(self, tracer, *a, **kw)

    def counting_event(self, *a, **kw):
        built["Event"] += 1
        event_init(self, *a, **kw)

    monkeypatch.setattr(trace.Span, "__init__", counting_span)
    monkeypatch.setattr(torch.cuda.Event, "__init__", counting_event)
    a = _matrix()
    known = np.ones(a.m, np.int64)
    tr = trace.Tracer()
    with trace.tracing(tr):
        workflow.ocean_spgemm(a, a, cache=False, known_sizes=known)
    first = tr.events()[-1]["mid"]
    assert built["Span"] > 0
    built.clear()
    steps = 0
    for ex in ("serial", "pipelined", "threaded"):
        _, rep = workflow.ocean_spgemm(a, a, cache=planner.PlanCache(),
                                       known_sizes=known, executor=ex)
        assert rep.overflow_rows > 0 and rep.device_seconds is None
        steps += len(rep.span_seconds)
    # a card's device is timed only while tracing
    assert trace.device_timer(torch.device("cuda", 0)) is None
    assert trace.current_mid() is None
    # one stopwatch a timed step, and nothing else
    assert built == {"stopwatch": steps} and steps == 3 * 8
    # the untraced calls drew no multiply id
    with trace.tracing(tr):
        workflow.ocean_spgemm(a, a, cache=False)
    assert tr.events()[-1]["mid"] == first + 1


def test_multiply_ids_per_thread():
    """Concurrent multiplies each keep their own id on their spans, and
    spans outside a multiply carry none."""
    tr = trace.Tracer()
    got = collections.defaultdict(set)
    errors = []

    def worker(i):
        try:
            for _ in range(20):
                with trace.root_span(worker=i) as root:
                    mid = root.attrs["mid"]
                    with trace.span("inner"):
                        trace.add_span("retro", time.perf_counter(), 0.0)
                    got[i].add(mid)
                trace.add_span("between", time.perf_counter(), 0.0)
        except BaseException as e:          # re-raised on the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.tracing(tr):
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    mids = [m for s in got.values() for m in s]
    assert len(mids) == len(set(mids)) == 8 * 20
    owner = {m: i for i, s in got.items() for m in s}
    for e in tr.events():
        if e["name"] == "between":
            assert e["mid"] is None
        else:
            assert e["mid"] in owner
            if e["name"] == trace.ROOT:
                assert owner[e["mid"]] == e["attrs"]["worker"]


def test_launch_counts_from_many_threads(launches):
    """Kernel wrappers launch from several threads (the serving pool's
    workers): no count is lost."""
    def worker():
        for _ in range(2000):
            metrics.count_launch("hash")
            metrics.count_launch("dense_window")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert launches() == {"hash": 16000, "dense_window": 16000}
    metrics.install_registry(None)
    metrics.count_launch("hash")            # no registry: counted nowhere
    assert launches() == {"hash": 16000, "dense_window": 16000}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_bin_device_spans_hold_their_kernels_on_the_card(card):
    """Each ``device.bin`` span of a dense or hash bin, on the host's clock
    through the tracer's anchor, contains that bin's kernel in the
    profiler's trace (aligned by ``perfbench.devtrace``'s marker) to
    within 100 us; the registry counts the launches the device spans
    and ``exec.dispatch`` do."""
    if ROOT_DIR not in sys.path:
        sys.path.insert(0, ROOT_DIR)
    from perfbench import devtrace
    from repro_torch.kernels import _build
    _build.library()
    a = formats.powerlaw_csr(3, 1 << 14, 1 << 14, 12.0, device=card)
    cache = planner.PlanCache()
    workflow.ocean_spgemm(a, a, cache=cache)          # plans and tunes
    torch.cuda.synchronize(card)
    # the profiler's marker kernel launched once before, so that its
    # alignment holds no first launch's latency
    torch.cuda._sleep(1000)
    torch.cuda.synchronize(card)
    reg = metrics.MetricsRegistry()
    prev = metrics.install_registry(reg)
    tr = trace.Tracer()
    try:
        with devtrace.Capture(card) as cap, trace.tracing(tr):
            reps = [workflow.ocean_spgemm(a, a, cache=cache)[1]
                    for _ in range(3)]
            torch.cuda.synchronize(card)
    finally:
        metrics.install_registry(prev)
    assert all(r.plan_cache_hit for r in reps)
    bins = sorted((e for e in tr.device_events()
                   if e["name"] == "device.bin"
                   and e["attrs"]["kind"] in ("dense", "hash")),
                  key=lambda e: e["t0"])
    kernels = sorted((s, e, n) for s, e, n in cap.events
                     if "slab_kernel" in n)
    assert bins and len(kernels) == len(bins)
    for ev, (s, e, name) in zip(bins, kernels):
        assert ("hash" in name) == (ev["attrs"]["kind"] == "hash")
        assert ev["t0"] - 1e-4 <= s and e <= ev["t0"] + ev["dur"] + 1e-4, \
            (ev, s, e, name)
    total = collections.Counter(e["attrs"]["kind"]
                                for e in tr.device_events()
                                if e["name"] == "device.bin")
    assert sum(total.values()) == sum(
        e["attrs"]["launches"] for e in tr.events()
        if e["name"] == "exec.dispatch")
    counted = metrics.launch_counts(reg)
    assert counted.get("hash", 0) == total.get("hash", 0)
    assert counted.get("dense_window", 0) + counted.get(
        "dense_longrow", 0) == total.get("dense", 0)
    secs = collections.defaultdict(float)
    for e in tr.device_events():
        if e["name"] == "device.bin":
            secs[e["mid"], e["attrs"]["kind"]] += e["dur"]
    roots = [e["mid"] for e in tr.events() if e["name"] == trace.ROOT]
    for mid, rep in zip(roots, reps):
        assert rep.device_seconds == pytest.approx(
            {k: v for (m, k), v in secs.items() if m == mid})

