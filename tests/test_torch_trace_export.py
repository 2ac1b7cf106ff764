"""The port's Chrome/Perfetto trace export vs the reference's, on the CPU.

One traced call of each package on the same inputs, and one traced pool
burst of each, are exported; span names and the nesting on each lane
(spans grouped by the recording thread's name, each with its parent's
name) must be the same, once the spans the port adds (each multiply's
root and the timed steps inside the merge and the plan lookup) are left
out. The port's validator rejects what the reference's rejects, and also
a multiply id without its root span and a device lane that does not nest.
"""
import collections
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro import serving as rserving  # noqa: E402
from repro.core import formats as rformats  # noqa: E402
from repro.core import tuning as rtuning  # noqa: E402
from repro.core import workflow as rworkflow  # noqa: E402
from repro.obs import trace as rtrace  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.core import formats, tuning, workflow  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.tools import trace_export  # noqa: E402
from tools import trace_export as rtrace_export  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
RUNGS = (32, 64, 128, 256, 512, 1024, 2048, rtuning.REFERENCE_RUNG)
POOL_SPANS = {"pool.warm", "pool.batch_assembly", "pool.batch",
              "pool.queue_wait"}
# the port's spans that the reference does not record
PORT_SPANS = {trace.ROOT}.union(*trace.SUB_SPANS.values())


@pytest.fixture(scope="module", autouse=True)
def pinned_tuning():
    with pytest.MonkeyPatch.context() as mp:
        rcache, pcache = rtuning.TuningCache(), tuning.TuningCache()
        for r in RUNGS:
            rcache.insert(rtuning.tuning_key(r), rtuning.HashTuning())
            pcache.insert(tuning.tuning_key(r, "cpu"), tuning.HashTuning())
        mp.setattr(rtuning, "DEFAULT_TUNING_CACHE", rcache)
        mp.setattr(tuning, "DEFAULT_TUNING_CACHE", pcache)
        yield


def _pair(gen, *args):
    return (getattr(rformats, gen)(*args),
            getattr(formats, gen)(*args, device="cpu"))


def lanes(tracer, exporter, only=None, port=False):
    """Export through ``exporter`` and validate; per recording thread's
    name, the multiset of (span name, parent name). ``port``: the port's
    own spans (``PORT_SPANS``) left out, and the children of a multiply's
    root parentless, as the reference records them."""
    doc = exporter.to_chrome_trace(tracer)
    exporter.validate_chrome_trace(json.dumps(doc))
    thread_of = {e["tid"]: e["thread"] for e in tracer.events()}
    out = collections.defaultdict(collections.Counter)
    for e in doc["traceEvents"]:
        if e.get("pid") != 0 or (port and e["name"] in PORT_SPANS):
            continue
        parent = e["args"].get("parent")
        if port and parent == trace.ROOT:
            parent = None
        if only is None or e["name"] in only:
            out[thread_of[e["tid"]]][e["name"], parent] += 1
    return dict(out)


@pytest.mark.parametrize("executor", ["threaded", "serial"])
def test_traced_call_spans_and_nesting_match_reference(executor):
    ra, pa = _pair("random_uniform_csr", 11, 120, 120, 6.0)
    rb, pb = _pair("random_uniform_csr", 14, 120, 120, 5.0)
    rtr, ptr = rtrace.Tracer(), trace.Tracer()
    with rtrace.tracing(rtr):
        rworkflow.ocean_spgemm(ra, rb, cache=False, executor=executor)
    with trace.tracing(ptr):
        workflow.ocean_spgemm(pa, pb, cache=False, executor=executor)
    got = lanes(ptr, trace_export, port=True)
    assert got == lanes(rtr, rtrace_export)
    names = set().union(*({n for n, _ in c} for c in got.values()))
    assert {"plan.analysis", "plan.prediction", "plan.binning",
            "exec.dispatch", "exec.collect", "exec.compact"} <= names
    # the port's own spans: one root, the compaction's one step in it
    main = lanes(ptr, trace_export)["MainThread"]
    assert main[trace.ROOT, None] == 1
    assert main["exec.compact", trace.ROOT] == 1
    assert main["exec.compact.scatter", "exec.compact"] == 1
    assert sum(n for (_, p), n in main.items() if p == "exec.compact") == 1


def _traced_burst(pkg, trace_mod, mats):
    *pats, b = mats
    tr = trace_mod.Tracer()
    with trace_mod.tracing(tr):
        pool = pkg.SpGEMMPool(pkg.PoolConfig(workers=1, max_batch=4),
                              autostart=False)
        futs = [pool.submit(pats[(ti + i) % 3], b, tenant=t)
                for i in range(2)
                for ti, t in enumerate(("acme", "globex", "initech"))]
        assert pool.warm_wait(120)
        pool.start()
        assert pool.drain(120)
        for f in futs:
            f.result(0)
        pool.shutdown(timeout=120)
    return tr


def test_traced_pool_burst_spans_match_reference(tmp_path):
    pairs = [_pair("random_uniform_csr", 11, 120, 120, 6.0),
             _pair("banded_csr", 12, 120, 120, 24),
             _pair("powerlaw_csr", 13, 120, 120, 6.0),
             _pair("random_uniform_csr", 14, 120, 120, 5.0)]
    rtr = _traced_burst(rserving, rtrace, [r for r, _ in pairs])
    ptr = _traced_burst(serving, trace, [p for _, p in pairs])
    got = lanes(ptr, trace_export, POOL_SPANS)
    assert got == lanes(rtr, rtrace_export, POOL_SPANS)
    assert {n for c in got.values() for n, _ in c} == POOL_SPANS
    assert sum(got["pool-queue"].values()) == 6
    # the whole burst, every span, writes and validates
    path = tmp_path / "pool.json"
    doc = trace_export.write_chrome_trace(ptr, str(path))
    assert trace_export.validate_chrome_trace(path.read_text()) == doc
    # the pool's spans span several multiplies: no multiply id; each
    # multiply's spans carry the id of its root
    mids = collections.defaultdict(set)
    for e in doc["traceEvents"]:
        mids[e["name"]].add(e["args"]["mid"])
    assert all(mids[n] == {None} for n in POOL_SPANS)
    assert None not in mids[trace.ROOT] and len(mids[trace.ROOT]) == 6
    assert mids["exec.compact"] == mids[trace.ROOT]


def test_validator_rejects_what_the_reference_rejects():
    base = {"name": "a", "ph": "X", "ts": 0.0, "dur": 5.0, "pid": 0,
            "tid": 1}
    bad = [({"traceEvents": []}, "traceEvents"),
           ({"traceEvents": [{k: v for k, v in base.items()
                              if k != "dur"}]}, "missing"),
           ({"traceEvents": [dict(base, dur=-1.0)]}, "negative"),
           ({"traceEvents": [dict(base, ph="B")]}, "complete event"),
           ({"traceEvents": [dict(base),
                             dict(base, name="b", ts=3.0, dur=5.0)]},
            "overlaps")]
    for doc, match in bad:
        for validate in (trace_export.validate_chrome_trace,
                         rtrace_export.validate_chrome_trace):
            with pytest.raises(ValueError, match=match):
                validate(json.dumps(doc))
    ok = {"traceEvents": [dict(base), dict(base, name="b", ts=1.0, dur=2.0),
                          dict(base, name="c", tid=2, ts=3.0, dur=9.0)]}
    assert trace_export.validate_chrome_trace(json.dumps(ok)) == \
        rtrace_export.validate_chrome_trace(json.dumps(ok))


def test_validator_requires_each_multiplys_root():
    base = {"name": "exec.compact", "ph": "X", "ts": 1.0, "dur": 2.0,
            "pid": 0, "tid": 1, "args": {"mid": 3}}
    root = dict(base, name=trace.ROOT, ts=0.0, dur=5.0)
    with pytest.raises(ValueError, match="no 'ocean.spgemm'"):
        trace_export.validate_chrome_trace(json.dumps(
            {"traceEvents": [base, dict(root, args={"mid": 4})]}))
    trace_export.validate_chrome_trace(json.dumps(
        {"traceEvents": [root, base]}))


def _with_device_spans(spans):
    """A tracer holding one traced multiply's root and the given device
    spans ``(device, host thread, t0, dur)`` (seconds after its epoch)."""
    tr = trace.Tracer()
    with trace.tracing(tr):
        with trace.root_span():
            mid = trace.current_mid()
    for i, (dev, tid, t0, dur) in enumerate(spans):
        tr._device_events.append({
            "name": "device.bin", "device": dev, "t0": tr.epoch + t0,
            "dur": dur, "tid": tid, "mid": mid,
            "attrs": {"mid": mid, "kind": "hash", "order": i}})
    return tr, mid


def test_device_lanes_export_and_nest():
    tr, mid = _with_device_spans([("cuda:0", 1, 0.0, 1e-3),
                                  ("cuda:0", 1, 2e-3, 1e-3),
                                  ("cuda:1", 1, 0.0, 5e-3),
                                  ("cuda:0", 2, 5e-4, 2e-3)])
    doc = trace_export.to_chrome_trace(tr)
    assert trace_export.validate_chrome_trace(json.dumps(doc)) == \
        json.loads(json.dumps(doc))
    dev = [e for e in doc["traceEvents"] if e["pid"] == 1]
    names = {e["args"]["name"] for e in dev if e["ph"] == "M"}
    assert names == {"device", "cuda:0 (thread 1)", "cuda:0 (thread 2)",
                     "cuda:1"}
    spans = [e for e in dev if e["ph"] == "X"]
    assert len({e["tid"] for e in spans}) == 3
    assert all(e["args"]["mid"] == mid for e in spans)
    assert [e["ts"] for e in spans[:2]] == pytest.approx([0.0, 2000.0])
    # one lane whose spans overlap without nesting is refused
    tr, _ = _with_device_spans([("cuda:0", 1, 0.0, 1e-3),
                                ("cuda:0", 1, 5e-4, 1e-3)])
    with pytest.raises(ValueError, match="overlaps"):
        trace_export.validate_chrome_trace(
            json.dumps(trace_export.to_chrome_trace(tr)))


def test_export_round_trip_matches_reference(tmp_path):
    docs = []
    for mod, exporter in ((trace, trace_export), (rtrace, rtrace_export)):
        tr = mod.Tracer()
        with mod.tracing(tr):
            with mod.span("outer"):
                with mod.span("inner", rows=2):
                    pass
            tr.add_span("lane2", tr.epoch, 0.5, tid=7, thread="other")
        doc = exporter.write_chrome_trace(tr, str(tmp_path / "t.json"))
        assert exporter.validate_chrome_trace(
            (tmp_path / "t.json").read_text()) == json.loads(json.dumps(doc))
        docs.append([(e["name"], e["ph"], e["tid"] == 7, dict(e["args"]))
                     for e in doc["traceEvents"]])
    # the port's args add the multiply id, null outside a multiply
    assert [args.pop("mid") for *_, args in docs[0]] == [None] * 3
    assert docs[0] == docs[1]


def test_cli_writes_a_validated_trace_on_the_cpu(tmp_path):
    out = tmp_path / "cli.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.trace_export", "--out",
         str(out), "--device", "cpu"], env=env, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "device=cpu" in run.stdout
    doc = trace_export.validate_chrome_trace(out.read_text())
    assert {"exec.dispatch", "exec.compact", trace.ROOT} <= {
        e["name"] for e in doc["traceEvents"]}
    check = subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.trace_export",
         "--validate", str(out)], env=env, capture_output=True, text=True,
        timeout=300)
    assert check.returncode == 0 and "ok" in check.stdout
