"""Export recorded Ocean spans as Chrome/Perfetto ``trace_event`` JSON.

PyTorch port of ``tools/trace_export.py``, with its own copy of the
logic. The tracer (``repro_torch.obs.trace``) records spans as absolute
``perf_counter`` (t0, duration) pairs per thread; this module rebases
them on the tracer's epoch and emits the Trace Event Format's complete
events (``"ph": "X"``, microsecond ``ts``/``dur``), loadable in
``chrome://tracing`` or https://ui.perfetto.dev. One lane (tid) per
recording thread; synthetic lanes (e.g. the pool's per-request
queue-wait spans) pass through unchanged. The tracer's device spans
(``device.bin``) go to a process of their own,
``device``, one lane per device (and per host thread that launched on it,
where several did). Every event's ``args`` carry its multiply id,
``mid`` (``null`` outside ``ocean_spgemm``).

As a CLI this runs one traced ``ocean_spgemm`` on a CUDA card (``--device
cpu`` runs the plain versions on the CPU) and writes the validated trace:

    PYTHONPATH=src python -m repro_torch.tools.trace_export --out t.json
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from typing import Dict, List

from ..obs.trace import ROOT

# span pairs closer than this are treated as properly nested when
# checking per-lane nesting (float rounding on very short spans)
NEST_TOLERANCE_US = 0.5

HOST_PID, DEVICE_PID = 0, 1


def _device_lanes(tracer) -> List[Dict]:
    """The device spans as complete events on the ``device`` process, one
    lane per (device, launching thread), each lane named."""
    lane_of: Dict = {}
    events: List[Dict] = []
    for ev in tracer.device_events():
        key = (ev["device"], ev["tid"])
        tid = lane_of.setdefault(key, len(lane_of))
        args = dict(ev["attrs"], mid=ev["mid"], device=ev["device"])
        events.append({"name": ev["name"], "ph": "X",
                       "ts": (ev["t0"] - tracer.epoch) * 1e6,
                       "dur": ev["dur"] * 1e6, "pid": DEVICE_PID,
                       "tid": tid, "args": args})
    per_device = collections.Counter(dev for dev, _ in lane_of)
    names = [{"name": "process_name", "ph": "M", "pid": DEVICE_PID,
              "tid": 0, "args": {"name": "device"}}] if lane_of else []
    for (dev, host_tid), tid in lane_of.items():
        label = dev if per_device[dev] == 1 else f"{dev} (thread {host_tid})"
        names.append({"name": "thread_name", "ph": "M", "pid": DEVICE_PID,
                      "tid": tid, "args": {"name": label}})
    return names + events


def to_chrome_trace(tracer) -> Dict:
    """Convert a tracer's recorded spans, host and device, to a Trace
    Event Format dict."""
    events: List[Dict] = []
    for ev in tracer.events():
        args = dict(ev["attrs"], mid=ev["mid"])
        if ev["parent"]:
            args["parent"] = ev["parent"]
        events.append({
            "name": ev["name"],
            "ph": "X",
            "ts": (ev["t0"] - tracer.epoch) * 1e6,
            "dur": ev["dur"] * 1e6,
            "pid": HOST_PID,
            "tid": ev["tid"],
            "args": args,
        })
    events.sort(key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    return {"traceEvents": events + _device_lanes(tracer),
            "displayTimeUnit": "ms"}


def write_chrome_trace(tracer, path: str) -> Dict:
    doc = to_chrome_trace(tracer)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
    return doc


def validate_chrome_trace(text: str) -> Dict:
    """Re-parse an exported trace and check it is well-formed.

    Checks: valid JSON with a ``traceEvents`` list; every event is a
    complete event with the required keys (or a process or thread name's
    metadata event), non-negative ``ts``/``dur``; every multiply id in the
    events' ``args`` has its root span, ``ocean.spgemm``; and within each
    (pid, tid) lane, the device's lanes too, the intervals nest properly —
    sorted by start, every event either fits inside the currently open
    event or starts after it ends (tolerance ``NEST_TOLERANCE_US``).
    Returns the parsed dict; raises ``ValueError`` on any violation."""
    doc = json.loads(text)
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        raise ValueError("traceEvents missing or empty")
    lanes: Dict = {}
    mids, rooted = set(), set()
    for i, e in enumerate(evs):
        if e.get("ph") == "M" and e.get("name") in ("process_name",
                                                     "thread_name"):
            continue
        for k in ("name", "ph", "ts", "dur", "pid", "tid"):
            if k not in e:
                raise ValueError(f"event {i} missing {k!r}: {e}")
        mid = e.get("args", {}).get("mid")
        if mid is not None:
            mids.add(mid)
            if e["name"] == ROOT and e["pid"] == HOST_PID:
                rooted.add(mid)
        if e["ph"] != "X":
            raise ValueError(f"event {i}: expected complete event, "
                             f"got ph={e['ph']!r}")
        if e["dur"] < 0.0 or e["ts"] < -NEST_TOLERANCE_US:
            raise ValueError(f"event {i}: negative ts/dur: {e}")
        lanes.setdefault((e["pid"], e["tid"]), []).append(e)
    if mids - rooted:
        raise ValueError(f"multiply ids {sorted(mids - rooted)} have no "
                         f"{ROOT!r} span")
    for lane, les in lanes.items():
        les.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[Dict] = []
        for e in les:
            end = e["ts"] + e["dur"]
            while stack and e["ts"] >= (stack[-1]["ts"] + stack[-1]["dur"]
                                        - NEST_TOLERANCE_US):
                stack.pop()
            if stack:
                p_end = stack[-1]["ts"] + stack[-1]["dur"]
                if end > p_end + NEST_TOLERANCE_US:
                    raise ValueError(
                        f"lane {lane}: {e['name']!r} "
                        f"[{e['ts']:.1f}, {end:.1f}] overlaps "
                        f"{stack[-1]['name']!r} ending {p_end:.1f}")
            stack.append(e)
    return doc


def _smoke_trace(out: str, executor: str, device: str) -> Dict:
    """Run one traced SpGEMM on ``device`` and write the validated
    trace."""
    import numpy as np
    import torch

    from ..core.formats import csr_from_dense
    from ..core.workflow import ocean_spgemm
    from ..obs import trace

    rng = np.random.default_rng(7)
    a = csr_from_dense(
        (rng.random((256, 192)) < 0.06) * rng.random((256, 192)),
        device=device)
    b = csr_from_dense(
        (rng.random((192, 224)) < 0.08) * rng.random((192, 224)),
        device=device)
    tr = trace.Tracer()
    with trace.tracing(tr):
        _, rep = ocean_spgemm(a, b, cache=False, executor=executor)
        if a.device.type == "cuda":
            torch.cuda.synchronize(a.device)
    doc = write_chrome_trace(tr, out)
    validate_chrome_trace(json.dumps(doc))
    names = {e["name"] for e in doc["traceEvents"]}
    required = {ROOT, "plan.analysis", "plan.prediction", "plan.binning",
                "analysis.wave1", "analysis.wave2", "exec.dispatch",
                "exec.collect", "exec.compact"}
    missing = required - names
    if missing:
        raise SystemExit(f"trace is missing expected spans: "
                         f"{sorted(missing)}")
    print(f"wrote {out}: {len(doc['traceEvents'])} events over "
          f"{len({(e['pid'], e.get('tid')) for e in doc['traceEvents']})} "
          "lanes "
          f"(workflow={rep.workflow}, executor={executor}, "
          f"device={device})")
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="trace.json",
                    help="output trace path (Chrome trace JSON)")
    ap.add_argument("--executor", default="threaded",
                    help="executor for the smoke run "
                         "(serial|pipelined|threaded)")
    ap.add_argument("--device", default="cuda",
                    help="device of the traced call (cuda|cpu)")
    ap.add_argument("--validate", metavar="PATH",
                    help="validate an existing trace file and exit")
    args = ap.parse_args(argv)
    if args.validate:
        with open(args.validate) as fh:
            doc = validate_chrome_trace(fh.read())
        print(f"{args.validate}: ok ({len(doc['traceEvents'])} events)")
        return 0
    _smoke_trace(args.out, args.executor, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
