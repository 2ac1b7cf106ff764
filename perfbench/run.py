"""Run one cell of ``BENCHMARK.json`` and print its result as one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration file makes the inputs from the seed on the card;
the traffic's driver warms up every shape the cell uses (set-up), then
multiplies for ``--seconds`` through the port's entry,
``repro_torch.core.workflow.ocean_spgemm``. Once the window has closed
the run reads the card's peak memory, empties the port's plan cache and
holds two of the window's outputs (multiply ``seed % 2`` and the last)
to the plain reference (``reference.py``). With ``--trace 0`` the result
carries the cell's end-to-end metrics; with ``--trace 1`` the window runs
under the port's span tracer and ``torch.profiler``, and the result
carries its per-layer metrics and a ``breakdown``. Each compared number is
printed beside its limit, last on standard error and last in the result.

It refuses to run without as many CUDA devices as the cell asks for, and
prints no result if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # process start, for setup_s

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    # any build or kernel cache of the program stays inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / ".perfbench_cache" / sub)

import torch  # noqa: E402

from perfbench import devtrace, manifest, reference, work  # noqa: E402
from perfbench.context import TraceContext  # noqa: E402
from perfbench.program import Port  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w(device: torch.device):
    """The card's power limit from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def check(held, ops, cfg):
    """Readings of every held C against the reference; the worst of each."""
    a, rhs = ops.a, ops.rhs
    found = {"pattern_mismatch": 0, "value_err": 0.0, "nnz_c": 0}
    failed = 0
    limits = cfg["limits"]
    for _, (v, c) in sorted(held.items()):
        got = reference.compare(
            (c.indptr, c.indices, c.values, c.nnz),
            (a.indptr, a.indices, a.values[v]),
            (rhs.indptr, rhs.indices, rhs.values[v]), rhs.shape[1])
        failed += not passes(got, limits)
        found["pattern_mismatch"] += got["pattern_mismatch"]
        found["value_err"] = (math.nan if math.isnan(got["value_err"])
                              else max(found["value_err"], got["value_err"]))
        found["nnz_c"] = got["nnz_c"]
    return found, failed


def passes(readings, limits) -> bool:
    # a NaN reading compares false, so it fails
    return all(readings[k] <= limit for k, limit in limits.items())


def run(bench: dict, cell: dict, seed: int, seconds: float, traced: bool,
        device: torch.device, *, port=None, config_override=None):
    """One run of ``cell`` on ``device``. Returns the result dict, or None
    where JAX or the JAX package was loaded."""
    cfg = manifest.config(bench, cell["config"])
    cfg.update(config_override or {})
    mix = manifest.traffic(cell["traffic"])
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    port = Port() if port is None else port
    port.build_kernels(device)
    pinned = port.pin_hash_tuning(device)
    gen = manifest.module("gen", cfg["generator"])
    ops = gen.make(cfg, seed, mix["value_sets"], device)
    driver = manifest.module("drivers", mix["driver"]).make(port, ops, mix,
                                                            sync)
    warmup_wall = driver.warm_up()

    tracer, capture = None, None
    if traced:
        tracer = port.trace.Tracer()
        port.trace.install(tracer)
        if on_card:
            capture = devtrace.Capture(device).__enter__()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    try:
        window = driver.measure(seconds, keep=seed % 2)
    finally:
        if capture is not None:
            capture.__exit__(None, None, None)
        if tracer is not None:
            port.trace.install(None)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return None

    reports = [r.report for r in window.records]
    print(f"perfbench: {cell['name']} seed {seed}: set-up multiply "
          f"{warmup_wall:.4f} s, window "
          f"{[round(r.t1 - r.t0, 4) for r in window.records]} s, "
          f"workflow {getattr(reports[0], 'workflow', None)}, "
          f"hash tuner pinned {pinned}, "
          f"bins {getattr(reports[0], 'bins', None)}", file=sys.stderr)
    held = window.held
    del window.records, driver
    port.forget_plans()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings, failed = check(held, ops, cfg)
    correct = failed == 0
    print(f"perfbench: check of {len(held)} outputs took "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    del held

    n = len(reports)
    span = window.t_end - window.t_start
    total_products = work.products(ops)
    wk = {"rows": ops.a.shape[0], "inner": ops.rhs.shape[0],
          "cols": ops.rhs.shape[1], "nnz_a": ops.a.nnz,
          "nnz_b": ops.rhs.nnz, "nnz_c": readings["nnz_c"],
          "products": total_products, "same_operand": ops.b is None}
    print(f"perfbench: work of a multiply {wk}", file=sys.stderr)
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card
           else device.type,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak),
           "power_limit_w": power_limit_w(device) if on_card else None}
    metrics = {}
    result = {"correct": correct, "attempted": n, "failed": failed}
    if not traced:
        values = {"gflops": n * work.flops(ops) / span / 1e9,
                  "peak_mem_gib": peak / GIB,
                  "setup_s": window.t_start - T0}
        for m in manifest.reported(bench["end_to_end"], cell["name"]):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        events = capture.events if capture is not None else []
        w0, w1 = window.t_start, window.t_end
        inside = devtrace.clip(events, w0, w1)
        ctx = TraceContext(
            reports=reports, device_events=inside, window=(w0, w1),
            work=wk, widths=cfg["widths"],
            peaks=peaks().get(dev["kind"]) if on_card else None)
        for m in manifest.reported(bench["per_layer"], cell["name"]):
            value = manifest.module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = devtrace.covered(inside)
        dev["window_s"] = w1 - w0
        bd = devtrace.breakdown(events, devtrace.spans_of(tracer), w0, w1)
        if bd is not None:
            result["breakdown"] = bd
    result["metrics"] = metrics
    result["device"] = dev
    limits = cfg["limits"]
    result["checks"] = {k: {"value": readings[k], "limit": limits[k]}
                        for k in limits}
    for k in limits:
        print(f"check {k} {readings[k]!r} limit {limits[k]!r}",
              file=sys.stderr)
    return result


def peaks() -> dict:
    with open(manifest.HERE / "peaks.json") as f:
        return json.load(f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; refusing to measure",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {cell['name']} needs {cell['chips']} CUDA "
              f"devices, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run(bench, cell, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0))
    if result is None:
        return 1
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
