"""Readings that the limits of ``correct`` are set from, at a cell's size.

    python3 perfbench/readings.py --config <config> --seeds 1 2 ... \
        --control-seeds 1 2 3 [--out <file.jsonl>]

For each seed it makes the configuration's inputs as a run does and
multiplies through the port twice, as the two traffic mixes do: once
planning from scratch (value set 0) and once replaying a cached plan with
other values (value set 1), and compares each C with the reference: the
lower readings. For each control seed it compares the control (the
reference one precision lower, in the program's place) with the
reference: the upper readings. One JSON line a reading. The benchmark's
own runs do not run this; it needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from perfbench import manifest, reference  # noqa: E402
from perfbench.program import Port  # noqa: E402


def triple(m, v):
    return m.indptr, m.indices, m.values[v]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cfg = manifest.config(manifest.load(), args.config)
    gen = manifest.module("gen", cfg["generator"])
    port = Port()
    port.build_kernels(dev)
    port.pin_hash_tuning(dev)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in args.seeds:
        ops = gen.make(cfg, seed, 2, dev)
        a_ptr, a_idx = ops.a.indptr.int(), ops.a.indices.int()
        csr = [port.csr(a_ptr, a_idx, ops.a.values[v], ops.a.shape)
               for v in range(2)]
        for traffic, v, cache in (("cold", 0, False), ("warm", 1, True)):
            if cache:
                port.multiply(csr[0], csr[0], True)
            t0 = time.perf_counter()
            c, rep = port.multiply(csr[v], csr[v], cache)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            got = reference.compare((c.indptr, c.indices, c.values, c.nnz),
                                    triple(ops.a, v), triple(ops.a, v),
                                    ops.a.shape[1])
            emit({"config": args.config, "kind": "program",
                  "traffic": traffic, "seed": seed, "wall_s": wall,
                  "workflow": rep.workflow, "hit": rep.plan_cache_hit,
                  "overflow_rows": rep.overflow_rows, **got})
            del c, rep
        port.forget_plans()
        del ops, csr
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        ops = gen.make(cfg, seed, 1, dev)
        args3 = (triple(ops.a, 0), triple(ops.a, 0), ops.a.shape[1])
        got = reference.compare(reference.control(*args3), *args3)
        emit({"config": args.config, "kind": "control", "seed": seed,
              **got})
        del ops
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
