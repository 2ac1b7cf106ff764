"""Render the dry-run's roofline table from its sweep JSONs.

The port of ``repro.launch.report``: the same table, its memory column
against the H100's 80 GB (``fits 80G``).

    PYTHONPATH=src python -m repro_torch.launch.report dryrun.json
"""
from __future__ import annotations

import json
import sys


def fmt_cell(r):
    if r["status"] == "skipped":
        return (f"| {r['arch']} | {r['shape']} | — | skipped | | | | | | "
                f"{r['reason'][:70]} |")
    if r["status"] == "error":
        return (f"| {r['arch']} | {r['shape']} | — | ERROR | | | | | | "
                f"{r.get('error','')[:70]} |")
    rf = r.get("roofline", {})
    gb = (r.get("per_device_bytes") or 0) / 1e9
    coll = rf.get("collective_s", 0.0)
    return ("| {arch} | {shape} | {policy} | ok | {gb:.2f} | {fits} | "
            "{c:.4f} | {m:.4f} | {k:.4f} | {b} ({u}) |").format(
        arch=r["arch"], shape=r["shape"], policy=r.get("policy", ""),
        gb=gb, fits="yes" if r.get("fits_80g") else "no",
        c=rf.get("compute_s", 0.0), m=rf.get("memory_s", 0.0), k=coll,
        b=rf.get("bottleneck", "?"),
        u=f"useful={rf.get('useful_ratio'):.3f}"
        if rf.get("useful_ratio") else "")


def render(path: str) -> str:
    with open(path) as f:
        rs = json.load(f)
    lines = [
        "| arch | shape | policy | status | GB/dev | fits 80G | compute_s |"
        " memory_s | collective_s | bottleneck |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rs:
        lines.append(fmt_cell(r))
    n_ok = sum(r["status"] == "ok" for r in rs)
    n_skip = sum(r["status"] == "skipped" for r in rs)
    n_err = sum(r["status"] == "error" for r in rs)
    n_fit = sum(bool(r.get("fits_80g")) for r in rs)
    lines.append("")
    lines.append(f"cells: {len(rs)} | ok: {n_ok} | skipped (documented): "
                 f"{n_skip} | errors: {n_err} | fit <80 GB/chip: {n_fit}")
    return "\n".join(lines)


def collective_detail(path: str, arch: str, shape: str) -> str:
    with open(path) as f:
        rs = json.load(f)
    for r in rs:
        if r["arch"] == arch and r["shape"] == shape:
            out = []
            for op, s in r.get("totals", {}).get("collectives", {}).items():
                out.append(f"{op}: n={s['count']:.0f} "
                           f"bytes={s['bytes']/1e6:.1f}MB")
            return "; ".join(out)
    return "n/a"


if __name__ == "__main__":
    for p in sys.argv[1:]:
        print(f"\n### {p}\n")
        print(render(p))
