"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; the configuration's file
names its generator (``gen/<generator>.py``), the traffic file its driver
(``drivers/<driver>.py``), and each per-layer metric is read by
``metrics/<metric>.py``. Nothing here knows a cell by name, so a later
cell, mix or metric is a new file and a new entry, never an edit.
"""
from __future__ import annotations

import importlib
import json
import re
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def checked(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    """The configuration's file, as it is run."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{checked(name)}.json") as f:
        return json.load(f)


def module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py``, imported."""
    return importlib.import_module(f"perfbench.{kind}.{checked(name)}")


def reported(metrics: List[dict], cell_name: str) -> List[dict]:
    """The metrics of a list that ``cell_name`` reports."""
    return [m for m in metrics
            if "workloads" not in m or cell_name in m["workloads"]]
