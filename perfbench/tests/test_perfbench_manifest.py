"""BENCHMARK.json against the shapes and character sets it must keep, every
name it gives resolved to a file, and the imports of the harness."""
import ast
import json
import re

import pytest

from perfbench import manifest

BENCH = manifest.load()
ROOT, HERE = manifest.ROOT, manifest.HERE
SOURCES = ("host_clock", "device_trace", "program_span", "program_counter")
ONE_LINE = re.compile(r"[^\t\n\r]{1,200}")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    for name in names:
        assert manifest.NAME.fullmatch(name), name
    for key in ("configs", "workloads"):
        seen = [x["name"] for x in BENCH[key]]
        assert len(seen) == len(set(seen))
    metric_names = [m["name"] for k in ("end_to_end", "per_layer")
                    for m in BENCH[k]]
    assert len(metric_names) == len(set(metric_names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert manifest.UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in BENCH["workloads"]:
        assert ONE_LINE.fullmatch(w["why"])
        assert manifest.NAME.fullmatch(w["traffic"])
    for c in BENCH["configs"]:
        assert ONE_LINE.fullmatch(c["source"]) and ONE_LINE.fullmatch(
            c["why"])
        for key in c["reduced"]:
            assert manifest.NAME.fullmatch(key)
    for m in BENCH["per_layer"]:
        assert ONE_LINE.fullmatch(m["layer"])


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_every_name_resolves_to_a_file():
    cells = {w["name"] for w in BENCH["workloads"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
        cfg = manifest.config(BENCH, c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (HERE / "gen" / f"{cfg['generator']}.py").is_file()
        assert set(cfg["limits"]) == {"pattern_mismatch", "value_err"}
        assert cfg["limits"]["pattern_mismatch"] == 0
        assert set(cfg["widths"]) == {"offset_bytes", "index_bytes",
                                      "value_bytes"}
    for w in BENCH["workloads"]:
        mix = manifest.traffic(w["traffic"])
        assert (HERE / "drivers" / f"{mix['driver']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_what_every_cell_reports():
    e2e = BENCH["end_to_end"]
    assert "setup_s" in [m["name"] for m in e2e]
    for w in BENCH["workloads"]:
        mine = {m["name"] for m in manifest.reported(e2e, w["name"])}
        assert "setup_s" in mine and len(mine) >= 2
        layer = manifest.reported(BENCH["per_layer"], w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in mine, (w["name"], m["name"])


def test_layers_named_once():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"], set()).add(m["name"])
    assert set(by_layer) == {"workflow", "planner", "executor", "kernels",
                             "device"}


def imports_of(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    tops = {name.split(".")[0] for name in imports_of(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_reference_imports_nothing_of_the_program():
    tops = {name.split(".")[0] for name in imports_of(HERE / "reference.py")}
    assert tops <= {"__future__", "math", "typing", "torch"}
