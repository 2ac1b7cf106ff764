"""A run of every cell, driven on the CPU at a small size with the port's
plain versions (the harness's look for a card skipped), sound and with
the timed path broken underneath; and the command's refusals."""
import json
import subprocess
import sys

import pytest
import torch

from perfbench import manifest, reference
from perfbench import run as bench_run
from perfbench.program import Port

BENCH = manifest.load()
SMALL = {"fem-q1-elasticity": {"nodes": [4, 4, 3]},
         "graph500-rmat-s15": {"scale": 8}}
CELLS = [w["name"] for w in BENCH["workloads"]]
CPU = torch.device("cpu")


FORBIDDEN_MODULES = bench_run.forbidden_modules


@pytest.fixture(autouse=True)
def own_tuning_cache(monkeypatch):
    """A run pins the port's process-wide hash tuning; keep that to the
    test. Other test files of this process load JAX and the JAX package,
    so the run here looks only for what the test itself loads."""
    Port()  # puts the checkout's src on the path
    from repro_torch.core import tuning
    monkeypatch.setattr(tuning, "DEFAULT_TUNING_CACHE", tuning.TuningCache())
    before = set(sys.modules)
    monkeypatch.setattr(bench_run, "forbidden_modules", lambda: sorted(
        {n.split(".")[0] for n in set(sys.modules) - before}
        & set(bench_run.FORBIDDEN)))
    return tuning


def run_cell(name, port=None, traced=False, seed=2**31 + 3):
    cell = manifest.cell(BENCH, name)
    return bench_run.run(BENCH, cell, seed, 0.2, traced, CPU, port=port,
                         config_override=SMALL[cell["config"]])


def altered(c, indptr=None, indices=None, values=None, nnz=None):
    return type(c)(c.indptr if indptr is None else indptr,
                   c.indices if indices is None else indices,
                   c.values if values is None else values, c.shape,
                   c.nnz if nnz is None else nnz)


class Faulty(Port):
    """The port with one fault planted where C is produced."""

    def __init__(self, fault):
        super().__init__()
        self.fault = fault
        self.first = None

    def multiply(self, a, b, plan_cache):
        c, rep = super().multiply(a, b, plan_cache)
        if self.fault == "stale":              # a result that never moves
            self.first = self.first or c
            return self.first, rep
        ptr = c.indptr.clone()
        if self.fault == "value":              # one answer altered
            vals = c.values.clone()
            vals[c.nnz // 2] += 0.01
            return altered(c, values=vals), rep
        if self.fault == "column":
            idx = c.indices.clone()
            row = int(torch.argmax(ptr[1:] - ptr[:-1]))
            idx[ptr[row]] = idx[ptr[row] + 1]
            return altered(c, indices=idx), rep
        # half the rows left out
        m = c.shape[0]
        ptr[m // 2 + 1:] = ptr[m // 2]
        return altered(c, indptr=ptr, nnz=int(ptr[-1])), rep


class Control(Port):
    """The reference one precision lower, in the program's place."""

    def multiply(self, a, b, plan_cache):
        c = reference.control((a.indptr.long(), a.indices.long(), a.values),
                              (b.indptr.long(), b.indices.long(), b.values),
                              b.shape[1], max_products=5000)
        return altered(a, indptr=c[0].int(), indices=c[1].int(),
                       values=c[2], nnz=c[3]), None


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, capsys):
    res = run_cell(name)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in manifest.reported(
        BENCH["end_to_end"], name)}
    assert all(m["value"] > 0 for k, m in res["metrics"].items()
               if k != "peak_mem_gib")      # the CPU has no card memory
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-2].startswith("check pattern_mismatch 0 limit 0")
    assert err[-1].startswith("check value_err ")
    json.dumps(res)


@pytest.mark.parametrize("name", ["fem-cold", "rmat-warm"])
def test_traced_run_reads_the_port(name):
    res = run_cell(name, traced=True)
    assert res["correct"]
    want = {m["name"] for m in manifest.reported(BENCH["per_layer"], name)}
    # the device metrics need a card; the port's spans and counters not
    assert set(res["metrics"]) == want - {"kernel_roofline_pct",
                                          "idle_pct"}
    assert res["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", ["value", "column", "half", "stale"])
@pytest.mark.parametrize("name", ["fem-warm", "rmat-cold"])
def test_broken_timed_path_is_not_correct(name, fault):
    res = run_cell(name, port=Faulty(fault))
    assert res["correct"] is False and res["failed"] >= 1


@pytest.mark.parametrize("name", ["fem-cold", "rmat-cold"])
def test_control_is_not_correct(name):
    res = run_cell(name, port=Control())
    assert res["correct"] is False
    assert res["checks"]["pattern_mismatch"]["value"] == 0
    assert res["checks"]["value_err"]["value"] > (
        res["checks"]["value_err"]["limit"])


def test_hash_tuning_pinned_to_the_default(own_tuning_cache):
    tuning = own_tuning_cache
    assert Port().pin_hash_tuning(CPU)
    for rung in (32, 256, 2048):
        assert tuning.hash_tuning_for(rung, device="cpu") == (
            tuning.DEFAULT_TUNING)
    assert tuning.DEFAULT_TUNING_CACHE.stats()["misses"] == 0


def test_no_pin_where_the_port_has_no_timed_tuner(own_tuning_cache,
                                                  monkeypatch):
    monkeypatch.delattr(own_tuning_cache, "DEFAULT_TUNING_CACHE")
    assert Port().pin_hash_tuning(CPU) is False


def test_jax_loaded_gives_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.perfbench_probe", object())
    monkeypatch.setitem(sys.modules, "repro.perfbench_probe", object())
    assert {"jax", "repro"} <= set(FORBIDDEN_MODULES())
    assert "repro_torch" not in FORBIDDEN_MODULES()
    assert run_cell("fem-cold") is None


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_run.main(["--workload", "fem-cold", "--seed", "1",
                           "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_needs_the_program(tmp_path):
    """A directory with only BENCHMARK.json and perfbench/ gives no result."""
    import shutil
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "fem-cold",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_device_trace_on_the_card(card):
    from perfbench import devtrace
    x = torch.ones(1 << 20, device=card)
    with devtrace.Capture(card) as cap:
        t0 = __import__("time").perf_counter()
        for _ in range(5):
            x = x * 2
        torch.cuda.synchronize(card)
        t1 = __import__("time").perf_counter()
    inside = devtrace.clip(cap.events, t0 - 1e-3, t1 + 1e-3)
    assert sum(devtrace.kind_of(e[2]) == "kernel" for e in inside) == 5
