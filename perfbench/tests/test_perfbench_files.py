"""BENCHMARK.json and the files it names: every configuration, workload,
driver and metric is a file found by name, and the entries agree."""

import ast
import json
import os
import re

import pytest

from perfbench.lib import harness
from perfbench.reference import spec

ROOT = harness.ROOT
BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"]}) == \
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"].startswith("perfbench/configs/")
    data = harness.load_json(os.path.join(ROOT, conf["file"]))
    assert data["reduced"] == conf["reduced"]
    for part in ("t2s", "acoustic", "vocoder"):
        assert getattr(spec, part)(data[part])
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_workload_file(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"} and cell["chips"] in (1, 4)
    assert 1 <= len(cell["why"]) <= 200
    wl = harness.load_json(os.path.join(harness.BENCH_DIR, "workloads", cell["name"] + ".json"))
    assert os.path.isfile(os.path.join(harness.BENCH_DIR, "drivers", wl["driver"] + ".py"))
    assert set(wl["limits"]) and all(v is not None for v in wl["limits"].values())
    e2e, layer = harness.cell_metrics(BENCH, cell["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(metric):
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    assert metric["better"] in ("lower", "higher") and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", metric["unit"])
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25
        if metric["name"] == "setup_s":
            return
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moves = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moves.get("workloads", cells))
        if metric["name"].split(".")[0].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
    path = os.path.join(harness.BENCH_DIR, "metrics", metric["name"] + ".py")
    assert callable(harness.load_module("metrics", metric["name"]).read), path


def test_layers_are_spelled_alike():
    by_name = {}
    for m in BENCH["per_layer"]:
        by_name.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_name.values())


def test_every_file_is_used():
    """Every cell has its workload file and every workload file its cell,
    every metric its reader."""
    files = {f[:-len(".json")] for f in os.listdir(os.path.join(harness.BENCH_DIR, "workloads"))}
    assert {w["name"] for w in BENCH["workloads"]} == files
    for f in files:
        wl = harness.load_json(os.path.join(harness.BENCH_DIR, "workloads", f + ".json"))
        assert os.path.isfile(os.path.join(harness.BENCH_DIR, "drivers", wl["driver"] + ".py"))
    metrics = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]} - {"setup_s"}
    assert {f[:-3] for f in os.listdir(os.path.join(harness.BENCH_DIR, "metrics")) if f.endswith(".py")} == metrics


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(harness.BENCH_DIR, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert tops <= {"__future__", "contextlib", "math", "typing", "numpy", "scipy", "torch", "perfbench"}, f
            assert all(m.startswith("perfbench.reference") for m in _imports(os.path.join(ref, f))
                       if m.split(".")[0] == "perfbench"), f
