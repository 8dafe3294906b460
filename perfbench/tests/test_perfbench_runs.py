"""Whole runs of each cell's driver at tiny sizes on the CPU: a sound run
prints a contract line and comes out correct, a run with the timed path
broken comes out not correct, nothing loads JAX, a new cell is found by its
files alone, and the command refuses to run without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench.lib import faults
from perfbench.lib import harness
from perfbench.tests import tiny

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(tmp_path, cell, trace=False, seed=2 ** 31 + 11):
    torch.set_num_threads(4)
    return harness.run_cell(tiny.bench(tmp_path, BENCH), cell, seed, 0.3, trace, device="cpu",
                            overrides=tiny.OVERRIDES[cell], log=lambda msg: None)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_sound_run(tmp_path, cell, trace):
    line, checks = _run(tmp_path, cell, trace)
    assert list(line)[-1] == "checked"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    e2e, layer = harness.cell_metrics(BENCH, cell)
    if trace:   # on the CPU the span metrics are read, the device metrics find nothing
        spans = {m["name"] for m in layer if m["source"] == "program_span"}
        assert set(line["metrics"]) == spans
    else:
        assert set(line["metrics"]) == {m["name"] for m in e2e}
    json.dumps(line)


def _applies(cell, fault):
    wl = harness.load_json(os.path.join(harness.BENCH_DIR, "workloads", cell + ".json"))
    return faults.applies(fault, {**wl, **tiny.OVERRIDES[cell]})


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in faults.FAULTS if _applies(c, f)])
def test_broken_path_is_not_correct(tmp_path, cell, fault):
    with faults.planted(fault):
        line, _ = _run(tmp_path, cell, seed=5)
    assert not line["correct"], line["checked"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(tmp_path, cell):
    """At a tiny size on the CPU (f32 program), the fp8 reference put in the
    program's place reads at least three times the program on one number
    and comes out not correct (the card's readings at the cell's size set
    the limits: test_control_on_the_card)."""
    torch.set_num_threads(4)
    line, _ = harness.run_cell(tiny.bench(tmp_path, BENCH), cell, 9, 0.3, False, device="cpu",
                               overrides=tiny.OVERRIDES[cell], log=lambda msg: None, control=True)
    assert line["correct"] and line["control_correct"] is False
    assert any(line["control"][k]["value"] > 3 * line["checked"][k]["value"] > 0 or
               line["control"][k]["value"] > 0 == line["checked"][k]["value"] for k in line["checked"]), line


CHILD = """
import json, sys
sys.path.insert(0, {repo!r}); sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from perfbench.lib import faults, harness
from perfbench.tests import tiny
bench = harness.load_json({root!r} + "/BENCHMARK.json")
bench = tiny.bench({tmp!r}, bench)
run = lambda: harness.run_cell(bench, {cell!r}, 3, 0.2, False, device="cpu", overrides={overrides!r},
                               log=lambda m: None)[0]["correct"]
res = {{"correct": run()}}
if {fault!r}:
    with faults.planted({fault!r}):
        res["fault_correct"] = run()
res["forbidden"] = sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "covomix_tpu"}})
print(json.dumps(res))
"""

# (new cell, the cell whose entries it copies, its traffic, a fault that has to fail it):
# a copy of the serving cell, and VoMix recipe training (Acous_VoMix.sh's
# step), which waits out of BENCHMARK.json for the port's bf16 embedding
# gradient (PERF.md, Open questions) and is run here through the same driver
NEW_CELLS = [
    ("covomix.serve_b64_copy", "covomix.serve_b64", None, None),
    ("covomix.train_vomix", "covomix.train_t2s",
     {"model": "acoustic", "batch": 2, "frames": 40, "k": 2, "lr": 1e-4, "cond_drop_prob": 0.3,
      "mask_frac": [0.3, 0.7]}, "acoustic_half_batch"),
]


@pytest.mark.parametrize("new,base,traffic,fault", NEW_CELLS, ids=[c[0] for c in NEW_CELLS])
def test_new_cell_found_by_its_files_and_no_jax(tmp_path, new, base, traffic, fault):
    """A copy of the benchmark gains a cell by a new workload file and a
    BENCHMARK.json entry alone; its run loads no JAX and no JAX package, and
    a fault planted under it makes it not correct."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    wl = harness.load_json(os.path.join(harness.BENCH_DIR, "workloads", base + ".json"))
    overrides = dict(tiny.OVERRIDES[base], **({"traffic": traffic} if traffic else {}))
    (root / "perfbench" / "workloads" / (new + ".json")).write_text(json.dumps(dict(wl, **overrides)))
    entry = next(w for w in bench["workloads"] if w["name"] == base)
    bench["workloads"].append({**entry, "name": new, "traffic": new.split(".", 1)[1]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if base in m.get("workloads", []):
            m["workloads"].append(new)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = CHILD.format(root=str(root), repo=harness.ROOT, tmp=str(tmp_path), cell=new, overrides=overrides,
                        fault=fault)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=str(root))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "forbidden": [], **({"fault_correct": False} if fault else {})}


def test_command_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run([sys.executable, os.path.join(harness.BENCH_DIR, "run.py"), "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    out = subprocess.run([sys.executable, os.path.join(harness.BENCH_DIR, "run.py"), "--workload", cell,
                          "--seed", str(2 ** 31 + 77), "--seconds", "5", "--trace", "0"], capture_output=True,
                         text=True, timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(card, cell):
    """The control at the cell's own size on three seeds: every seed's
    program reading comes out correct and every seed's control not correct
    (control.py exits 1 where a control reads correct)."""
    out = subprocess.run([sys.executable, os.path.join(harness.BENCH_DIR, "control.py"), "--workload", cell,
                          "--seeds", "101,102,103", "--seconds", "6"], capture_output=True, text=True,
                         timeout=1800, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert len(lines) == 3
    for res in lines:
        assert res["correct"] and res["control_correct"] is False, res
