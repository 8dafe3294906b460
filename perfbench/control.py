#!/usr/bin/env python3
"""Readings that set a cell's limits: for each seed, one short run of the
cell (set-up, `--seconds` of its traffic) and then both comparisons on what
it served: the program against the f32 reference (the lower readings) and
the control, the reference computed in fp8 e4m3 (one precision below the
configurations' bf16) put in the program's place and judged by the same
limits (the upper readings). With `--fault <name>` (perfbench/lib/faults.py)
the program runs with that fault planted and only its readings are taken.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 8 [--fault <name>]

Runs every seed in one process (the kernels are built and the decode
graphs captured once); one JSON line per seed on standard output, with
`correct` (the program's verdict) and `control_correct` (the control's).
Exits 1 where a seed's control, or a run with a fault planted, comes out
correct: the control has to fail the cell's limits. Needs a CUDA card; the
benchmark's own runs never run it."""

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Program and control readings of a cell, per seed.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--fault", default=None, help="a fault of perfbench/lib/faults.py to plant")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from run import cache_dirs
    cache_dirs()

    import torch

    from perfbench.lib import faults, harness

    if not torch.cuda.is_available():
        print("control readings are taken on a CUDA card", file=sys.stderr)
        return 3
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    passed = []
    for seed in (int(s) for s in args.seeds.split(",") if s):
        with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
            line, _ = harness.run_cell(bench, args.workload, seed, args.seconds, False, control=not args.fault)
        out = {"seed": seed, "correct": line["correct"], "program": line["checked"], "attempted": line["attempted"]}
        if args.fault:
            out["fault"] = args.fault
            passed.append(line["correct"])
        else:
            out.update(control_correct=line["control_correct"], control=line["control"])
            passed.append(line["control_correct"])
        print(json.dumps(out), flush=True)
    if any(passed):
        print(f"{'the fault' if args.fault else 'the control'} came out correct on "
              f"{sum(passed)} of {len(passed)} seeds", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
