#!/usr/bin/env python3
"""The benchmark of covomix_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads BENCHMARK.json beside this folder for the cell's configuration and
metrics, builds the program on weights drawn from the seed, warms the
cell's shapes (set-up), drives the cell's closed loop for `--seconds`,
then checks what the window produced against the plain reference
(`perfbench/reference/`). Progress and the compared numbers go to standard
error; the last line of standard output is one JSON object: correct,
attempted, failed, metrics (end-to-end with --trace 0, per-layer with
--trace 1), device, and last `checked` (each compared number and its limit).
Exits 3 without a result where no CUDA card (or too few) is visible, and 4
where the process has loaded JAX or the JAX package."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "covomix_tpu")


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell (see the module doc).")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, ROOT)

    import torch

    from perfbench.lib import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    line, checks = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                                    t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"the process loaded {', '.join(found)}: the benchmark measures covomix_tpu_torch alone",
              file=sys.stderr)
        return 4
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
