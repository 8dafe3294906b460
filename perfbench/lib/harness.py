"""One run of one cell: set-up, the measured window, the metrics, the check.

Everything that belongs to one configuration, traffic mix, driver kind or
metric is a file found by name: `BENCHMARK.json` names the cell's
configuration file and its metrics, `perfbench/workloads/<cell>.json` its
driver and traffic, `perfbench/drivers/<driver>.py` the code that drives the
program, `perfbench/metrics/<metric>.py` each metric's reader.

A driver module defines `Driver(ctx)` with
  * `setup()`: builds the program on the seeded weights and warms every
    shape the cell's traffic uses;
  * `step(i) -> dict`: one unit of the closed loop (a call, a file), ended
    by the host copy of its output; the record holds at least `requests`,
    `failed` and `audio_s` or `frames`, and what the metric readers read;
  * `release()`: drops the program's state once the window has closed;
  * `check(control=False) -> [(name, value, limit)]`: the comparison with
    the plain reference (with `control`, the reference in fp8 put in the
    program's place, judged by the same limits);
  * optionally `close()`: removes what set-up wrote (after the check).
A metric module defines `read(ctx) -> float or None` (None: nothing to read;
the metric is then left out of the line)."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch

from perfbench.lib import trace as TR

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_module(kind: str, name: str):
    """perfbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def seed_words(seed: int) -> list:
    """Any whole number (negative, or past 64 bits) as non-negative 32-bit words."""
    s = int(seed) % (1 << 128)
    return [(s >> (32 * i)) & 0xFFFFFFFF for i in range(4)]


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose (weights, inputs, noise, ...) of a run."""
    tag = [ord(ch) for ch in purpose]
    return int(np.random.SeedSequence(seed_words(seed) + tag).generate_state(2, np.uint64)[0] >> np.uint64(1))


@dataclasses.dataclass
class Context:
    """What a driver and the metric readers see of a run."""
    name: str
    seed: int
    device: torch.device
    cfg: dict                      # the configuration file
    wl: dict                       # the workload file
    trace: bool
    spans: TR.Spans
    records: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    setup_s: float = 0.0
    view: Optional[TR.TraceView] = None
    traced_steps: int = 0
    peak: Optional[dict] = None    # the card's peaks ("bf16_flops", "bytes_s") or None
    wrapped: list = dataclasses.field(default_factory=list)   # (module, attribute, original) replaced

    def rng(self, purpose: str) -> np.random.Generator:
        return np.random.default_rng(sub_seed(self.seed, purpose))

    def generator(self, purpose: str) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, purpose))

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


PEAKS = {   # NVIDIA's H100 SXM data sheet: dense bf16 tensor-core FLOP/s, HBM3 bytes/s
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "bytes_s": 3.35e12},
}


def cell_metrics(bench: dict, name: str):
    """(end-to-end metrics, per-layer metrics) of BENCHMARK.json that the
    cell `name` reports."""
    has = lambda m: "workloads" not in m or name in m["workloads"]
    return [m for m in bench["end_to_end"] if has(m)], [m for m in bench["per_layer"] if has(m)]


def passes(checks, failed: int = 0) -> bool:
    """The verdict on a run's checks: no request failed, and every compared
    number is there, finite and within its limit."""
    return failed == 0 and bool(checks) and all(
        v is not None and math.isfinite(v) and lim is not None and v <= lim for _, v, lim in checks)


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, log=None, overrides: Optional[dict] = None,
             control: bool = False):
    """One run of cell `name`; returns (result line dict, checks
    [(name, value, limit)]). `overrides` replaces top-level keys of the
    workload file (tests: tiny traffic). `control` adds the control's
    readings (`driver.check(control=True)`) to the line as `control`, and
    its verdict by the same test as `correct` as `control_correct`."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(f"# {msg}", file=sys.stderr, flush=True))
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    dev = torch.device(device)
    ctx = Context(name, seed, dev, load_json(os.path.join(ROOT, conf["file"])),
                  {**load_json(os.path.join(BENCH_DIR, "workloads", name + ".json")), **(overrides or {})}, trace, None)
    ctx.spans = TR.Spans(ctx.sync if trace else (lambda: None))
    if dev.type == "cuda":
        ctx.peak = PEAKS.get(torch.cuda.get_device_name(dev))
        torch.cuda.reset_peak_memory_stats(dev)
    driver = load_module("drivers", ctx.wl["driver"]).Driver(ctx)
    driver.setup()
    ctx.sync()
    ctx.setup_s = time.perf_counter() - t_start
    log(f"{name} seed {seed}: set-up {ctx.setup_s:.3f} s")

    trace_steps = ctx.wl["trace_steps"] if trace else 0
    traced = contextlib.ExitStack()
    prof = None

    def end_trace(steps):
        ctx.sync()
        traced.close()
        ctx.traced_steps = steps

    t0 = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t0 < seconds:
        if i == 0 and trace_steps:
            prof = traced.enter_context(torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]))
            traced.enter_context(torch.profiler.record_function(TR.WINDOW))
        ctx.spans.call = i
        t_step = time.perf_counter()
        try:
            with ctx.spans.span(ctx.wl["entry_span"]) if trace else contextlib.nullcontext():
                rec = driver.step(i)
        except Exception:   # a step that raises counts its requests as failed; the window goes on
            log(f"step {i} failed:\n{traceback.format_exc()}")
            n = ctx.wl.get("requests_per_step", 1)
            rec = {"requests": n, "failed": n}
        rec["wall_s"] = time.perf_counter() - t_step
        ctx.records.append(rec)
        i += 1
        if prof is not None and i == trace_steps:
            end_trace(i)
    ctx.window_s = time.perf_counter() - t0
    ctx.spans.call = -1
    if prof is not None and not ctx.traced_steps:
        end_trace(i)
    log(f"window {ctx.window_s:.3f} s, {i} steps of " + " ".join(f"{r['wall_s']:.4f}" for r in ctx.records) + " s")

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0}
    line = {}
    if trace:
        ctx.view = TR.read_trace(prof) if prof is not None else None
        if ctx.view is not None:
            device_info["busy_s"] = ctx.view.busy_s
            device_info["window_s"] = ctx.view.window_s
            line["breakdown"] = {"device_ops": ctx.view.by_kernel(), "idle_gaps": ctx.view.idle_gaps()}
    e2e, layer = cell_metrics(bench, name)
    metrics = {}
    for m in (layer if trace else e2e):
        value = ctx.setup_s if m["name"] == "setup_s" else load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    for k, v in driver.counters().items():
        log(f"counter {k} = {v}")

    attempted = sum(int(r["requests"]) for r in ctx.records)
    failed = sum(int(r["failed"]) for r in ctx.records)
    driver.release()
    checks = driver.check(control=False)
    correct = passes(checks, failed)
    line.update({"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
                 "device": device_info})
    if control:
        control_checks = driver.check(control=True)
        line["control_correct"] = passes(control_checks)
        line["control"] = {n: {"value": v, "limit": lim} for n, v, lim in control_checks}
    line["checked"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    getattr(driver, "close", lambda: None)()
    return line, checks
