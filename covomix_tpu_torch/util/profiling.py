"""Tracing, profiling and numerics-debug helpers (port of
covomix_tpu/util/profiling.py).

  * `trace`: a torch.profiler trace of the host and the card, written as a
    Chrome / Perfetto trace (`trace.json`) where a directory is given
  * `scope`: a named range, a `record_function` span in the trace and an
    NVTX range on the card
  * `debug_nans`: raises at the first op that produces a NaN (the JAX
    package's jax_debug_nans)
  * `checkify_call`: runs a function and returns (error, value), the error
    naming the first op that produced a NaN or divided by zero (JAX's
    checkify float checks)
  * `device_report`: the PyTorch / CUDA versions and each card's name,
    memory and power limit
  * `idle_share` / `device_idle_share`: a window's device idle share, 1 minus
    the union of the card's activity intervals (kernels, copies, sets) over
    the window's wall time."""

from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
from typing import Optional

import torch
from torch.autograd import DeviceType
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, enabled: bool = True):
    """Profile the host and, where there is one, the card while the block
    runs; yields the profiler (None when not enabled), whose events
    `device_idle_share` reads. With `log_dir` the trace is written there as
    `trace.json`, for Perfetto or chrome://tracing."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def scope(name: str):
    """A named range: `with profiling.scope("t2s_decode"): ...` shows as a
    span in `trace`'s output and as an NVTX range on the card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class _FloatChecks(TorchDispatchMode):
    """Looks at every op's floating outputs; `on_error(message)` at a NaN,
    and with `div` at an Inf that a division of finite operands made."""

    def __init__(self, on_error, div: bool):
        super().__init__()
        self.on_error, self.div = on_error, div

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
                continue
            if bool(torch.isnan(t).any()):
                self.on_error(f"NaN produced by {func}")
                break
            if self.div and func.overloadpacket in (torch.ops.aten.div, torch.ops.aten.div_) \
                    and bool(torch.isinf(t).any()) \
                    and all(bool(torch.isfinite(a).all()) for a in tree_leaves(args) if isinstance(a, torch.Tensor)):
                self.on_error(f"division by zero in {func}")
                break
        return out


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """NanDetector equivalent: inside the block, the first op whose output
    holds a NaN raises FloatingPointError naming the op. Each op's outputs
    are read back, so the block runs slowly and synchronously."""
    if not enabled:
        yield
        return

    def raise_(message):
        raise FloatingPointError(message)

    with _FloatChecks(raise_, div=False):
        yield


class CheckError:
    """What `checkify_call` found: `get()` the message or None, `throw()`
    raises it (the JAX checkify Error's two methods)."""

    def __init__(self, message: Optional[str] = None):
        self.message = message

    def get(self) -> Optional[str]:
        return self.message

    def throw(self):
        if self.message is not None:
            raise FloatingPointError(self.message)


def checkify_call(fn, *args, **kwargs):
    """Run fn(*args, **kwargs) to its end, returning (CheckError, value):
    the error names the first op that produced a NaN or divided finite
    operands into an Inf; use in tests to localize NaN / division faults
    without aborting."""
    found = []

    def record(message):
        if not found:
            found.append(message)

    with _FloatChecks(record, div=True):
        value = fn(*args, **kwargs)
    return CheckError(found[0] if found else None), value


def _power_limits() -> list:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` lines,
    or [] where there is no nvidia-smi."""
    if shutil.which("nvidia-smi") is None:
        return []
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return [line.strip() for line in res.stdout.splitlines() if line.strip()]


def device_report() -> str:
    """The PyTorch and CUDA versions, then one line per card: name, compute
    capability, memory, SMs and the power limit nvidia-smi reads."""
    lines = [f"torch {torch.__version__}; CUDA {torch.version.cuda}; cuDNN {torch.backends.cudnn.version()}"]
    if not torch.cuda.is_available():
        lines.append("  no CUDA device (cpu)")
        return "\n".join(lines)
    limits = _power_limits()
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        limit = limits[i].split(",")[-1].strip() if i < len(limits) else "power limit not read"
        lines.append(f"  {i}: {p.name} (sm_{p.major}{p.minor}, {p.total_memory / 2 ** 30:.1f} GiB, "
                     f"{p.multi_processor_count} SMs), power limit {limit}")
    return "\n".join(lines)


def idle_share(intervals, window) -> float:
    """1 - |union of `intervals` [(start, end)] clipped to `window`| / the
    window's length: the share of the window in which nothing ran."""
    lo, hi = window
    busy, cur_lo, cur_hi = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_hi is None or s > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = s, e
        else:
            cur_hi = max(cur_hi, e)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    return 1.0 - busy / (hi - lo)


def device_idle_share(prof, window: Optional[str] = None) -> dict:
    """The device idle share of a finished `trace`: over the span of the
    `scope` named `window` (its first), or else over the trace from its
    first event to its last. Returns {"idle_share", "window_ms", "busy_ms",
    "device_events"}; device_events 0 means the trace saw no device work."""
    events = list(prof.profiler.kineto_results.events())
    on_device = [e.device_type() != DeviceType.CPU for e in events]
    # a scope's projection onto the device timeline is an annotation, not work
    device = [(e.start_ns(), e.end_ns()) for e, dev in zip(events, on_device) if dev and not e.is_user_annotation()]
    if window is None:
        span = (min(e.start_ns() for e in events), max(e.end_ns() for e in events))
    else:
        spans = [(e.start_ns(), e.end_ns()) for e, dev in zip(events, on_device)
                 if not dev and e.is_user_annotation() and e.name() == window]
        if not spans:
            raise KeyError(f"no scope {window!r} in the trace")
        span = min(spans)
    share = idle_share(device, span)
    return {"idle_share": share, "window_ms": (span[1] - span[0]) / 1e6,
            "busy_ms": (1.0 - share) * (span[1] - span[0]) / 1e6,
            "device_events": sum(1 for s, e in device if e > span[0] and s < span[1])}
