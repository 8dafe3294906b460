"""Tracing, profiling and numerics-debug helpers (port of
covomix_tpu/util/profiling.py).

  * `trace`: a torch.profiler trace of the host and the card, written as a
    Chrome / Perfetto trace (`trace.json`) where a directory is given
  * `scope`: a named range of the program's hot path (`serve.*`, `file.*`,
    `t2s.*`, `flow.*`, `vocoder.*`, `train.*`), a `record_function` range
    while a profiler runs and nothing else otherwise
  * `debug_nans`: raises at the first op that produces a NaN (the JAX
    package's jax_debug_nans)
  * `checkify_call`: runs a function and returns (error, value), the error
    naming the first op that produced a NaN or divided by zero (JAX's
    checkify float checks)
  * `device_report`: the PyTorch / CUDA versions and each card's name,
    memory and power limit
  * `idle_share` / `device_idle_share`: a window's device idle share, 1 minus
    the union of the card's activity intervals (kernels, copies, sets) over
    the window's wall time
  * `device_time_by_kernel`: the card's time in a trace by kernel name.

Where the host time of a few calls goes:

    from covomix_tpu_torch.util import profiling
    with profiling.trace("trace_dir"):
        for text, prompt in files[:3]:
            synth.monologue("covosingle", text, prompt, gen)

writes `trace_dir/trace.json`; open it in Perfetto (ui.perfetto.dev). The
host row shows the program's scopes (`file.call`, then `t2s.generate` >
`t2s.encode` / `t2s.prepare` / `t2s.read` ..., `flow.sample` > `flow.step`,
`vocoder.generator`), the device rows the kernels on the same clock, so
each idle stretch of the card lies under the scope the host was in. The
profiler slows the host's launches (graph replays most), so a traced call
idles the card more than an untraced one. For Nsight Systems run the calls under `torch.autograd.profiler.
emit_nvtx()` instead: the scopes then become NVTX ranges. Scopes stop at a
captured CUDA graph's edge: a replay is one launch to the host, so the
decode step's and the training step's own phases are not seen."""

from __future__ import annotations

import contextlib
import functools
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


_NO_SCOPE = contextlib.nullcontext()


class _Numbered:
    """A profiler range that keeps numbers (a call count, a shape) as its
    inputs."""

    __slots__ = ("name", "numbers", "handle")

    def __init__(self, name: str, numbers: tuple):
        self.name, self.numbers, self.handle = name, numbers, None

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(self.name, *self.numbers)

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self.handle)
        return False


def scope(name: str, *numbers: int):
    """A named range: `with profiling.scope("t2s.read"): ...` shows as a
    span in `trace`'s output (and as an NVTX range under
    `torch.autograd.profiler.emit_nvtx`). `numbers` (a call count, a shape)
    are kept with the range as its inputs: the trace shows them (`Concrete
    Inputs`) where the profiler records shapes (`record_shapes=True`).
    With no profiler running it returns a shared do-nothing context after
    one check, so the hot path may call it freely; never call it inside a
    function that is captured into a CUDA graph (it would be recorded once,
    at the capture)."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SCOPE
    if not numbers:
        return torch.profiler.record_function(name)
    return _Numbered(name, numbers)


def scoped(name: str):
    """Decorator: `scope(name)` around every call of the function."""
    def wrap(fn):
        @functools.wraps(fn)
        def scoped_fn(*args, **kwargs):
            with scope(name):
                return fn(*args, **kwargs)
        return scoped_fn
    return wrap


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


def power_limits() -> list:
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
    limits = power_limits()
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


def device_time_by_kernel(prof) -> dict:
    """{name: [launches, ms]} of the card's work (kernels, copies, sets) in a
    finished `trace`, the most time first; empty where the trace saw no
    device work."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU and not e.is_user_annotation():
            rec = out.setdefault(e.name(), [0, 0.0])
            rec[0] += 1
            rec[1] += e.duration_ns() / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))
