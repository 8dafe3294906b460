"""The port's `util/profiling.py` (covomix_tpu/util/profiling.py on
torch.profiler) on the CPU: a trace written to disk with the scopes in it,
NaN detection that raises at the op, checkify's (error, value), the device
report, and the idle-share arithmetic on synthetic intervals."""

import json
import math

import numpy as np
import pytest
import torch

from covomix_tpu_torch.util import profiling as P


def test_trace_writes_chrome_trace_with_scopes(tmp_path):
    with P.trace(str(tmp_path)) as prof:
        with P.scope("t2s_decode"):
            y = torch.randn(64, 64) @ torch.randn(64, 64)
        with P.scope("flow"):
            y = torch.tanh(y)
    assert prof is not None
    data = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert {"t2s_decode", "flow", "aten::mm", "aten::tanh"} <= names
    # on the CPU the trace holds no device activity: the decode window is all idle
    share = P.device_idle_share(prof, "t2s_decode")
    assert share["device_events"] == 0 and share["idle_share"] == 1.0 and share["window_ms"] > 0
    assert P.device_time_by_kernel(prof) == {}
    with pytest.raises(KeyError, match="vocoder"):
        P.device_idle_share(prof, "vocoder")


def test_trace_disabled_yields_none(tmp_path):
    with P.trace(str(tmp_path), enabled=False) as prof:
        torch.ones(3).sum()
    assert prof is None and not (tmp_path / "trace.json").exists()


def test_debug_nans_raises_at_the_op():
    """0 * inf is the first NaN: the op that made it is named; ops before it
    (the inf itself) and the same code outside the block pass."""
    x = torch.tensor([1.0, 0.0])
    with P.debug_nans():
        y = torch.log(x)                       # [0, -inf]: no NaN yet
        with pytest.raises(FloatingPointError, match="mul"):
            _ = y * torch.zeros(2)
    assert torch.isnan(y * torch.zeros(2)).any()
    with P.debug_nans(enabled=False):
        assert torch.isnan(y * torch.zeros(2)).any()


def test_checkify_call_returns_the_error_and_the_value():
    def f(a, b):
        return torch.sqrt(a) + b / b

    err, val = P.checkify_call(f, torch.tensor([4.0, 1.0]), torch.tensor([2.0, 0.0]))
    assert "div" in err.get() and torch.isnan(val[1]) and val[0] == 3.0
    with pytest.raises(FloatingPointError):
        err.throw()
    err, val = P.checkify_call(f, torch.tensor([4.0, -1.0]), torch.tensor([1.0, 1.0]))
    assert "sqrt" in err.get() and val[0] == 3.0
    err, val = P.checkify_call(lambda a: torch.tensor(1.0) / a, torch.tensor([0.0]))
    assert "division by zero" in err.get() and math.isinf(val[0])
    err, val = P.checkify_call(f, torch.tensor([4.0]), torch.tensor([2.0]))
    assert err.get() is None and float(val[0]) == 3.0
    err.throw()                                  # no error: nothing raised


def test_device_report_names_versions():
    report = P.device_report()
    assert f"torch {torch.__version__}" in report.splitlines()[0]
    if not torch.cuda.is_available():
        assert "no CUDA device" in report


@pytest.mark.parametrize("intervals,window,expect", [
    ([], (0, 10), 1.0),
    ([(0, 10)], (0, 10), 0.0),
    ([(2, 4), (3, 6), (8, 9)], (0, 10), 0.5),         # overlapping kernels count once
    ([(-5, 2), (9, 20)], (0, 10), 0.7),               # clipped to the window
    ([(1, 2), (1, 2), (5, 5)], (0, 4), 0.75),         # duplicates and empty intervals
    ([(12, 15)], (0, 10), 1.0),                       # outside the window
])
def test_idle_share_on_synthetic_intervals(intervals, window, expect):
    assert P.idle_share(intervals, window) == pytest.approx(expect)
    # the same against a 1 us grid
    lo, hi = window
    grid = np.arange(lo, hi, 0.001) + 0.0005
    busy = np.zeros_like(grid, dtype=bool)
    for s, e in intervals:
        busy |= (grid >= s) & (grid < e)
    assert P.idle_share(intervals, window) == pytest.approx(1.0 - busy.mean(), abs=1e-3)


def test_device_time_by_kernel_sums_device_events():
    """Device events summed by name, the most time first; host events and
    a scope's projection onto the device timeline left out."""
    from types import SimpleNamespace
    from torch.autograd import DeviceType

    def event(name, dev, ns, annotation=False):
        return SimpleNamespace(name=lambda: name, device_type=lambda: dev, duration_ns=lambda: ns,
                               is_user_annotation=lambda: annotation)

    events = [event("gemm", DeviceType.CUDA, 2_000_000), event("aten::mm", DeviceType.CPU, 9_000_000),
              event("flash_fwd", DeviceType.CUDA, 1_500_000), event("gemm", DeviceType.CUDA, 1_000_000),
              event("window", DeviceType.CUDA, 50_000_000, annotation=True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    out = P.device_time_by_kernel(prof)
    assert list(out) == ["gemm", "flash_fwd"]
    assert out["gemm"] == [2, pytest.approx(3.0)] and out["flash_fwd"] == [1, pytest.approx(1.5)]
