"""The readers of device idle time under the program's own spans
(`lib/program_spans.py` and its six metric files) on hand-built traces: the
latest-started span holding a gap labels it, a gap under a benchmark span
and no program span counts in none, each reading is per traced step, and a
trace without program spans reads None."""

import random
from types import SimpleNamespace

import pytest

from perfbench.lib import harness
from perfbench.lib import program_spans as PS
from perfbench.lib import trace as TR

READERS = {"decode_idle_in_read_s.serve": "read", "decode_idle_in_read_s.file": "read",
           "decode_idle_host_s.serve": "host", "decode_idle_host_s.file": "host",
           "flow_idle_host_s.file": "flow", "dispatch_idle_host_s.train": "train"}
NS = 1e9


def _ctx(device, host, steps=1, window=(0, 1000)):
    return SimpleNamespace(view=TR.TraceView(window, device, [(window[0], window[1], TR.WINDOW)] + host),
                           traced_steps=steps)


def _read(metric, ctx):
    return harness.load_module("metrics", metric).read(ctx)


# device busy everywhere but the gaps [100, 110) [200, 230) [300, 360) [400, 500) [600, 700) [800, 810)
DEVICE = [(0, 100, "k"), (110, 200, "k"), (230, 300, "k"), (360, 400, "k"), (500, 600, "k"), (700, 800, "k"),
          (810, 1000, "k")]
HOST = [(0, 1000, "entry"),                  # the benchmark's spans
        (90, 470, "decode"),
        (95, 410, "t2s.generate"),           # the program's
        (95, 150, "t2s.prepare"),
        (190, 260, "t2s.read"),              # holds the 30-long gap; t2s.generate holds it too
        (290, 380, "t2s.capture"),
        (460, 1000, "flow.sample"),
        (590, 720, "flow.step"),
        (805, 815, "train.fill")]
WANT = {"read": 30, "host": 10 + 60, "flow": 100, "train": 10}    # [400, 500): under `decode` alone


@pytest.mark.parametrize("metric", sorted(READERS))
def test_innermost_program_span_wins(metric):
    assert _read(metric, _ctx(DEVICE, HOST)) == pytest.approx(WANT[READERS[metric]] / NS)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reading_is_per_traced_step(metric):
    assert _read(metric, _ctx(DEVICE, HOST, steps=4)) == pytest.approx(WANT[READERS[metric]] / NS / 4)


def test_gap_under_a_benchmark_span_alone_counts_in_none():
    """The gap [400, 500) lies under `decode` and `entry` after
    t2s.generate ended: it keeps the benchmark span's label, which no
    reader takes, and the six readings are the same without it."""
    gaps = PS.labelled_gaps(_ctx(DEVICE, HOST).view)
    assert ("decode", 100 / NS) in gaps
    assert not (PS.in_read("decode") or PS.decode_host("decode") or PS.is_program("decode"))
    busy = DEVICE + [(400, 500, "k")]
    for metric, kind in READERS.items():
        assert _read(metric, _ctx(busy, HOST)) == pytest.approx(WANT[kind] / NS)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_no_program_spans_reads_none(metric):
    benchmark_only = [r for r in HOST if not PS.is_program(r[2])]
    assert _read(metric, _ctx(DEVICE, benchmark_only)) is None
    assert _read(metric, SimpleNamespace(view=None, traced_steps=1)) is None


def test_labels_are_the_harness_rule():
    """On random traces the one-sweep labels sum, by label, to what the
    harness's own `TraceView.idle_gaps` reports (ties in start included)."""
    rng = random.Random(7)
    names = ["entry", "decode", "t2s.generate", "t2s.read", "t2s.capture", "flow.step", "file.call", "serve.call"]
    for _ in range(30):
        device = []
        for _ in range(rng.randint(0, 40)):
            s = rng.randint(-50, 1050)
            device.append((s, s + rng.randint(1, 60), "k"))
        host = []
        for _ in range(rng.randint(0, 25)):
            s = rng.choice([rng.randint(0, 1000), 100, 500])
            host.append((s, s + rng.randint(0, 400), rng.choice(names)))
        view = _ctx(device, host).view
        sums = {}
        for label, sec in PS.labelled_gaps(view):
            sums[label] = sums.get(label, 0) + sec
        want = dict(view.idle_gaps(top=len(names) + 2))
        assert sums.keys() == want.keys()
        assert all(sums[k] == pytest.approx(want[k]) for k in want)
