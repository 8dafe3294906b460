"""Device idle time labelled by the program's own spans: the ranges that
`covomix_tpu_torch.util.profiling.scope` records inside the port's hot path
(`serve.*`, `file.*`, `t2s.*`, `flow.*`, `vocoder.*`, `train.*`).

Each idle gap of the traced window is labelled by the harness's rule
(`TraceView.idle_gaps`): the latest-started host range that holds the gap's
middle, the window's own range left out. A reader sums the gaps whose label
it takes, per traced step. It reads None where the trace holds no program
span (a program without them) or no device operation."""

from __future__ import annotations

import heapq
from typing import Callable, Optional

from perfbench.lib import trace as TR

PROGRAM = ("serve.", "file.", "t2s.", "flow.", "vocoder.", "train.")


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


def in_read(label: str) -> bool:
    """The host blocked on a decode chunk's stop flag: the card's own gaps
    between the kernels of the chunk's graph replays."""
    return label == "t2s.read"


def decode_host(label: str) -> bool:
    """The decode's host work: encode, prepare, capture, the graph replays'
    launches (in `t2s.generate` itself, between reads), finish."""
    return label.startswith("t2s.") and not in_read(label)


def labelled_gaps(view: TR.TraceView) -> list:
    """[(label, seconds)] of every idle gap of the window, in time order:
    `TraceView.idle_gaps`' labels, in one sweep over the ranges by start
    (kept on the view: the readers of one run share it)."""
    if "_program_gaps" not in view.__dict__:
        view._program_gaps = _labelled(view)
    return view._program_gaps


def _labelled(view: TR.TraceView) -> list:
    busy = TR._merged([(s, e) for s, e, _ in view.device], view.window)
    edges = [view.window[0]] + [x for iv in busy for x in iv] + [view.window[1]]
    ranges = sorted((r[0], i, r[1], r[2]) for i, r in enumerate(view.host_ranges) if r[2] != TR.WINDOW)
    open_, k, out = [], 0, []          # open_: heap of the started ranges, latest start (then first listed) on top
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        while k < len(ranges) and ranges[k][0] <= mid:
            start, i, end, name = ranges[k]
            heapq.heappush(open_, (-start, i, end, name))
            k += 1
        while open_ and open_[0][2] < mid:     # ended before this gap: before every later one too
            heapq.heappop(open_)
        out.append((open_[0][3] if open_ else "outside_spans", (b - a) / 1e9))
    return out


def idle_per_step(ctx, take: Callable[[str], bool]) -> Optional[float]:
    """Seconds per traced step of the idle gaps whose label `take` takes."""
    view = ctx.view
    if view is None or not ctx.traced_steps or not any(is_program(r[2]) for r in view.host_ranges):
        return None
    return sum(s for label, s in labelled_gaps(view) if take(label)) / ctx.traced_steps
