"""Seconds per dispatch the card idles while the host is in `MultiStep`'s
spans (`train.dispatch`, `train.fill`, `train.capture`, `train.replay`):
the program's share of the dispatch's idle, apart from the benchmark's own
batch drawing."""

from perfbench.lib.program_spans import idle_per_step


def read(ctx):
    return idle_per_step(ctx, lambda label: label.startswith("train."))
