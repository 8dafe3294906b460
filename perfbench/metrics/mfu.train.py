"""Percent of the dense bf16 peak: the traced dispatches' model FLOPs (3x the
forward of each step) over the traced window."""

from perfbench.lib.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
