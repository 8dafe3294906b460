"""Percent of the dense bf16 peak: the traced steps' model FLOPs (the T2S
decode as its teacher-forced forward over the decoded length, the flow's 32
field evaluations, the vocoder) over the traced window."""

from perfbench.lib.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
