"""Percent of its roofline reached by the fused vocoder stage and tail
kernels in the traced files: the launches' least time over their device
time."""

from perfbench.lib.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "vocoder_fused", lambda name: "vocoder_fused_kernel" in name)
