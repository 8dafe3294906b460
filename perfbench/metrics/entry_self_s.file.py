"""Seconds per step spent in the entry itself, outside the decode, flow and
vocoder spans (upload, packing, slicing, host copies)."""

from perfbench.lib.readers import self_per_step


def read(ctx):
    return self_per_step(ctx, ctx.wl["entry_span"])
