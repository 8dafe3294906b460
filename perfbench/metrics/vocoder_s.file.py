"""Seconds per step in the vocoder (`vocoder.generator`), ended by a
synchronize."""

from perfbench.lib.readers import span_per_step


def read(ctx):
    return span_per_step(ctx, "vocoder")
