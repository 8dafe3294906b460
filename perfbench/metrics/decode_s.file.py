"""Seconds per step in the T2S decode (`text2semantic.generate`), ended by a
synchronize."""

from perfbench.lib.readers import span_per_step


def read(ctx):
    return span_per_step(ctx, "decode")
