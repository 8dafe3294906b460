"""Percent of the traced window in which no operation ran on the card."""

from perfbench.lib.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
