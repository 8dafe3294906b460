"""Percent of its roofline reached by the flash backward pair (dQ and dK/dV)
in the traced dispatches: the launches' least time over their device time."""

from perfbench.lib.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "flash_bwd", lambda name: "flash_bwd_" in name)
