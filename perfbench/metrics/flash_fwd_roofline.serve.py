"""Percent of its roofline reached by the flash forward (with its rotary
pre-pass) in the traced calls: the launches' least time over their device
time."""

from perfbench.lib.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "flash_fwd", lambda name: "flash_fwd" in name or "flash_rotary_halfsplit" in name)
