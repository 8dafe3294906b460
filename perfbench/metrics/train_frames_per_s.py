"""20-ms frames trained (mel frames, or semantic targets) over every dispatch
of the window, over the window's length (host clock; each dispatch ends with the
host read of its losses)."""

from perfbench.lib.readers import window_rate


def read(ctx):
    return window_rate(ctx, "frames")
