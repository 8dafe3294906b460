"""Generated seconds of every file of the window over the window's length
(host clock; the window ends when its last file has returned)."""

from perfbench.lib.readers import window_rate


def read(ctx):
    return window_rate(ctx, "audio_s")
