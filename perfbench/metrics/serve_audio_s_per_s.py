"""Generated dialogue seconds of every call of the window over the window's
length (host clock; the window ends when its last call has returned)."""

from perfbench.lib.readers import window_rate


def read(ctx):
    return window_rate(ctx, "audio_s")
