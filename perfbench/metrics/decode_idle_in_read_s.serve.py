"""Seconds per step the card idles while the host waits in `t2s.read` for a
decode chunk's stop flag: the gaps between the kernels of the chunk's graph
replays, which fusing the decode step's glue removes."""

from perfbench.lib.program_spans import idle_per_step, in_read


def read(ctx):
    return idle_per_step(ctx, in_read)
