"""Seconds per step the card idles while the host is in any other decode
span (`t2s.encode`, `t2s.prepare`, `t2s.capture`, `t2s.finish`, and
`t2s.generate` itself, where the graph replays are launched): host work
that casting the weights once or reading the stop flag less often
removes."""

from perfbench.lib.program_spans import decode_host, idle_per_step


def read(ctx):
    return idle_per_step(ctx, decode_host)
