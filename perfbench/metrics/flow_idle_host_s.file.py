"""Seconds per file the card idles while the host is in the flow sampler's
spans (`flow.sample`, `flow.embed`, `flow.step`): the one-row flow's eager
launches, which capturing the sampler removes."""

from perfbench.lib.program_spans import idle_per_step


def read(ctx):
    return idle_per_step(ctx, lambda label: label.startswith("flow."))
