"""The share of the traced jobs' walls in which no operation ran on the
card, in percent, from the profiler's device intervals."""

from perfbench.metrics._idle import idle_pct


def read(run: dict):
    return idle_pct(run)
