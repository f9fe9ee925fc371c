"""service.windows_per_dispatch: the windows a fused dispatch carries on
average, ``sched.batch.windows`` over ``sched.batch.dispatches`` summed
over the traced rounds (the coalescer's own counters)."""

from perfbench.metrics._rounds import counter_total


def read(run: dict):
    windows = counter_total(run, "sched.batch.windows")
    dispatches = counter_total(run, "sched.batch.dispatches")
    if not windows or not dispatches:
        return None
    return windows / dispatches
