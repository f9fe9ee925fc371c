"""transform.resolve_s: seconds a job spends in barrier 1 (the duplicate resolve and the indel-event merge), the mean per job of
the stats line's "resolve_s" (the program's own span walls)."""

from perfbench.metrics._stage import mean_of


def read(run: dict):
    return mean_of(run, "resolve_s")
