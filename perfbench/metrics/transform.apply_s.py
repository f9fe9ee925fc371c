"""transform.apply_s: seconds a job spends in pass C (the table gather, kernel 2, the OQ stash), the mean per job of
the stats line's "apply_s" (the program's own span walls)."""

from perfbench.metrics._stage import mean_of


def read(run: dict):
    return mean_of(run, "apply_s")
