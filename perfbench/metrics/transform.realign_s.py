"""transform.realign_s: seconds a job spends in the realign tail (prep, sweeps, decisions), the mean per job of
the stats line's "realign_s" (the program's own span walls)."""

from perfbench.metrics._stage import mean_of


def read(run: dict):
    return mean_of(run, "realign_s")
