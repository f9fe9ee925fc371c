"""transform.observe_s: seconds a job spends in pass B (the SNP mask, the MD walk, covariate keys and kernel 1), the mean per job of
the stats line's "observe_s" (the program's own span walls)."""

from perfbench.metrics._stage import mean_of


def read(run: dict):
    return mean_of(run, "observe_s")
