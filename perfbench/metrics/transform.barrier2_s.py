"""transform.barrier2_s: seconds a job spends in barrier 2 (the histogram merge and the table solve), the mean per job of
the stats line's "obs_merge_s", "solve_s" (the program's own span walls)."""

from perfbench.metrics._stage import mean_of


def read(run: dict):
    return mean_of(run, "obs_merge_s", "solve_s")
