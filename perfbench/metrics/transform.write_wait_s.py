"""transform.write_wait_s: seconds a job spends in waiting on the Parquet writer pool, the mean per job of
the stats line's "write_wait_s" (the program's own span walls)."""

from perfbench.metrics._stage import mean_of


def read(run: dict):
    return mean_of(run, "write_wait_s")
