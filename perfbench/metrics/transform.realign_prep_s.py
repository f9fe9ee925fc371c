"""transform.realign_prep_s: seconds a job's realign tail spends preparing: target map and groups, native prep, consensuses and tiles, the mean per job of the
program's own span ``realign.prep`` (each job's --trace-out export)."""

from perfbench.metrics._spans import mean_span_s


def read(run: dict):
    return mean_span_s(run, "realign.prep")
