"""transform.realign_decide_s: seconds a job's realign tail spends scoring, deciding the rewrites and writing them back, the mean per job of the
program's own span ``realign.decide`` (each job's --trace-out export)."""

from perfbench.metrics._spans import mean_span_s


def read(run: dict):
    return mean_span_s(run, "realign.decide")
