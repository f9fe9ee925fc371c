"""transform.oq_stash_s: seconds a job's pass C spends stashing the original qualities as OQ, the mean per job of the
program's own span ``bqsr.apply.oq_stash`` (each job's --trace-out export)."""

from perfbench.metrics._spans import mean_span_s


def read(run: dict):
    return mean_span_s(run, "bqsr.apply.oq_stash")
