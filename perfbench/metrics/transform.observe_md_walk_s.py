"""transform.observe_md_walk_s: seconds a job's pass B spends in the MD walk and the read mask of its observes, the mean per job of the
program's own span ``bqsr.observe.md_walk`` (each job's --trace-out export)."""

from perfbench.metrics._spans import mean_span_s


def read(run: dict):
    return mean_span_s(run, "bqsr.observe.md_walk")
