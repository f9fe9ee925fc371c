"""transform.unattributed_s: seconds of a job's streamed run under none of its
top-level stage spans, the mean per job of the stats line's "unattributed_s"
(derived from the program's own span totals)."""

from perfbench.metrics._stage import mean_of


def read(run: dict):
    return mean_of(run, "unattributed_s")
