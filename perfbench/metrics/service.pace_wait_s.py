"""service.pace_wait_s: seconds a sample's job spends blocked in its
tenant's weighted fair-queuing turns, summed per round over the round's
samples and taken per sample (the program's ``sched.pace.wait`` spans).
In ``service.four_samples`` each sample streams as one BAM window, so a
job makes three turns and none waits for another tenant: there it reads
~4e-5 s and cannot move ``transform_reads_per_s``; it shows whether a
traffic with more windows a sample lets the weights act."""

from perfbench.metrics._rounds import span_totals


def read(run: dict):
    got = span_totals(run, "sched.pace.wait")
    if got is None:
        return None
    return got[0] / (got[2] * len(run["state"].samples))
