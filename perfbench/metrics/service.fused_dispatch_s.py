"""service.fused_dispatch_s: seconds a round's coalescer dispatch thread
spends in fused dispatches (the program's ``sched.batch.fused`` spans:
fuse, launch, fetch), the mean per round."""

from perfbench.metrics._rounds import span_totals


def read(run: dict):
    got = span_totals(run, "sched.batch.fused")
    if got is None:
        return None
    return got[0] / got[2]
